"""madipm_tpu_torch: package import without jax, options, status, the host
problem layer, TorchQP against DeviceQP, and the generators."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models import generators as jgen
from madipm_tpu.models import qp as jqp
from madipm_tpu.utils import options as jopt
from madipm_tpu.utils.status import Status as JStatus
from madipm_tpu_torch.models import generators as tgen
from madipm_tpu_torch.models import qp as tqp
from madipm_tpu_torch.ops import chol_inv
from madipm_tpu_torch.solver import driver
from madipm_tpu_torch.utils import options as topt

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "madipm_tpu_torch")


def _package_sources():
    """The package's .py files; ``_build`` holds build output, not sources."""
    for root, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_imports_without_jax():
    """Every module of the package imports with jax made unimportable."""
    mods = []
    for path in _package_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "import madipm_tpu_torch as p\n"
        "assert callable(p.madipm) and callable(p.madipm_batch)\n"
        "assert sys.modules['jax'] is None\n"
        "assert not any(k.startswith('jax.') or k == 'jaxlib' for k in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for path in _package_sources():
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                assert not (s.startswith("import jax") or s.startswith("from jax")), (path, s)


def test_options_match_field_for_field():
    jf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(jopt.IPMOptions)]
    tf = [(f.name, f.default, f.default_factory) for f in dataclasses.fields(topt.IPMOptions)]
    assert [n for n, *_ in jf] == [n for n, *_ in tf]
    plain = lambda d: {k: getattr(v, "value", v) for k, v in dataclasses.asdict(d).items()}
    for (n, jd, jfac), (_, td, tfac) in zip(jf, tf):
        if jfac is not dataclasses.MISSING:
            assert type(jfac()).__name__ == type(tfac()).__name__, n
            assert plain(jfac()) == plain(tfac()), n
        elif isinstance(jd, jopt.PrintLevel):
            assert int(jd) == int(td), n
        else:
            assert jd == td, n
    for name in ("KKTSystem", "LinearSolver", "PrintLevel", "StepRuleKind"):
        je, te = getattr(jopt, name), getattr(topt, name)
        assert [(e.name, e.value) for e in je] == [(e.name, e.value) for e in te]
    with pytest.warns(UserWarning, match="bogus"):
        topt.load_options(tol=1e-6, bogus=1)


def test_status_codes_match():
    assert [(s.name, int(s)) for s in JStatus] == [(s.name, int(s)) for s in mtt.Status]


def _general_lp(seed=0, n=12, m=7):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.6)
    lcon = rng.standard_normal(m) - 1.0
    ucon = lcon + np.where(rng.random(m) < 0.4, 0.0, rng.random(m) + 0.5)
    ucon[0] = np.inf
    lvar = np.where(rng.random(n) < 0.8, 0.0, -np.inf)
    uvar = np.where(rng.random(n) < 0.4, 2.0, np.inf)
    lvar[1] = uvar[1] = 0.5  # a fixed variable
    c = rng.standard_normal(n)
    return dict(c=c, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar)


def _same_model(a, b):
    for f in ("c", "lcon", "ucon", "lvar", "uvar", "x0", "y0"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.A.toarray(), b.A.toarray())
    assert (a.c0, a.minimize, a.nvar, a.ncon) == (b.c0, b.minimize, b.nvar, b.ncon)


def test_host_reformulations_match():
    d = _general_lp()
    jm, tm = mt.from_dense(**d), mtt.from_dense(**d)
    _same_model(jm, tm)
    _same_model(jqp.slack_form(jm), tqp.slack_form(tm))
    (js, jmap), (ts, tmap) = jqp.standard_form(jm, True), tqp.standard_form(tm, True)
    _same_model(js, ts)
    np.testing.assert_array_equal(jmap.ind_rng, tmap.ind_rng)
    rng = np.random.default_rng(1)
    ys, zl, zu = rng.standard_normal(js.ncon), rng.random(js.nvar), rng.random(js.nvar)
    for a, b in zip(jmap.duals(ys, zl, zu), tmap.duals(ys, zl, zu)):
        np.testing.assert_array_equal(a, b)


def _device_fields(p) -> dict:
    names = ("c", "A", "b", "lb", "ub", "Q", "c0", "row_mask", "col_mask", "x0", "y0")
    return {k: (None if getattr(p, k) is None else np.asarray(getattr(p, k))) for k in names}


def test_torchqp_matches_deviceqp():
    """pad_to_device gives the same padded fields and masks, and the
    operator methods agree to 1e-12."""
    sm = tqp.slack_form(mtt.from_dense(**_general_lp(seed=3)))
    jp = jqp.pad_to_device(jqp.slack_form(mt.from_dense(**_general_lp(seed=3))))
    tp = tqp.pad_to_device(sm, pad_multiple=128)
    assert (tp.batch, tp.m, tp.n) == (1, jp.m, jp.n) == (1, 128, 128)
    for k, v in _device_fields(jp).items():
        if v is None:
            assert getattr(tp, k) is None
            continue
        t = getattr(tp, k).numpy()[0]
        np.testing.assert_array_equal(t.reshape(v.shape), v, err_msg=k)
    for mask in ("free_mask", "has_lb", "has_ub"):
        np.testing.assert_array_equal(getattr(tp, mask).numpy()[0], np.asarray(getattr(jp, mask)))
    np.testing.assert_array_equal(tp.live_rows().numpy()[0], np.asarray(jp.live_rows()))

    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(jp.n), rng.standard_normal(jp.m)
    dinv = rng.random(jp.n) * np.asarray(jp.free_mask)
    cs = rng.random(jp.m) + 0.5
    tx, ty = torch.tensor(x)[None], torch.tensor(y)[None]
    pairs = [
        (tp.matvec(tx), jp.matvec(jnp.asarray(x))),
        (tp.rmatvec(ty), jp.rmatvec(jnp.asarray(y))),
        (tp.row_inf_norm(), jp.row_inf_norm()),
        (tp.scale_rows(torch.tensor(cs)[None]).A, jp.scale_rows(jnp.asarray(cs)).A),
        (tp.assemble_normal_matrix(torch.tensor(dinv)[None], torch.float64),
         jp.assemble_normal_matrix(jnp.asarray(dinv), jnp.float64)),
    ]
    for t, j in pairs:
        j = np.asarray(j)
        assert np.max(np.abs(t.numpy()[0] - j)) <= 1e-12 * max(1.0, np.max(np.abs(j)))
    assert tp.scale_quad(torch.ones(1, 1, dtype=torch.float64)) is tp


def test_torchqp_from_numpy_batched_and_stack():
    from madipm_tpu_torch.parallel.batch import bucket_pad, stack_problems

    models = [mtt.from_dense(**_general_lp(seed=s)) for s in range(3)]
    probs, slacked = bucket_pad(models)
    assert probs.batch == 3 and probs.A.shape == (3, 128, 128)
    fields = {k: (None if v is None else v.numpy()) for k, v in vars(probs).items()
              if k in {f.name for f in dataclasses.fields(tqp.TorchQP)}}
    fields["c0"] = fields["c0"][:, 0]
    again = tqp.TorchQP.from_numpy(fields)
    for f in dataclasses.fields(tqp.TorchQP):
        a, b = getattr(probs, f.name), getattr(again, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    with pytest.raises(ValueError, match="padded shape"):
        stack_problems([probs, tqp.pad_to_device(slacked[0], pad_multiple=256)])


def test_generators_match():
    for deg in (False, True):
        jm, jinfo = jgen.known_optimum_lp(20, 40, seed=5, degenerate=deg)
        tm, tinfo = tgen.known_optimum_lp(20, 40, seed=5, degenerate=deg)
        _same_model(jm, tm)
        assert jm.name == tm.name and jinfo["obj"] == tinfo["obj"]
    sys.path.insert(0, REPO)
    import bench

    for a, b in zip(bench.make_suite(k=2, n=30, m=12, density=0.3),
                    tgen.make_suite(k=2, n=30, m=12, density=0.3)):
        _same_model(a, b)
        assert a.name == b.name


#: (options, exception or None, match or the field that must take the
#: option: of the KKTConfig, or of the SolverConfig for the Ozaki options);
#: the ids are the ones these cases had while the three A7b options and the
#: two Ozaki products were refused
MAKE_CONFIG_CASES = [
    (dict(fp64_matvec="ozaki"), None, "use_ozaki", "kw0-NotImplementedError-A12"),
    (dict(fp64_matvec="ozaki_i8"), None, "ozaki_variant", "kw1-NotImplementedError-A12"),
    (dict(fp64_matvec="nope"), ValueError, "fp64_matvec", "kw2-ValueError-fp64_matvec"),
    (dict(factor_precision="high"), None, "factor_precision", "kw3-NotImplementedError-A7b"),
    (dict(barrier_update="monotone"), ValueError, "barrier_update", "kw4-ValueError-barrier_update"),
    (dict(pcg_flex=True), None, "use_flex_pcg", "kw5-NotImplementedError-A7b"),
    (dict(precond_refine=True), None, "precond_refine", "kw6-NotImplementedError-A7b"),
    (dict(factor_dtype="float16"), ValueError, "factor_dtype", "kw7-ValueError-factor_dtype"),
    (dict(factor_dtype="bfloat16"), ValueError, "factor_dtype", "kw8-ValueError-factor_dtype"),
    (dict(factor_precision="fast"), ValueError, "factor_precision", "kw9-ValueError-factor_precision"),
]


@pytest.mark.parametrize("kw, exc, match", [c[:3] for c in MAKE_CONFIG_CASES],
                         ids=[c[3] for c in MAKE_CONFIG_CASES])
def test_make_config_rejects_unported(kw, exc, match):
    """Invalid values are refused; the A7b options are passed into the
    KKTConfig, and the two Ozaki products resolve to the use_ozaki and
    ozaki_variant that the JAX package's make_config gives on the CPU."""
    if exc is not None:
        with pytest.raises(exc, match=match):
            driver.make_config(topt.IPMOptions(**kw), is_qp=False)
        return
    from madipm_tpu.solver import driver as jdriver

    (value,) = kw.values()
    cfg = driver.make_config(topt.IPMOptions(**kw), is_qp=False)
    jcfg = jdriver.make_config(jopt.IPMOptions(**kw), is_qp=False)
    if "fp64_matvec" in kw:
        assert (cfg.use_ozaki, cfg.ozaki_variant) == (jcfg.use_ozaki, jcfg.ozaki_variant)
        assert cfg.use_ozaki and getattr(cfg, match) == getattr(jcfg, match)
        return
    assert getattr(cfg.kkt, match) == getattr(jcfg.kkt, match) == value


def test_make_config_rejects_normal_for_qp():
    with pytest.raises(ValueError, match="NormalKKT"):
        driver.make_config(topt.IPMOptions(kkt_system=topt.KKTSystem.NORMAL), is_qp=True)


@pytest.mark.parametrize("is_qp, kw", [
    (False, {}),
    (False, dict(factor_dtype="float32", linear_solver="CHOLESKY_INV")),
    (False, dict(use_pallas=True, fp64_matvec="emulated")),
    (True, {}),  # AUGMENTED + LDL, no refinement in fp64
    (True, dict(kkt_system="CONDENSED")),  # K1 refines even with an fp64 factor
    (True, dict(kkt_system="CONDENSED", linear_solver="CHOLESKY_INV", use_pallas=True)),
    (True, dict(kkt_system="SCALED_AUGMENTED", linear_solver="LU", factor_dtype="float32")),
    (False, dict(kkt_system="AUGMENTED", max_ncorr=3)),
])
def test_make_config_resolves_like_jax(is_qp, kw):
    from madipm_tpu.solver import driver as jdriver

    def resolve(opt_mod):
        out = dict(kw)
        for key, enum in (("kkt_system", "KKTSystem"), ("linear_solver", "LinearSolver")):
            if key in out:
                out[key] = getattr(opt_mod, enum)[out[key]]
        return opt_mod.IPMOptions(**out)

    cfg = driver.make_config(resolve(topt), is_qp=is_qp)
    jcfg = jdriver.make_config(resolve(jopt), is_qp=is_qp)
    assert cfg.kkt.kind.value == jcfg.kkt.kind.value
    assert cfg.kkt.refinement_steps == jcfg.kkt.refinement_steps
    assert cfg.kkt.linear_solver.value == jcfg.kkt.linear_solver.value
    assert str(cfg.kkt.factor_dtype)[6:] == str(jcfg.kkt.factor_dtype)
    assert cfg.kkt.use_pallas == jcfg.kkt.use_pallas
    assert cfg.max_ncorr == jcfg.max_ncorr


def test_chol_inv_wrapper_dispatch():
    """CPU tensors take the plain version and launch nothing; any other
    non-CUDA device raises instead of falling back."""
    S = torch.eye(64, dtype=torch.float64) * 4.0
    before = chol_inv.launches
    L, W = chol_inv.chol_inv(S)
    assert chol_inv.launches == before
    torch.testing.assert_close(L, 2.0 * torch.eye(64, dtype=torch.float64))
    torch.testing.assert_close(W, 0.5 * torch.eye(64, dtype=torch.float64))
    with pytest.raises(ValueError, match="device"):
        chol_inv.chol_inv(torch.empty(64, 64, device="meta"))
