"""The A7b options of madipm_tpu_torch against madipm_tpu: the flexible
PCG (``pcg_flex``), the second-order preconditioner (``precond_refine``)
and ``factor_precision``.

Unit functions, per lane against the unbatched JAX function: ``pcg_lowp``
(fp32 to 1e-5, fp64 to 1e-12, lanes leaving the loop at different trips),
``pcg_flex`` (fp64, 1e-12), the ``Smat`` of NORMAL and CONDENSED factors
(fp32, 1e-5) and ``_mixed_inner_solver`` on the same factors (fp64 1e-12;
fp32 1e-4, its 8 inner trips carry fp32 rounding through Smat's condition).  Which matrix ``Smat`` holds is
asserted: NORMAL the Jacobi-scaled S before PRECOND_SHIFT (the JAX
package's ``Shat_raw``), CONDENSED the shifted C the factor was taken of.

Solves (status, iterations +-1 with the reason printed, objective to 1e-8
relative) in the accelerator configuration (fp32 CHOLESKY_INV + fp64 PCG)
with each option against the JAX package with the same option.  In the CPU
configuration (fp64 factor) all three options are inert in both packages,
which apply them only to a factor below the solve dtype, so one JAX solve
of the plain configuration is the reference of the three.  On the CPU the
port leaves float32 products in float32 whatever ``factor_precision``
says (as XLA's CPU backend does), so those solves equal the plain one bit
for bit; the precision switch itself is held by ``matmul_precision``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import random_lp
from test_torch_kkt import FIELDS, _iterate, _lp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models import qp as jqp
from madipm_tpu.models.generators import known_optimum_qp
from madipm_tpu.ops import kkt as jkkt
from madipm_tpu.ops import linalg as jlin
from madipm_tpu.utils import options as jopt
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.ops import kkt as tkkt
from madipm_tpu_torch.ops import linalg as tlin
from madipm_tpu_torch.solver import driver as tdriver
from madipm_tpu_torch.utils import options as topt

torch.set_num_threads(2)


def _rel(t, j):
    t, j = np.asarray(t, dtype=np.float64), np.asarray(j, dtype=np.float64).reshape(np.shape(t))
    return float(np.max(np.abs(t - j)) / max(1e-300, np.max(np.abs(j))))


def _systems(dtype, seed=3, lanes=3, m=48):
    """SPD S per lane, conditioned from 1e1 to 1e4, and the inverse factor
    of a shifted S as a weak preconditioner (so the loops take trips)."""
    rng = np.random.default_rng(seed)
    S, W, b = [], [], []
    for i in range(lanes):
        G = rng.standard_normal((m, m))
        s = G @ G.T / m + np.diag(10.0 ** rng.uniform(-1 - i, 0, m))
        S.append(s)
        W.append(np.linalg.inv(np.linalg.cholesky(s + 0.05 * np.eye(m))))
        b.append(rng.standard_normal(m))
    return [np.array(v, dtype=dtype) for v in (S, W, b)]


@pytest.mark.parametrize("dtype, tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_pcg_lowp_matches_jax(dtype, tol):
    S, W, b = _systems(dtype)
    b = b / np.max(np.abs(b), axis=-1, keepdims=True)
    St, Wt, bt = (torch.tensor(v) for v in (S, W, b))
    out = tlin.pcg_lowp(lambda v: (Wt.mT @ (Wt @ v.unsqueeze(-1))).squeeze(-1),
                        lambda v: (St @ v.unsqueeze(-1)).squeeze(-1), bt, max_iters=8)
    assert out.dtype == bt.dtype
    for i in range(len(S)):
        Wi, Si = jnp.asarray(W[i]), jnp.asarray(S[i])
        j = jlin.pcg_lowp(lambda v: Wi.T @ (Wi @ v), lambda v: Si @ v, jnp.asarray(b[i]), max_iters=8)
        assert _rel(out[i], j) <= tol, i


def test_pcg_flex_matches_jax():
    S, W, b = _systems(np.float64, seed=5)
    W32 = W.astype(np.float32)
    St, bt, Wt = torch.tensor(S), torch.tensor(b), torch.tensor(W32)
    pre = lambda r: (Wt.mT @ (Wt @ r.to(torch.float32).unsqueeze(-1))).squeeze(-1)
    out = tlin.pcg_flex(pre, lambda v: (St @ v.unsqueeze(-1)).squeeze(-1), bt, max_iters=20, rtol=1e-13)
    for i in range(len(S)):
        Wi, Si = jnp.asarray(W32[i]), jnp.asarray(S[i])
        j = jlin.pcg_flex(lambda r: Wi.T @ (Wi @ r.astype(jnp.float32)), lambda v: Si @ v,
                          jnp.asarray(b[i]), max_iters=20, rtol=1e-13)
        assert _rel(out[i], j) <= 1e-12, i
        assert np.max(np.abs(S[i] @ out[i].numpy() - b[i])) <= 1e-10 * np.max(np.abs(b[i]))


def _cfgs(kind, solver, **flags):
    jc = jkkt.KKTConfig(kind=jopt.KKTSystem[kind], linear_solver=jopt.LinearSolver[solver],
                        factor_dtype=jnp.float32, refinement_steps=12, **flags)
    tc = tkkt.KKTConfig(kind=topt.KKTSystem[kind], linear_solver=topt.LinearSolver[solver],
                        factor_dtype=torch.float32, refinement_steps=12, **flags)
    return jc, tc


def _problem(kind):
    if kind == "NORMAL":
        models = [_lp(s) for s in (1, 2)]
    else:
        models = [known_optimum_qp(20, 40, seed=s)[0] for s in (1, 2)]
    jps = [jqp.pad_to_device(jqp.slack_form(q), pad_multiple=32) for q in models]
    fields = FIELDS + (("Q",) if kind == "CONDENSED" else ())
    tp = TorchQP.from_numpy({k: np.stack([np.asarray(getattr(jp, k)) for jp in jps]) for k in fields})
    rng = np.random.default_rng(7)
    its = [_iterate(jp, rng) for jp in jps]
    return jps, its, tp, {k: torch.tensor(np.stack([i[k] for i in its])) for k in its[0]}


@pytest.mark.parametrize("kind, solver", [("NORMAL", "CHOLESKY"), ("CONDENSED", "CHOLESKY")])
def test_smat_and_inner_solver_match_jax(kind, solver):
    jps, its, tp, tit = _problem(kind)
    dc = -1e-8 if kind == "NORMAL" else -1e-2  # K1: gamma 100, C conditioned ~1e3 for fp32
    jc, tc = _cfgs(kind, solver, use_flex_pcg=True)
    B = tp.batch
    fac, _, _, ok = tkkt.factorize(tc, tp, tit["x"], tit["zl"], tit["zu"],
                                   torch.full((B, 1), 1e-8, dtype=torch.float64),
                                   torch.full((B, 1), dc, dtype=torch.float64))
    assert bool(ok.all()) and fac.Smat.dtype == torch.float32
    # which matrix: rebuild M from the same pieces
    sigma = tkkt.build_sigma(tp, tit["x"], tit["zl"], tit["zu"], torch.full((B, 1), 1e-8, dtype=torch.float64))
    if kind == "NORMAL":
        M, _, _ = tkkt._assemble_normal(tp, sigma, torch.full((B, 1), dc, dtype=torch.float64), torch.float32)
    else:
        M, _, _ = tkkt._assemble_condensed(tp, sigma, torch.full((B, 1), dc, dtype=torch.float64), torch.float32)
    Mhat = M * fac.jac.unsqueeze(-1) * fac.jac.unsqueeze(-2)
    shifted = Mhat + tkkt.PRECOND_SHIFT * torch.eye(M.shape[-1])
    assert torch.equal(fac.Smat, Mhat if kind == "NORMAL" else shifted), kind
    jfac = jax.jit(functools.partial(jkkt.factorize, jc))
    r = np.random.default_rng(9).standard_normal((B, M.shape[-1]))
    r = np.where(fac.live.numpy(), r, 0.0) if kind == "NORMAL" else np.where(tp.free_mask.numpy(), r, 0.0)
    cls = tkkt.NormalFactors if kind == "NORMAL" else tkkt.CondensedFactors
    for i, (jp, it) in enumerate(zip(jps, its)):
        a = {k: jnp.asarray(v) for k, v in it.items()}
        jf, _, _, jok = jfac(jp, a["x"], a["zl"], a["zu"], 1e-8, dc)
        assert bool(jok)
        assert _rel(fac.Smat[i], jf.Smat) <= 1e-5
        # The inner solver on the same (the JAX package's) factors, in
        # fp32 and cast to fp64.  The inner CG runs 8 trips on Smat
        # (condition ~7e3 / ~1.5e3 here), which carries the two packages' fp32
        # rounding, ~6e-8 a product, to ~2e-5: fp32 is held at 1e-4, the
        # logic in fp64 at 1e-12.
        for dt, tol in ((jnp.float32, 1e-4), (jnp.float64, 1e-12)):
            jf2 = jf._replace(L=jf.L.astype(dt), jac=jf.jac.astype(dt), Smat=jf.Smat.astype(dt))
            tf = tkkt.factors_from_numpy(cls, {k: np.asarray(v) for k, v in jf2._asdict().items()})
            out = tkkt._mixed_inner_solver(tc, tf)(torch.tensor(r[i : i + 1]))
            jout = jkkt._mixed_inner_solver(jc, jf2)(jnp.asarray(r[i]))
            assert _rel(out[0], jout) <= tol, (i, dt)


@pytest.mark.parametrize("flags", [dict(), dict(use_flex_pcg=True, factor_dtype=torch.float64),
                                   dict(precond_refine=True, kind=topt.KKTSystem.CONDENSED)])
def test_smat_is_kept_only_where_used(flags):
    """None unless pcg_flex or precond_refine (NORMAL) runs on a factor
    below the solve dtype; K1 keeps it for pcg_flex alone."""
    jps, its, tp, tit = _problem("CONDENSED" if flags.get("kind") else "NORMAL")
    kw = dict(kind=topt.KKTSystem.NORMAL, linear_solver=topt.LinearSolver.CHOLESKY,
              factor_dtype=torch.float32, refinement_steps=12)
    kw.update(flags)
    fac, _, _, _ = tkkt.factorize(tkkt.KKTConfig(**kw), tp, tit["x"], tit["zl"], tit["zu"],
                                  torch.full((tp.batch, 1), 1e-8, dtype=torch.float64),
                                  torch.full((tp.batch, 1), -1e-4, dtype=torch.float64))
    assert fac.Smat is None


def test_matmul_precision_is_scoped_and_restored():
    before = torch.get_float32_matmul_precision()
    cuda = torch.device("cuda")
    for name, want in tkkt.MATMUL_PRECISION.items():
        with tkkt.matmul_precision(name, cuda):
            assert torch.get_float32_matmul_precision() == want
        assert torch.get_float32_matmul_precision() == before
    with pytest.raises(RuntimeError, match="inside"):
        with tkkt.matmul_precision("default", cuda):
            raise RuntimeError("inside")
    assert torch.get_float32_matmul_precision() == before
    with tkkt.matmul_precision("default", torch.device("cpu")):
        assert torch.get_float32_matmul_precision() == before


ACC = dict(factor_dtype="float32", refinement_steps=12, pcg_adaptive_tol=True, predictor_pcg_budget=0,
           pcg_tol_floor=1e-8, fp64_matvec="emulated", pad_multiple=32, tol=1e-8, max_iter=300)
CPU = dict(pad_multiple=32, tol=1e-8, max_iter=300)
OPTIONS = {"pcg_flex": dict(pcg_flex=True), "precond_refine": dict(precond_refine=True),
           "factor_precision": dict(factor_precision="default")}


def _lp_data():
    c, A, b, lvar, uvar = random_lp(np.random.default_rng(0), 64, 24, density=0.5, upper_frac=0.3)
    return dict(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)


def _solve(pkg, config, extra, **kw):
    opts = dict(ACC if config == "acc" else CPU, **extra)
    if config == "acc":
        opts["linear_solver"] = pkg.LinearSolver.CHOLESKY_INV
    return pkg.madipm(pkg.from_dense(**_lp_data()), print_level=pkg.PrintLevel.ERROR,
                      regularization=pkg.FixedRegularization(1e-8, -1e-8), **opts, **kw)


@pytest.fixture(scope="module")
def jax_cpu_plain():
    return _solve(mt, "cpu", {})


def _compare(ts, js, label):
    assert ts.status == js.status and ts.success, label
    if ts.iter != js.iter:
        print(f"{label}: iterations {ts.iter} (torch) vs {js.iter} (jax): the fp32 factors of the "
              f"two packages differ by ~1e-7")
    assert abs(ts.iter - js.iter) <= 1, label
    assert abs(ts.objective - js.objective) <= 1e-8 * max(1.0, abs(js.objective)), label


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_solves_match_jax_acc(option):
    js = _solve(mt, "acc", OPTIONS[option])
    ts = _solve(mtt, "acc", OPTIONS[option], device="cpu", rethrow_error=True)
    _compare(ts, js, f"acc {option}")


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_solves_match_jax_cpu(option, jax_cpu_plain):
    ts = _solve(mtt, "cpu", OPTIONS[option], device="cpu", rethrow_error=True)
    assert ts.iter == jax_cpu_plain.iter
    _compare(ts, jax_cpu_plain, f"cpu {option}")


def test_factor_precision_names_on_the_cpu():
    """Every name is accepted; on the CPU the solve is the plain one."""
    plain = _solve(mtt, "acc", {}, device="cpu")
    for name in tkkt.MATMUL_PRECISION:
        st = _solve(mtt, "acc", dict(factor_precision=name), device="cpu")
        assert st.iter == plain.iter and st.objective == plain.objective, name
    with pytest.raises(ValueError, match="factor_precision"):
        tdriver.make_config(topt.IPMOptions(factor_precision="fastest"), is_qp=False)
