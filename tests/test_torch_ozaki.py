"""madipm_tpu_torch/ops/ozaki.py and its solver wiring on the CPU, against
madipm_tpu/ops/ozaki.py.

The slices and scales must be bit-equal to JAX's (the slicing is exact
arithmetic on both sides, once the power-of-two scales agree); the four
products may differ only by the final fp64 sum over the exact pair
partials, so they are held to 1e-15 K rowmax|A| max|x| (K the contraction
length).  The solves run the JAX test's LP and QP (tests/test_ozaki.py)
through both packages; each asserts that the port's problem really carries
slices, since ``with_ozaki`` returns the problem unsliced off 128-multiples.
The kernel itself (csrc/ozaki.cu) runs on the card only: ``chip_smoke.py``
holds it against the plain versions tested here.

JAX is imported inside the tests: the gloo ranks import this module.
"""

import warnings

import numpy as np
import pytest
import torch

import madipm_tpu_torch as mtt
from madipm_tpu_torch.ops import ozaki
from madipm_tpu_torch.solver import driver

torch.set_num_threads(2)

B, M, N = 2, 128, 256


def _matrix(seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N)) * np.exp(rng.uniform(-6, 6, (B, M, 1)))
    A[0, 3] = 0.0  # a zero row: scale 1
    A[1, 5, :7] = 2.0 ** np.arange(-3, 4)  # a row of exact powers of two
    return A, rng.standard_normal((B, N)) * 1e3, rng.standard_normal((B, M))


def _jax():
    import jax.numpy as jnp

    from madipm_tpu.ops import ozaki as jo

    return jnp, jo


def test_pow2_scale_bit_equal():
    jnp, jo = _jax()
    rng = np.random.default_rng(1)
    mx = np.concatenate([2.0 ** np.arange(-60.0, 61.0),
                         np.abs(rng.standard_normal(500)) * np.exp(rng.uniform(-30, 30, 500)),
                         np.nextafter(2.0 ** np.arange(-10.0, 11.0), 0.0), [0.0, 1e-300, 3e38]])
    got = ozaki._pow2_scale(torch.tensor(mx)).numpy()
    want = np.asarray(jo._pow2_scale(jnp.asarray(mx)))
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.all(got[mx == 0.0] == 1.0)


@pytest.mark.parametrize("variant, n_slices", [("bf16", 5), ("bf16", 7), ("i8", None)])
def test_slices_bit_equal(variant, n_slices):
    """Slices (bf16 compared as float32) and row scales of every lane equal
    the JAX package's; the port keeps the bf16 slices (B, S, m, n) where
    JAX keeps (S, C, m, 128)."""
    jnp, jo = _jax()
    A = _matrix()[0]
    sm = ozaki.slice_any(torch.tensor(A), variant, n_slices)
    assert sm.slices.shape == (B, n_slices or ozaki.N8_SLICES, M, N)
    for b in range(B):
        jsm = jo.slice_any(jnp.asarray(A[b]), variant, n_slices)
        if variant == "bf16":
            want = np.asarray(jsm.slices.astype(jnp.float32))
            want = want.transpose(0, 2, 1, 3).reshape(n_slices, M, N)
            got = sm.slices[b].float().numpy()
        else:
            want, got = np.asarray(jsm.slices), sm.slices[b].numpy()
        assert np.array_equal(got, want)
        assert np.array_equal(sm.row_scale[b].numpy(), np.asarray(jsm.row_scale))


@pytest.mark.parametrize("variant", ["bf16", "i8"])
def test_products_match_jax(variant):
    """A x and A' v of every lane against JAX's matvec/matvec_t (bf16 at 5
    and 7 slices) or matvec_i8/matvec_t_i8, and the dispatchers."""
    jnp, jo = _jax()
    A, x, v = _matrix(2)
    counts = (5, 7) if variant == "bf16" else (None,)
    for n_slices in counts:
        sm = ozaki.slice_any(torch.tensor(A), variant, n_slices)
        y, yt = ozaki.apply(sm, torch.tensor(x)), ozaki.apply_t(sm, torch.tensor(v))
        assert y.shape == (B, M) and yt.shape == (B, N) and y.dtype == torch.float64
        for b in range(B):
            jsm = jo.slice_any(jnp.asarray(A[b]), variant, n_slices)
            jy = np.asarray(jo.apply(jsm, jnp.asarray(x[b])))
            jyt = np.asarray(jo.apply_t(jsm, jnp.asarray(v[b])))
            rowmax = np.abs(A[b]).max(axis=1)
            assert np.all(np.abs(y[b].numpy() - jy) <= 1e-15 * N * rowmax * np.abs(x[b]).max())
            assert np.max(np.abs(yt[b].numpy() - jyt)) <= 1e-15 * M * rowmax.max() * np.abs(v[b]).max()
    # a shorter x is zero-padded, as in JAX
    short = ozaki.apply(sm, torch.tensor(x[:, : N - 5]))
    torch.testing.assert_close(short, ozaki.apply(sm, torch.tensor(np.pad(x[:, : N - 5], ((0, 0), (0, 5))))),
                               rtol=0, atol=0)


def test_cpu_takes_plain_version_and_other_devices_raise(monkeypatch):
    """A CPU tensor never reaches the kernel; a tensor on another device
    goes to the kernel's checks and is refused, never computed plainly."""
    A, x, v = _matrix(3)
    monkeypatch.setattr(ozaki, "_load", lambda: pytest.fail("a CPU tensor reached the kernel"))
    before = dict(ozaki.launches)
    for variant in ("bf16", "i8"):
        sm = ozaki.slice_any(torch.tensor(A), variant)
        ozaki.apply(sm, torch.tensor(x))
        ozaki.apply_t(sm, torch.tensor(v))
        meta = type(sm)(sm.slices.to("meta"), sm.row_scale.to("meta"))
        with pytest.raises(ValueError, match="CUDA device"):
            ozaki.apply(meta, torch.empty(B, N, dtype=torch.float64, device="meta"))
    assert ozaki.launches == before
    too_many = ozaki.slice_matrix(torch.tensor(A), 9)
    meta = ozaki.SlicedMatrix(too_many.slices.to("meta"), too_many.row_scale.to("meta"))
    with pytest.raises(ValueError, match="at most 8 slices"):
        ozaki.apply(meta, torch.empty(B, N, dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="rows divisible by 128"):
        ozaki.matvec_t(ozaki.slice_matrix(torch.tensor(A[:, :100])), torch.zeros(B, 100))


# ---------------------------------------------------------------------------
# Solves through both packages
# ---------------------------------------------------------------------------

#: tests/test_ozaki.py::test_ozaki_solve_matches_emulated's options
LP_OPTIONS = dict(tol=1e-8, regularization="fixed", print_level="ERROR", linear_solver="CHOLESKY_INV",
                  factor_dtype="float32", refinement_steps=6, pcg_adaptive_tol=True)


def _opts(pkg, kw):
    out = dict(kw)
    for key, enum in (("print_level", pkg.PrintLevel), ("linear_solver", pkg.LinearSolver)):
        if key in out:
            out[key] = enum[out[key]]
    if out.get("regularization") == "fixed":
        out["regularization"] = pkg.FixedRegularization(1e-8, -1e-8)
    return out


def _lp_data():
    """tests/test_ozaki.py's 50 x 100 LP (rng seed 42, as its fixture)."""
    rng = np.random.default_rng(42)
    m, n = 50, 100
    A = np.asarray(rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5))
    for r in np.flatnonzero(np.abs(A).sum(1) == 0):
        A[r, int(rng.integers(n))] = 1.0
    b = A @ (rng.random(n) + 0.5)
    c = rng.random(n) + 0.1
    return dict(c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=np.full(n, np.inf))


def _qp_data():
    """tests/test_ozaki.py::test_ozaki_qp's 20 x 40 QP."""
    rng = np.random.default_rng(42)
    m, n = 20, 40
    A = np.asarray(rng.standard_normal((m, n)))
    b = A @ (rng.random(n) + 0.5)
    c = rng.standard_normal(n)
    G = rng.standard_normal((n, n))
    return dict(c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=np.full(n, np.inf),
                Q=G @ G.T / n + np.eye(n))


#: name -> (data, options) of the solves held against JAX
SOLVES = {
    "lp_ozaki": (_lp_data, dict(LP_OPTIONS, fp64_matvec="ozaki")),
    "lp_ozaki_i8": (_lp_data, dict(LP_OPTIONS, fp64_matvec="ozaki_i8")),
    "lp_ozaki_shared": (_lp_data, dict(LP_OPTIONS, fp64_matvec="ozaki", ozaki_share_slices=True)),
    "qp_ozaki": (_qp_data, dict(print_level="ERROR", fp64_matvec="ozaki")),
}


def _result(st):
    return dict(status=int(st.status), iter=st.iter, objective=st.objective,
                solution=np.asarray(st.solution))


@pytest.fixture(scope="module")
def jax_solves():
    import madipm_tpu as mt

    return {name: _result(mt.madipm(mt.from_dense(**data()), **_opts(mt, kw)))
            for name, (data, kw) in SOLVES.items()}


def _agrees(got, want, label):
    rel = abs(got["objective"] - want["objective"]) / max(1.0, abs(want["objective"]))
    assert got["status"] == want["status"] and mtt.Status(got["status"]) == mtt.Status.SOLVE_SUCCEEDED
    if got["iter"] != want["iter"]:
        print(f"{label}: iterations {got['iter']} against {want['iter']}: the products' last "
              f"fp64 sums run in another order")
    assert abs(got["iter"] - want["iter"]) <= 1
    assert rel <= 1e-8


@pytest.mark.parametrize("name", list(SOLVES))
def test_solve_matches_jax(name, jax_solves):
    data, kw = SOLVES[name]
    solver = mtt.MPCSolver(mtt.from_dense(**data()), device="cpu", **_opts(mtt, kw))
    cfg = solver.cfg
    assert cfg.use_ozaki and cfg.ozaki_variant == ("i8" if name.endswith("i8") else "bf16")
    prob_s, _, _ = driver.initialize(cfg, solver.prob)
    kind = ozaki.SlicedMatrixI8 if cfg.ozaki_variant == "i8" else ozaki.SlicedMatrix
    assert isinstance(prob_s.A_sl, kind), "the solve ran without slices"
    assert (prob_s.At_sl is None) == name.endswith("shared")
    assert (prob_s.Q_sl is not None) == name.startswith("qp")
    _agrees(_result(solver.solve()), jax_solves[name], name)


def test_share_rule_and_bound_warning():
    """The share rule counts the real slices and bytes: at 4096 x 10240 the
    two copies of 5 bf16 slices (0.84 GB) or of 8 int8 slices (0.67 GB)
    stay stored, where the JAX package's fixed 2*7*2 bytes per entry
    (1.17 GB) shares them; 7 bf16 slices share.  The bf16 bound warns past
    0.1 tol and names the slice count that meets it, on CUDA only a count
    the kernel takes (at most 8), where more slices are refused."""
    m, n = 4096, 10240
    assert 2 * 7 * 2 * m * n > 1 << 30  # madipm_tpu/solver/driver.py's estimate: shared
    cfg = lambda **kw: driver.make_config(mtt.IPMOptions(**kw), is_qp=False)
    assert not driver.ozaki_share(cfg(fp64_matvec="ozaki", ozaki_slices=5), m, n)
    assert not driver.ozaki_share(cfg(fp64_matvec="ozaki_i8"), m, n)
    assert driver.ozaki_share(cfg(fp64_matvec="ozaki"), m, n)
    assert driver.ozaki_share(cfg(fp64_matvec="ozaki", ozaki_share_slices=True), 128, 128)
    assert not driver.ozaki_share(cfg(fp64_matvec="ozaki", ozaki_share_slices=False), m, n)
    for device in ("cpu", "cuda"):
        with pytest.warns(UserWarning, match="use ozaki_slices=7"):
            driver._check_ozaki_slices(cfg(fp64_matvec="ozaki", ozaki_slices=5, tol=1e-8), 2048, device)
    # 2n 2^-8(S-1) <= 1e-14 at n = 2048 needs 9 slices
    with pytest.warns(UserWarning, match="use ozaki_slices=9"):
        driver._check_ozaki_slices(cfg(fp64_matvec="ozaki", tol=1e-13), 2048, "cpu")
    with pytest.warns(UserWarning, match="use native fp64 products"):
        driver._check_ozaki_slices(cfg(fp64_matvec="ozaki", tol=1e-13), 2048, "cuda")
    with pytest.raises(ValueError, match="at most 8 slices"):
        driver._check_ozaki_slices(cfg(fp64_matvec="ozaki", ozaki_slices=9, tol=1e-8), 2048, "cuda")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        driver._check_ozaki_slices(cfg(fp64_matvec="ozaki", ozaki_slices=9, tol=1e-8), 2048, "cpu")
        for device in ("cpu", "cuda"):
            driver._check_ozaki_slices(cfg(fp64_matvec="ozaki", tol=1e-8), 2048, device)
            driver._check_ozaki_slices(cfg(fp64_matvec="ozaki_i8", tol=1e-8), 2048, device)


# ---------------------------------------------------------------------------
# The column group: two gloo ranks
# ---------------------------------------------------------------------------


def _mesh_rank(rank, world):
    """The LP through MPCSolver(mesh=...) with the bf16 Ozaki products:
    each rank slices its column block."""
    from madipm_tpu_torch.parallel import make_mesh

    solver = mtt.MPCSolver(mtt.from_dense(**_lp_data()), device="cpu", mesh=make_mesh(world, ("cols",)),
                           **_opts(mtt, SOLVES["lp_ozaki"][1]))
    prob_s, _, _ = driver.initialize(solver.cfg, solver.prob)
    return dict(_result(solver.solve(logged=False)), sliced=prob_s.A_sl is not None,
                block=tuple(prob_s.A_sl.slices.shape))


def test_column_group_two_ranks(tmp_path):
    from madipm_tpu_torch.tools.gloo_ranks import start_ranks

    run = start_ranks(_mesh_rank, 2, tmp_path / "gloo2", deadline=120.0)
    solver = mtt.MPCSolver(mtt.from_dense(**_lp_data()), device="cpu", pad_multiple=256,
                           **_opts(mtt, SOLVES["lp_ozaki"][1]))
    want = _result(solver.solve(logged=False))
    ranks = run.wait()
    for r in ranks:
        assert r["sliced"] and r["block"] == (1, ozaki.N_SLICES, 256, 128)
        assert r["iter"] == ranks[0]["iter"] and np.array_equal(r["solution"], ranks[0]["solution"])
    _agrees(ranks[0], want, "2 ranks against one process")
