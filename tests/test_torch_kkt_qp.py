"""madipm_tpu_torch.ops.kkt on QPs (CONDENSED, AUGMENTED, SCALED_AUGMENTED)
against madipm_tpu.ops.kkt on the same DeviceQP fields.

Two lanes (two padded QPs with a fixed column and an empty row, n=48,
m=20 -> 128 columns, 128 rows; 64 and 32 for LDL_INV) at a random
interior iterate, del_w = 1e-8, del_c = -1e-8, fp64 factors.
Tolerances, relative to the largest entry of the JAX result:

- assembly (C, K, gamma, live): 1e-12;
- K2 / K2.5 factors and directions (LDL, LDL_INV, LU + refinement): 1e-8.
  The augmented matrix has pivots from 1e-8 to 1e3, so two eliminations
  that differ by rounding agree to ~cond x eps;
- K1 factors 1e-6 (the explicit inverse factor of CHOLESKY_INV, whose
  entries reach 1e4, 1e-5) and directions 1e-5: C = Sigma + Q + 1e8 A'A has a
  condition number near 1e10, and the PCG leaves at a residual of
  1e-14 |rhs| ~ 1e-6;
- the KKT residual of each direction, on both sides: K2 <= 1e-9 of the
  right-hand side's size, K1 <= 1e-6 (dy = -1e8 (rp - A dx) carries the
  rounding of A dx times gamma).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import madipm_tpu as mt
from madipm_tpu.models import qp as jqp
from madipm_tpu.ops import kkt as jkkt
from madipm_tpu.utils import options as jopt
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.ops import kkt as tkkt
from madipm_tpu_torch.utils import options as topt

torch.set_num_threads(2)

FIELDS = ("c", "A", "b", "lb", "ub", "Q", "c0", "row_mask", "col_mask", "x0", "y0")

#: (kind, linear_solver) -> (factor tol, direction tol)
CASES = {
    ("CONDENSED", "CHOLESKY"): (1e-6, 1e-5),
    ("CONDENSED", "CHOLESKY_INV"): (1e-5, 1e-5),
    ("AUGMENTED", "LDL"): (1e-8, 1e-8),
    ("AUGMENTED", "LDL_INV"): (1e-8, 1e-8),
    ("AUGMENTED", "LU"): (1e-8, 1e-8),
    ("SCALED_AUGMENTED", "LDL"): (1e-8, 1e-8),
    ("SCALED_AUGMENTED", "LU"): (1e-8, 1e-8),
}
IDS = [f"{k}-{s}" for k, s in CASES]


def _qp(seed, n=48, m=20):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    A[5] = 0.0  # structurally empty row: pinned out of every system
    xs = rng.random(n) + 0.5
    uvar = np.where(rng.random(n) < 0.3, xs + 2.0, np.inf)
    lvar = np.zeros(n)
    lvar[2] = uvar[2] = 0.4  # fixed
    P = rng.standard_normal((n, n // 4)) / np.sqrt(n)
    return mt.from_dense(c=rng.standard_normal(n), A=A, lcon=A @ xs, ucon=A @ xs,
                         lvar=lvar, uvar=uvar, Q=P @ P.T + 0.1 * np.eye(n))


def _iterate(jp, rng):
    lb, ub = np.asarray(jp.lb), np.asarray(jp.ub)
    hl, hu, free = np.asarray(jp.has_lb), np.asarray(jp.has_ub), np.asarray(jp.free_mask)
    u = rng.random(jp.n)
    with np.errstate(invalid="ignore"):
        x = np.where(hl & hu, lb + (ub - lb) * (0.05 + 0.9 * u), lb + 0.1 + u)
    x = np.where(free, x, np.where(np.asarray(jp.col_mask), lb, 0.0))
    zl = np.where(hl, 10.0 ** rng.uniform(-3, 2, jp.n), 0.0)
    zu = np.where(hu, 10.0 ** rng.uniform(-3, 2, jp.n), 0.0)
    return dict(x=x, zl=zl, zu=zu, rx=rng.standard_normal(jp.n) * free,
                rp=rng.standard_normal(jp.m) * np.asarray(jp.row_mask))


def _lanes(pad_multiple):
    rng = np.random.default_rng(11)
    jps = [jqp.pad_to_device(jqp.slack_form(_qp(s)), pad_multiple=pad_multiple) for s in (1, 2)]
    its = [_iterate(jp, rng) for jp in jps]
    tp = TorchQP.from_numpy({k: np.stack([np.asarray(getattr(jp, k)) for jp in jps]) for k in FIELDS})
    tit = {k: torch.tensor(np.stack([i[k] for i in its])) for k in its[0]}
    return jps, its, tp, tit


@pytest.fixture(scope="module")
def lanes():
    return _lanes(128)


@pytest.fixture(scope="module")
def lanes32():
    """The same lanes padded to 64 columns and 32 rows, for LDL_INV: the
    JAX package's LDL_INV recursion compiles several times faster there."""
    return _lanes(32)


def _close(t, j, tol, what=""):
    t = np.asarray(t, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64).reshape(t.shape)
    err = float(np.max(np.abs(t - j)))
    assert err <= tol * max(1e-300, float(np.max(np.abs(j)))), (what, err)


def _lane_scalar(v):
    return torch.full((2, 1), v, dtype=torch.float64)


def _cfgs(kind, solver, refinement=None):
    if refinement is None:
        refinement = 12 if kind == "CONDENSED" else 0
    jc = jkkt.KKTConfig(kind=jopt.KKTSystem[kind], linear_solver=jopt.LinearSolver[solver],
                        factor_dtype=jnp.float64, refinement_steps=refinement)
    tc = tkkt.KKTConfig(kind=topt.KKTSystem[kind], linear_solver=topt.LinearSolver[solver],
                        factor_dtype=torch.float64, refinement_steps=refinement)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_fns(kind, solver, refinement=None):
    jc, _ = _cfgs(kind, solver, refinement)
    fac = jax.jit(functools.partial(jkkt.factorize, jc))
    solve = jax.jit(functools.partial(jkkt.solve_condensed, jc),
                    static_argnames=("pcg_budget", "return_products"))
    return fac, solve


def test_assembly_matches(lanes):
    jps, its, tp, tit = lanes
    sig = tkkt.build_sigma(tp, tit["x"], tit["zl"], tit["zu"], _lane_scalar(1e-8))
    dc = torch.tensor([[-1e-8], [-1e-10]], dtype=torch.float64)  # lane 1 under the relax floor
    C, gamma, live = tkkt._assemble_condensed(tp, sig, dc, torch.float64)
    K, live2 = tkkt._assemble_augmented(tp, sig, dc, torch.float64)
    assert K.shape == (2, tp.n + tp.m, tp.n + tp.m)
    for i, (jp, it) in enumerate(zip(jps, its)):
        jsig = jkkt.build_sigma(jp, jnp.asarray(it["x"]), jnp.asarray(it["zl"]), jnp.asarray(it["zu"]), 1e-8)
        jC, jgamma, jlive = jkkt._assemble_condensed(jp, jsig, float(dc[i, 0]), jnp.float64)
        _close(C[i], jC, 1e-12, "C")
        assert float(gamma[i, 0]) == float(jgamma) == 1e8  # the floor holds lane 1 at 1e8
        jK, jlive2 = jkkt._assemble_augmented(jp, jsig, float(dc[i, 0]), jnp.float64)
        _close(K[i], jK, 1e-12, "K")
        for t, j in ((live[i], jlive), (live2[i], jlive2)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert not bool(jlive[5])  # the empty row is pinned


@pytest.mark.parametrize("kind, solver", list(CASES), ids=IDS)
def test_factorize_and_solve_match(request, kind, solver):
    jps, its, tp, tit = request.getfixturevalue("lanes32" if solver == "LDL_INV" else "lanes")
    _, tc = _cfgs(kind, solver)
    jfac, jsolve = _jax_fns(kind, solver)
    ftol, dtol = CASES[kind, solver]
    dw, dc = _lane_scalar(1e-8), _lane_scalar(-1e-8)
    fac, tdw, tdc, tok = tkkt.factorize(tc, tp, tit["x"], tit["zl"], tit["zu"], dw, dc)
    assert bool(tok.all())
    k1 = kind == "CONDENSED"
    assert isinstance(fac, tkkt.CondensedFactors if k1 else tkkt.AugmentedFactors)
    kws = [dict(), dict(return_products=True)]
    if k1:
        kws += [dict(pcg_budget=6), dict(pcg_budget=0, return_products=True)]
    outs = [tkkt.solve_condensed(tc, tp, fac, tit["rx"], tit["rp"], **kw) for kw in kws]
    res = tkkt.solve_residual(tp, fac, tit["rx"], tit["rp"], *outs[0])
    dx_off = outs[0][0] + 0.01 * tit["rx"]  # an O(1) residual, not rounding noise
    res_off = tkkt.solve_residual(tp, fac, tit["rx"], tit["rp"], dx_off, outs[0][1])
    for i, (jp, it) in enumerate(zip(jps, its)):
        a = {k: jnp.asarray(v) for k, v in it.items()}
        jf, jdw, jdc, jok = jfac(jp, a["x"], a["zl"], a["zu"], 1e-8, -1e-8)
        assert bool(jok)
        assert float(tdw[i, 0]) == float(jdw) and float(tdc[i, 0]) == float(jdc)
        _close(fac.jac[i], jf.jac, 1e-12, "jac")
        _close(fac.sigma[i], jf.sigma, 1e-12, "sigma")
        _close(fac.del_c[i], jf.del_c, 0.0, "del_c")
        if k1:
            _close(fac.L[i], jf.L, ftol, "factor")
            _close(fac.gamma[i], jf.gamma, 0.0, "gamma")
        else:
            _close(fac.Lfac[i], jf.Lfac, ftol, "Lfac")
            if solver == "LU":
                np.testing.assert_array_equal(fac.dfac[i].numpy() - 1, np.asarray(jf.dfac))
            else:
                _close(fac.dfac[i], jf.dfac, ftol, "dfac")
        for kw, out in zip(kws, outs):
            # pcg_budget=0 applies K1's factor alone, with no PCG to polish
            # its cond x eps error
            tol = 1e-3 if kw.get("pcg_budget") == 0 else dtol
            for t, j in zip(out, jsolve(jp, jf, a["rx"], a["rp"], **kw)):
                _close(t[i], j, tol, f"{kind} {solver} {kw}")
        jdx, jdy = jsolve(jp, jf, a["rx"], a["rp"])
        jres = float(jkkt.solve_residual(jp, jf, a["rx"], a["rp"], jdx, jdy))
        rtol = 1e-6 if k1 else 1e-9
        assert float(res[i, 0]) <= rtol and jres <= rtol, (float(res[i, 0]), jres)
        _close(res_off[i], jkkt.solve_residual(jp, jf, a["rx"], a["rp"], jdx + 0.01 * a["rx"], jdy),
               1e-6, "solve_residual")


def test_k2_refinement_with_fp32_factor(lanes):
    """AUGMENTED + LDL in fp32 with 12 refinement sweeps on the fp64
    operator: the refined direction matches JAX's to 1e-6 (two fp32 factors
    that differ by ~1e-7 leave different refinement floors) and solves the
    fp64 system far below the fp32 factor's own error."""
    jps, its, tp, tit = lanes
    jc = jkkt.KKTConfig(kind=jopt.KKTSystem.AUGMENTED, linear_solver=jopt.LinearSolver.LDL,
                        factor_dtype=jnp.float32, refinement_steps=12)
    tc = tkkt.KKTConfig(kind=topt.KKTSystem.AUGMENTED, linear_solver=topt.LinearSolver.LDL,
                        factor_dtype=torch.float32, refinement_steps=12)
    dw, dc = _lane_scalar(1e-4), _lane_scalar(-1e-4)
    fac, _, _, tok = tkkt.factorize(tc, tp, tit["x"], tit["zl"], tit["zu"], dw, dc)
    assert bool(tok.all()) and fac.Lfac.dtype == torch.float32
    dx, dy = tkkt.solve_condensed(tc, tp, fac, tit["rx"], tit["rp"])
    res = tkkt.solve_residual(tp, fac, tit["rx"], tit["rp"], dx, dy)
    assert float(res.max()) <= 1e-9
    for i, (jp, it) in enumerate(zip(jps, its)):
        a = {k: jnp.asarray(v) for k, v in it.items()}
        jf, _, _, jok = jkkt.factorize(jc, jp, a["x"], a["zl"], a["zu"], 1e-4, -1e-4)
        jdx, jdy = jkkt.solve_condensed(jc, jp, jf, a["rx"], a["rp"])
        _close(dx[i], jdx, 1e-6, "dx")
        _close(dy[i], jdy, 1e-6, "dy")


@pytest.mark.parametrize("kind, solver", [("CONDENSED", "CHOLESKY"), ("AUGMENTED", "LDL"),
                                          ("AUGMENTED", "LU")], ids=["K1", "K2-LDL", "K2-LU"])
def test_factorize_retry_rule_and_force_ok(lanes, kind, solver):
    """Lane 0's first attempt fails and retries with x100 bumps, lane 1 is
    fine at once.  The SPD kind forces del_c negative on a retry, the
    augmented kinds multiply it as it is.  With force_ok on lane 0 its
    first attempt is accepted.  Each lane matches unbatched JAX."""
    jps, its, tp, tit = lanes
    _, tc = _cfgs(kind, solver)
    jfac, _ = _jax_fns(kind, solver)
    if kind == "CONDENSED":
        # a negative Sigma makes C indefinite until del_w is bumped over it
        zl = tit["zl"].clone()
        zl[0] = torch.where(tp.has_lb[0], -50.0, 0.0)
        dw0, dc0 = 1e-8, 1e-3  # a positive del_c: the retry must flip its sign
    else:
        # a NaN in lane 0's Sigma: every attempt fails, and the multiplied
        # del_c keeps its sign
        zl = tit["zl"].clone()
        zl[0, 0] = float("nan")
        dw0, dc0 = 1e-8, 1e-3
    dw = _lane_scalar(dw0)
    dc = torch.tensor([[dc0], [-1e-8]], dtype=torch.float64)
    for force in (None, torch.tensor([[True], [False]])):
        fac, tdw, tdc, tok = tkkt.factorize(tc, tp, tit["x"], zl, tit["zu"], dw, dc, force_ok=force)
        for i, (jp, it) in enumerate(zip(jps, its)):
            a = {k: jnp.asarray(v) for k, v in it.items()}
            fo = jnp.asarray(force is not None and bool(force[i, 0]))
            jf, jdw, jdc, jok = jfac(jp, a["x"], jnp.asarray(zl[i].numpy()), a["zu"], dw0,
                                     float(dc[i, 0]), fo)
            assert float(tdw[i, 0]) == float(jdw) and float(tdc[i, 0]) == float(jdc), (i, force)
            assert bool(tok[i, 0]) == bool(jok), (i, force)
        assert float(tdw[1, 0]) == 1e-8 and float(tdc[1, 0]) == -1e-8  # lane 1 never retried
        if force is not None:
            assert float(tdw[0, 0]) == dw0 and float(tdc[0, 0]) == dc0 and bool(tok[0, 0])
        elif kind == "CONDENSED":
            assert float(tdw[0, 0]) > dw0 and float(tdc[0, 0]) < 0
        else:
            assert float(tdw[0, 0]) == dw0 * 100.0 * 100.0 and float(tdc[0, 0]) == dc0 * 100.0 * 100.0
            assert not bool(tok[0, 0])
        if solver == "LU":
            assert fac.dfac.dtype == torch.int32  # the lane merge keeps integer pivots


@pytest.mark.parametrize("kind, solver", [("CONDENSED", "CHOLESKY_INV"), ("AUGMENTED", "LDL"),
                                          ("AUGMENTED", "LU")], ids=["K1", "K2-LDL", "K2-LU"])
def test_jax_factors_feed_the_torch_solve(lanes, kind, solver):
    """State carried across: factors computed by the JAX package, as numpy
    arrays, go through factors_from_numpy into the port's solve, which
    returns JAX's direction (tolerances as above)."""
    jps, its, tp, tit = lanes
    _, tc = _cfgs(kind, solver)
    jfac, jsolve = _jax_fns(kind, solver)
    cls = tkkt.CondensedFactors if kind == "CONDENSED" else tkkt.AugmentedFactors
    dtol = CASES[kind, solver][1]
    for i, (jp, it) in enumerate(zip(jps, its)):
        a = {k: jnp.asarray(v) for k, v in it.items()}
        jf, *_ = jfac(jp, a["x"], a["zl"], a["zu"], 1e-8, -1e-8)
        tf = tkkt.factors_from_numpy(cls, {k: np.asarray(v) for k, v in jf._asdict().items()})
        lane = TorchQP.from_numpy({k: np.asarray(getattr(jp, k)) for k in FIELDS})
        dx, dy = tkkt.solve_condensed(tc, lane, tf, tit["rx"][i:i + 1], tit["rp"][i:i + 1])
        jdx, jdy = jsolve(jp, jf, a["rx"], a["rp"])
        _close(dx[0], jdx, dtol, "dx")
        _close(dy[0], jdy, dtol, "dy")
