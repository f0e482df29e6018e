"""madipm_tpu_torch.ops.kkt (NORMAL slice) and ops.linalg against madipm_tpu.

Two lanes (two padded LPs with a fixed column and an empty row, m=48 -> a
128 x 128 factor) at a random interior iterate.  Tolerances, relative to
the largest entry of the JAX result:

- unit functions (build_sigma, _assemble_normal, the Jacobi scale, pcg,
  the Cholesky helpers), fp64: 1e-12;
- factorize + solve_condensed, fp64 CHOLESKY (direct solve): 1e-10;
- factorize + solve_condensed, fp32 CHOLESKY_INV + fp64 PCG: 1e-8 (the
  fp32 factors agree to ~1e-7 and the PCG polishes the rest); with
  pcg_budget=0 (the factor alone, no PCG) the fp32 size, 1e-3.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madipm_tpu.models import qp as jqp
from madipm_tpu.ops import kkt as jkkt
from madipm_tpu.ops import linalg as jlin
from madipm_tpu.utils import options as jopt
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.ops import kkt as tkkt
from madipm_tpu_torch.ops import linalg as tlin
from madipm_tpu_torch.utils import options as topt

torch.set_num_threads(2)

FIELDS = ("c", "A", "b", "lb", "ub", "c0", "row_mask", "col_mask", "x0", "y0")


def _lp(seed, n=96, m=48):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    A[5] = 0.0  # structurally empty row: pinned out of the normal matrix
    xs = rng.random(n) + 0.5
    uvar = np.where(rng.random(n) < 0.3, xs + 2.0, np.inf)
    lvar = np.zeros(n)
    lvar[2] = uvar[2] = 0.4  # fixed
    return jqp.QuadraticModel(c=rng.random(n) + 0.1, A=A, lcon=A @ xs, ucon=A @ xs,
                              lvar=lvar, uvar=uvar)


def _iterate(jp, rng):
    lb, ub = np.asarray(jp.lb), np.asarray(jp.ub)
    hl, hu, free = np.asarray(jp.has_lb), np.asarray(jp.has_ub), np.asarray(jp.free_mask)
    u = rng.random(jp.n)
    with np.errstate(invalid="ignore"):
        x = np.where(hl & hu, lb + (ub - lb) * (0.05 + 0.9 * u), lb + 0.1 + u)
    x = np.where(free, x, np.where(np.asarray(jp.col_mask), lb, 0.0))
    # Sigma spread over a few decades, as in mid-solve iterations
    zl = np.where(hl, 10.0 ** rng.uniform(-3, 2, jp.n), 0.0)
    zu = np.where(hu, 10.0 ** rng.uniform(-3, 2, jp.n), 0.0)
    return dict(x=x, zl=zl, zu=zu, rx=rng.standard_normal(jp.n) * free,
                rp=rng.standard_normal(jp.m) * np.asarray(jp.row_mask))


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(11)
    jps = [jqp.pad_to_device(jqp.slack_form(_lp(s))) for s in (1, 2)]
    its = [_iterate(jp, rng) for jp in jps]
    tp = TorchQP.from_numpy({k: np.stack([np.asarray(getattr(jp, k)) for jp in jps]) for k in FIELDS})
    tit = {k: torch.tensor(np.stack([i[k] for i in its])) for k in its[0]}
    return jps, its, tp, tit


def _close(t, j, tol, what=""):
    t = np.asarray(t, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64).reshape(t.shape)
    err = float(np.max(np.abs(t - j)))
    assert err <= tol * max(1e-300, float(np.max(np.abs(j)))), (what, err)


def _lane_scalar(v):
    return torch.full((2, 1), v, dtype=torch.float64)


def test_build_sigma_and_assemble_normal(lanes):
    jps, its, tp, tit = lanes
    sig = tkkt.build_sigma(tp, tit["x"], tit["zl"], tit["zu"], _lane_scalar(1e-8))
    S, dinv, live = tkkt._assemble_normal(tp, sig, _lane_scalar(-1e-8), torch.float64)
    for i, (jp, it) in enumerate(zip(jps, its)):
        jsig = jkkt.build_sigma(jp, jnp.asarray(it["x"]), jnp.asarray(it["zl"]), jnp.asarray(it["zu"]), 1e-8)
        _close(sig[i], jsig, 1e-12, "sigma")
        jS, jdinv, jlive = jkkt._assemble_normal(jp, jsig, -1e-8, jnp.float64)
        _close(S[i], jS, 1e-12, "S")
        _close(dinv[i], jdinv, 1e-12, "dinv")
        np.testing.assert_array_equal(live[i].numpy(), np.asarray(jlive))
        assert not bool(jlive[5])  # the empty row is pinned


def _cfgs(name):
    if name == "fp64-cholesky":
        kw = dict(kind="NORMAL", linear_solver="CHOLESKY", refinement_steps=0)
        fd = (jnp.float64, torch.float64)
    else:
        kw = dict(kind="NORMAL", linear_solver="CHOLESKY_INV", refinement_steps=12)
        fd = (jnp.float32, torch.float32)
    jc = jkkt.KKTConfig(kind=jopt.KKTSystem[kw["kind"]], linear_solver=jopt.LinearSolver[kw["linear_solver"]],
                        factor_dtype=fd[0], refinement_steps=kw["refinement_steps"])
    tc = tkkt.KKTConfig(kind=topt.KKTSystem[kw["kind"]], linear_solver=topt.LinearSolver[kw["linear_solver"]],
                        factor_dtype=fd[1], refinement_steps=kw["refinement_steps"])
    return jc, tc


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
    jc, _ = _cfgs(name)
    fac = jax.jit(functools.partial(jkkt.factorize, jc))
    solve = jax.jit(functools.partial(jkkt.solve_condensed, jc),
                    static_argnames=("pcg_budget", "return_products"))
    return fac, solve


SOLVE_TOL = {"fp64-cholesky": 1e-10, "fp32-inv-pcg": 1e-8}


@pytest.mark.parametrize("name", list(SOLVE_TOL))
def test_factorize_and_solve_match(lanes, name):
    jps, its, tp, tit = lanes
    _, tc = _cfgs(name)
    jfac, jsolve = _jax_fns(name)
    tol = SOLVE_TOL[name]
    dw, dc = _lane_scalar(1e-8), _lane_scalar(-1e-8)
    fac, tdw, tdc, tok = tkkt.factorize(tc, tp, tit["x"], tit["zl"], tit["zu"], dw, dc)
    assert bool(tok.all())
    rtol = torch.tensor([[1e-12], [1e-10]], dtype=torch.float64)
    runs = [
        dict(kw=dict(), out=tkkt.solve_condensed(tc, tp, fac, tit["rx"], tit["rp"])),
        dict(kw=dict(pcg_budget=6), out=tkkt.solve_condensed(tc, tp, fac, tit["rx"], tit["rp"], pcg_budget=6)),
        dict(kw=dict(pcg_budget=0, return_products=True),
             out=tkkt.solve_condensed(tc, tp, fac, tit["rx"], tit["rp"], pcg_budget=0, return_products=True)),
        dict(kw=dict(return_products=True), rtol=rtol,
             out=tkkt.solve_condensed(tc, tp, fac, tit["rx"], tit["rp"], pcg_rtol=rtol, return_products=True)),
    ]
    # a perturbed direction, so the residual is O(1) and not rounding noise
    dx_off = runs[0]["out"][0] + 0.01 * tit["rx"]
    res = tkkt.solve_residual(tp, fac, tit["rx"], tit["rp"], dx_off, runs[0]["out"][1])
    for i, (jp, it) in enumerate(zip(jps, its)):
        a = {k: jnp.asarray(v) for k, v in it.items()}
        jf, jdw, jdc, jok = jfac(jp, a["x"], a["zl"], a["zu"], 1e-8, -1e-8)
        assert bool(jok)
        assert float(tdw[i, 0]) == float(jdw) and float(tdc[i, 0]) == float(jdc)
        _close(fac.jac[i], jf.jac, 1e-12 if name == "fp64-cholesky" else 1e-6, "jac")
        _close(fac.L[i], jf.L, 1e-10 if name == "fp64-cholesky" else 1e-4, "factor")
        for run in runs:
            kw = dict(run["kw"])
            if "rtol" in run:
                kw["pcg_rtol"] = float(run["rtol"][i, 0])
            jout = jsolve(jp, jf, a["rx"], a["rp"], **kw)
            # pcg_budget=0 applies the factor alone: no PCG polishes an
            # fp32 factor's ~1e-7 differences, so they stay at fp32 size.
            rtol_run = 1e-3 if (kw.get("pcg_budget") == 0 and name != "fp64-cholesky") else tol
            for t, j in zip(run["out"], jout):
                _close(t[i], j, rtol_run, f"{name} {run['kw']}")
        jdx, jdy = jsolve(jp, jf, a["rx"], a["rp"])
        _close(res[i], jkkt.solve_residual(jp, jf, a["rx"], a["rp"], jdx + 0.01 * a["rx"], jdy),
               1e-12, "solve_residual")


def test_factorize_retry_and_force_ok_per_lane(lanes):
    """Lane 0 starts from an indefinite system (del_c = +1e3) and retries
    with x100 bumps; lane 1 is fine at once.  With force_ok on lane 0 its
    first attempt is accepted.  Each lane matches unbatched JAX."""
    name = "fp32-inv-pcg"
    jps, its, tp, tit = lanes
    _, tc = _cfgs(name)
    jfac, _ = _jax_fns(name)
    dw = _lane_scalar(1e-8)
    dc = torch.tensor([[1e3], [-1e-8]], dtype=torch.float64)
    for force in (None, torch.tensor([[True], [False]])):
        fac, tdw, tdc, tok = tkkt.factorize(tc, tp, tit["x"], tit["zl"], tit["zu"], dw, dc, force_ok=force)
        for i, (jp, it) in enumerate(zip(jps, its)):
            a = {k: jnp.asarray(v) for k, v in it.items()}
            # force_ok=False is JAX's no-force case (ok | False), one compile
            fo = jnp.asarray(force is not None and bool(force[i, 0]))
            jf, jdw, jdc, jok = jfac(jp, a["x"], a["zl"], a["zu"], 1e-8, float(dc[i, 0]), fo)
            assert float(tdw[i, 0]) == float(jdw) and float(tdc[i, 0]) == float(jdc), (i, force)
            assert bool(tok[i, 0]) == bool(jok)
            if bool(jok) and force is None:
                _close(fac.L[i], jf.L, 1e-4, "factor")
        if force is None:
            assert float(tdw[0, 0]) > 1e-8 and float(tdw[1, 0]) == 1e-8  # lane 0 retried alone
        else:
            assert float(tdc[0, 0]) == 1e3 and bool(tok[0, 0])


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    return G @ G.T / n + np.diag(10.0 ** rng.uniform(-2, 1, n))


def test_pcg_matches_jax_per_lane():
    """Two lanes on a fixed SPD system: lane 0 with a perturbed fp32
    preconditioner (several PCG trips), lane 1 with an exact one (exits
    at once); each lane equals the unbatched JAX pcg to 1e-12."""
    n = 64
    S = np.stack([_spd(n, 1), _spd(n, 2)])
    P = S.copy()
    P[0] += 0.05 * np.eye(n)
    Lp = np.linalg.cholesky(P).astype(np.float32)
    rhs = np.random.default_rng(3).standard_normal((2, n))
    TS, TL = torch.tensor(S), torch.tensor(Lp)
    x, r = tlin.pcg(lambda b: tlin.cholesky_solve(TL, b), lambda v: (TS @ v.unsqueeze(-1)).squeeze(-1),
                    torch.tensor(rhs), max_iters=10, rtol=1e-14, return_residual=True)
    x_only = tlin.pcg(lambda b: tlin.cholesky_solve(TL, b), lambda v: (TS @ v.unsqueeze(-1)).squeeze(-1),
                      torch.tensor(rhs), max_iters=10, rtol=1e-14)
    torch.testing.assert_close(x, x_only, rtol=0, atol=0)
    for i in range(2):
        JL, JS = jnp.asarray(Lp[i]), jnp.asarray(S[i])
        jx, jr = jlin.pcg(lambda b: jlin.cholesky_solve(JL, b), lambda v: JS @ v, jnp.asarray(rhs[i]),
                          max_iters=10, rtol=1e-14, return_residual=True)
        _close(x[i], jx, 1e-12, "x")
        # the residual sits at the rounding floor: compare it on rhs's scale
        assert float(np.max(np.abs(r[i].numpy() - np.asarray(jr)))) <= 1e-12 * np.max(np.abs(rhs[i]))
    assert np.max(np.abs(np.einsum("bij,bj->bi", S, x.numpy()) - rhs)) < 1e-10


def test_cholesky_helpers_match_jax():
    S = np.stack([_spd(32, 4), -np.eye(32)])
    L = tlin.cholesky_factor(torch.tensor(S))
    ok = tlin.cholesky_is_ok(L)
    assert ok.tolist() == [True, False] and torch.isnan(L[1]).all()
    jL = jlin.cholesky_factor(jnp.asarray(S))
    assert np.asarray(jlin.cholesky_is_ok(jL)).tolist() == [True, False]
    _close(L[0], jL[0], 1e-12, "L")
    b = np.random.default_rng(0).standard_normal(32)
    _close(tlin.cholesky_solve(L[0], torch.tensor(b)), jlin.cholesky_solve(jL[0], jnp.asarray(b)), 1e-12, "solve")
    L32 = tlin.cholesky_factor(torch.tensor(S[0], dtype=torch.float32))
    assert L32.dtype == torch.float32 and bool(tlin.cholesky_is_ok(L32))
