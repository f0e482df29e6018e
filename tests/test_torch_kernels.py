"""madipm_tpu_torch.solver.kernels and solver.state against madipm_tpu.

Two lanes (two padded LPs with fixed, free, one- and two-sided bounded
variables) hold a random interior iterate each; every function's batched
torch output on lane i must equal the JAX function on lane i's data to a
relative 1e-12 (both fp64 on the CPU; the sums run in another order), and
integer outputs (argmin positions, masks, counters) exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from madipm_tpu.models import qp as jqp
from madipm_tpu.solver import kernels as JK
from madipm_tpu.solver import state as jstate
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.solver import kernels as TK
from madipm_tpu_torch.solver import state as tstate

torch.set_num_threads(2)

TOL = 1e-12
FIELDS = ("c", "A", "b", "lb", "ub", "Q", "c0", "row_mask", "col_mask", "x0", "y0")


def _lp(seed, n=40, m=20):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    A[m - 1] = 0.0  # a structurally empty row
    xs = rng.random(n) + 0.5
    lvar = np.where(rng.random(n) < 0.8, 0.0, -np.inf)
    uvar = np.where(rng.random(n) < 0.4, xs + 2.0, np.inf)
    lvar[3] = uvar[3] = 0.7  # fixed
    return jqp.QuadraticModel(c=rng.random(n) - 0.3, A=A, lcon=A @ xs, ucon=A @ xs,
                              lvar=lvar, uvar=uvar)


def _iterate(jp, rng):
    lb, ub = np.asarray(jp.lb), np.asarray(jp.ub)
    free, hl, hu = (np.asarray(v) for v in (jp.free_mask, jp.has_lb, jp.has_ub))
    n, m = jp.n, jp.m
    u = rng.random(n)
    with np.errstate(invalid="ignore"):
        x = np.where(hl & hu, lb + (ub - lb) * (0.05 + 0.9 * u),
                     np.where(hl, lb + 0.1 + u, np.where(hu, ub - 0.1 - u, rng.standard_normal(n))))
    x = np.where(free, x, np.where(np.asarray(jp.col_mask), lb, 0.0))
    x[np.flatnonzero(hl)[:2]] = lb[np.flatnonzero(hl)[:2]] + 1e-22  # touch the bound
    it = dict(
        x=x, y=rng.standard_normal(m) * np.asarray(jp.row_mask),
        zl=np.where(hl, rng.random(n) + 0.1, 0.0), zu=np.where(hu, rng.random(n) + 0.1, 0.0),
        dx=rng.standard_normal(n) * free, dzl=rng.standard_normal(n) * hl,
        dzu=rng.standard_normal(n) * hu, dy=rng.standard_normal(m),
    )
    it["mu"] = 0.3
    return it


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(7)
    jps = [jqp.pad_to_device(jqp.slack_form(_lp(s)), pad_multiple=64) for s in (1, 2)]
    its = [_iterate(jp, rng) for jp in jps]
    stacked = {k: np.stack([np.asarray(getattr(jp, k)) for jp in jps]) for k in FIELDS if k != "Q"}
    tp = TorchQP.from_numpy(stacked)
    tit = {k: torch.tensor(np.stack([np.asarray(i[k]) for i in its])).reshape(2, -1) for k in its[0]}
    return jps, its, tp, tit


def _close(t, j, what):
    t = np.asarray(t, dtype=np.float64)
    j = np.asarray(j, dtype=np.float64).reshape(t.shape)
    fin = np.isfinite(j)
    assert np.array_equal(fin, np.isfinite(t)), what
    np.testing.assert_array_equal(t[~fin], j[~fin], err_msg=what)
    scale = max(1.0, float(np.max(np.abs(j[fin])))) if fin.any() else 1.0
    err = float(np.max(np.abs(t[fin] - j[fin]))) if fin.any() else 0.0
    assert err <= TOL * scale, (what, err, scale)


def _compare(lanes, name, tfun, jfun, argnames, extra=()):
    jps, its, tp, tit = lanes
    tout = tfun(tp, *(tit[a] for a in argnames), *extra)
    tout = tout if isinstance(tout, tuple) else (tout,)
    for i, (jp, it) in enumerate(zip(jps, its)):
        jextra = tuple(float(e[i, 0]) if torch.is_tensor(e) else e for e in extra)
        jout = jfun(jp, *(jnp.asarray(it[a]) for a in argnames), *jextra)
        jout = jout if isinstance(jout, tuple) else (jout,)
        assert len(jout) == len(tout)
        for k, (t, j) in enumerate(zip(tout, jout)):
            t = t[i].numpy()
            if t.dtype == np.bool_ or np.issubdtype(t.dtype, np.integer):
                np.testing.assert_array_equal(t.reshape(np.shape(j)), np.asarray(j), err_msg=f"{name}[{k}]")
            else:
                _close(t, j, f"{name}[{k}] lane {i}")


MU = torch.tensor([[0.3], [0.02]], dtype=torch.float64)

CASES = [
    ("slacks", TK.slacks, JK.slacks, ("x",), ()),
    ("eval_obj", TK.eval_obj, JK.eval_obj, ("x",), ()),
    ("eval_cons_residual", TK.eval_cons_residual, JK.eval_cons_residual, ("x",), ()),
    ("dual_residual", TK.dual_residual, JK.dual_residual, ("x", "y", "zl", "zu"), ()),
    ("primal_infeasibility", TK.primal_infeasibility, JK.primal_infeasibility, ("x",), ()),
    ("dual_infeasibility", TK.dual_infeasibility, JK.dual_infeasibility, ("x", "y", "zl", "zu"), ()),
    ("complementarity_inf", TK.complementarity_inf, JK.complementarity_inf, ("x", "zl", "zu"), (MU,)),
    ("complementarity_measure", TK.complementarity_measure, JK.complementarity_measure,
     ("x", "zl", "zu"), ()),
    ("affine_complementarity_measure", TK.affine_complementarity_measure,
     JK.affine_complementarity_measure, ("x", "zl", "zu", "dx", "dzl", "dzu"), (MU, MU * 2)),
    ("dual_objective", TK.dual_objective, JK.dual_objective, ("y", "zl", "zu"), ()),
    ("predictor_rhs", TK.predictor_rhs, JK.predictor_rhs, ("x", "y", "zl", "zu"), ()),
    ("corrector_rhs", TK.corrector_rhs, JK.corrector_rhs,
     ("x", "y", "zl", "zu", "mu", "dzl", "dzu"), ()),
    ("mehrotra_correction", TK.mehrotra_correction, JK.mehrotra_correction, ("dx", "dzl", "dzu"), ()),
    ("alpha_max", TK.alpha_max, JK.alpha_max, ("x", "zl", "zu", "dx", "dzl", "dzu"), (0.99,)),
    ("fraction_to_boundary", TK.fraction_to_boundary, JK.fraction_to_boundary,
     ("x", "zl", "zu", "dx", "dzl", "dzu"), (MU,)),
    ("mehrotra_adaptive_step", TK.mehrotra_adaptive_step, JK.mehrotra_adaptive_step,
     ("x", "zl", "zu", "dx", "dzl", "dzu"), (0.99,)),
    ("mehrotra_barrier", TK.mehrotra_barrier, JK.mehrotra_barrier, ("x", "zl", "zu"),
     (MU * 0.1, 1e-12, 3.0, 1e-6, 10.0)),
    ("adjust_boundary", TK.adjust_boundary, JK.adjust_boundary, ("x",), (MU,)),
    ("ls_infeasibility_certificate", TK.ls_infeasibility_certificate,
     JK.ls_infeasibility_certificate, ("x",), (None, 0.0)),
]


@pytest.mark.parametrize("name, tfun, jfun, args, extra", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_jax(lanes, name, tfun, jfun, args, extra):
    _compare(lanes, name, tfun, jfun, args, extra)


def test_recover_bound_duals_matches_jax(lanes):
    jps, its, tp, tit = lanes
    rhs = TK.corrector_rhs(tp, tit["x"], tit["y"], tit["zl"], tit["zu"], MU, tit["dzl"], tit["dzu"])
    dzl, dzu = TK.recover_bound_duals(tp, tit["x"], tit["zl"], tit["zu"], rhs, tit["dx"])
    for i, (jp, it) in enumerate(zip(jps, its)):
        a = {k: jnp.asarray(v) for k, v in it.items()}
        jr = JK.corrector_rhs(jp, a["x"], a["y"], a["zl"], a["zu"], float(MU[i, 0]), a["dzl"], a["dzu"])
        jl, ju = JK.recover_bound_duals(jp, a["x"], a["zl"], a["zu"], jr, a["dx"])
        _close(dzl[i].numpy(), jl, "dzl")
        _close(dzu[i].numpy(), ju, "dzu")


def test_masked_argmin_first_minimum_wins():
    vals = torch.tensor([[3.0, 1.0, 1.0, 2.0], [5.0, 5.0, 5.0, 5.0], [0.5, 0.2, 0.2, 0.1]],
                        dtype=torch.float64)
    mask = torch.tensor([[True, True, True, True], [False] * 4, [True, True, True, False]])
    a, i = TK._masked_argmin_ratio(vals, mask)
    for k in range(3):
        ja, ji = JK._masked_argmin_ratio(jnp.asarray(vals[k].numpy()), jnp.asarray(mask[k].numpy()))
        assert int(i[k, 0]) == int(ji) and float(a[k, 0]) == float(ja)
    assert i[:, 0].tolist() == [1, 0, 1]


def test_state_init_and_round_trip():
    js = jstate.init_state(8, 4)
    ts = tstate.init_state(1, 8, 4)
    tn = ts.to_numpy()
    for k, v in js._asdict().items():
        np.testing.assert_array_equal(tn[k][0], np.asarray(v), err_msg=k)
    back = tstate.IPMState.from_numpy({k: np.asarray(v) for k, v in js._asdict().items()})
    for k, v in back.to_numpy().items():
        np.testing.assert_array_equal(v, tn[k], err_msg=k)
    assert back.k.dtype == torch.int32 and back.ls_cert.dtype == torch.bool
    two = tstate.IPMState.from_numpy({k: np.concatenate([v, v]) for k, v in tn.items()})
    assert two.x.shape == (2, 8) and two.mu.shape == (2, 1)
    mask = torch.tensor([[True], [False]])
    mixed = two.replace(x=two.x + 1.0).where(mask, two)
    assert mixed.x[0].eq(1.0).all() and mixed.x[1].eq(0.0).all()
