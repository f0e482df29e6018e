"""madipm_tpu_torch.solver.driver against madipm_tpu.solver.driver, one
phase at a time: initialize, update_termination and one iteration, each
fed the same state (a JAX IPMState carried over with IPMState.from_numpy).

Tolerances relative to the largest entry: 1e-10 in the fp64 CHOLESKY
configuration, 1e-8 in the fp32-factor CHOLESKY_INV + fp64 PCG one;
statuses and counters exactly.  A loop trip of the latter runs its
predictor with predictor_pcg_budget=0, the fp32 factor alone: the two
packages' fp32 factors differ by ~1e-7, the affine direction by ~1e-4,
and through mu_aff and sigma the step by ~1e-7, so the trip is held to
1e-5 there.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from madipm_tpu.models import qp as jqp
from madipm_tpu.solver import driver as jdrv
from madipm_tpu.utils import options as jopt
from madipm_tpu_torch.models.qp import TorchQP
from madipm_tpu_torch.solver import driver as tdrv
from madipm_tpu_torch.solver.state import IPMState
from madipm_tpu_torch.utils import options as topt
from madipm_tpu_torch.utils.status import Status

torch.set_num_threads(2)

FIELDS = ("c", "A", "b", "lb", "ub", "c0", "row_mask", "col_mask", "x0", "y0")
TOL = {"fp64": 1e-10, "acc": 1e-8}
STEP_TOL = {"fp64": 1e-10, "acc": 1e-5}
ACC = dict(factor_dtype="float32", refinement_steps=12, pcg_adaptive_tol=True,
           predictor_pcg_budget=0, pcg_tol_floor=1e-8, fp64_matvec="emulated")


def _cfgs(name):
    extra = {} if name == "fp64" else ACC
    reg = dict(regularization=jopt.FixedRegularization(1e-8, -1e-8))
    jo = jopt.IPMOptions(tol=1e-8, **reg, **extra,
                         linear_solver=None if name == "fp64" else jopt.LinearSolver.CHOLESKY_INV)
    to = topt.IPMOptions(tol=1e-8, regularization=topt.FixedRegularization(1e-8, -1e-8), **extra,
                         linear_solver=None if name == "fp64" else topt.LinearSolver.CHOLESKY_INV)
    return jdrv.make_config(jo, is_qp=False), tdrv.make_config(to, is_qp=False)


@functools.lru_cache(maxsize=None)
def _jfns(name):
    jc, _ = _cfgs(name)
    return (jax.jit(functools.partial(jdrv.initialize, jc)),
            jax.jit(functools.partial(jdrv.update_termination, jc)),
            jax.jit(functools.partial(jdrv._loop_body, jc)))


def _lp(seed, n=80, m=40):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
    xs = rng.random(n) + 0.5
    uvar = np.where(rng.random(n) < 0.3, xs + 3.0 * rng.random(n), np.inf)
    return jqp.QuadraticModel(c=rng.random(n) + 0.1, A=A, lcon=A @ xs, ucon=A @ xs,
                              lvar=np.zeros(n), uvar=uvar)


@pytest.fixture(scope="module")
def probs():
    jp = jqp.pad_to_device(jqp.slack_form(_lp(3)), pad_multiple=32)
    return jp, TorchQP.from_numpy({k: np.asarray(getattr(jp, k)) for k in FIELDS})


def _jstate_np(js):
    return {k: np.asarray(v) for k, v in js._asdict().items()}


def _check_state(ts: IPMState, js, tol, what):
    tn, jn = ts.to_numpy(), _jstate_np(js)
    for k, j in jn.items():
        t = tn[k][0]
        if j.dtype == np.bool_ or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=f"{what}.{k}")
            continue
        fin = np.isfinite(j)
        np.testing.assert_array_equal(np.isfinite(t), fin, err_msg=f"{what}.{k}")
        np.testing.assert_array_equal(t[~fin], j[~fin], err_msg=f"{what}.{k}")
        if fin.any():
            err = np.max(np.abs(t[fin] - j[fin]))
            assert err <= tol * max(1e-300, np.max(np.abs(j[fin]))), (what, k, err)


@pytest.mark.parametrize("name", ["fp64", "acc"])
def test_initialize_termination_and_iteration_match(probs, name):
    jp, tp = probs
    _, tc = _cfgs(name)
    jinit, jterm, jbody = _jfns(name)
    tol = TOL[name]

    jps, jscale, js = jinit(jp)
    tps, tscale, ts = tdrv.initialize(tc, tp)
    _check_state(ts, js, tol, "initialize")
    for f in ("A", "b", "c", "lb", "ub"):
        np.testing.assert_allclose(getattr(tps, f).numpy()[0], np.asarray(getattr(jps, f)), rtol=1e-14)
    np.testing.assert_allclose(tscale.con_scale.numpy()[0], np.asarray(jscale.con_scale), rtol=1e-14)

    # Carry the JAX state over, then one termination check and one loop trip.
    carried = IPMState.from_numpy(_jstate_np(js))
    _check_state(tdrv.update_termination(tc, tps, carried), jterm(jps, js), tol, "termination")
    js1 = jbody(jps, js)
    ts1 = tdrv._loop_body(tc, tps, carried)
    tol = STEP_TOL[name]
    _check_state(ts1, js1, tol, "loop body")
    # with the carried A x / A' y pair (the product recurrence)
    ax, aty = jps.matvec(js1.x), jps.rmatvec(js1.y)
    js2, jax2, jaty2 = jbody(jps, js1, ax, aty)
    c1 = IPMState.from_numpy(_jstate_np(js1))
    ts2, tax2, taty2 = tdrv._loop_body(tc, tps, c1, torch.tensor(np.asarray(ax))[None],
                                       torch.tensor(np.asarray(aty))[None])
    _check_state(ts2, js2, tol, "loop body (recurrence)")
    for t, j in ((tax2, jax2), (taty2, jaty2)):
        assert np.max(np.abs(t.numpy()[0] - np.asarray(j))) <= tol * np.max(np.abs(np.asarray(j)))


def test_finished_lane_keeps_its_state(probs):
    """A lane that is no longer REGULAR only gets its termination fields
    refreshed by a loop trip; a running lane beside it iterates."""
    _, tp = probs
    _, tc = _cfgs("fp64")
    two = TorchQP(**{f.name: (None if getattr(tp, f.name) is None else
                              torch.cat([getattr(tp, f.name)] * 2))
                     for f in dataclasses.fields(TorchQP)})
    tps, _, ts = tdrv.initialize(tc, two)
    ts = ts.replace(status=torch.tensor([[int(Status.MAXIMUM_ITERATIONS_EXCEEDED)], [int(Status.REGULAR)]],
                                        dtype=torch.int32))
    out = tdrv._loop_body(tc, tps, ts)
    for f in ("x", "y", "zl", "zu", "k", "mu", "lb", "ub"):
        assert torch.equal(getattr(out, f)[0], getattr(ts, f)[0]), f
    assert int(out.k[1, 0]) == 1 and not torch.equal(out.x[1], ts.x[1])
