"""utils/checkpoint.py of madipm_tpu_torch against madipm_tpu.

A checkpoint is the JAX package's ``.npz`` in both packages, so each
resumes the other's (the cases of tests/test_frontends.py):

- the files carry the same names, shapes and dtypes, and a state read
  back equals the one written (initialized states to 1e-12);
- three iterations run by JAX, saved, resumed by the port; three run by
  the port, saved, resumed by JAX: both succeed at the uninterrupted
  objective within 1e-7 with the iteration counter carried through;
- an infeasible LP checkpointed mid-grind resumes to
  INFEASIBLE_PROBLEM_DETECTED (the certificate is refreshed on resume);
- ``warm_start_state`` builds the JAX package's state to 1e-12, and a
  resume from it ends as the JAX package's (status, iterations, objective
  to 1e-8 relative);
- missing fields take the JAX package's fill-ins.
"""

import numpy as np
import pytest
import torch

from conftest import random_lp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.utils import checkpoint as jck
from madipm_tpu_torch.solver import driver as tdriver
from madipm_tpu_torch.utils import checkpoint as tck

torch.set_num_threads(2)

OPTS = dict(print_level=mt.PrintLevel.ERROR)
TOPTS = dict(print_level=mtt.PrintLevel.ERROR, device="cpu")


def _lp(pkg, seed=78):
    c, A, b, lvar, uvar = random_lp(np.random.default_rng(42), 30, 10, seed=seed)
    return pkg.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's uninterrupted solve, its initialized state and its
    checkpoint after three iterations."""
    import jax
    from functools import partial

    from madipm_tpu.solver import driver as jdriver

    solver = mt.MPCSolver(_lp(mt), **OPTS)
    ref = solver.solve()
    _, _, st0 = jax.jit(partial(jdriver.initialize, solver.cfg))(solver.prob)
    prob_s, _, st = jax.jit(partial(jdriver.initialize, solver.cfg))(solver.prob)
    step = jax.jit(partial(jdriver.iteration, solver.cfg))
    for _ in range(3):
        st = step(prob_s, st)
    d = tmp_path_factory.mktemp("jax_ckpt")
    jck.save_state(str(d / "init.npz"), st0)
    jck.save_state(str(d / "mid.npz"), st)
    return dict(solver=solver, ref=ref, init=str(d / "init.npz"), mid=str(d / "mid.npz"), st0=st0)


def _port_init(solver):
    return tdriver.initialize(solver.cfg, solver.prob)


def test_checkpoint_format_matches_jax(jax_run, tmp_path):
    solver = mtt.MPCSolver(_lp(mtt), **TOPTS)
    _, _, st = _port_init(solver)
    path = str(tmp_path / "port_init.npz")
    tck.save_state(path, st)
    with np.load(path) as mine, np.load(jax_run["init"]) as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        for f in theirs.files:
            assert mine[f].shape == theirs[f].shape and mine[f].dtype == theirs[f].dtype, f
            np.testing.assert_allclose(mine[f], theirs[f], rtol=1e-12, atol=1e-12, err_msg=f)
    back = tck.load_state(path, device="cpu").to_numpy()
    for f, v in st.to_numpy().items():
        np.testing.assert_array_equal(back[f], v, err_msg=f)
    jst = jck.load_state(path)
    for f in jst._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)), back[f][0], err_msg=f)


def test_jax_checkpoint_resumes_in_port(jax_run):
    solver = mtt.MPCSolver(_lp(mtt), **TOPTS)
    st = tck.load_state(jax_run["mid"], device="cpu")
    assert int(st.k[0, 0]) == 3
    stats = tck.resume(solver, st)
    ref = jax_run["ref"]
    assert stats.success and stats.iter >= 3
    assert stats.objective == pytest.approx(ref.objective, abs=1e-7)
    fused = solver.solve()
    assert stats.objective == pytest.approx(fused.objective, abs=1e-7)


def test_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    solver = mtt.MPCSolver(_lp(mtt), **TOPTS)
    prob_s, _, st = _port_init(solver)
    for _ in range(3):
        st = tdriver.iteration(solver.cfg, prob_s, st)
    path = str(tmp_path / "port_mid.npz")
    tck.save_state(path, st)
    stats = jck.resume(jax_run["solver"], jck.load_state(path))
    assert stats.success and stats.iter >= 3
    assert stats.objective == pytest.approx(jax_run["ref"].objective, abs=1e-7)
    mine = tck.resume(solver, tck.load_state(path, device="cpu"))
    assert mine.status == stats.status and abs(mine.iter - stats.iter) <= 1
    assert mine.objective == pytest.approx(stats.objective, abs=1e-7)


def test_resume_detects_infeasibility(tmp_path):
    """x0 = 1 and x0 = 3 (tests/test_frontends.py): checkpointed after five
    iterations, the resumed solve must still classify the LP infeasible."""
    qp = mtt.from_dense(c=[1.0, 1.0], A=[[1.0, 0.0], [1.0, 0.0]], lcon=[1.0, 3.0],
                        ucon=[1.0, 3.0], lvar=[0.0, 0.0], uvar=[np.inf, np.inf])
    solver = mtt.MPCSolver(qp, max_iter=500, **TOPTS)
    prob_s, _, st = _port_init(solver)
    for _ in range(5):
        st = tdriver.iteration(solver.cfg, prob_s, st)
    path = str(tmp_path / "infeas.npz")
    tck.save_state(path, st)
    stats = tck.resume(solver, tck.load_state(path, device="cpu"))
    assert stats.status == mtt.Status.INFEASIBLE_PROBLEM_DETECTED
    assert stats.iter < 400


def test_warm_start_state_matches_jax(jax_run):
    ref = jax_run["ref"]
    x0, y0 = ref.solution * 1.01, ref.multipliers
    jst = jck.warm_start_state(jax_run["solver"], x0=x0, y0=y0)
    solver = mtt.MPCSolver(_lp(mtt), **TOPTS)
    tst = tck.warm_start_state(solver, x0=x0, y0=y0).to_numpy()
    for f in jst._fields:
        np.testing.assert_allclose(tst[f][0], np.asarray(getattr(jst, f)), rtol=1e-12, atol=1e-12,
                                   err_msg=f)
    warm = tck.resume(solver, tck.warm_start_state(solver, x0=x0, y0=y0))
    jwarm = jck.resume(jax_run["solver"], jst)
    assert warm.status == jwarm.status and warm.success and warm.iter == jwarm.iter
    assert warm.objective == pytest.approx(jwarm.objective, rel=1e-8)


def test_load_state_fills_missing_fields(jax_run, tmp_path):
    with np.load(jax_run["init"]) as data:
        kept = {f: data[f] for f in data.files if f not in ("best_pr", "ls_cert", "n_stall", "mu")}
    path = str(tmp_path / "old.npz")
    np.savez(path, **kept)
    st = tck.load_state(path, device="cpu").to_numpy()
    assert st["best_pr"][0] == np.finfo(np.float64).max and not st["ls_cert"][0]
    assert st["n_stall"][0] == 0 and st["n_stall"].dtype == np.int32 and st["mu"][0] == 0.0
    np.testing.assert_array_equal(st["x"][0], np.asarray(jax_run["st0"].x))


def test_save_state_writes_one_instance(tmp_path):
    from madipm_tpu_torch.solver.state import init_state

    with pytest.raises(ValueError, match="one instance"):
        tck.save_state(str(tmp_path / "two.npz"), init_state(2, 4, 3))
