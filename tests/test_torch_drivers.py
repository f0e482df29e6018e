"""The logged, timed and chunked drivers and ``trace_dir`` of
madipm_tpu_torch against madipm_tpu on the CPU.

- Logged (the default at print_level INFO): ``madipm`` of both packages on
  one LP (NORMAL) and one QP (AUGMENTED), each run through more than ten
  iterations; the tables have the same rows, headers at the same rows, the
  ``iter`` column equal and the objective column within 1e-6 relative;
  status and iterations equal, objective within 1e-8 relative.  An
  ``output_file`` with a quiet console still gets the table.
- Timed: ``solve(timed=True)`` of both packages on the LP (same status,
  iterations, objective within 1e-8); its iterates are the logged
  driver's, and 0 < linear_solver_time <= solver_time.
- Chunked: ``max_wall_time=0.0`` with ``chunk=1`` (tests/test_solver.py)
  ends MAXIMUM_WALLTIME_EXCEEDED at k = 0 in both, with the same state;
  ``max_wall_time=300`` solves as the JAX package's chunked driver does.
- ``trace_dir`` writes a Chrome trace file.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from conftest import random_lp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models.generators import known_optimum_qp
from madipm_tpu.solver import driver as jdriver
from madipm_tpu_torch.solver import driver as tdriver

torch.set_num_threads(2)

ROW = re.compile(r"^\s*(\d+)\s+(\S+)\s")


def _instances():
    c, A, b, lvar, uvar = random_lp(np.random.default_rng(11), 60, 24, density=0.4, upper_frac=0.3)
    lp = dict(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar)
    qp, _ = known_optimum_qp(12, 30, seed=2, degenerate=True)
    qpd = dict(c=qp.c, A=qp.A.toarray(), lcon=qp.lcon, ucon=qp.ucon, lvar=qp.lvar, uvar=qp.uvar,
               Q=qp.Q.toarray())
    return {"lp": lp, "qp": qpd}


INSTANCES = _instances()
#: tol 1e-10 keeps both instances going past the second header (row 10)
OPTS = dict(tol=1e-10, max_iter=200)


def _table(text):
    """(header row indices, [(iter, objective)]) of a logged solve's output."""
    headers, rows = [], []
    for line in text.splitlines():
        if line.strip() == tdriver.LOG_HEADER:
            headers.append(len(rows))
        elif ROW.match(line):
            k, obj = ROW.match(line).groups()
            rows.append((int(k), float(obj)))
    return headers, rows


@pytest.mark.parametrize("inst", ["lp", "qp"])
def test_logged_table_matches_jax(inst, capsys):
    d = INSTANCES[inst]
    js = mt.madipm(mt.from_dense(**d), **OPTS)
    jout = capsys.readouterr().out
    ts = mtt.madipm(mtt.from_dense(**d), device="cpu", rethrow_error=True, **OPTS)
    tout = capsys.readouterr().out
    assert js.status == ts.status and ts.success
    assert ts.iter == js.iter > 10
    assert abs(ts.objective - js.objective) <= 1e-8 * max(1.0, abs(js.objective))
    jh, jrows = _table(jout)
    th, trows = _table(tout)
    assert th == jh and len(th) >= 2
    assert len(trows) == len(jrows) == ts.iter + 1
    assert [k for k, _ in trows] == [k for k, _ in jrows] == list(range(ts.iter + 1))
    for (_, a), (_, b) in zip(trows, jrows):
        assert abs(a - b) <= 1e-6 * max(1.0, abs(b))
    assert "EXIT" in tout


def test_output_file_gets_the_table(tmp_path, capsys):
    """A quiet console with a verbose file sink still runs the logged
    driver (the JAX package's rule)."""
    f = str(tmp_path / "solve.log")
    st = mtt.madipm(mtt.from_dense(**INSTANCES["lp"]), device="cpu", print_level=mtt.PrintLevel.ERROR,
                    file_print_level=mtt.PrintLevel.INFO, output_file=f, **OPTS)
    assert st.success
    assert "inf_pr" not in capsys.readouterr().out
    with open(f) as fh:
        headers, rows = _table(fh.read())
    assert len(rows) == st.iter + 1 and headers[:2] == [0, 10]


@pytest.fixture(scope="module")
def jax_timed():
    solver = mt.MPCSolver(mt.from_dense(**INSTANCES["lp"]), print_level=mt.PrintLevel.ERROR, **OPTS)
    return solver.solve(timed=True)


def test_timed_matches_jax(jax_timed):
    solver = mtt.MPCSolver(mtt.from_dense(**INSTANCES["lp"]), device="cpu",
                           print_level=mtt.PrintLevel.ERROR, rethrow_error=True, **OPTS)
    ts = solver.solve(timed=True)
    assert ts.status == jax_timed.status and ts.success
    assert ts.iter == jax_timed.iter
    assert abs(ts.objective - jax_timed.objective) <= 1e-8 * max(1.0, abs(jax_timed.objective))
    assert 0.0 < ts.linear_solver_time <= ts.solver_time
    assert set(solver.timers) == {"linear_solver_time", "eval_time", "step_time"}
    assert all(v > 0.0 for v in solver.timers.values())
    # the timed driver's iterates are the logged driver's, bit for bit
    logged = solver.solve(logged=True)
    assert logged.iter == ts.iter and logged.objective == ts.objective
    np.testing.assert_array_equal(logged.solution, ts.solution)


def _lp_model(pkg, seed):
    c, A, b, lvar, uvar = random_lp(None, 60, 20, seed=seed)
    return pkg.from_dense(c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar), (c, A, b, lvar, uvar)


def test_chunked_walltime_exceeded_matches_jax():
    """Zero budget, chunk=1 (tests/test_solver.py): the guard fires before
    the first chunk, after one last termination check."""
    jsol = mt.MPCSolver(_lp_model(mt, 3)[0], print_level=mt.PrintLevel.ERROR)
    _, _, jst = jdriver.solve_device_chunked(jsol.cfg, jsol.prob, max_wall_time=0.0, chunk=1)
    tsol = mtt.MPCSolver(_lp_model(mtt, 3)[0], device="cpu", print_level=mtt.PrintLevel.ERROR)
    _, _, tst = tdriver.solve_device_chunked(tsol.cfg, tsol.prob, max_wall_time=0.0, chunk=1)
    assert int(jst.status) == int(mt.Status.MAXIMUM_WALLTIME_EXCEEDED)
    s = tst.to_numpy()
    assert int(s["status"][0]) == int(jst.status) and int(s["k"][0]) == int(jst.k) == 0
    for f in ("x", "y", "zl", "zu", "obj_val", "inf_pr", "inf_du", "inf_compl"):
        np.testing.assert_allclose(s[f][0], np.asarray(getattr(jst, f)), rtol=1e-10, atol=1e-12)
    st = mtt.madipm(_lp_model(mtt, 3)[0], device="cpu", print_level=mtt.PrintLevel.ERROR,
                    max_wall_time=0.0)
    assert st.status == mtt.Status.MAXIMUM_WALLTIME_EXCEEDED and st.iter == 0


def test_chunked_completion_matches_jax():
    jm, (c, A, b, lvar, uvar) = _lp_model(mt, 4)
    js = mt.MPCSolver(jm, print_level=mt.PrintLevel.ERROR, max_wall_time=300.0).solve(logged=False)
    solver = mtt.MPCSolver(_lp_model(mtt, 4)[0], device="cpu", print_level=mtt.PrintLevel.ERROR,
                           max_wall_time=300.0, rethrow_error=True)
    ts = solver.solve(logged=False)  # routes through the chunked driver
    assert ts.status == js.status and ts.success
    assert ts.iter == js.iter
    assert abs(ts.objective - js.objective) <= 1e-8 * max(1.0, abs(js.objective))
    fused = mtt.madipm(_lp_model(mtt, 4)[0], device="cpu", print_level=mtt.PrintLevel.ERROR)
    assert fused.iter == ts.iter and abs(fused.objective - ts.objective) <= 1e-10 * abs(ts.objective)


def test_trace_dir_writes_a_trace(tmp_path):
    d = str(tmp_path / "trace")
    solver = mtt.MPCSolver(_lp_model(mtt, 5)[0], device="cpu", print_level=mtt.PrintLevel.ERROR)
    st = solver.solve(trace_dir=d)
    assert st.success
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(os.path.join(d, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("matmul" in str(e.get("name", "")) or "mm" in str(e.get("name", "")) for e in events)
    from madipm_tpu_torch.utils.logging import profile_trace

    with profile_trace(None):
        pass
    with profile_trace(""):
        pass
