"""The controls, one precision below the float64 answers the
configurations state, come out not correct: the program's own path in
float32, and, for the QP cells, where that path gives no number, the
plain reference in float32 put in the program's place; at a size a test
holds, on the CPU.  On the card they are read at the
cells' own sizes by ``python3 -m perfbench.calibrate --control ...``."""

import time

import pytest

from perfbench import calibrate, harness


@pytest.mark.parametrize("name", ["lp_normal.sweep8", "qp_k1.sweep8"])
def test_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name, k=2, m=16, n=32)
    run = harness.run(cell, seed=2**31 + 5, seconds=0.1, traced=False, device="cpu",
                      t_start=time.perf_counter(), control=True, log=lambda m: None)
    assert not run.correct, run.checks
    assert run.checks["kkt_res"][0] > run.checks["kkt_res"][1]


def test_reference_control_is_not_correct(tiny_cell):
    # the QP cells' control: their program path in float32 gives NaN, no number
    cell = tiny_cell("qp_k1.sweep8", k=2, m=16, n=32)
    run = harness.run(cell, seed=2**31 + 6, seconds=0.1, traced=False, device="cpu",
                      t_start=time.perf_counter(), solve=calibrate.reference_control("cpu"),
                      log=lambda m: None)
    assert not run.correct, run.checks
