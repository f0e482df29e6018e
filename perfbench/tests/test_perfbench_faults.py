"""A run with the program broken underneath comes out not correct, once
for each fault that a cell of this benchmark can have; the same run with
the program as it is comes out correct.  The runs skip the harness's
look for a card and go through the rest of a run on the CPU, at a size a
test holds.  (One chip: no exchange between chips to leave out.)"""

import time

import pytest

from perfbench import harness


def _program(cell, device="cpu", **override):
    import madipm_tpu_torch as mtt

    args = harness.call_arguments(cell.config, mtt)
    args.update(override)
    return lambda ms: mtt.madipm_batch(ms, device=device, **args)


def state_unchanged(cell):
    """Every step returns the state it was given: the answer is the
    starting point."""
    return _program(cell, max_iter=0)


def half_the_batch(cell):
    """Half the batch solved, the other half handed the first half's answers."""
    solve = _program(cell)

    def run(ms):
        half = solve(ms[: len(ms) // 2])
        return (half * len(ms))[: len(ms)]
    return run


def answer_altered(cell):
    """One instance's solution altered where it is produced."""
    solve = _program(cell)

    def run(ms):
        stats = solve(ms)
        x = stats[-1].solution.copy()
        x[0] += 1e-4 * (1 + abs(x[0]))
        stats[-1].solution = x
        return stats
    return run


def _run(cell, solve):
    return harness.run(cell, seed=2**31 + 17, seconds=0.3, traced=False, device="cpu",
                       t_start=time.perf_counter(), solve=solve, log=lambda m: None)


@pytest.mark.parametrize("name", ["lp_normal.sweep8", "qp_k1.sweep8"])
def test_sound_program_is_correct(tiny_cell, name):
    cell = tiny_cell(name)
    run = _run(cell, None)
    assert run.correct, run.checks


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", ["lp_normal.sweep8", "qp_k1.sweep8"])
def test_fault_is_not_correct(tiny_cell, name, fault):
    cell = tiny_cell(name, k=3)
    run = _run(cell, fault(cell))
    assert not run.correct, run.checks
