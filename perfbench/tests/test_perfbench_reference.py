"""The plain reference solves what the generators make: LPs against
scipy's HiGHS, QPs to their KKT conditions, and the comparison's numbers
read zero on the reference's own answers."""

import numpy as np
import pytest
from scipy.optimize import linprog

from perfbench import spec
from perfbench.reference import ipm, judge


def _highs(q):
    bounds = [(lo, None if not np.isfinite(hi) else hi) for lo, hi in zip(q["lvar"], q["uvar"])]
    r = linprog(q["c"], A_eq=q["A"], b_eq=q["lcon"], bounds=bounds, method="highs")
    assert r.status == 0
    return r.fun


@pytest.mark.parametrize("seed0", [3, 2**31 + 99])
def test_lp_against_highs(seed0):
    inst = spec.generator("make_suite").generate(k=3, m=64, n=128, density=0.15, seed0=seed0)
    sol = ipm.solve(ipm.Batch.from_instances(inst, [1.0, 1.0001, 0.99995], "cpu"))
    assert bool(sol.solved.all())
    for i, q in enumerate(inst):
        q = dict(q, lcon=q["lcon"] * [1.0, 1.0001, 0.99995][i])
        ref = _highs(q)
        assert abs(float(sol.objective[i]) - ref) <= 1e-9 * (1 + abs(ref))


def test_qp_kkt():
    inst = spec.generator("make_qp_suite").generate(k=2, m=32, n=64, density=0.15, seed0=11)
    p = ipm.Batch.from_instances(inst, [1.0, 1.0], "cpu")
    sol = ipm.solve(p)
    assert bool(sol.solved.all())
    for r in ipm.residuals(p, sol.x, sol.y, sol.zl, sol.zu):
        assert float(r.max()) <= 1e-9


def test_readings_of_the_reference_itself():
    inst = spec.generator("make_suite").generate(k=2, m=32, n=64, density=0.2, seed0=5)
    sol = ipm.solve(ipm.Batch.from_instances(inst, [1.0, 1.0], "cpu"))
    answers = [dict(status=judge.SOLVE_SUCCEEDED, objective=float(sol.objective[i]),
                    x=sol.x[i].numpy(), y=sol.y[i].numpy(), zl=sol.zl[i].numpy(), zu=sol.zu[i].numpy())
               for i in range(2)]
    v = judge.readings(inst, [1.0, 1.0], answers, "cpu")
    assert v["unsolved"] == 0 and v["ref_unsolved"] == 0
    assert v["kkt_res"] <= 1e-9 and v["obj_gap"] == 0 and v["x_gap"] == 0
    answers[1]["status"] = 6
    assert judge.readings(inst, [1.0, 1.0], answers, "cpu")["unsolved"] == 1


def test_ranged_rows_refused():
    inst = spec.generator("make_suite").generate(k=1, m=8, n=16, density=0.3, seed0=1)
    inst[0]["ucon"] = inst[0]["ucon"] + 1
    with pytest.raises(ValueError):
        ipm.Batch.from_instances(inst, [1.0], "cpu")
