"""The benchmark's copies of the generators build the same instances as
``madipm_tpu_torch.models.generators``."""

import numpy as np
import pytest

from madipm_tpu_torch.models import generators as program
from perfbench import spec

CASES = [
    ("make_suite", dict(m=24, n=48, density=0.15)),
    ("make_qp_suite", dict(m=16, n=40, density=0.15)),
]


@pytest.mark.parametrize("seed0", [7, 2**31 + 1234])
@pytest.mark.parametrize("name, sizes", CASES, ids=[c[0] for c in CASES])
def test_same_instances(name, sizes, seed0):
    raw = spec.generator(name).generate(k=3, seed0=seed0, **sizes)
    models = getattr(program, name)(k=3, seed0=seed0, **sizes)
    for r, q in zip(raw, models):
        np.testing.assert_array_equal(r["A"], q.A.toarray())
        for key in ("c", "lcon", "ucon", "lvar", "uvar"):
            np.testing.assert_array_equal(r[key], getattr(q, key))
        if r["Q"] is None:
            assert q.Q is None
        else:
            np.testing.assert_array_equal(r["Q"], q.Q.toarray())


def test_generate_by_name():
    raw = spec.generator("make_suite").generate(k=2, seed0=5, m=8, n=16, density=0.3)
    assert len(raw) == 2 and raw[0]["A"].shape == (8, 16)
    with pytest.raises(FileNotFoundError):
        spec.generator("nope")


def _lp_optimum(q):
    from scipy.optimize import linprog

    bounds = [(lo, None if not np.isfinite(hi) else hi) for lo, hi in zip(q["lvar"], q["uvar"])]
    r = linprog(q["c"], A_eq=q["A"], b_eq=q["lcon"], bounds=bounds, method="highs")
    assert r.status == 0
    return r.fun


def test_layout_keeps_the_problem():
    from perfbench import harness

    inst = spec.generator("make_suite").generate(k=1, seed0=3, m=16, n=32, density=0.3)[0]
    a, b = (harness.laid_out(inst, np.random.default_rng([2**31 + 5, 0])) for _ in range(2))
    np.testing.assert_array_equal(a["A"], b["A"])
    assert not np.array_equal(a["A"], inst["A"])
    assert abs(_lp_optimum(a) - _lp_optimum(inst)) <= 1e-9 * (1 + abs(_lp_optimum(inst)))
    qp = spec.generator("make_qp_suite").generate(k=1, seed0=4, m=8, n=16, density=0.3)[0]
    q = harness.laid_out(qp, np.random.default_rng(1))
    np.testing.assert_array_equal(q["Q"], q["Q"].T)
    np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(q["Q"])), np.sort(np.linalg.eigvalsh(qp["Q"])))
