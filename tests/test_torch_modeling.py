"""madipm_tpu_torch.Model and the structured generators against madipm_tpu.

- ``Model._build_qp()``: every case of tests/test_modeling.py is built in
  both packages from the same calls; the two QuadraticModels agree field
  by field, exactly (no solve).
- Solves: two cases (an LP with its dual, a QP) against the JAX package's
  solve (status, iterations, objective to 1e-8 relative, duals to 1e-8);
  the others against scipy's HiGHS or the closed-form optimum of
  tests/test_modeling.py.
- ``transportation_lp``, ``min_cost_flow_lp``, ``staircase_lp`` and
  ``structured_suite``: equal array for array.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.optimize import linprog

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu import modeling as jmod
from madipm_tpu.models import generators as jgen
from madipm_tpu_torch import modeling as tmod
from madipm_tpu_torch.models import generators as tgen

torch.set_num_threads(2)

MODS = {mt: jmod, mtt: tmod}


def _simple_lp(pkg):
    m = pkg.Model("simple")
    x = m.add_variables(2, lb=0.0, name="x")
    con = m.add_constraint(x[0] + x[1] == 1.0)
    m.minimize(x[0] + x[1])
    return m, dict(x=x, con=con, obj=1.0)


def _vectorized_lp(pkg):
    rng = np.random.default_rng(42)
    n, meq = 20, 6
    A = rng.standard_normal((meq, n))
    b = A @ (rng.random(n) + 0.5)
    c = rng.random(n) + 0.1
    m = pkg.Model()
    x = m.add_variables(n, lb=0.0)
    m.add_constraint(A @ x == b)
    m.minimize(c @ x)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=[(0, None)] * n, method="highs")
    return m, dict(x=x, obj=ref.fun)


def _maximize(pkg):
    m = pkg.Model()
    x = m.add_variables(2, lb=0.0, ub=2.0)
    m.add_constraint(x[0] + x[1] <= 3.0)
    m.maximize(x[0] + 2.0 * x[1])
    return m, dict(x=x, obj=5.0)


def _inequalities(pkg):
    m = pkg.Model()
    x = m.add_variables(2, lb=0.0)
    m.add_constraint(x[0] + x[1] >= 1.0)
    m.add_constraint(2.0 * x[0] + x[1] <= 4.0)
    m.minimize(x[0] + 3.0 * x[1])
    return m, dict(x=x, obj=1.0)


def _sparse_matrix(pkg):
    rng = np.random.default_rng(42)
    n = 30
    A = sp.random(8, n, density=0.3, random_state=7, format="csr")
    A = A + sp.csr_matrix((np.ones(8), (np.arange(8), np.arange(8))), shape=(8, n))
    b = A @ (rng.random(n) + 0.5)
    m = pkg.Model()
    x = m.add_variables(n, lb=0.0)
    m.add_constraint(MODS[pkg].matmul(A, x) == b)
    m.minimize(np.ones(n) @ x)
    ref = linprog(np.ones(n), A_eq=A.toarray(), b_eq=b, bounds=[(0, None)] * n, method="highs")
    return m, dict(x=x, obj=ref.fun)


def _block_ops(pkg):
    m = pkg.Model()
    x = m.add_variables(3, lb=0.0)
    m.add_constraint(x.sum() == 2.0)
    m.add_constraint(x >= 0.1)
    m.minimize(x[0] + 2.0 * x[1] + 3.0 * x[2])
    return m, dict(x=x, obj=2.3)


def _setters(pkg):
    m = pkg.Model()
    v = m.add_variable(lb=0.0, name="v")
    w = m.add_variable(name="w")
    m.set_lower_bound(w, 0.0)
    m.set_upper_bound(w, 1.0)
    m.set_start_value(v, 0.4)
    m.add_constraint(v + w == 1.0)
    m.minimize(v + 2.0 * w)
    return m, dict(x=v, obj=1.0)


def _quadratic(pkg):
    m = pkg.Model()
    x = m.add_variables(2, lb=-10.0, ub=10.0)
    m.add_constraint(x[0] + x[1] == 1.0)
    m.minimize(x[0] * x[0] + x[1] * x[1])
    return m, dict(x=x, obj=0.5)


def _cross_terms(pkg):
    P = np.array([[2.0, 0.5], [0.5, 1.0]])
    q = np.array([-1.0, -2.0])
    m = pkg.Model()
    x = m.add_variables(2, lb=0.0, ub=10.0)
    m.minimize(0.5 * (P[0, 0] * x[0] * x[0] + P[1, 1] * x[1] * x[1]) + P[0, 1] * x[0] * x[1] + q @ x)
    xref = np.linalg.solve(P, -q)
    return m, dict(x=x, obj=0.5 * xref @ P @ xref + q @ xref)


def _expressions(pkg):
    m = pkg.Model()
    x = m.add_variables(2, lb=0.0)
    m.add_constraint(x[0] + x[1] == 1.0)
    m.minimize(x[0] + 2.0 * x[1])
    return m, dict(x=x, obj=1.0)


def _infeasible(pkg):
    m = pkg.Model()
    x = m.add_variables(2, lb=0.0)
    m.add_constraint(x[0] + x[1] == -1.0)
    m.minimize(x.sum())
    return m, dict(x=x, obj=None)


CASES = {
    "simple_lp": _simple_lp, "vectorized_lp": _vectorized_lp, "maximize": _maximize,
    "inequalities": _inequalities, "sparse_matrix": _sparse_matrix, "block_ops": _block_ops,
    "setters": _setters, "quadratic": _quadratic, "cross_terms": _cross_terms,
    "expressions": _expressions, "infeasible": _infeasible,
}


def _same(a, b):
    if sp.issparse(a) or sp.issparse(b):
        assert sp.issparse(a) and sp.issparse(b) and a.shape == b.shape
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
def test_build_qp_matches_jax(case):
    jq = CASES[case](mt)[0]._build_qp()
    tq = CASES[case](mtt)[0]._build_qp()
    for f in ("c", "A", "lcon", "ucon", "lvar", "uvar", "Q", "c0", "x0", "y0", "name", "minimize"):
        _same(getattr(jq, f), getattr(tq, f))


@pytest.mark.parametrize("case", ["simple_lp", "quadratic"])
def test_solve_matches_jax(case):
    jm, jinfo = CASES[case](mt)
    tm, tinfo = CASES[case](mtt)
    js = jm.optimize(print_level=mt.PrintLevel.ERROR)
    ts = tm.optimize(device="cpu", print_level=mtt.PrintLevel.ERROR)
    assert js.status == ts.status and ts.success
    assert ts.iter == js.iter
    assert abs(ts.objective - js.objective) <= 1e-8 * max(1.0, abs(js.objective))
    np.testing.assert_allclose(tm.value(tinfo["x"]), jm.value(jinfo["x"]), atol=1e-8)
    np.testing.assert_allclose(tm.reduced_costs(), jm.reduced_costs(), atol=1e-8)
    if "con" in tinfo:
        assert abs(tm.dual(tinfo["con"]) - jm.dual(jinfo["con"])) <= 1e-8


@pytest.mark.parametrize("case", [c for c in CASES if c not in ("simple_lp", "quadratic")])
def test_solve_matches_reference_optimum(case):
    """The port's solve (device given to the Model) at the optimum HiGHS or
    tests/test_modeling.py gives; the infeasible case ends unsolved."""
    m, info = CASES[case](mtt)
    m.options["device"] = "cpu"
    st = m.optimize(print_level=mtt.PrintLevel.ERROR)
    if info["obj"] is None:
        assert not st.success
        return
    assert st.success and m.is_solved
    assert m.objective_value() == pytest.approx(info["obj"], rel=1e-6, abs=1e-6)
    assert np.all(np.isfinite(m.value(info["x"])))


def test_model_api_mirrors_jax():
    """Expressions, errors and getters of tests/test_modeling.py."""
    m = mtt.Model("m", device="cpu")
    x = m.add_variables(3)
    e = 2.0 * x[0] + x[1] - 0.5 * x[2] + 4.0
    assert isinstance(e, tmod.AffExpr) and e.coefs == {0: 2.0, 1: 1.0, 2: -0.5} and e.const == 4.0
    q = (x[0] + x[1]) * (x[0] - x[1]) + 3.0 * x[0]
    assert isinstance(q, tmod.QuadExpr) and q.quad[(0, 0)] == 1.0 and q.quad[(1, 1)] == -1.0
    me = np.arange(6, dtype=float).reshape(2, 3) @ x
    assert isinstance(me, tmod.MatExpr) and me.M.shape == (2, 3)
    with pytest.raises(RuntimeError):
        m.objective_value()
    with pytest.raises(TypeError):
        m.add_constraint("x <= 1")
    m.add_constraint(x.sum() == 1.0)
    m.add_constraint(x >= 0.0)
    m.minimize(x[0] + x[1] + x[2] * x[2])
    st = m.optimize(print_level=mtt.PrintLevel.ERROR)
    assert st.success and m.termination_status() == mtt.Status.SOLVE_SUCCEEDED
    assert m.value(x[0] * x[0]) == pytest.approx(m.value(x[0]) ** 2, abs=1e-12)
    assert m.solve_time() >= 0.0


GENERATORS = [
    ("transportation_lp", (6, 9), dict(seed=3)),
    ("transportation_lp", (24, 36), dict(seed=7)),
    ("min_cost_flow_lp", (20,), dict(arcs_per_node=3, seed=5)),
    ("min_cost_flow_lp", (96, 4), dict(seed=9)),
    ("staircase_lp", (5, 4, 2), dict(seed=1)),
    ("staircase_lp", (12, 8, 4), dict(seed=11)),
]


def _same_model(a, b):
    for f in ("c", "A", "lcon", "ucon", "lvar", "uvar", "Q", "c0", "name", "minimize"):
        _same(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("name, args, kw", GENERATORS, ids=[f"{g[0]}-{g[1]}" for g in GENERATORS])
def test_generator_matches_jax(name, args, kw):
    _same_model(getattr(jgen, name)(*args, **kw), getattr(tgen, name)(*args, **kw))


def test_structured_suite_matches_jax():
    """The suite at scale 1 and 2, instance for instance; the balanced
    transports keep JAX's dropped last demand row."""
    for scale in (1, 2):
        js, ts = jgen.structured_suite(scale=scale), tgen.structured_suite(scale=scale)
        assert len(js) == len(ts) == 8
        for a, b in zip(js, ts):
            _same_model(a, b)
    t = tgen.transportation_lp(4, 5)
    assert t.A.shape == (4 + 5 - 1, 20)
