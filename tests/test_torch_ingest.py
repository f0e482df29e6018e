"""The file front end of madipm_tpu_torch against madipm_tpu: the MPS/QPS
reader and writer (Python and native parsers), Ruiz scaling, presolve with
its postsolve, and the front ends ``from_mps``, ``solve_linprog`` and
``solve_qp``.

Host code is held to exact equality (models, reductions) or 1e-12 (maps
of floating data); solves to the same status, objective to 1e-8, solution
and multipliers to 1e-6.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu import frontends as jfront
from madipm_tpu.models import mps as jmps, native as jnative, presolve as jpre, scale as jscale
from madipm_tpu_torch.models import mps as tmps, native as tnative, presolve as tpre, scale as tscale

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
FILES = sorted(
    [os.path.join("torture", f) for f in os.listdir(os.path.join(DATA, "torture"))]
    + ["simple.mps", "simple_qp.qps"]
)
MODEL_FIELDS = ("c", "lcon", "ucon", "lvar", "uvar", "c0", "minimize", "name", "x0", "y0")


def to_port(qp):
    """A madipm_tpu QuadraticModel as the port's, field for field (and
    the parser's notes on integer columns and unknown references)."""
    out = mtt.QuadraticModel(
        c=qp.c, A=qp.A.copy(), lcon=qp.lcon, ucon=qp.ucon, lvar=qp.lvar, uvar=qp.uvar,
        Q=None if qp.Q is None else qp.Q.copy(), c0=qp.c0, x0=qp.x0, y0=qp.y0,
        name=qp.name, minimize=qp.minimize,
    )
    for f in ("_integer_cols", "_n_unknown_refs"):
        if hasattr(qp, f):
            setattr(out, f, getattr(qp, f))
    return out


def assert_same_model(t, j):
    assert type(t) is mtt.QuadraticModel
    for f in MODEL_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    for f in ("A", "Q"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.shape == b.shape and abs(a - b).max() == 0.0, f
    for f in ("_integer_cols", "_n_unknown_refs"):
        assert getattr(t, f, None) == getattr(j, f, None), f


# ---------------------------------------------------------------------------
# MPS / QPS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parser", ["python", "native"])
@pytest.mark.parametrize("fn", FILES)
def test_read_mps_matches_jax(fn, parser):
    use_native = parser == "native"
    if use_native and not tnative.available():
        pytest.skip("native library unavailable")
    path = os.path.join(DATA, fn)
    assert_same_model(tmps.read_mps(path, use_native=use_native),
                      jmps.read_mps(path, use_native=use_native))


def test_write_mps_round_trips(tmp_path):
    """The port's writer, read back by both packages' readers: the
    corpus and the JAX package's writer fuzz models (LPs and QPs)."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from fuzz_mps_roundtrip import random_model

    rng = np.random.default_rng(42)
    models = [tmps.read_mps(os.path.join(DATA, fn)) for fn in FILES]
    models += [to_port(random_model(rng)[0]) for _ in range(12)]
    assert any(q.Q is not None for q in models) and any(not q.minimize for q in models)
    path = str(tmp_path / "m.mps")
    for i, qp in enumerate(models):
        tmps.write_mps(qp, path)
        jmps.write_mps(mt.QuadraticModel(**{f: getattr(qp, f) for f in (
            "c", "A", "lcon", "ucon", "lvar", "uvar", "Q", "c0", "name", "minimize")}),
            str(tmp_path / "j.mps"))
        assert open(path).read() == open(tmp_path / "j.mps").read(), i
        back = tmps.read_mps(path, use_native=False)
        assert_same_model(back, jmps.read_mps(path, use_native=False))
        for f in ("c", "lcon", "ucon", "lvar", "uvar"):
            np.testing.assert_allclose(getattr(back, f), getattr(qp, f), rtol=1e-15, err_msg=f)
        assert abs(back.A - qp.A).max() <= 1e-15 * max(1.0, abs(qp.A).max()) if qp.A.nnz else True


def test_gzip_and_bz2_read(tmp_path):
    import bz2
    import gzip

    text = open(os.path.join(DATA, "simple.mps"), "rb").read()
    for ext, opener in ((".gz", gzip.open), (".bz2", bz2.open)):
        path = str(tmp_path / f"simple.mps{ext}")
        with opener(path, "wb") as fh:
            fh.write(text)
        assert_same_model(tmps.read_mps(path, use_native=False), jmps.read_mps(path, use_native=False))


def test_native_load_writes_nothing_into_native_dir(monkeypatch):
    """The port loads the repo's library, or builds into its own _build/;
    native/ keeps every file as it was (names, sizes, mtimes)."""
    jnative.available()  # the JAX loader may build native/ itself first
    ndir = tnative._NATIVE_DIR

    def snapshot():
        return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in ndir.iterdir()}

    before = snapshot()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)  # load afresh
    assert tnative.available()
    tnative.native_parse_mps(open(os.path.join(DATA, "simple.mps")).read())
    assert snapshot() == before


def test_native_coo_to_csr_matches_jax():
    if not tnative.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(8)
    Ai, Aj, Ax = rng.integers(0, 9, 40), rng.integers(0, 13, 40), rng.standard_normal(40)
    for got, want in zip(tnative.native_coo_to_csr(9, Ai, Aj, Ax), jnative.native_coo_to_csr(9, Ai, Aj, Ax)):
        np.testing.assert_array_equal(got, want)
    indptr, indices, data = tnative.native_coo_to_csr(9, Ai, Aj, Ax)
    dense = np.zeros((9, 13))
    np.add.at(dense, (Ai, Aj), Ax)
    np.testing.assert_allclose(sp.csr_matrix((data, indices, indptr), shape=(9, 13)).toarray(), dense,
                               rtol=0, atol=1e-15)


def test_native_builds_into_its_own_directory(tmp_path):
    """Without the repo's library the port compiles the source into the
    build directory it is given and loads that."""
    if tnative.shutil.which("g++") is None and tnative.shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "native"
    src.mkdir()
    (src / "mps_native.cpp").write_bytes((tnative._NATIVE_DIR / "mps_native.cpp").read_bytes())
    lib = tnative.find_library(src, tmp_path / "build")
    assert lib is not None
    assert sorted(p.name for p in src.iterdir()) == ["mps_native.cpp"]
    assert [p.suffix for p in (tmp_path / "build").iterdir()] == [".so"]


# ---------------------------------------------------------------------------
# Scaling and presolve
# ---------------------------------------------------------------------------


def _random_lp(seed, m=12, n=20):
    rng = np.random.default_rng(seed)
    A = sp.random(m, n, density=0.3, random_state=rng, format="csr") * 100.0
    A = A + sp.diags(rng.uniform(0.01, 50.0, m), 0, shape=(m, n), format="csr")
    x = rng.random(n) + 0.5
    return mt.QuadraticModel(c=rng.random(n), A=A, lcon=A @ x, ucon=A @ x + (rng.random(m) < 0.3),
                             lvar=np.zeros(n), uvar=np.where(rng.random(n) < 0.3, 3.0, np.inf),
                             Q=sp.eye(n, format="csr") if seed % 2 else None)


@pytest.mark.parametrize("seed", range(3))
def test_scale_qp_matches_jax(seed):
    jq = _random_lp(seed)
    js, jr = jscale.scale_qp(jq)
    ts, tr = tscale.scale_qp(to_port(jq))
    np.testing.assert_array_equal(tr.Dr, jr.Dr)
    np.testing.assert_array_equal(tr.Dc, jr.Dc)
    assert_same_model(ts, js)
    rng = np.random.default_rng(seed)
    vecs = dict(x=rng.random(jq.nvar), y=rng.random(jq.ncon), zl=rng.random(jq.nvar), zu=rng.random(jq.nvar))
    for got, want in zip(tr.unscale_solution(**vecs), jr.unscale_solution(**vecs)):
        np.testing.assert_array_equal(got, want)


def test_ruiz_scale_dense_matches_jax():
    import jax.numpy as jnp

    A = np.random.default_rng(3).standard_normal((3, 17, 29)) * np.logspace(-3, 3, 29)
    A[1, 4] = 0.0  # an empty row keeps its unit factor
    for i in range(3):
        want = jscale.ruiz_scale_dense(jnp.asarray(A[i]))
        got = tscale.ruiz_scale_dense(torch.tensor(A[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0)
    batched = tscale.ruiz_scale_dense(torch.tensor(A))  # the stack at once
    for i in range(3):
        for g, w in zip(batched, tscale.ruiz_scale_dense(torch.tensor(A[i]))):
            np.testing.assert_array_equal(g[i].numpy(), w.numpy())


def _planted(seed):
    """tests/test_postsolve.py's model with every reduction class planted."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_postsolve import TestReductionMix

    return TestReductionMix()._planted_model(seed)


def _cascade():
    """Presolve solves it outright: PRESOLVE_SOLVED (tests/test_models.py)."""
    return mt.from_dense(c=[1.0, 2.0, 3.0], A=[[1.0, 1.0, 0.0], [0.0, 1.0, 1.0]], lcon=[4.0, 5.0],
                         ucon=[4.0, 5.0], lvar=[2.0, 0.0, 0.0], uvar=[2.0, np.inf, np.inf])


PRESOLVE_CASES = (
    [f"file:{fn}" for fn in FILES] + [f"planted:{s}" for s in range(3)] + ["random:1", "cascade"]
)


def _presolve_input(case):
    kind, _, arg = case.partition(":")
    if kind == "file":
        return jmps.read_mps(os.path.join(DATA, arg))
    if kind == "planted":
        return _planted(int(arg))
    if kind == "random":
        return _random_lp(int(arg))
    return _cascade()


@pytest.mark.parametrize("case", PRESOLVE_CASES)
def test_presolve_and_postsolve_match_jax(case):
    jq = _presolve_input(case)
    jred, jflag, jpost = jpre.presolve_qp(jq)
    tred, tflag, tpost = tpre.presolve_qp(to_port(jq))
    assert tflag == jflag
    assert (tpost.status is None) == (jpost.status is None)
    if jpost.status is not None:
        assert int(tpost.status) == int(jpost.status) and isinstance(tpost.status, mtt.Status)
    assert_same_model(tred, jred)
    for f in ("keep_cols", "keep_rows", "fixed_vals", "fixed_mask"):
        np.testing.assert_array_equal(getattr(tpost, f), getattr(jpost, f), err_msg=f)
    assert repr(tpost.col_elims) == repr(jpost.col_elims)
    rng = np.random.default_rng(0)
    nk, mk = jpost.keep_cols.size, jpost.keep_rows.size
    x_red, y_red = rng.random(nk), rng.standard_normal(mk)
    zl, zu = rng.random(nk), rng.random(nk)
    x = tpost.x(x_red)
    np.testing.assert_allclose(x, jpost.x(x_red), rtol=1e-12, atol=1e-12)
    for got, want in zip(tpost.duals(x, y_red, zl, zu), jpost.duals(x, y_red, zl, zu)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if case == "cascade":
        assert tpost.status == mtt.Status.PRESOLVE_SOLVED
        np.testing.assert_allclose(tpost.x(np.empty(0)), [2.0, 2.0, 3.0])


# ---------------------------------------------------------------------------
# Front ends
# ---------------------------------------------------------------------------

OPTS = dict(tol=1e-8, max_iter=300)


def _compare(name, js, ts):
    assert int(ts.status) == int(js.status) and ts.success, (name, js.status, ts.status)
    assert abs(ts.objective - js.objective) <= 1e-8 * max(1.0, abs(js.objective)), name
    for f in ("solution", "multipliers", "multipliers_L", "multipliers_U"):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.shape == b.shape, (name, f)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * max(1.0, np.abs(b).max()), err_msg=f)


@pytest.mark.parametrize("fn,sparse", [("simple.mps", None), ("simple_qp.qps", None),
                                       ("simple.mps", True), ("simple_qp.qps", True)])
def test_from_mps_matches_jax(fn, sparse):
    path = os.path.join(DATA, fn)
    kw = dict(OPTS, print_level=mt.PrintLevel.ERROR)
    js = jfront.from_mps(path, sparse=sparse, **kw)
    ts = mtt.from_mps(path, sparse=sparse, device="cpu", rethrow_error=True,
                      **dict(OPTS, print_level=mtt.PrintLevel.ERROR))
    _compare(fn, js, ts)
    want = {"simple.mps": js.objective, "simple_qp.qps": -6.25}[fn]
    assert abs(ts.objective - want) <= 1e-6


def test_from_mps_presolve_solved(tmp_path):
    """A file that presolve solves outright returns PRESOLVE_SOLVED with
    the postsolved primal and duals, in both packages."""
    path = str(tmp_path / "cascade.mps")
    tmps.write_mps(to_port(_cascade()), path)
    js = jfront.from_mps(path, print_level=mt.PrintLevel.ERROR)
    ts = mtt.from_mps(path, device="cpu", print_level=mtt.PrintLevel.ERROR)
    assert ts.status == mtt.Status.PRESOLVE_SOLVED and int(js.status) == int(ts.status)
    np.testing.assert_allclose(ts.solution, [2.0, 2.0, 3.0])
    assert ts.objective == js.objective
    for f in ("multipliers", "multipliers_L", "multipliers_U"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))


def test_solve_linprog_matches_jax():
    rng = np.random.default_rng(5)
    n = 8
    A_ub = rng.standard_normal((4, n))
    b_ub = np.abs(A_ub) @ np.ones(n) + 1.0
    A_eq = rng.random((2, n))
    b_eq = A_eq @ np.full(n, 0.5)
    c = rng.standard_normal(n)
    bounds = [(0, 2)] * n
    jr = jfront.solve_linprog(c, A_ub, b_ub, A_eq, b_eq, bounds, print_level=mt.PrintLevel.ERROR, **OPTS)
    tr = mtt.solve_linprog(c, A_ub, b_ub, A_eq, b_eq, bounds, device="cpu",
                           print_level=mtt.PrintLevel.ERROR, **OPTS)
    assert isinstance(tr, mtt.LinprogResult)
    assert tr.status == jr.status == 0 and tr.success and tr.nit == jr.nit
    assert abs(tr.fun - jr.fun) <= 1e-8 * max(1.0, abs(jr.fun))
    np.testing.assert_allclose(tr.x, jr.x, atol=1e-6)
    np.testing.assert_allclose(tr.slack, jr.slack, atol=1e-6)
    np.testing.assert_allclose(tr.con, jr.con, atol=1e-6)
    _compare("linprog", jr.ipm_stats, tr.ipm_stats)


def test_solve_qp_matches_jax():
    P = np.array([[4.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 1.0]])
    kw = dict(P=P, q=[1.0, 1.0, -1.0], G=[[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], h=[0.0, 0.0],
              A=[[1.0, 1.0, 1.0]], b=[1.0], ub=[np.inf, np.inf, 0.8])
    js = jfront.solve_qp(**kw, print_level=mt.PrintLevel.ERROR, **OPTS)
    ts = mtt.solve_qp(**kw, device="cpu", print_level=mtt.PrintLevel.ERROR, **OPTS)
    _compare("qp", js, ts)
