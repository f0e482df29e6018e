"""The sparse ELL route: madipm_tpu_torch.models.sparse, the sparse bucket
and the sparse solves against madipm_tpu on the same packed inputs.

Instances are those of the JAX package's tests/test_sparse.py (numpy
seeds, n=300 x m=90 and smaller).  Operators are held to 1e-12; solves to
the same status, iterations equal or +-1 (a difference is printed with
its cause) and objective to 1e-8 relative, in the CPU configuration (fp64
CHOLESKY) and, for the LP on NORMAL, the accelerator configuration (fp32
CHOLESKY_INV + fp64 PCG; its JAX compile alone takes ~20 s on the CPU,
so it is not repeated for every instance).  Each JAX reference is
computed once per module.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import madipm_tpu as mt
import madipm_tpu_torch as mtt
from madipm_tpu.models import sparse as jsparse
from madipm_tpu.models.qp import slack_form as jslack_form
from madipm_tpu.parallel import batch as jbatch
from madipm_tpu_torch.models import native, sparse as tsparse
from madipm_tpu_torch.models.qp import slack_form
from madipm_tpu_torch.ops import kkt as tkkt
from madipm_tpu_torch.parallel import batch as tbatch

torch.set_num_threads(2)


def make_sparse_lp(pkg, rng, n, m, density=0.05):
    """tests/test_sparse.py's generator, for either package's model class."""
    A = sp.random(m, n, density=density, random_state=rng, format="csr")
    A = A + sp.diags(np.ones(m), 0, shape=(m, n), format="csr")
    xstar = rng.random(n) + 0.5
    return pkg.QuadraticModel(c=rng.random(n) + 0.1, A=A, lcon=A @ xstar, ucon=A @ xstar,
                              lvar=np.zeros(n), uvar=np.full(n, np.inf))


def make_sparse_qp(pkg, rng, n, m, density=0.05, q_density=0.02, uvar=None):
    """Convex sparse QP with SPD Q = B'B + I, equality rows."""
    A = sp.random(m, n, density=density, random_state=rng, format="csr")
    A = A + sp.diags(np.ones(m), 0, shape=(m, n), format="csr")
    B = sp.random(n, n, density=q_density, random_state=rng, format="csr")
    Q = (B.T @ B + sp.eye(n)).tocsr()
    xstar = rng.random(n) + 0.5
    ub = np.full(n, np.inf) if uvar is None else uvar(xstar)
    return pkg.QuadraticModel(c=rng.standard_normal(n), A=A, lcon=A @ xstar, ucon=A @ xstar,
                              lvar=np.zeros(n), uvar=ub, Q=Q)


def both(make, seed, *args, **kw):
    """The same instance as a model of each package."""
    return make(mt, np.random.default_rng(seed), *args, **kw), make(mtt, np.random.default_rng(seed), *args, **kw)


def fields_of(prob) -> dict:
    """A JAX SparseDeviceQP (one lane or a stack) as numpy arrays."""
    return {f.name: None if getattr(prob, f.name) is None else np.asarray(getattr(prob, f.name))
            for f in dataclasses.fields(prob)}


def lane(prob, i):
    return jax.tree_util.tree_map(lambda a: a[i], prob)


# ---------------------------------------------------------------------------
# Operators and packing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def packed():
    """One LP packed with both patterns and one QP packed for K1, by the
    JAX package, and the port's SparseTorchQP of the same fields."""
    lp, _ = both(make_sparse_lp, 3, n=300, m=90, density=0.04)
    qp, _ = both(make_sparse_qp, 14, n=150, m=50)
    out = {}
    for name, model, kkt in (("lp", lp, "both"), ("qp", qp, "condensed")):
        jp = jsparse.pad_sparse_to_device(jslack_form(model), kkt=kkt)
        out[name] = (jp, tsparse.SparseTorchQP.from_numpy(fields_of(jp)))
    return out


def _vec(size, seed, positive=False):
    v = np.random.default_rng(seed).standard_normal(size)
    return np.abs(v) + 0.5 if positive else v


def _op_lp_matvec(jp, tp):
    x = _vec(jp.n, 0)
    return jp.matvec(jnp.asarray(x)), tp.matvec(torch.tensor(x)[None])


def _op_lp_rmatvec(jp, tp):
    y = _vec(jp.m, 1)
    return jp.rmatvec(jnp.asarray(y)), tp.rmatvec(torch.tensor(y)[None])


def _op_lp_row_inf_norm(jp, tp):
    return jp.row_inf_norm(), tp.row_inf_norm()


def _op_lp_scale_rows(jp, tp):
    s = _vec(jp.m, 2, positive=True)
    js, ts = jp.scale_rows(jnp.asarray(s)), tp.scale_rows(torch.tensor(s)[None])
    return (jnp.concatenate([js.A_val.ravel(), js.AT_val.ravel()]),
            torch.cat([ts.A_val.reshape(1, -1), ts.AT_val.reshape(1, -1)], dim=1))


def _op_lp_assemble_normal_matrix(jp, tp):
    d = _vec(jp.n, 3, positive=True)
    return (jp.assemble_normal_matrix(jnp.asarray(d), jnp.float64),
            tp.assemble_normal_matrix(torch.tensor(d)[None], torch.float64))


def _op_qp_assemble_ata(jp, tp):
    w = (np.random.default_rng(4).random(jp.m) > 0.2).astype(np.float64)
    return jp.assemble_ata(jnp.asarray(w), jnp.float64), tp.assemble_ata(torch.tensor(w)[None], torch.float64)


def _op_qp_qmatvec(jp, tp):
    x = _vec(jp.n, 5)
    return jp.qmatvec(jnp.asarray(x)), tp.qmatvec(torch.tensor(x)[None])


def _op_qp_add_quad(jp, tp):
    C = np.random.default_rng(6).standard_normal((jp.n, jp.n))
    return jp.add_quad(jnp.asarray(C), jnp.float64), tp.add_quad(torch.tensor(C)[None], torch.float64)


OPERATORS = {name[4:]: fn for name, fn in globals().items() if name.startswith("_op_")}


@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_operator_matches_jax(packed, name):
    jp, tp = packed[name.split("_")[0]]
    want, got = OPERATORS[name](jp, tp)
    want, got = np.asarray(want), got[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))


def test_assembly_of_a_partly_fixed_lane_matches_jax(packed):
    """assemble_ata and live_rows read the free mask: pin some columns."""
    jp, tp = packed["qp"]
    lb, ub = np.asarray(jp.lb).copy(), np.asarray(jp.ub).copy()
    ub[::7] = lb[::7]
    jq = dataclasses.replace(jp, lb=jnp.asarray(lb), ub=jnp.asarray(ub))
    tq = dataclasses.replace(tp, lb=torch.tensor(lb)[None], ub=torch.tensor(ub)[None])
    np.testing.assert_array_equal(tq.live_rows()[0].numpy(), np.asarray(jq.live_rows()))
    w = np.ones(jp.m)
    np.testing.assert_allclose(tq.assemble_ata(torch.tensor(w)[None], torch.float64)[0].numpy(),
                               np.asarray(jq.assemble_ata(jnp.asarray(w), jnp.float64)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kkt", ["normal", "condensed", "both"])
def test_pad_sparse_to_device_matches_jax_field_by_field(kkt):
    """The port's host packing gives the JAX package's arrays exactly."""
    jm, tm = both(make_sparse_qp if kkt == "condensed" else make_sparse_lp, 9, n=120, m=37)
    jf = fields_of(jsparse.pad_sparse_to_device(jslack_form(jm), kkt=kkt))
    tf = tsparse.pack_sparse(slack_form(tm), kkt=kkt)
    assert set(jf) == set(tf)
    for name, want in jf.items():
        got = tf[name]
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
    tp = tsparse.pad_sparse_to_device(slack_form(tm), kkt=kkt)
    assert tp.pair_a.dtype == torch.int64 and tp.A_val.dtype == torch.float64
    assert tp.seg_len.shape == (1, tf["s_low"].size + 1)


def test_native_and_python_patterns_assemble_the_same_matrix():
    """The C++ pattern code sorts pairs within a destination in another order
    than the Python one; the assembled S agrees all the same."""
    if not native.available():
        pytest.skip("native library unavailable")
    A = sp.random(37, 120, density=0.08, random_state=13, format="csr")
    A = tsparse._clean_csr(A + sp.diags(np.ones(37), 0, shape=(37, 120), format="csr"))
    mp = 64
    val, idx, ell_pos = tsparse._to_ell(A, mp, 128)
    py = tsparse.build_normal_pattern(A, ell_pos, mp)
    nat = tsparse.NormalPattern(*native.native_normal_pattern(
        A.indptr, A.indices, A.shape[0], A.shape[1], val.shape[1], mp))
    np.testing.assert_array_equal(py.s_low, nat.s_low)
    np.testing.assert_array_equal(py.s_up, nat.s_up)
    assert py.pair_a.size == nat.pair_a.size
    assert not np.array_equal(py.pair_a, nat.pair_a)  # the orders differ
    dinv = torch.tensor(np.random.default_rng(1).random(128))[None]
    S = []
    for pat in (py, nat):
        fields = dict(tsparse.pack_sparse(slack_form(mtt.QuadraticModel(
            c=np.zeros(120), A=A, lcon=np.zeros(37), ucon=np.zeros(37),
            lvar=np.zeros(120), uvar=np.full(120, np.inf))), m_pad=mp), **pat._asdict())
        S.append(tsparse.SparseTorchQP.from_numpy(fields).assemble_normal_matrix(dinv, torch.float64))
    Ad = torch.tensor(A.toarray())
    want = (Ad * dinv[:, :120]) @ Ad.T  # dense A D A'
    torch.testing.assert_close(S[0][0], S[1][0], rtol=0, atol=1e-12)
    torch.testing.assert_close(S[0][0, :37, :37], want[:37, :37], rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# Buckets
# ---------------------------------------------------------------------------


def _bucket_models(kind):
    if kind == "lp":  # different shapes and pattern lengths per lane
        return [both(make_sparse_lp, 33 + i, n=200 + 40 * i, m=50 + 10 * i,
                     density=0.03 + 0.01 * i) for i in range(3)]
    return [both(make_sparse_qp, 42, n=100, m=30), both(make_sparse_lp, 43, n=140, m=40)]


@pytest.mark.parametrize("kind", ["lp", "mixed"])
def test_bucket_pad_sparse_matches_jax(kind):
    """One shared shape, padded patterns; each lane assembles what the JAX
    lane assembles (padded pairs and destinations land in the sinks)."""
    pairs = _bucket_models(kind)
    jprob, _ = jbatch.bucket_pad_sparse([j for j, _ in pairs])
    tprob, _ = tbatch.bucket_pad_sparse([t for _, t in pairs], device="cpu")
    jf = fields_of(jprob)
    for f in dataclasses.fields(jprob):
        want, got = jf[f.name], getattr(tprob, f.name)
        assert (got is None) == (want is None), f.name
        if want is not None:
            np.testing.assert_array_equal(got.numpy().reshape(want.shape), want, err_msg=f.name)
    lens = (tprob.seg_len if kind == "lp" else tprob.cseg_len).numpy()
    assert len({int(row[:-1].sum()) for row in lens}) == len(pairs)  # pattern lengths differ
    assert (lens[:, -1] > 0).any()  # some lane has padded pairs in its sink
    rng = np.random.default_rng(7)
    if kind == "lp":
        d = rng.random((len(pairs), jprob.n)) + 0.5
        got = tprob.assemble_normal_matrix(torch.tensor(d), torch.float64)
        want = [lane(jprob, i).assemble_normal_matrix(jnp.asarray(d[i]), jnp.float64) for i in range(len(pairs))]
    else:
        w = np.ones((len(pairs), jprob.m))
        C = tprob.add_quad(tprob.assemble_ata(torch.tensor(w), torch.float64), torch.float64)
        got = C
        want = [lane(jprob, i).add_quad(lane(jprob, i).assemble_ata(jnp.asarray(w[i]), jnp.float64), jnp.float64)
                for i in range(len(pairs))]
    for i, wi in enumerate(want):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(wi), rtol=0, atol=1e-12)


def test_stack_problems_refuses_mixed_shapes():
    a = tsparse.pad_sparse_to_device(slack_form(both(make_sparse_lp, 1, n=60, m=20)[1]))
    b = tsparse.pad_sparse_to_device(slack_form(both(make_sparse_lp, 2, n=60, m=20)[1]))
    with pytest.raises(ValueError, match="padded shape"):
        tbatch.stack_problems([a, b])  # same m and n, other pattern lengths


# ---------------------------------------------------------------------------
# Solves against the JAX package
# ---------------------------------------------------------------------------


def _ranged_qp(pkg, rng, n=120, m=40):
    """tests/test_sparse.py's bounded QP, with ranged rows and an inequality."""
    qp = make_sparse_qp(pkg, rng, n, m, density=0.06, uvar=lambda xs: np.where(
        np.arange(n) % 3 == 0, xs + 0.25, np.inf))
    lcon, ucon = qp.lcon.copy(), qp.ucon.copy()
    lcon[:5] -= 1.0
    ucon[:3] += 1.0
    ucon[3:5] = np.inf
    return pkg.QuadraticModel(c=qp.c, A=qp.A, lcon=lcon, ucon=ucon, lvar=qp.lvar, uvar=qp.uvar, Q=qp.Q)


def _empty_row(pkg, rng):
    A = sp.csr_matrix(np.array([[1.0, 1.0, 0.0], [0.0, 0.0, 0.0]]))
    return pkg.QuadraticModel(c=[1.0, 1.0, 1.0], A=A, lcon=[1.0, 0.0], ucon=[1.0, 0.0],
                              lvar=np.zeros(3), uvar=np.full(3, np.inf))


#: the accelerator configuration of ROADMAP.md (fp32 factor, fp64 PCG)
ACCEL = dict(linear_solver="CHOLESKY_INV", factor_dtype="float32", refinement_steps=12,
             pcg_adaptive_tol=True, predictor_pcg_budget=0, pcg_tol_floor=1e-8,
             fp64_matvec="emulated")

#: name -> (generator, its arguments, options by enum name)
SOLVES = {
    "lp-normal": (make_sparse_lp, dict(n=300, m=90, density=0.04), {}),
    "lp-condensed": (make_sparse_lp, dict(n=300, m=90, density=0.04), dict(kkt_system="CONDENSED")),
    "qp-auto-k1": (make_sparse_qp, dict(n=180, m=60), {}),
    "qp-bounded-ranged": (_ranged_qp, {}, {}),
    "lp-empty-row": (_empty_row, {}, {}),
    "lp-normal-accel": (make_sparse_lp, dict(n=300, m=90, density=0.04), ACCEL),
}


def _opts(pkg, kw):
    out = dict(print_level=pkg.PrintLevel.ERROR, tol=1e-8, max_iter=300)
    for k, v in kw.items():
        if k == "kkt_system":
            v = pkg.KKTSystem[v]
        elif k == "linear_solver":
            v = pkg.LinearSolver[v]
        out[k] = v
    return out


def _compare(name, js, ts):
    assert js.status == ts.status and ts.success, (name, js.status, ts.status)
    if ts.iter != js.iter:
        print(f"{name}: iterations {ts.iter} (torch) vs {js.iter} (jax): the two packages sum "
              f"the ELL products and segments in other orders, and the last bits of the factor "
              f"moved the last step across the tolerance")
    assert abs(ts.iter - js.iter) <= 1, (name, ts.iter, js.iter)
    rel = abs(ts.objective - js.objective) / max(1.0, abs(js.objective))
    assert rel <= 1e-8, (name, rel)
    assert ts.solution.shape == js.solution.shape


@pytest.mark.parametrize("name", list(SOLVES))
def test_sparse_madipm_matches_jax(name):
    make, args, kw = SOLVES[name]
    jm, tm = both(make, 11, **args)
    js = mt.madipm(jm, sparse=True, **_opts(mt, kw))
    solver = mtt.MPCSolver(tm, device="cpu", sparse=True, rethrow_error=True, **_opts(mtt, kw))
    assert isinstance(solver.prob, mtt.SparseTorchQP)
    ts = solver.solve()
    _compare(name, js, ts)


def test_sparse_batch_matches_jax_lanes():
    """A mixed LP/QP bucket solved on K1 in one batch, lane by lane
    against the JAX package's vmapped bucket."""
    pairs = _bucket_models("mixed")
    js = jbatch.madipm_batch([j for j, _ in pairs], sparse=True, **_opts(mt, {}))
    ts = mtt.madipm_batch([t for _, t in pairs], device="cpu", sparse=True, **_opts(mtt, {}))
    for i, (j, t) in enumerate(zip(js, ts)):
        _compare(f"lane {i}", j, t)


# ---------------------------------------------------------------------------
# Route choice and refusals
# ---------------------------------------------------------------------------


def _tall_lp(pkg, m=2048, n=32769, per_col=3):
    """The auto rule's boundary: m n = 67.1e6 > 64e6 entries, a few
    nonzeros per column (0.15% dense), equality rows (no slacks)."""
    rng = np.random.default_rng(5)
    rows = rng.integers(0, m, size=(n, per_col)).ravel()
    cols = np.repeat(np.arange(n), per_col)
    A = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(m, n))
    b = A @ (rng.random(n) + 0.5)
    return pkg.QuadraticModel(c=rng.random(n), A=A, lcon=b, ucon=b, lvar=np.zeros(n),
                              uvar=np.full(n, np.inf))


def test_auto_rule_picks_the_sparse_route_like_jax():
    """Construction only: both packages choose the ELL route for the tall
    LP and the dense one for a small LP."""
    jsol = mt.MPCSolver(_tall_lp(mt))
    tsol = mtt.MPCSolver(_tall_lp(mtt), device="cpu")
    assert isinstance(jsol.prob, jsparse.SparseDeviceQP)
    assert isinstance(tsol.prob, mtt.SparseTorchQP)
    np.testing.assert_array_equal(tsol.prob.s_low[0].numpy(), np.asarray(jsol.prob.s_low))
    jm, tm = both(make_sparse_lp, 3, n=300, m=90)
    assert not isinstance(mt.MPCSolver(jm).prob, jsparse.SparseDeviceQP)
    assert isinstance(mtt.MPCSolver(tm, device="cpu").prob, mtt.TorchQP)


def test_sparse_qp_refuses_augmented():
    jm, tm = both(make_sparse_qp, 16, n=60, m=20)
    with pytest.raises(ValueError, match="CONDENSED"):
        mt.MPCSolver(jm, sparse=True, kkt_system=mt.KKTSystem.AUGMENTED)
    with pytest.raises(ValueError, match="CONDENSED"):
        mtt.MPCSolver(tm, device="cpu", sparse=True, kkt_system=mtt.KKTSystem.AUGMENTED)
    with pytest.raises(ValueError, match="NORMAL and CONDENSED"):
        mtt.MPCSolver(both(make_sparse_lp, 16, n=60, m=20)[1], device="cpu", sparse=True,
                      kkt_system=mtt.KKTSystem.AUGMENTED)
    with pytest.raises(ValueError, match="CONDENSED"):
        mtt.madipm_batch([tm], device="cpu", sparse=True, kkt_system=mtt.KKTSystem.AUGMENTED)


def test_dense_fields_refused_with_not_implemented():
    """The AUGMENTED assembly on a sparse problem raises what
    SparseDeviceQP.dense_A raises, not an AttributeError."""
    tp = tsparse.pad_sparse_to_device(slack_form(both(make_sparse_qp, 16, n=60, m=20)[1]))
    with pytest.raises(NotImplementedError, match="AUGMENTED"):
        _ = tp.dense_A
    sigma = torch.ones(1, tp.n, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="AUGMENTED"):
        tkkt._assemble_augmented(tp, sigma, torch.full((1, 1), -1e-8), torch.float64)
    # bound updates (the solver loop's dataclasses.replace) keep the class
    moved = dataclasses.replace(tp, lb=tp.lb - 1.0)
    assert isinstance(moved, tsparse.SparseTorchQP) and moved.is_qp


def test_missing_condensed_pattern_raises():
    jm, tm = both(make_sparse_lp, 17, n=80, m=24)
    jp = jsparse.pad_sparse_to_device(jslack_form(jm), kkt="normal")
    tp = tsparse.pad_sparse_to_device(slack_form(tm), kkt="normal")
    with pytest.raises(NotImplementedError, match="condensed"):
        jp.assemble_ata(jnp.ones(jp.m), jnp.float64)
    with pytest.raises(NotImplementedError, match="condensed"):
        tp.assemble_ata(torch.ones(1, tp.m, dtype=torch.float64), torch.float64)
    with pytest.raises(ValueError, match="LP-only"):
        tsparse.pack_sparse(slack_form(both(make_sparse_qp, 17, n=60, m=20)[1]), kkt="normal")
