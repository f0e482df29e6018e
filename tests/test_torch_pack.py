"""The dense route's packer (``models/qp.pack_lanes``, through
``parallel/batch.bucket_pad`` and ``pad_to_device``) against a plain numpy
oracle: each lane densified with ``toarray`` and padded on the host.  Every
field must hold the same bits, for LPs with inequality and range rows, QPs,
lanes of different sizes, non-canonical CSR and float32; and the packer's
upload counters must not grow with the number of lanes."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import madipm_tpu_torch as mtt
from madipm_tpu_torch.models import qp as tqp
from madipm_tpu_torch.parallel import batch

torch.set_num_threads(2)

FIELDS = ("c", "A", "b", "lb", "ub", "Q", "c0", "row_mask", "col_mask", "x0", "y0")
PAD = 8


def oracle(slacked, m_pad, n_pad, dtype=torch.float64) -> dict:
    """The padded fields of a bucket of equality-form models, built lane by
    lane on the host."""
    B = len(slacked)
    out = dict(A=np.zeros((B, m_pad, n_pad)), c=np.zeros((B, n_pad)), lb=np.zeros((B, n_pad)),
               ub=np.zeros((B, n_pad)), x0=np.zeros((B, n_pad)), b=np.zeros((B, m_pad)),
               y0=np.zeros((B, m_pad)), c0=np.zeros((B, 1)),
               row_mask=np.zeros((B, m_pad), dtype=bool), col_mask=np.zeros((B, n_pad), dtype=bool),
               Q=np.zeros((B, n_pad, n_pad)) if slacked[0].is_qp else None)
    for i, s in enumerate(slacked):
        m, n = s.ncon, s.nvar
        out["A"][i, :m, :n] = s.A.toarray()
        if s.is_qp:
            out["Q"][i, :n, :n] = s.Q.toarray()
        out["c"][i, :n], out["lb"][i, :n], out["ub"][i, :n] = s.c, s.lvar, s.uvar
        out["x0"][i, :n], out["b"][i, :m], out["y0"][i, :m] = s.x0, s.lcon, s.y0
        out["c0"][i] = s.c0
        out["row_mask"][i, :m] = True
        out["col_mask"][i, :n] = True
    return {k: None if v is None else torch.as_tensor(v, dtype=torch.bool if v.dtype == bool else dtype)
            for k, v in out.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bit patterns (a float's sign of zero included)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(prob, want: dict):
    for k in FIELDS:
        got = getattr(prob, k)
        if want[k] is None:
            assert got is None, k
            continue
        assert got.dtype == want[k].dtype and got.shape == want[k].shape, k
        assert torch.equal(got, want[k]), k
        assert torch.equal(_bits(got), _bits(want[k])), k
    for k in ("group", "A_rows", "A_sl", "At_sl", "Q_sl"):
        assert getattr(prob, k) is None, k


def _lp(seed, m=12, n=20, density=0.4, ranges=True):
    """A general-form LP: equality, inequality and range rows, range and
    free variables."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    A[np.abs(A).sum(axis=1) == 0, 0] = 1.0
    x = rng.random(n) + 0.5
    ax = A @ x
    lcon, ucon = ax.copy(), ax.copy()
    lcon[: m // 3] = -np.inf                      # <= rows
    ucon[m // 3: m // 2] = np.inf                 # >= rows
    if ranges:
        lcon[m // 2: 2 * m // 3] -= 1.0           # range rows
        ucon[m // 2: 2 * m // 3] += 1.0
    lvar, uvar = np.zeros(n), np.full(n, np.inf)
    uvar[::3] = x[::3] + 2.0
    lvar[1::5] = -np.inf
    return mtt.from_dense(c=rng.random(n), A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar,
                          c0=float(seed), x0=rng.random(n), y0=rng.random(m))


def _qp(seed, m=10, n=24):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((n, 3))
    q = _lp(seed, m=m, n=n)
    return mtt.from_dense(c=q.c, A=q.A.toarray(), lcon=q.lcon, ucon=q.ucon, lvar=q.lvar, uvar=q.uvar,
                          Q=P @ P.T + 0.5 * np.eye(n), c0=q.c0)


def _non_canonical(shape, seed):
    """A CSR with long rows in shuffled column order, explicit (and
    negative) zeros, and a column stored three times in each row, whose
    sum depends on the order of the additions: (1e16 + 1) - 1e16 is 0 in
    storage order and 1 in another (sorting a long row may reorder it)."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    indptr, indices, data = [0], [], []
    for _ in range(rows):
        js = list(rng.permutation(cols)[:min(cols, 20)])
        vs = list(rng.standard_normal(len(js)))
        vs[0], vs[1], vs[2] = 1e16, -0.0, 0.0
        js += [js[0], js[0], js[3]]
        vs += [1.0, -1e16, 0.0]
        order = rng.permutation(len(js))
        indices += [js[i] for i in order]
        data += [vs[i] for i in order]
        indptr.append(len(indices))
    M = sp.csr_matrix((np.array(data), np.array(indices, dtype=np.int32), np.array(indptr)), shape=shape)
    assert not M.has_canonical_format
    return M


def test_lp_with_inequality_and_range_rows():
    models = [_lp(s) for s in (1, 2, 3)]
    probs, slacked = batch.bucket_pad(models, pad_multiple=PAD, device="cpu")
    assert all(s.nvar > q.nvar for s, q in zip(slacked, models))  # slack columns
    assert_same(probs, oracle(slacked, probs.m, probs.n))


def test_k1_qp():
    models = [_qp(s) for s in (4, 5)]
    probs, slacked = batch.bucket_pad(models, pad_multiple=PAD, device="cpu")
    assert probs.is_qp
    assert_same(probs, oracle(slacked, probs.m, probs.n))


def test_lanes_of_different_sizes():
    models = [_lp(6, m=5, n=9), _lp(7, m=17, n=30, ranges=False), _lp(8, m=11, n=12)]
    probs, slacked = batch.bucket_pad(models, pad_multiple=PAD, device="cpu")
    assert len({(s.ncon, s.nvar) for s in slacked}) == 3
    assert_same(probs, oracle(slacked, probs.m, probs.n))
    qps = [_qp(9, m=4, n=8), _qp(10, m=9, n=21)]
    probs, slacked = batch.bucket_pad(qps, pad_multiple=PAD, device="cpu")
    assert_same(probs, oracle(slacked, probs.m, probs.n))


def test_non_canonical_csr():
    # equality-form, so that slack_form hands the matrices over as they are
    rng = np.random.default_rng(11)
    models = []
    for i in range(2):
        b = rng.standard_normal(10)
        q = mtt.from_dense(c=rng.random(24), A=np.eye(10, 24), lcon=b, ucon=b, lvar=np.zeros(24),
                           uvar=np.full(24, np.inf), Q=np.eye(24))
        q.A, q.Q = _non_canonical((10, 24), 20 + i), _non_canonical((24, 24), 30 + i)
        models.append(q)
    # canonical, with a negative zero stored: toarray's 0.0 + -0.0 is 0.0
    q = mtt.from_dense(c=np.ones(24), A=np.eye(7, 24), lcon=np.ones(7), ucon=np.ones(7),
                       lvar=np.zeros(24), uvar=np.full(24, np.inf), Q=np.eye(24))
    q.A.data[3] = q.Q.data[5] = -0.0
    models.append(q)
    probs, slacked = batch.bucket_pad(models, pad_multiple=PAD, device="cpu")
    assert slacked[0] is models[0] and not slacked[0].A.has_canonical_format
    assert slacked[2].A.has_canonical_format and np.signbit(slacked[2].A.data).any()
    assert_same(probs, oracle(slacked, probs.m, probs.n))
    # an LP whose slack form stacks a non-canonical A
    lps = [_lp(21), _lp(22)]
    for i, q in enumerate(lps):
        q.A = _non_canonical(q.A.shape, 40 + i)
    probs, slacked = batch.bucket_pad(lps, pad_multiple=PAD, device="cpu")
    assert_same(probs, oracle(slacked, probs.m, probs.n))


def test_float32():
    models = [_lp(13), _lp(14, m=7, n=15)]
    probs, slacked = batch.bucket_pad(models, pad_multiple=PAD, dtype=torch.float32, device="cpu")
    assert_same(probs, oracle(slacked, probs.m, probs.n, dtype=torch.float32))
    qps = [_qp(15)]
    probs, slacked = batch.bucket_pad(qps, pad_multiple=PAD, dtype=torch.float32, device="cpu")
    assert_same(probs, oracle(slacked, probs.m, probs.n, dtype=torch.float32))


def test_one_lane_pad_to_device():
    s = mtt.slack_form(_qp(16))
    prob = tqp.pad_to_device(s, pad_multiple=16, device="cpu")
    assert (prob.batch, prob.m, prob.n) == (1, 16, 32)
    assert_same(prob, oracle([s], 16, 32))
    prob = tqp.pad_to_device(s, m_pad=24, n_pad=40)
    assert_same(prob, oracle([s], 24, 40))
    with pytest.raises(ValueError, match="equality-only"):
        tqp.pad_to_device(_lp(17))
    with pytest.raises(ValueError, match="smaller than problem"):
        tqp.pad_to_device(s, m_pad=8, n_pad=40)
    with pytest.raises(ValueError, match="padded shape"):
        batch.bucket_pad([_lp(18), _qp(19)], pad_multiple=PAD, device="cpu")


@pytest.mark.parametrize("make", [_lp, _qp], ids=["lp", "qp"])
def test_upload_counters(make):
    """Two host-to-device copies a bucket at any k, of exactly the staged
    buffers' bytes: each lane's nonzeros (8-byte values, 4-byte column
    indices), the row counts and the vectors, each field padded to the
    alignment at most."""
    seen = {}
    for k in (1, 6):
        slacked = [mtt.slack_form(make(s)) for s in range(k)]
        m_pad = max(tqp._round_up(s.ncon, PAD) for s in slacked)
        n_pad = max(tqp._round_up(s.nvar, PAD) for s in slacked)
        _, staged = tqp.pack_lanes(slacked, m_pad, n_pad, device="cpu")
        b0, u0 = batch.upload_bytes, batch.uploads
        probs, _ = batch.bucket_pad(slacked, pad_multiple=PAD, device="cpu")
        assert (probs.m, probs.n) == (m_pad, n_pad)
        seen[k] = batch.uploads - u0
        assert batch.upload_bytes - b0 == sum(staged)
        nnz = sum(s.A.nnz + (s.Q.nnz if s.is_qp else 0) for s in slacked)
        counts = k * (m_pad + (n_pad if slacked[0].is_qp else 0))
        payload = 12 * nnz + 4 * counts + k * (8 * (4 * n_pad + 2 * m_pad + 1) + m_pad + n_pad)
        assert payload <= sum(staged) <= payload + 15 * tqp._STAGE_ALIGN  # 15 fields at most
    assert seen[1] == seen[6] == 2
