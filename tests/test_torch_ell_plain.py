"""The ELL route (``models/sparse.SparseTorchQP``, ``madipm_batch(sparse=True)``)
against plain PyTorch on the CPU, with no JAX: the products and the
normal matrix against dense products of the same CSR, one batched solve
against the benchmark's plain reference (``perfbench/reference``), and the
spans and counters of the route (``madipm.sparse.pattern``,
``madipm.sparse.segsum``, the ``madipm.qp.*`` products)."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import madipm_tpu_torch as mtt
from madipm_tpu_torch.models import qp, sparse
from madipm_tpu_torch.ops import chol_inv, kkt
from madipm_tpu_torch.parallel import batch
from madipm_tpu_torch.utils import logging
from perfbench import harness, spec
from perfbench.reference import judge

torch.set_num_threads(2)

PAD = 8
#: two small seeded buckets: (seed0, k, m, n, density)
BUCKETS = [(11, 2, 24, 96, 0.08), (2**31 + 7, 3, 40, 160, 0.05)]
#: tolerance of each dtype against the float64 dense product
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _suite(seed0, k, m, n, density):
    return spec.generator("make_sparse_suite").generate(k=k, seed0=seed0, m=m, n=n, density=density)


def _bucket(raw, dtype):
    """The bucket of the raw instances and their dense (B, m_pad, n_pad) A."""
    models = [mtt.from_dense(**r) for r in raw]
    prob, slacked = batch.bucket_pad_sparse(models, pad_multiple=PAD, dtype=dtype, device="cpu")
    A = torch.zeros((prob.batch, prob.m, prob.n), dtype=torch.float64)
    for i, s in enumerate(slacked):
        dense = torch.as_tensor(s.A.toarray())
        A[i, : dense.shape[0], : dense.shape[1]] = dense.to(dtype).double()
    return prob, A


def _close(got, want, dtype):
    err = (got.double() - want).abs().max() / want.abs().max()
    assert float(err) <= TOL[dtype], float(err)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["fp64", "fp32"])
@pytest.mark.parametrize("bucket", BUCKETS, ids=["bucket0", "bucket1"])
@pytest.mark.parametrize("op", ["matvec", "rmatvec", "assemble_normal_matrix"])
def test_ell_operator_matches_dense(op, bucket, dtype):
    prob, A = _bucket(_suite(*bucket), dtype)
    g = torch.Generator().manual_seed(bucket[0] % 1000)
    if op == "matvec":
        x = torch.randn((prob.batch, prob.n), generator=g, dtype=torch.float64)
        got, want = prob.matvec(x.to(dtype)), A @ x.to(dtype).double().unsqueeze(-1)
    elif op == "rmatvec":
        y = torch.randn((prob.batch, prob.m), generator=g, dtype=torch.float64)
        got, want = prob.rmatvec(y.to(dtype)), A.mT @ y.to(dtype).double().unsqueeze(-1)
    else:
        d = torch.rand((prob.batch, prob.n), generator=g, dtype=torch.float64) + 0.5
        d = torch.where(prob.col_mask, d, 0.0)
        got = prob.assemble_normal_matrix(d.to(dtype), dtype)
        d = d.to(dtype).double()
        want = (A * d.unsqueeze(-2)) @ A.mT
    assert got.dtype == dtype
    _close(got, want.reshape(got.shape), dtype)


def _cell_arguments(pad=32):
    """``madipm_batch``'s arguments in the cell ``lp_sparse.sweep4``
    (``sparse=True`` among them), padded to ``pad``."""
    cell = spec.cell("lp_sparse.sweep4")
    args = harness.call_arguments(cell.config, mtt)
    args["pad_multiple"] = pad
    return args


def test_sparse_batch_holds_against_the_plain_reference():
    raw = _suite(5, 2, 128, 2048, 0.03)
    stats = mtt.madipm_batch([mtt.from_dense(**r) for r in raw], device="cpu", **_cell_arguments())
    assert all(s.status == mtt.Status.SOLVE_SUCCEEDED for s in stats)
    values = judge.readings(raw, [1.0] * len(raw), [harness._answer(s) for s in stats], "cpu")
    limits = json.loads((spec.HOME / "limits" / "lp_normal.sweep8.json").read_text())
    assert judge.verdict(values, limits), values


def _counters():
    return dict(pattern_ns=sparse.pattern_ns, segsum_calls=sparse.segsum_calls,
                segsum_elems=sparse.segsum_elems, segsum_segments=sparse.segsum_segments,
                product_bytes=qp.product_bytes, assembly_flops=kkt.assembly_flops,
                assembly_bytes=kkt.assembly_bytes)


def _host_ops(prof):
    """(name, start, end) of every host operation, by start (one thread)."""
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU), key=lambda s: (s[1], -s[2]))


def _inside(ops, outer):
    """The names of the operations that lie inside some ``outer`` span."""
    ranges = [(s, e) for name, s, e in ops if name == outer]
    return {name for name, s, e in ops if name != outer and any(a <= s and e <= b for a, b in ranges)}


@pytest.fixture(scope="module")
def counted_solve():
    """One small ELL solve under a profiler: its counters' changes, its
    host operations, its chol_inv calls and its bucket."""
    raw = _suite(3, 2, 64, 512, 0.05)
    models = [mtt.from_dense(**r) for r in raw]
    opts = _cell_arguments(pad=PAD)
    mtt.madipm_batch(models, device="cpu", **opts)  # the native library's one-off load
    calls = []
    real = chol_inv.chol_inv

    def counting(M):
        calls.append(M.shape)
        return real(M)

    chol_inv.chol_inv = counting
    try:
        before = _counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            stats = mtt.madipm_batch(models, device="cpu", **opts)
        after = _counters()
    finally:
        chol_inv.chol_inv = real
    prob, _ = batch.bucket_pad_sparse(models, pad_multiple=PAD, device="cpu")
    return dict(stats=stats, d={k: after[k] - before[k] for k in after}, ops=_host_ops(prof),
                chol_calls=len(calls), prob=prob)


def test_counters_of_one_sparse_solve(counted_solve):
    d, prob = counted_solve["d"], counted_solve["prob"]
    assert all(s.success for s in counted_solve["stats"])
    assert d["pattern_ns"] > 0
    B, P = prob.pair_a.shape
    assert d["segsum_calls"] > 0
    assert d["segsum_elems"] == B * P * d["segsum_calls"]
    assert d["segsum_segments"] == prob.seg_len.numel() * d["segsum_calls"]
    # one assembly, hence one segmented sum, per factor attempt
    assert d["segsum_calls"] == counted_solve["chol_calls"]
    nnz = prob.seg_len.shape[-1] - 1
    assert d["assembly_flops"] == 3 * B * P * d["segsum_calls"]
    assert d["assembly_bytes"] == (3 * B * P * (8 + 4) + 8 * B * (nnz + 1) + 2 * B * nnz * 4) \
        * d["segsum_calls"]


def test_spans_of_one_sparse_solve(counted_solve):
    ops, d, prob = counted_solve["ops"], counted_solve["d"], counted_solve["prob"]
    count = lambda name: sum(op[0] == name for op in ops)
    assert count("madipm.sparse.pattern") == 1
    assert "madipm.sparse.pattern" in _inside(ops, "madipm.batch.pack")
    assert count("madipm.sparse.segsum") == d["segsum_calls"]
    assert "madipm.sparse.segsum" in _inside(ops, "madipm.kkt.assemble")
    assert "aten::segment_reduce" in _inside(ops, "madipm.sparse.segsum")
    for name in ("madipm.qp.matvec", "madipm.qp.rmatvec"):
        assert "aten::gather" in _inside(ops, name)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    assert d["product_bytes"] == count("madipm.qp.matvec") * nbytes(prob.A_val, prob.A_col) \
        + count("madipm.qp.rmatvec") * nbytes(prob.AT_val, prob.AT_row)


def test_ell_spans_cost_one_check_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no profiler recording")

    monkeypatch.setattr(logging, "_RecordFunctionFast", refuse)
    prob, _ = _bucket(_suite(11, 2, 24, 96, 0.08), torch.float64)
    before = qp.product_bytes
    prob.matvec(torch.ones((prob.batch, prob.n), dtype=torch.float64))
    prob.rmatvec(torch.ones((prob.batch, prob.m), dtype=torch.float64))
    prob.qmatvec(torch.ones((prob.batch, prob.n), dtype=torch.float64))
    prob.assemble_normal_matrix(torch.ones((prob.batch, prob.n), dtype=torch.float64), torch.float32)
    assert qp.product_bytes - before == sum(t.numel() * t.element_size()
                                            for t in (prob.A_val, prob.A_col, prob.AT_val, prob.AT_row))


def test_counters_of_one_sparse_qp_solve_on_k1():
    from madipm_tpu_torch.models import generators

    models = generators.make_qp_suite(k=2, m=16, n=32, density=0.3)
    opts = dict(_cell_arguments(pad=PAD), kkt_system=mtt.KKTSystem.CONDENSED, factor_dtype="float64")
    before = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        stats = mtt.madipm_batch(models, device="cpu", **opts)
    d = {k: v - before[k] for k, v in _counters().items()}
    assert all(s.success for s in stats)
    prob, _ = batch.bucket_pad_sparse(models, pad_multiple=PAD, device="cpu")
    B, P = prob.cpair_a.shape
    nnz = prob.cseg_len.shape[-1] - 1
    assert d["segsum_elems"] == B * P * d["segsum_calls"] > 0
    assert d["assembly_flops"] == 3 * B * P * d["segsum_calls"]
    assert d["assembly_bytes"] == (3 * B * P * 16 + 8 * B * (nnz + 1) + 16 * B * nnz) * d["segsum_calls"]
    ops = _host_ops(prof)
    count = lambda name: sum(op[0] == name for op in ops)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    assert count("madipm.qp.qmatvec") > 0
    assert d["product_bytes"] == count("madipm.qp.matvec") * nbytes(prob.A_val, prob.A_col) \
        + count("madipm.qp.rmatvec") * nbytes(prob.AT_val, prob.AT_row) \
        + count("madipm.qp.qmatvec") * nbytes(prob.Q_val, prob.Q_col)
