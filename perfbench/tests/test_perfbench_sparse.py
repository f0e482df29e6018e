"""The tall sparse LP cell (``lp_sparse.sweep4``): its generator, its
files, and the readers of its two per-layer metrics on hand-made records."""

import time

import numpy as np
import pytest
from test_perfbench_metrics import _call, _run

from madipm_tpu_torch.models import sparse
from perfbench import spec, trace
from perfbench.roofline import peaks

CELL = "lp_sparse.sweep4"
gen = spec.generator("make_sparse_suite")
segment_sum = spec.roofline("segment_sum")


def _sizes():
    return {k: v for k, v in spec.cell(CELL).config["generator"].items() if k != "name"}


def test_generator_is_deterministic_from_seed0():
    a, b = (gen.generate(k=2, seed0=2**31 + 17, m=32, n=256, density=0.05) for _ in range(2))
    c = gen.generate(k=2, seed0=2**31 + 18, m=32, n=256, density=0.05)
    for key in ("A", "c", "lcon", "uvar"):
        np.testing.assert_array_equal(a[0][key], b[0][key])
        np.testing.assert_array_equal(a[1][key], b[1][key])
    # instance i draws from seed0 + i
    np.testing.assert_array_equal(a[1]["A"], c[0]["A"])
    assert not np.array_equal(a[0]["A"], c[0]["A"])


def test_generator_law_at_small_size():
    m, n, density = 64, 512, 0.05
    inst = gen.generate(k=1, seed0=9, m=m, n=n, density=density)[0]
    rng = np.random.default_rng(9)
    gen.sparse_lp(rng, m, n, density)
    xstar = rng.random(n) + 0.5
    np.testing.assert_allclose(inst["A"] @ xstar, inst["lcon"], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(inst["lcon"], inst["ucon"])
    assert np.all((inst["c"] >= 0.1) & (inst["c"] < 1.1))
    bounded = np.isfinite(inst["uvar"])
    assert np.all(inst["uvar"][bounded] >= xstar[bounded])
    assert 0.15 < bounded.mean() < 0.35
    assert np.all(inst["lvar"] == 0) and inst["Q"] is None


def test_empty_rows_get_one_unit_entry():
    A = gen.generate(k=1, seed0=4, m=200, n=64, density=0.002)[0]["A"]
    nnz = (A != 0).sum(axis=1)
    assert nnz.min() >= 1
    lone = nnz == 1
    assert lone.any()


def test_full_size_density_no_empty_row_and_time():
    # the process's CPU time, so that the other tests running beside it do not count
    sizes = _sizes()
    t0 = time.process_time()
    made = gen.generate(k=spec.cell(CELL).traffic["k"], **sizes)
    seconds = time.process_time() - t0
    for inst in made:
        A = inst["A"]
        assert A.shape == (sizes["m"], sizes["n"])
        nz = A != 0
        assert abs(nz.mean() / sizes["density"] - 1) < 0.05
        assert nz.any(axis=1).all()
    del made
    assert seconds < 3.0, seconds


def test_cell_resolves():
    cell = spec.cell(CELL)
    assert cell.chips == 1 and cell.traffic == {"k": 4}
    assert cell.config["call"]["sparse"] is True
    assert cell.config["generator"]["name"] == "make_sparse_suite"
    assert {m["name"] for m in cell.per_layer} == {"ell_pattern_ms", "segsum_roofline"}
    assert cell.limits["unsolved"] == cell.limits["nonfinite"] == cell.limits["ref_unsolved"] == 0
    dense = spec.cell("lp_normal.sweep8").config
    assert cell.config["options"] == dense["options"] and cell.config["control"] == dense["control"]


def _summary(by_name):
    return trace.Summary(window_s=2.0, busy_s=1.0, enqueues=10, device_ops=5,
                         device_time_by_name=by_name, idle_by_host={}, longest_gap_s=0.1)


@pytest.mark.parametrize("attr", ["pattern_ns", "segsum_calls"])
def test_readers_read_none_without_counters(monkeypatch, attr):
    run = _run([_call(0.0, 1.0), _call(1.0, 2.0, traced=True)], cell=CELL, k=4,
               summary=_summary({"cub::DeviceSegmentedReduceKernel<float>": 0.01}), chol=2)
    monkeypatch.delattr(sparse, attr)
    reader = {"pattern_ns": "ell_pattern_ms", "segsum_calls": "segsum_roofline"}[attr]
    assert spec.metric(reader).read(run) is None
    monkeypatch.setattr(sparse, attr, 0, raising=False)
    assert spec.metric(reader).read(run) is None


def test_segsum_reads_none_without_a_trace(monkeypatch):
    monkeypatch.setattr(sparse, "segsum_calls", 3)
    run = _run([_call(0.0, 1.0)], cell=CELL, k=4)
    assert spec.metric("segsum_roofline").read(run) is None


def test_ell_pattern_ms_on_a_hand_made_run(monkeypatch):
    monkeypatch.setattr(sparse, "pattern_ns", 6_000_000_000)
    calls = [_call(float(i), float(i) + 1) for i in range(4)] + [_call(4.0, 6.0, traced=True)]
    # five calls of the run and the warm call packed: 6 s over 6
    assert spec.metric("ell_pattern_ms").read(_run(calls, cell=CELL, k=4)) == pytest.approx(1000.0)


def test_segsum_roofline_on_a_hand_made_run(monkeypatch):
    kernel = spec.metric("segsum_roofline").KERNELS[0]
    monkeypatch.setattr(sparse, "segsum_calls", 10)
    monkeypatch.setattr(sparse, "segsum_elems", 10 * 5_000_000)
    monkeypatch.setattr(sparse, "segsum_segments", 10 * 3_000_000)
    summary = _summary({f"void cub::{kernel}<float>(...)": 0.004, "chol_kernel": 0.5, "other": 1.0})
    run = _run([_call(0.0, 1.0), _call(1.0, 3.0, traced=True)], summary=summary, chol=2, cell=CELL, k=4)
    per_call = 0.004 / 2
    bound = (5_000_000 * 4 + 3_000_000 * (8 + 4)) / peaks.BYTES_PER_S
    assert spec.metric("segsum_roofline").read(run) == pytest.approx(100.0 * bound / per_call)


def test_segment_sum_bytes_by_hand():
    # 1,000 float32 contributions read, 100 int64 lengths read, 100 float32 sums written
    assert segment_sum.nbytes(1000, 100, "float32") == 1000 * 4 + 100 * 8 + 100 * 4
    assert segment_sum.nbytes(1000, 100, "float64") == 1000 * 8 + 100 * 8 + 100 * 8
    # at this size the bytes bound the time, not the adds
    assert segment_sum.bound_s(1000, 100, "float32") == pytest.approx(5200 / peaks.BYTES_PER_S)
