"""The readers of the dense route's upload counters (``pack_upload_mb``,
``pack_uploads``) on hand-made records: None where the program lacks the
counter or it reads 0, and the count over the run's calls and the warm
call otherwise."""

import pytest
from test_perfbench_metrics import _call, _run

from madipm_tpu_torch.parallel import batch
from perfbench import spec

READERS = {"upload_bytes": "pack_upload_mb", "uploads": "pack_uploads"}
DENSE = ["lp_normal.sweep8", "qp_k1.sweep8", "lp_normal.sweep128", "qp_k1.sweep32"]


def _calls():
    # four calls of the window and the profiled one
    return [_call(float(i), float(i) + 1) for i in range(4)] + [_call(4.0, 6.0, traced=True)]


@pytest.mark.parametrize("attr", sorted(READERS))
def test_readers_read_none_without_counters(monkeypatch, attr):
    run = _run(_calls())
    monkeypatch.delattr(batch, attr)
    assert spec.metric(READERS[attr]).read(run) is None
    monkeypatch.setattr(batch, attr, 0, raising=False)
    assert spec.metric(READERS[attr]).read(run) is None


def test_readers_on_a_hand_made_run(monkeypatch):
    # five calls of the run and the warm call packed: 6 calls of two copies
    # and 483 MB each
    monkeypatch.setattr(batch, "upload_bytes", 6 * 483_000_000)
    monkeypatch.setattr(batch, "uploads", 12)
    run = _run(_calls(), cell="lp_normal.sweep128", k=128)
    assert spec.metric("pack_upload_mb").read(run) == pytest.approx(483.0)
    assert spec.metric("pack_uploads").read(run) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(READERS.values()))
def test_reported_in_the_dense_cells(name):
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == name)
    assert entry["layer"] == "parallel.batch packing and upload" and entry["moves"] == "solve_p95_s"
    assert entry["source"] == "program_counter" and entry["workloads"] == DENSE
    assert all(name in {m["name"] for m in spec.cell(c).per_layer} for c in DENSE)
    assert name not in {m["name"] for m in spec.cell("lp_sparse.sweep4").per_layer}
