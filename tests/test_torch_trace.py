"""The program's spans and counters (utils/logging.span, and the counters
of parallel/batch, ops/linalg, models/qp and ops/kkt) on two-instance
16 x 32 batches on the CPU: the spans of one ``madipm_batch`` call and
their nesting, what the counters add up to, nothing recorded with no
profiler, and answers bit-equal with the profiler on and off."""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import madipm_tpu_torch as mtt
from madipm_tpu_torch.models import generators, qp
from madipm_tpu_torch.ops import kkt, linalg
from madipm_tpu_torch.parallel import batch
from madipm_tpu_torch.utils import logging, sync

torch.set_num_threads(2)

#: the options of the benchmark's two configurations (perfbench/configs)
COMMON = dict(tol=1e-8, max_iter=300, print_level=mtt.PrintLevel.ERROR,
              regularization=mtt.FixedRegularization(1e-8, -1e-8), step_rule=mtt.AdaptiveStep(0.99),
              linear_solver=mtt.LinearSolver.CHOLESKY_INV, refinement_steps=12, pcg_adaptive_tol=True,
              product_recurrence=True, mu_balance=0.01)
LP = dict(COMMON, kkt_system=mtt.KKTSystem.NORMAL, factor_dtype="float32", predictor_pcg_budget=0,
          pcg_tol_cap=1e-6, pcg_tol_floor=1e-8)
QP = dict(COMMON, kkt_system=mtt.KKTSystem.CONDENSED, factor_dtype="float64", pcg_tol_cap=1e-9,
          pcg_tol_floor=1e-13)
PAD = 8

#: the enclosing span of each span in one call (None: the call's root)
PARENTS = {
    "madipm.batch": {None},
    "madipm.batch.pack": {"madipm.batch"},
    "madipm.batch.solve": {"madipm.batch"},
    "madipm.batch.unpack": {"madipm.batch"},
    "madipm.ipm.init": {"madipm.batch.solve"},
    "madipm.ipm.cert": {"madipm.batch.solve"},
    "madipm.ipm.iter": {"madipm.batch.solve"},
    "madipm.ipm.termination": {"madipm.ipm.iter"},
    "madipm.ipm.factor": {"madipm.ipm.iter"},
    "madipm.ipm.direction": {"madipm.ipm.iter"},
    "madipm.ipm.step": {"madipm.ipm.iter"},
    "madipm.kkt.assemble": {"madipm.ipm.init", "madipm.ipm.factor"},
    "madipm.kkt.factor": {"madipm.ipm.init", "madipm.ipm.factor"},
    "madipm.kkt.precond": {"madipm.ipm.init", "madipm.ipm.direction", "madipm.linalg.pcg"},
    "madipm.linalg.pcg": {"madipm.ipm.init", "madipm.ipm.direction"},
}
#: a product is taken wherever the solve needs one
PARENTS.update(dict.fromkeys(
    ("madipm.qp.matvec", "madipm.qp.rmatvec", "madipm.qp.qmatvec"),
    {"madipm.batch.solve", "madipm.ipm.init", "madipm.ipm.cert", "madipm.ipm.iter", "madipm.ipm.termination",
     "madipm.ipm.direction", "madipm.ipm.step", "madipm.linalg.pcg"}))


def _models(kind):
    if kind == "lp":
        return generators.make_suite(k=2, m=16, n=32, density=0.3), LP
    return generators.make_qp_suite(k=2, m=16, n=32, density=0.3), QP


def _counters():
    return dict(pack_ns=batch.pack_ns, pcg_trips=linalg.pcg_trips, product_bytes=qp.product_bytes,
                assembly_flops=kkt.assembly_flops, assembly_bytes=kkt.assembly_bytes, syncs=sync.count)


def _spans(prof):
    """(name, start, end) of the program's spans on the host, by start."""
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("madipm.") and e.device_type() == DeviceType.CPU),
                  key=lambda s: (s[1], -s[2]))


def _parents(spans):
    """The innermost enclosing span of each span (one thread: they nest)."""
    out, stack = [], []
    for name, s, e in spans:
        while stack and stack[-1][2] <= s:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


def _answers(stats):
    return [(s.status, s.iter, s.objective, s.solution.tobytes(), s.multipliers.tobytes(),
             s.multipliers_L.tobytes(), s.multipliers_U.tobytes()) for s in stats]


def test_span_records_nothing_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened with no profiler recording")

    monkeypatch.setattr(logging, "_RecordFunctionFast", refuse)
    with logging.span("madipm.test"):
        pass
    assert logging.spanned("madipm.test")(lambda a, b=0: a + b)(1, b=2) == 3


@pytest.mark.parametrize("kind", ["lp", "qp"])
def test_spans_and_counters_of_one_call(kind):
    models, opts = _models(kind)
    before = _counters()
    off = mtt.madipm_batch(models, device="cpu", pad_multiple=PAD, **opts)
    between = _counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = mtt.madipm_batch(models, device="cpu", pad_multiple=PAD, **opts)
    after = _counters()

    assert all(s.success for s in on)
    assert _answers(on) == _answers(off)
    same = [k for k in before if k != "pack_ns"]  # counts, not times: the same in both calls
    assert [between[k] - before[k] for k in same] == [after[k] - between[k] for k in same]

    spans = _spans(prof)
    names = {name for name, _, _ in spans}
    expected = set(PARENTS) - ({"madipm.qp.qmatvec"} if kind == "lp" else set())
    assert names == expected
    for name, parent in _parents(spans):
        assert parent in PARENTS[name], (name, parent)
    assert sum(name == "madipm.batch" for name, _, _ in spans) == 1

    d = {k: after[k] - between[k] for k in after}
    probs, _ = batch.bucket_pad(models, pad_multiple=PAD, device="cpu")
    B, m, n = probs.A.shape
    count = {name: sum(s[0] == name for s in spans) for name in names}
    A_bytes, Q_bytes = 8 * B * m * n, 8 * B * n * n
    assert d["product_bytes"] == (count["madipm.qp.matvec"] + count["madipm.qp.rmatvec"]) * A_bytes \
        + count.get("madipm.qp.qmatvec", 0) * Q_bytes
    assert 0 < d["pcg_trips"] <= d["syncs"]
    assert d["pack_ns"] > 0
    if kind == "lp":  # A D A' in float32: the symmetric half, A read, S written
        flops, out = B * m * (m + 1) * n, 4 * B * m * m
    else:  # A' W A in float64
        flops, out = B * n * (n + 1) * m, 8 * B * n * n
    assert d["assembly_flops"] == count["madipm.kkt.assemble"] * flops
    assert d["assembly_bytes"] == count["madipm.kkt.assemble"] * (A_bytes + out)
