"""The reduction of a profiled call by the program's spans
(``perfbench/spans.py``) on hand-made raw events, in the forms of
torch 2.11 and 2.12, and the five readings on hand-made records."""

import pytest
from test_perfbench_metrics import _Event as _BareEvent
from test_perfbench_metrics import _call, _run

from perfbench import spans, spec, trace
from perfbench.roofline import peaks


class _Event(_BareEvent):
    """A raw event of torch 2.11 with its correlation id."""

    def __init__(self, name, kind, start, end, thread=1, corr=0):
        super().__init__(name, kind, start, end, thread)
        self._corr = corr

    def correlation_id(self):
        return self._corr


class _NewerEvent(_Event):
    def activity_type(self):
        return self._v[1]


def _events(E):
    # the program's spans are host ranges (``cpu_op``); the window is a ``record_function``
    return [
        E(trace.WINDOW, "user_annotation", 0, 1000),
        E("madipm.batch", "cpu_op", 10, 990),
        E("madipm.batch.pack", "cpu_op", 20, 100),
        E("madipm.batch.solve", "cpu_op", 100, 900),
        E("madipm.ipm.iter", "cpu_op", 200, 800),
        E("madipm.qp.matvec", "cpu_op", 300, 400),
        E("madipm.kkt.assemble", "cpu_op", 500, 600),
        E("madipm.other.thread", "cpu_op", 300, 700, thread=2),
        E("aten::bmm", "cpu_op", 340, 380),
        E("cudaLaunchKernel", "cuda_runtime", 5, 6, corr=5),         # before any span
        E("cudaMemcpyAsync", "cuda_runtime", 50, 55, corr=1),        # packing
        E("cudaLaunchKernel", "cuda_runtime", 350, 352, corr=2),     # in the product, in the iteration
        E("cudaLaunchKernel", "cuda_runtime", 550, 552, corr=3),     # the assembly
        E("cudaLaunchKernel", "cuda_runtime", 700, 702, corr=4),     # the iteration
        E("early", "kernel", 8, 15, corr=5),
        E("upload", "gpu_memcpy", 60, 120, corr=1),
        E("gemv", "kernel", 360, 420, corr=2),                       # runs on past the product's span
        E("gemm", "kernel", 560, 650, corr=3),
        E("late", "kernel", 850, 950, corr=4),                       # past the solve's end
        E("unlinked", "kernel", 960, 1100, corr=99),                 # clipped to the window
        E("madipm.qp.matvec", "gpu_user_annotation", 360, 420),      # a range mirrored on the device: no work
    ]


FORMS = pytest.mark.parametrize("E", [_Event, _NewerEvent], ids=["torch-2.11", "torch-2.12"])


@FORMS
def test_attribution_sums_to_the_device_time(E):
    events = _events(E)
    s = spans.attribute(events)
    assert s.device_s == pytest.approx({
        "madipm.batch.pack": 60e-9, "madipm.qp.matvec": 60e-9, "madipm.kkt.assemble": 90e-9,
        "madipm.ipm.iter": 100e-9, spans.OUTSIDE: (7 + 40) * 1e-9})
    assert sum(s.device_s.values()) == pytest.approx(sum(trace.summarize(events).device_time_by_name.values()))
    assert s.count == {name: 1 for name in ("madipm.batch", "madipm.batch.pack", "madipm.batch.solve",
                                            "madipm.ipm.iter", "madipm.qp.matvec", "madipm.kkt.assemble")}


@FORMS
def test_the_product_inside_the_iteration_takes_its_kernel(E):
    # without the assembly's span its kernel goes to the iteration around it
    s = spans.attribute([e for e in _events(E) if e.name() != "madipm.kkt.assemble"])
    assert s.device_s["madipm.qp.matvec"] == pytest.approx(60e-9)
    assert s.device_s["madipm.ipm.iter"] == pytest.approx((90 + 100) * 1e-9)
    assert "madipm.batch.solve" not in s.device_s
    assert "madipm.other.thread" not in s.device_s and "madipm.other.thread" not in s.count


@FORMS
def test_busy_inside_the_solve_is_clipped_to_it(E):
    s = spans.attribute(_events(E))
    assert s.solve_s == pytest.approx(800e-9)
    # the upload from 100, the gemv, the gemm, the late kernel until 900
    assert s.solve_busy_s == pytest.approx((20 + 60 + 90 + 50) * 1e-9)


@FORMS
def test_a_spans_mirror_on_the_device_is_no_work(E):
    events = _events(E)
    mirror = next(e for e in events if e.name() == "madipm.qp.matvec" and e.device_type() != trace.DeviceType.CPU)
    assert not trace._is_device_activity(mirror)
    assert not any(name.startswith("madipm.") for name in trace.summarize(events).device_time_by_name)


def test_innermost_of_nested_ranges():
    ranges = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 70, "d")]
    assert spans.innermost([5, 25, 40, 55, 65, 100, 200], ranges) == ["a", "c", "b", "a", "d", None, None]


def _span_run(counters, traced, span_summary, cell="lp_normal.sweep8"):
    calls = [_call(0.0, 1.0, iters=(10, 12)), _call(1.0, 2.0, iters=(20, 16))]
    return spans.SpanRun(run=_run(calls, cell=cell), counters=counters, counters_traced=traced,
                         spans=span_summary)


def test_readings():
    counters = dict(pack_ns=3_000_000, pcg_trips=320)
    traced = dict(product_bytes=10**9, assembly_flops=4 * 10**12, assembly_bytes=10**9)
    s = spans.attribute(_events(_NewerEvent))
    r = _span_run(counters, traced, s)
    read = {name: fn(r) for name, (_, fn) in spans.READINGS.items()}
    assert read["pack_ms"] == pytest.approx(1.5)
    assert read["pcg_trips_per_iter"] == pytest.approx(320 / (12 + 20))
    assert read["solve_idle_pct"] == pytest.approx(100 * (1 - 220 / 800))
    assert read["matvec_roofline"] == pytest.approx(100 * (1e9 / peaks.BYTES_PER_S) / 60e-9)
    bound = max(4e12 / peaks.FLOPS["float32"], 1e9 / peaks.BYTES_PER_S)
    assert read["assembly_roofline"] == pytest.approx(100 * bound / 90e-9)
    assert spec.cell("lp_normal.sweep8").config["options"]["factor_dtype"] == "float32"


def test_readings_read_nothing_without_counters_or_spans():
    none = dict.fromkeys(spans.COUNTERS)
    r = _span_run(none, none, spans.attribute([_Event(trace.WINDOW, "user_annotation", 0, 10)]))
    assert all(fn(r) is None for _, fn in spans.READINGS.values())
    r = _span_run(dict(pack_ns=1, pcg_trips=1), dict(product_bytes=1, assembly_flops=1, assembly_bytes=1),
                  None)
    assert spans.solve_idle_pct(r) is None and spans.matvec_roofline(r) is None
    assert spans.assembly_roofline(r) is None


def test_the_programs_counters():
    c = spans.counters()
    assert set(c) == set(spans.COUNTERS) and all(isinstance(v, int) for v in c.values())
    assert spans.delta(dict(a=5, b=None), dict(a=2, b=None)) == dict(a=3, b=None)
