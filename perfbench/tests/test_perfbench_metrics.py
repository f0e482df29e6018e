"""The metric arithmetic on hand-made records: the rate over the window,
the 95th percentile over every call, the idle share from the union of
the device's intervals, and the readers of the trace."""

import pytest

from perfbench import harness, spec, trace


def _call(start, end, solver_time=0.0, iters=(10, 12), statuses=(2, 2), traced=False):
    return harness.Call(start=start, end=end, solver_time=solver_time, iters=list(iters),
                        statuses=list(statuses), scale=1.0, traced=traced)


def _run(calls, syncs=0, summary=None, chol=0, cell="lp_normal.sweep8", k=2):
    return harness.Run(cell=spec.cell(cell), k=k, setup_s=7.5, calls=calls, syncs=syncs,
                       chol_launches_traced=chol, trace=summary, checks={}, correct=True,
                       memory_peak_bytes=0)


def read(name, run):
    return spec.metric(name).read(run)


def test_rate_over_the_window():
    # 3 calls of 2 instances, one failed (status 3: acceptable level counts as failed);
    # the profiled call after the window is not in it
    calls = [_call(10.0, 11.0), _call(11.5, 12.0, statuses=(2, 3)), _call(12.0, 14.0),
             _call(14.0, 30.0, traced=True)]
    assert read("solved_per_s", _run(calls)) == pytest.approx(5 / 4.0)


def test_p95_over_all_calls():
    calls = [_call(float(i), float(i) + w) for i, w in enumerate([1.0] * 19 + [3.0])]
    calls.append(_call(30.0, 90.0, traced=True))
    # linear between order statistics: 95% of the way through 20 walls
    assert read("solve_p95_s", _run(calls)) == pytest.approx(1.0 + 0.05 * 2.0)


def test_setup_and_host_layers():
    calls = [_call(0.0, 1.0, solver_time=0.8, iters=(10, 20)),
             _call(1.0, 2.5, solver_time=1.2, iters=(30, 5)),
             _call(2.5, 9.0, solver_time=0.1, traced=True)]
    run = _run(calls, syncs=300)
    assert read("setup_s", run) == 7.5
    assert read("pack_upload_ms", run) == pytest.approx(1e3 * (0.2 + 0.3) / 2)
    assert read("syncs_per_iter", run) == pytest.approx(300 / (20 + 30 + 12))
    assert read("iters_per_solve", run) == pytest.approx((10 + 20 + 30 + 5 + 10 + 12) / 6)


def test_union_of_intervals():
    busy, gaps = trace.busy_and_gaps([(5, 10), (8, 12), (20, 25), (30, 40)], 0, 35)
    assert busy == 5 + 2 + 5 + 5
    assert gaps == [(0, 5), (12, 20), (25, 30)]


def test_gaps_labelled_by_innermost_host_op():
    host = [(0, 100, "outer"), (10, 30, "inner"), (50, 60, "other")]
    gaps = [(12, 20), (35, 45), (55, 57), (120, 130)]
    labels = trace.label_gaps(gaps, host)
    assert labels == pytest.approx({"inner": 8e-9, "outer": 10e-9, "other": 2e-9,
                                    trace.NO_HOST_OP: 10e-9})


def test_enqueue_names():
    for name in ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                 "cudaLaunchKernelExC", "cudaMemcpyAsync", "cudaMemsetAsync", "cudaGraphLaunch"):
        assert trace.ENQUEUE.match(name), name
    for name in ("cudaStreamSynchronize", "cudaEventRecord", "cudaGetDevice", "aten::mm"):
        assert not trace.ENQUEUE.match(name), name


def _summary(**kw):
    base = dict(window_s=2.0, busy_s=0.5, enqueues=3200, device_ops=3000,
                device_time_by_name={"void chol_kernel<float>(...)": 0.002, "gemv": 0.3},
                idle_by_host={}, longest_gap_s=0.01)
    base.update(kw)
    return trace.Summary(**base)


def test_trace_readers():
    calls = [_call(0.0, 1.0), _call(1.0, 2.0, iters=(20, 16), traced=True)]
    run = _run(calls, summary=_summary(), chol=20, k=8)
    assert read("device_idle_pct", run) == pytest.approx(75.0)
    assert read("enqueues_per_iter", run) == pytest.approx(3200 / 20)
    bound = spec.roofline("chol_inv").bound_s(8, 1024, "float32")
    assert read("chol_inv_roofline", run) == pytest.approx(100 * bound / (0.002 / 20))


def test_trace_readers_read_nothing_without_a_trace():
    run = _run([_call(0.0, 1.0)])
    for name in ("device_idle_pct", "enqueues_per_iter", "chol_inv_roofline"):
        assert read(name, run) is None
    # a trace without the kernel gives no share, never 0
    run = _run([_call(0.0, 1.0, traced=True)], summary=_summary(device_time_by_name={"gemv": 1.0}), chol=3)
    assert read("chol_inv_roofline", run) is None


@pytest.mark.parametrize("cell, shape", [("lp_normal.sweep8", (8, 1024, "float32")),
                                         ("qp_k1.sweep32", (32, 1024, "float64"))])
def test_factor_shape_from_the_configuration(cell, shape):
    mod = spec.metric("chol_inv_roofline")
    run = _run([_call(0.0, 1.0)], cell=cell, k=shape[0])
    assert mod.factor_shape(run) == shape


class _Event:
    """A raw profiler event of torch 2.11 (no ``activity_type``)."""

    def __init__(self, name, kind, start, end, thread=1):
        self._v = (name, kind, start, end, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        from torch.autograd import DeviceType

        on_device = self._v[1] in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
        return DeviceType.CUDA if on_device else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[1] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


class _NewerEvent(_Event):
    """A raw profiler event of a torch that names its activity type."""

    def activity_type(self):
        return self._v[1]


@pytest.mark.parametrize("_Event", [_Event, _NewerEvent], ids=["torch-2.11", "torch-2.12"])
def test_summarize_raw_events(_Event):
    events = [
        _Event(trace.WINDOW, "user_annotation", 100, 1100),
        _Event("aten::mm", "cpu_op", 150, 400),
        _Event("cudaLaunchKernel", "cuda_runtime", 160, 170),
        _Event("cudaMemcpyAsync", "cuda_runtime", 500, 510),
        _Event("cudaStreamSynchronize", "cuda_runtime", 520, 1000),
        _Event("gemm", "kernel", 200, 600),
        _Event("copy", "gpu_memcpy", 550, 700),
        _Event("early", "kernel", 0, 150),       # clipped to the window
        _Event("gpu range", "gpu_user_annotation", 100, 1100),  # not device work
        _Event("cudaLaunchKernel", "cuda_runtime", 2000, 2010),  # outside the window
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx((150 - 100 + 700 - 200) * 1e-9)
    assert s.enqueues == 2 and s.device_ops == 3
    assert s.device_time_by_name["early"] == pytest.approx(50e-9)
    assert s.longest_gap_s == pytest.approx(400e-9)
    assert sum(s.idle_by_host.values()) == pytest.approx(s.window_s - s.busy_s)
    assert s.idle_by_host == pytest.approx({"aten::mm": 50e-9, "cudaStreamSynchronize": 400e-9})
