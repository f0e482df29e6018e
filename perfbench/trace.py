"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
calls inside the window, and the reduction of its raw events.

The profiler records the host's operations, the CUDA runtime and driver
calls, and every kernel, copy and memset on the device.  The harness
marks the profiled calls with one host range (:data:`WINDOW`), and every
interval here is read from the same trace and clipped to that range.
The raw events are read from the profiler's result
(``prof.profiler.kineto_results``) without building its tree of function
events, which at ~1,600 operations an iteration would take longer than
the run.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Tuple

from torch.autograd import DeviceType

#: the host range around the profiled calls
WINDOW = "perfbench.window"
#: kineto's activity types on the device (torch >= 2.12 names them)
DEVICE_ACTIVITIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
#: the host calls into the CUDA runtime or driver that put an operation on
#: a stream: kernel launches (plain, cooperative, extended), copies,
#: memsets, graph launches
ENQUEUE = re.compile(r"^cu(da)?(Launch\w*|GraphLaunch\w*|Memcpy\w*|Memset\w*)$")
#: what the host was doing where no host operation covers a gap
NO_HOST_OP = "host, outside any op"

_Interval = Tuple[int, int]


@dataclasses.dataclass
class Summary:
    """What the metric readers take from the trace."""

    window_s: float                  # the profiled range, on the trace's clock
    busy_s: float                    # union of device activity within it
    enqueues: int                    # runtime / driver calls that enqueue
    device_ops: int                  # device activity records
    device_time_by_name: Dict[str, float]  # seconds summed per device op name
    idle_by_host: Dict[str, float]   # idle seconds per innermost host op
    longest_gap_s: float


def _union(intervals: List[_Interval]) -> List[_Interval]:
    out: List[_Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_and_gaps(intervals: List[_Interval], lo: int, hi: int):
    """(busy ns, idle gaps) of ``intervals`` clipped to [lo, hi): the
    length of their union and the stretches of [lo, hi) it leaves out."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]
    merged = _union([iv for iv in clipped if iv[1] > iv[0]])
    busy = sum(e - s for s, e in merged)
    gaps, t = [], lo
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return busy, gaps


def label_gaps(gaps: List[_Interval], host_ops: List[Tuple[int, int, str]]) -> Dict[str, float]:
    """Idle seconds summed by the innermost host operation that covers the
    middle of each gap (one sweep over the host operations by start)."""
    ops = sorted(host_ops)
    mids = sorted(((s + e) // 2, e - s) for s, e in gaps)
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, str]] = []  # (end, name) of the ops open at the sweep
    i = 0
    for mid, length in mids:
        while i < len(ops) and ops[i][0] <= mid:
            stack.append((ops[i][1], ops[i][2]))
            i += 1
        # the innermost open op covering ``mid`` is the latest started that has not ended
        while stack and stack[-1][0] <= mid:
            stack.pop()
        covering = next((name for end, name in reversed(stack) if end > mid), NO_HOST_OP)
        out[covering] += length / 1e9
    return dict(out)


def _is_device_activity(e) -> bool:
    """A kernel, copy or memset on the device (not a range that the
    profiler mirrors onto the device's timeline)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_ACTIVITIES
    annotation = getattr(e, "is_user_annotation", None)
    return e.device_type() != DeviceType.CPU and not (annotation and annotation()) \
        and e.name() != WINDOW


def summarize(events) -> Summary:
    """Reduce the profiler's raw events (``kineto_results.events()``).
    Gaps are labelled by the host operations of the thread that opened the
    window range, which is the one that drives the program."""
    window = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not window:
        raise ValueError(f"the trace has no {WINDOW!r} range")
    lo, hi, thread = window[0].start_ns(), window[0].end_ns(), window[0].start_thread_id()
    dev: List[_Interval] = []
    by_name: Dict[str, float] = defaultdict(float)
    host: List[Tuple[int, int, str]] = []
    enqueues = 0
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if _is_device_activity(e):
            if t > lo and s < hi:
                dev.append((s, t))
                by_name[e.name()] += (min(t, hi) - max(s, lo)) / 1e9
        elif e.device_type() == DeviceType.CPU and lo <= s < hi and e.name() != WINDOW:
            if ENQUEUE.match(e.name()):
                enqueues += 1
            if e.start_thread_id() == thread:
                host.append((s, t, e.name()))
    busy, gaps = busy_and_gaps(dev, lo, hi)
    return Summary(
        window_s=(hi - lo) / 1e9,
        busy_s=busy / 1e9,
        enqueues=enqueues,
        device_ops=len(dev),
        device_time_by_name=dict(by_name),
        idle_by_host=label_gaps(gaps, host),
        longest_gap_s=max((e - s for s, e in gaps), default=0) / 1e9,
    )


def top(d: Dict[str, float], n: int = 10, width: int = 96) -> List[list]:
    """The ``n`` largest entries as [name, seconds], names cut to ``width``."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class Capture:
    """``with Capture() as cap: ...`` profiles the block (host and CUDA)
    inside the :data:`WINDOW` range; ``cap.summary`` is set on exit."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events())
        self._prof = None
        return False

