"""The program's own spans and counters in a cell's run: where the device
time of a profiled call goes by the innermost ``madipm.`` span, and the
five per-layer readings that rest on the spans and counters of
``madipm_tpu_torch`` (:data:`READINGS`).

    python3 -m perfbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``perfbench.run --trace 1`` does: set-up, the window of
timed calls, the comparison with the reference; then one warm call and
one profiled call on the last call's instances.  It prints one JSON line:
``correct``, the cell's per-layer metrics read from that profiled call
(``metrics``), the five readings (``spans``), the device seconds by span
(``device_s_by_span``), each span's count, and the breakdown of
``perfbench.run``.  The harness (``harness.Run``, ``trace.Summary``) keeps
neither the counters nor the raw events, so the readings are not in a
``perfbench.run`` line; the counters are read around each call through
``harness.run``'s ``solve`` argument.

Device time is put down to the span open on the driving thread (the one
that opened ``trace.WINDOW``) when the operation was enqueued: each
kernel, copy or memset is linked by its correlation id to the runtime or
driver call that put it on a stream (``trace.ENQUEUE``), and goes to the
innermost ``madipm.`` span around that call, or to :data:`OUTSIDE`.  A
CUDA graph replayed under one span puts all its kernels there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

from . import harness, spec
from . import trace as trace_mod
from .roofline import peaks

#: the prefix of the program's span names
PREFIX = "madipm."
#: the span of one call's solve, between its two device synchronisations
SOLVE = "madipm.batch.solve"
#: the spans of the fp64 products and of the assembly product
PRODUCTS = ("madipm.qp.matvec", "madipm.qp.rmatvec", "madipm.qp.qmatvec")
ASSEMBLE = "madipm.kkt.assemble"
#: device time enqueued outside any program span
OUTSIDE = "outside any span"
#: the program's counters: (module of madipm_tpu_torch, attribute)
COUNTERS = {
    "pack_ns": ("parallel.batch", "pack_ns"),
    "pcg_trips": ("ops.linalg", "pcg_trips"),
    "product_bytes": ("models.qp", "product_bytes"),
    "assembly_flops": ("ops.kkt", "assembly_flops"),
    "assembly_bytes": ("ops.kkt", "assembly_bytes"),
    "syncs": ("utils.sync", "count"),
    "chol_launches": ("ops.chol_inv", "launches"),
}


@dataclasses.dataclass
class Spans:
    """What the readings take from the profiled call's trace."""

    device_s: Dict[str, float]   # device seconds by innermost span at enqueue, OUTSIDE included
    count: Dict[str, int]        # occurrences of each span
    solve_s: float               # host length of the SOLVE spans
    solve_busy_s: float          # union of device activity inside them


def counters() -> Dict[str, Optional[int]]:
    """The program's counters now; None for one the program lacks."""
    import importlib

    out = {}
    for key, (module, name) in COUNTERS.items():
        out[key] = getattr(importlib.import_module(f"madipm_tpu_torch.{module}"), name, None)
    return out


def delta(after: dict, before: dict) -> Dict[str, Optional[int]]:
    return {k: None if after[k] is None or before[k] is None else after[k] - before[k] for k in after}


def innermost(points: List[int], ranges: List[Tuple[int, int, str]]) -> List[Optional[str]]:
    """For each time in ``points``, the name of the innermost of the
    nested ``ranges`` (start, end, name) open at it, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out: List[Optional[str]] = [None] * len(points)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while i < len(ranges) and ranges[i][0] <= t:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] <= t:  # nested: an ended range is above the open ones
            stack.pop()
        out[j] = stack[-1][2] if stack else None
    return out


def attribute(events) -> Spans:
    """Reduce the raw events (``kineto_results.events()``) of a profiled
    call made inside ``trace.WINDOW``, as ``trace.summarize`` does: device
    intervals clipped to the window."""
    window = [e for e in events if e.name() == trace_mod.WINDOW and e.device_type() == DeviceType.CPU]
    if not window:
        raise ValueError(f"the trace has no {trace_mod.WINDOW!r} range")
    lo, hi, thread = window[0].start_ns(), window[0].end_ns(), window[0].start_thread_id()
    spans: List[Tuple[int, int, str]] = []
    enqueued: Dict[int, int] = {}
    dev: List[Tuple[int, int, int]] = []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if trace_mod._is_device_activity(e):
            if t > lo and s < hi:
                dev.append((max(s, lo), min(t, hi), e.correlation_id()))
        elif e.device_type() == DeviceType.CPU and lo <= s < hi:
            if e.name().startswith(PREFIX) and e.start_thread_id() == thread:
                spans.append((s, t, e.name()))
            elif trace_mod.ENQUEUE.match(e.name()):
                enqueued[e.correlation_id()] = s
    device_s: Dict[str, float] = defaultdict(float)
    linked = [i for i, (_, _, c) in enumerate(dev) if c in enqueued]
    names = innermost([enqueued[dev[i][2]] for i in linked], spans)
    owner = dict(zip(linked, names))
    for i, (s, t, _) in enumerate(dev):
        device_s[owner.get(i) or OUTSIDE] += (t - s) / 1e9
    intervals = [(s, t) for s, t, _ in dev]
    solves = [(s, t) for s, t, name in spans if name == SOLVE]
    return Spans(
        device_s=dict(device_s),
        count=dict(Counter(name for _, _, name in spans)),
        solve_s=sum(t - s for s, t in solves) / 1e9,
        solve_busy_s=sum(trace_mod.busy_and_gaps(intervals, s, t)[0] for s, t in solves) / 1e9,
    )


@dataclasses.dataclass
class SpanRun:
    """A run's records with the program's counters and spans."""

    run: harness.Run
    counters: Dict[str, Optional[int]]         # over the window's calls
    counters_traced: Dict[str, Optional[int]]  # over the profiled call
    spans: Optional[Spans]


def pack_ms(r: SpanRun) -> Optional[float]:
    """Host time of ``madipm.batch.pack`` per timed call (``pack_ns``)."""
    calls = r.run.timed_calls
    if r.counters["pack_ns"] is None or not calls:
        return None
    return r.counters["pack_ns"] / 1e6 / len(calls)


def solve_idle_pct(r: SpanRun) -> Optional[float]:
    """The device's idle share inside ``madipm.batch.solve``, profiled call."""
    if r.spans is None or r.spans.solve_s <= 0:
        return None
    return 100.0 * (1.0 - r.spans.solve_busy_s / r.spans.solve_s)


def pcg_trips_per_iter(r: SpanRun) -> Optional[float]:
    """Trips of the fp64 PCG per batch iteration over the timed calls."""
    iters = sum(max(c.iters) for c in r.run.timed_calls)
    if r.counters["pcg_trips"] is None or not iters:
        return None
    return r.counters["pcg_trips"] / iters


def matvec_roofline(r: SpanRun) -> Optional[float]:
    """The fp64 products' share of their bytes bound: the profiled call's
    ``product_bytes`` at the card's bandwidth over the device time under
    the three ``madipm.qp.*`` spans."""
    nbytes = r.counters_traced["product_bytes"]
    device_s = sum(r.spans.device_s.get(name, 0.0) for name in PRODUCTS) if r.spans else 0.0
    if not nbytes or device_s <= 0:
        return None
    return 100.0 * (nbytes / peaks.BYTES_PER_S) / device_s


def assembly_roofline(r: SpanRun) -> Optional[float]:
    """The assembly product's share of its bound (``assembly_flops`` at the
    factor dtype's peak, ``assembly_bytes`` at the bandwidth, the larger)
    over the device time under ``madipm.kkt.assemble``."""
    flops, nbytes = r.counters_traced["assembly_flops"], r.counters_traced["assembly_bytes"]
    device_s = r.spans.device_s.get(ASSEMBLE, 0.0) if r.spans else 0.0
    if not flops or not nbytes or device_s <= 0:
        return None
    dtype = r.run.cell.config["options"]["factor_dtype"]
    return 100.0 * peaks.bound_s(flops, nbytes, dtype) / device_s


#: name -> (unit, reader)
READINGS = {
    "pack_ms": ("ms", pack_ms),
    "solve_idle_pct": ("%", solve_idle_pct),
    "pcg_trips_per_iter": ("trips/iter", pcg_trips_per_iter),
    "matvec_roofline": ("%", matvec_roofline),
    "assembly_roofline": ("%", assembly_roofline),
}


class _Kept(trace_mod.Capture):
    """``trace.Capture`` that keeps the raw events (``self.events``)."""

    def __exit__(self, *exc):
        prof = self._prof
        out = super().__exit__(*exc)
        if exc[0] is None:
            self.events = prof.profiler.kineto_results.events()
        return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    import madipm_tpu_torch as mtt

    from . import run as run_mod

    if not torch.cuda.is_available():
        print("perfbench.spans: needs a CUDA device; no result", file=sys.stderr)
        return 2
    call_args = harness.call_arguments(cell.config, mtt)
    per_call: List[dict] = []
    last: dict = {}

    def solve(models):
        last["models"] = models
        before = counters()
        stats = mtt.madipm_batch(models, device="cuda", **call_args)
        per_call.append(delta(counters(), before))
        return stats

    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    log(f"perfbench.spans: card {run_mod.card_limits()}; torch {torch.__version__}")
    run = harness.run(cell, seed=args.seed, seconds=args.seconds, traced=False, device="cuda",
                      t_start=t_start, solve=solve, log=log)
    # per_call[0] is the warm call
    window = {k: None if v is None else sum(c[k] for c in per_call[1:]) for k, v in per_call[1].items()}

    models = last.pop("models")
    solve(models)  # the allocator warm again after the comparison
    with _Kept() as cap:
        t0 = time.perf_counter()
        stats = solve(models)
        t1 = time.perf_counter()
    traced = per_call[-1]
    call = harness.Call(start=t0, end=t1, solver_time=float(stats[0].solver_time),
                        iters=[int(s.iter) for s in stats], statuses=[int(s.status) for s in stats],
                        scale=1.0, traced=True)
    full = dataclasses.replace(run, calls=run.calls + [call], trace=cap.summary,
                               syncs=run.syncs + traced["syncs"],
                               chol_launches_traced=traced["chol_launches"] or 0)
    spans = attribute(cap.events)
    r = SpanRun(run=full, counters=window, counters_traced=traced, spans=spans)
    readings = {}
    for name, (unit, read) in READINGS.items():
        value = read(r)
        if value is not None and math.isfinite(value):
            readings[name] = {"value": value, "unit": unit}
    t = cap.summary
    out = {
        "cell": cell.name, "seed": args.seed, "correct": run.correct,
        "metrics": run_mod.metrics_of(full, cell.per_layer),
        "spans": readings,
        "batch_iterations": max(call.iters),
        "device_time_s": sum(t.device_time_by_name.values()), "busy_s": t.busy_s, "window_s": t.window_s,
        "device_s_by_span": dict(sorted(spans.device_s.items(), key=lambda kv: -kv[1])),
        "span_count": spans.count,
        "solve": {"length_s": spans.solve_s, "busy_s": spans.solve_busy_s},
        "counters_window": window, "counters_traced": traced,
        "breakdown": {"device_ops": trace_mod.top(t.device_time_by_name),
                      "idle_gaps": trace_mod.top(t.idle_by_host)},
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
