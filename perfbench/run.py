"""Run one cell of the benchmark of ``madipm_tpu_torch`` on the card.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the cell (``harness.run``),
measures for ``--seconds``, checks the answers against the plain
reference, and prints as the last line of its standard output one JSON
object: ``correct``, ``attempted`` and ``failed`` (instances), ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number with its limit.  The compared numbers
are also the last lines of its standard error.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; with jax, jaxlib, flax or ``madipm_tpu`` loaded
once the window has closed, with 3.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import harness, spec  # noqa: E402
from . import trace as trace_mod  # noqa: E402


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_limits() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def metrics_of(run: harness.Run, entries) -> dict:
    out = {}
    for m in entries:
        value = spec.metric(m["name"]).read(run)
        if value is not None:
            if not math.isfinite(value):
                raise ValueError(f"metric {m['name']} read {value}")
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result(run: harness.Run, traced: bool, kind: str) -> dict:
    calls = run.calls
    attempted = len(calls) * run.k
    solved = sum(s == harness.judge.SOLVE_SUCCEEDED for c in calls for s in c.statuses)
    device = {"platform": "gpu", "kind": kind, "count": run.cell.chips,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": run.correct, "attempted": attempted, "failed": attempted - solved,
           "metrics": metrics_of(run, run.cell.per_layer if traced else run.cell.end_to_end),
           "device": device}
    if traced:
        t = run.trace
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": trace_mod.top(t.device_time_by_name),
                            "idle_gaps": trace_mod.top(t.idle_by_host)}
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _err(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result")
        return 2
    kind = torch.cuda.get_device_name(0)
    _err(f"perfbench: card {card_limits()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    run = harness.run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                      device="cuda", t_start=_T_START, log=_err)
    found = harness.loaded_forbidden()
    if found:
        _err(f"perfbench: the process loaded {found} (forbidden by whole top-level name); no result")
        return 3
    if args.trace:
        t = run.trace
        _err(f"perfbench: traced {len(run.traced_calls)} call(s): window {t.window_s:.6f} s, device busy "
             f"{t.busy_s:.6f} s, {t.device_ops} device operations, {t.enqueues} enqueue calls, "
             f"{run.chol_launches_traced} chol_inv launches, longest gap {t.longest_gap_s:.6f} s")
    line = json.dumps(result(run, bool(args.trace), kind))
    for name, (value, limit) in run.checks.items():
        _err(f"check {name} {value!r} limit {limit!r}")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
