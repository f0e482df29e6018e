"""Readings that the limits of ``perfbench/limits/<cell>.json`` are set
from, on the card, many seeds in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds <a,b,...> [--seconds 3]
                                   [--control program|reference]

For each seed it runs the cell as ``perfbench.run`` does (set-up, a short
window at the cell's own load, the comparison with the reference on as
many instances as a run compares) and prints one JSON line: the numbers,
the calls, their walls and batch iterations.  A control, which the
comparison has to find not correct, runs one precision below the float64
that the configurations state: ``--control program`` is the program's own
path in float32 (the configuration's ``control`` group), ``--control
reference`` the plain reference put in the program's place, computed in
float32 with TF32 off.  The benchmark's runs never run either.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types

from . import harness, spec
from .reference import ipm, judge

#: the float32 reference's stopping tolerance: what float32 reaches
REFERENCE_CONTROL_TOL = 1e-6


def reference_control(device: str):
    """A stand-in for the program's call: the plain reference in float32
    (TF32 off) on the instances the call was given, answering as the
    program does; an instance counts as solved where the reference met
    :data:`REFERENCE_CONTROL_TOL`."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def solve(models):
        raw = [dict(c=q.c, A=q.A.toarray(), lcon=q.lcon, ucon=q.ucon, lvar=q.lvar, uvar=q.uvar,
                    Q=None if q.Q is None else q.Q.toarray()) for q in models]
        t0 = time.perf_counter()
        sol = ipm.solve(ipm.Batch.from_instances(raw, [1.0] * len(raw), device, dtype=torch.float32),
                        tol=REFERENCE_CONTROL_TOL)
        if device.startswith("cuda"):
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        as_np = lambda t, i: t[i].double().cpu().numpy()
        return [types.SimpleNamespace(
            status=judge.SOLVE_SUCCEEDED if bool(sol.solved[i]) else 6, objective=float(sol.objective[i]),
            solution=as_np(sol.x, i), multipliers=as_np(sol.y, i), multipliers_L=as_np(sol.zl, i),
            multipliers_U=as_np(sol.zu, i), iter=int(sol.iterations[i]), solver_time=wall)
            for i in range(len(models))]
    return solve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("program", "reference"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    solve = reference_control("cuda") if args.control == "reference" else None
    log = lambda msg: print(msg, file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.run(cell, seed=seed, seconds=args.seconds, traced=False, device="cuda",
                          t_start=t0, control=args.control == "program", solve=solve, log=log)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control, "correct": run.correct,
            "checks": {name: v for name, (v, _) in run.checks.items()},
            "calls": len(run.calls),
            "walls": [c.end - c.start for c in run.calls],
            "batch_iters": [max(c.iters) for c in run.calls],
            "statuses": sorted(set(s for c in run.calls for s in c.statuses)),
            "setup_s": run.setup_s, "seconds": time.perf_counter() - t0,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
