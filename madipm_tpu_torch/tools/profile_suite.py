"""Where the time of one batched solve goes on the GPU.

    python3 -m madipm_tpu_torch.tools.profile_suite [--suite lp|qp|qp_k2|sparse_lp] [--runs 3]

Solves a bench suite with ``madipm_batch`` (a warm run, then ``--runs``
timed runs on the rhs scaled by 1 + 1e-4 r), then one more run under
``torch.profiler`` and prints: the walls, iterations, host syncs, kernel
launches per batch iteration, the device's busy share of the best wall
and the device time by kernel name.  Suites: ``lp`` (8 LPs, m=1024,
n=2048, NORMAL, fp32 CHOLESKY_INV + fp64 PCG), ``qp`` (8 QPs, m=512,
n=1024, K1 CONDENSED, fp64 CHOLESKY_INV + PCG), ``qp_k2`` (4 QPs, m=256,
n=512, AUGMENTED + LDL), ``sparse_lp`` (4 LPs, m=2048, n=32768, density
0.004, the ELL route with ``lp``'s options).  It needs a CUDA device and prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys

import torch

import madipm_tpu_torch as mtt
from madipm_tpu_torch.models.generators import make_qp_suite, make_suite
from madipm_tpu_torch.ops import chol_inv
from madipm_tpu_torch.utils import sync

_BASE = dict(tol=1e-8, max_iter=300, print_level=mtt.PrintLevel.ERROR)


def _suite(name: str):
    """(models, options) of a named suite."""
    base = dict(_BASE, regularization=mtt.FixedRegularization(1e-8, -1e-8))
    lp_options = dict(
        base, linear_solver=mtt.LinearSolver.CHOLESKY_INV, factor_dtype="float32",
        refinement_steps=12, pcg_adaptive_tol=True, predictor_pcg_budget=0,
        pcg_tol_cap=1e-6, pcg_tol_floor=1e-8,
    )
    if name == "lp":
        return make_suite(k=8, n=2048, m=1024, density=0.15), lp_options
    if name == "sparse_lp":
        return make_suite(k=4, n=32768, m=2048, density=0.004), dict(lp_options, sparse=True)
    if name == "qp":
        return make_qp_suite(k=8, m=512, n=1024, density=0.15), dict(
            base, kkt_system=mtt.KKTSystem.CONDENSED, linear_solver=mtt.LinearSolver.CHOLESKY_INV,
            factor_dtype="float64", refinement_steps=12, pcg_adaptive_tol=True,
        )
    if name == "qp_k2":
        return make_qp_suite(k=4, m=256, n=512, density=0.15), dict(
            base, kkt_system=mtt.KKTSystem.AUGMENTED,
        )
    raise ValueError(f"unknown suite {name!r}")


def _scaled(models, r: int):
    f = 1 + 1e-4 * r
    return [dataclasses.replace(q, lcon=q.lcon * f, ucon=q.ucon * f) for q in models]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--suite", default="qp", choices=("lp", "qp", "qp_k2", "sparse_lp"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_suite: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    models, options = _suite(args.suite)
    k = len(models)
    mtt.madipm_batch(models, device="cuda", **options)  # warm: builds the kernels
    walls = []
    for r in range(1, args.runs + 1):
        chol_inv.launches = chol_inv.cholesky_launches = sync.count = 0
        stats = mtt.madipm_batch(_scaled(models, r), device="cuda", **options)
        iters = [s.iter for s in stats]
        walls.append(stats[0].solver_time)
        print(f"{args.suite} run {r}: {sum(s.success for s in stats)}/{k} solved, iterations {iters}, "
              f"wall {walls[-1]:.4f} s, {sum(iters) / walls[-1]:.2f} iter/s, "
              f"{sync.count / max(iters):.2f} syncs per batch iteration, "
              f"chol_inv launches {chol_inv.launches}, cholesky launches {chol_inv.cholesky_launches}",
              flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats = mtt.madipm_batch(_scaled(models, args.runs + 1), device="cuda", **options)
    trips = max(s.iter for s in stats)
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"profiled run: wall {stats[0].solver_time:.4f} s (profiler on), {trips} batch iterations, "
          f"{launches} device kernels and copies ({launches / trips:.0f} per batch iteration), "
          f"device busy {busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / min(walls):.1f}% of the best "
          f"unprofiled wall {min(walls):.4f} s", flush=True)
    if busy_us == 0:
        print("profile_suite: the profiler recorded no device time", file=sys.stderr)
        return 1
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:14]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {100 * e.self_device_time_total / busy_us:5.1f}% "
              f"{e.count:7d} x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
