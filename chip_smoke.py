#!/usr/bin/env python3
"""Smoke test of madipm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs, in order, and fails (non-zero exit) at the first phase that fails:

1. the device: a CUDA device must be present (no CPU fallback); prints its
   name and ``nvidia-smi``'s name and power limit;
2. the build: compiles the chol_inv kernel from ``madipm_tpu_torch/csrc``;
3. the kernel against its plain torch version on the card, at the main
   path's shape (B=8, N=1024) and at (3, 256), in fp32 and fp64, with both
   times; an indefinite matrix must come back non-finite;
4. the main path: ``madipm_batch`` on the bench suite (8 LPs, m=1024,
   n=2048, density 0.15) with the accelerator options; one warm run, then
   a timed run on the rhs scaled by 1+1e-4, which must solve 8/8 through
   the kernel;
5. the certificate: four known-optimum LPs at 1024 x 2048 through
   ``madipm``, each to rel-KKT <= 1e-8.

The last two lines are the kernel table and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

import madipm_tpu_torch as mtt
from madipm_tpu_torch.models.generators import known_optimum_lp, make_suite
from madipm_tpu_torch.ops import block_chol, chol_inv
from madipm_tpu_torch.utils import sync

#: (L, Linv) agreement of kernel and plain version, relative to max |.|
KERNEL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}

#: bench.py's accelerator options, without ozaki_slices (matvecs are native fp64)
BENCH_OPTIONS = dict(
    tol=1e-8,
    max_iter=300,
    regularization=mtt.FixedRegularization(1e-8, -1e-8),
    print_level=mtt.PrintLevel.ERROR,
    linear_solver=mtt.LinearSolver.CHOLESKY_INV,
    factor_dtype="float32",
    refinement_steps=12,
    pcg_adaptive_tol=True,
    predictor_pcg_budget=0,
    pcg_tol_cap=1e-6,
    pcg_tol_floor=1e-8,
)

#: scripts/run_known_optimum.py's accelerator options
CERT_OPTIONS = dict(
    tol=1e-8,
    max_iter=300,
    regularization=mtt.FixedRegularization(1e-8, -1e-8),
    print_level=mtt.PrintLevel.ERROR,
    linear_solver=mtt.LinearSolver.CHOLESKY_INV,
    factor_dtype="float32",
    refinement_steps=12,
    pcg_adaptive_tol=True,
    predictor_pcg_budget=0,
)


def log(msg: str):
    print(msg, flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the current stream (after a warm call)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_spd(batch: int, n: int, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    G = torch.randn(batch, n, n, generator=gen, device="cuda", dtype=torch.float64)
    S = G @ G.mT / n + 0.1 * torch.eye(n, device="cuda", dtype=torch.float64)
    return S.to(dtype).contiguous()


def phase_kernel() -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = chol_inv.launches
    row = {}
    for batch, n in ((8, 1024), (3, 256)):
        for dtype in (torch.float32, torch.float64):
            S = random_spd(batch, n, dtype, gen)
            L, W = chol_inv.chol_inv(S)
            Lp, Wp = block_chol.chol_inv(S)
            torch.cuda.synchronize()
            err_L = float((L - Lp).abs().max() / Lp.abs().max())
            err_W = float((W - Wp).abs().max() / Wp.abs().max())
            eye = torch.eye(n, device="cuda", dtype=dtype)
            err_I = float((W @ L - eye).abs().max())
            tol = KERNEL_TOL[dtype]
            ms = cuda_ms(lambda: chol_inv.chol_inv(S), reps=10)
            plain_ms = cuda_ms(lambda: block_chol.chol_inv(S), reps=3)
            log(f"kernel B={batch} N={n} {str(dtype)[6:]}: rel err L {err_L:.3e}, "
                f"Linv {err_W:.3e}, |Linv L - I| {err_I:.3e} (tol {tol:g}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            check(err_L <= tol and err_W <= tol and err_I <= tol,
                  f"kernel disagrees with the plain version at B={batch} N={n} {dtype}")
            if (batch, n, dtype) == (8, 1024, torch.float32):  # the main path's shape
                row = dict(
                    max_abs_err=float(max((L - Lp).abs().max(), (W - Wp).abs().max())),
                    ms=ms, plain_ms=plain_ms,
                )
    for dtype in (torch.float32, torch.float64):
        L, W = chol_inv.chol_inv(-torch.eye(256, device="cuda", dtype=dtype))
        check(not bool(torch.isfinite(L).all()), f"indefinite S gave a finite factor ({dtype})")
    check(chol_inv.launches > before, "the launch counter did not rise")
    return row


def rel_kkt(qp, st) -> float:
    """Relative KKT residual of a returned primal-dual point
    (scripts/run_known_optimum.py)."""
    x, y, zl, zu = st.solution, st.multipliers, st.multipliers_L, st.multipliers_U
    A = qp.A
    r_p = np.max(np.abs(A @ x - qp.lcon)) / max(1.0, np.max(np.abs(qp.lcon)))
    r_d = np.max(np.abs(qp.c + A.T @ y - zl + zu)) / max(1.0, np.max(np.abs(qp.c)))
    sl = np.where(np.isfinite(qp.lvar), x - qp.lvar, 0.0)
    su = np.where(np.isfinite(qp.uvar), qp.uvar - x, 0.0)
    compl = max(np.max(np.abs(sl * zl)), np.max(np.abs(su * zu))) / max(1.0, np.max(np.abs(qp.c)))
    return max(float(r_p), float(r_d), float(compl))


def phase_main_path(device, k=8, m=1024, n=2048, density=0.15) -> dict:
    models = make_suite(k=k, n=n, m=m, density=density)
    warm = mtt.madipm_batch(models, device=device, **BENCH_OPTIONS)
    log(f"main path warm run: {sum(s.success for s in warm)}/{k} solved, "
        f"iters {[s.iter for s in warm]}, {warm[0].solver_time:.3f} s")
    scaled = [dataclasses.replace(q, lcon=q.lcon * (1 + 1e-4), ucon=q.ucon * (1 + 1e-4))
              for q in models]
    chol_inv.launches = 0
    sync.count = 0
    stats = mtt.madipm_batch(scaled, device=device, **BENCH_OPTIONS)
    launches, syncs = chol_inv.launches, sync.count
    iters = [s.iter for s in stats]
    wall = stats[0].solver_time
    kkt = [rel_kkt(q, s) for q, s in zip(scaled, stats)]
    log(f"main path timed run: {sum(s.success for s in stats)}/{k} solved, "
        f"statuses {[s.status.name for s in stats]}")
    log(f"main path: per-instance iterations {iters}, wall {wall:.4f} s, "
        f"{sum(iters) / wall:.2f} iter/s, rel-KKT max {max(kkt):.3e}")
    log(f"main path: chol_inv launches {launches}, host syncs {syncs} "
        f"({syncs / max(iters):.2f} per batch iteration, {max(iters)} batch iterations)")
    check(all(s.success for s in stats), "the bench suite did not solve 8/8")
    check(all(np.all(np.isfinite(s.solution)) and s.solution.shape == (n,) for s in stats),
          "non-finite or misshapen solutions")
    check(launches > 0, "the main path never launched the chol_inv kernel")
    return dict(launches=launches)


def phase_certificate(device, m=1024, n=2048):
    worst = 0.0
    for deg in (False, True):
        for seed in (1, 2):
            qp, info = known_optimum_lp(m, n, seed=seed + m, degenerate=deg)
            st = mtt.madipm(qp, device=device, rethrow_error=True, **CERT_OPTIONS)
            kkt = rel_kkt(qp, st)
            obj_err = abs(st.objective - info["obj"]) / max(1.0, abs(info["obj"]))
            log(f"certificate {qp.name} seed {seed + m}: {st.status.name}, iter {st.iter}, "
                f"rel-KKT {kkt:.3e}, rel obj err {obj_err:.3e}, {st.total_time:.3f} s")
            check(st.success and kkt <= 1e-8, f"known optimum {qp.name} seed {seed + m} failed")
            worst = max(worst, kkt)
    log(f"certificate: 4/4 at rel-KKT <= 1e-8 (worst {worst:.3e})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    t0 = time.time()
    lib = chol_inv.build()
    log(f"build: {lib.name} in {time.time() - t0:.2f} s")

    row = phase_kernel()
    launches = phase_main_path("cuda")["launches"]
    phase_certificate("cuda")

    print(json.dumps({"kernels": [dict(
        name="chol_inv", route="cuda", source="madipm_tpu_torch/csrc/chol_inv.cu",
        replaces="madipm_tpu/ops/pallas_chol.py:239", launches=launches, **row,
    )]}), flush=True)
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
