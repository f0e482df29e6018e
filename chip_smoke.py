#!/usr/bin/env python3
"""Smoke test of madipm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs, in order, and fails (non-zero exit) at the first phase that fails:

1. the device: a CUDA device must be present (no CPU fallback); prints its
   name and ``nvidia-smi``'s name and power limit;
2. the build: compiles the kernel library from ``madipm_tpu_torch/csrc``;
3. the kernels against their plain torch versions on the card, in fp32 and
   fp64: ``chol_inv`` (L, L^-1) and ``cholesky`` (L alone) at the main
   paths' shape (B=8, N=1024) and at (3, 256), each with its time, its
   plain version's, one torch.linalg call's and its bound; then at one
   tile (1, 32), odd tile counts (2, 96), (1, 128), (16, 1024), (2, 4096)
   and more instances than one wave holds (600, 128); the L of the two
   bit-identical at every shape; an indefinite matrix non-finite, alone and
   as one lane of a batch whose other lanes do not change by a bit; 50
   calls with no sync between them, all bit-identical; and the operations
   one call enqueues, which must not depend on N;
4. the LP main path: ``madipm_batch`` on the bench suite (8 LPs, m=1024,
   n=2048, density 0.15) with the accelerator options; one warm run, then
   a timed run on the rhs scaled by 1+1e-4, which must solve 8/8 through
   the fp32 ``chol_inv`` kernel;
5. the LP certificate: four known-optimum LPs at 1024 x 2048 through
   ``madipm``, each to rel-KKT <= 1e-8;
6. the QP main path: the QP bench suite (8 convex QPs, m=512, n=1024,
   density 0.15) on the CONDENSED (K1) system with an fp64 factor, once
   through CHOLESKY_INV (the fp64 ``chol_inv`` kernel) and once through
   CHOLESKY with ``use_pallas=True`` (the ``cholesky`` kernel); each 8/8,
   objectives of the two equal to 1e-7;
7. the QP certificate: known-optimum convex QPs, K1 at 512 x 1024 and K2
   (AUGMENTED, LDL) at 256 x 512, each to rel-KKT <= 1e-8 with the Q term
   in the dual residual; one K2 instance also with two Gondzio corrections.

Each main path is driven with the launch counters set to 0 just before it
and read just after.  The last two lines are the kernel table and
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
from madipm_tpu_torch.models.generators import (
    known_optimum_lp,
    known_optimum_qp,
    make_qp_suite,
    make_suite,
)
from madipm_tpu_torch.ops import block_chol, chol_inv, linalg
from madipm_tpu_torch.utils import sync

#: (L, Linv) agreement of kernel and plain version, relative to max |.|
KERNEL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}

#: the card's peaks for the kernels' bounds: NVIDIA's H100 SXM data sheet,
#: FLOP/s of what each dtype's products run on (fp32: outside the tensor
#: cores; fp64: the tensor cores, which the kernel's mma.sync uses), and
#: bytes/s of device memory
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12

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

#: scripts/ablate_predictor_qp.py's K1 options (fp64 factor: gamma ~ 1e8)
QP_OPTIONS = dict(
    tol=1e-8,
    max_iter=300,
    regularization=mtt.FixedRegularization(1e-8, -1e-8),
    print_level=mtt.PrintLevel.ERROR,
    kkt_system=mtt.KKTSystem.CONDENSED,
    linear_solver=mtt.LinearSolver.CHOLESKY_INV,
    factor_dtype="float64",
    refinement_steps=12,
    pcg_adaptive_tol=True,
)

#: scripts/run_known_optimum.py --qp: its base options, one KKT system each
QP_CERT_OPTIONS = dict(
    tol=1e-8,
    max_iter=300,
    regularization=mtt.FixedRegularization(1e-8, -1e-8),
    print_level=mtt.PrintLevel.ERROR,
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


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype):
    """(least milliseconds the card could take, which resource sets it)."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def library_chol_inv(S):
    """(L, L^-1) by torch.linalg: the yardstick of chol_inv, timed here only."""
    L, _ = torch.linalg.cholesky_ex(S)
    eye = torch.eye(S.shape[-1], device=S.device, dtype=S.dtype).expand_as(S)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def agreement(name, S, outs, refs) -> float:
    """Hold a kernel's outputs (L first, then L^-1 where there is one)
    against the plain version's on ``S``: each relative to max |.| within
    KERNEL_TOL, |L L' - S| within ten times that, |L^-1 L - I| within
    KERNEL_TOL, upper triangles exactly zero.  Returns the largest absolute
    difference."""
    batch, n, dtype = S.shape[0], S.shape[-1], S.dtype
    tol = KERNEL_TOL[dtype]
    errs = [float((o - r).abs().max() / r.abs().max()) for o, r in zip(outs, refs)]
    L = outs[0]
    err_S = float((L @ L.mT - S).abs().max() / S.abs().max())
    err_up = max(float(torch.triu(o, 1).abs().max()) for o in outs)
    err_I = 0.0
    if len(outs) > 1:
        eye = torch.eye(n, device=S.device, dtype=dtype)
        err_I = float((outs[1] @ L - eye).abs().max())
    log(f"kernel {name} B={batch} N={n} {str(dtype)[6:]}: rel err vs plain "
        f"{[f'{e:.3e}' for e in errs]}, |L L' - S| {err_S:.3e}, |Linv L - I| {err_I:.3e} (tol {tol:g})")
    check(all(e <= tol for e in errs) and err_S <= 10 * tol and err_I <= tol and err_up == 0.0,
          f"kernel {name} disagrees with the plain version at B={batch} N={n} {dtype}")
    return float(max((o - r).abs().max() for o, r in zip(outs, refs)))


def check_kernel(name, S, kernel, plain, library, flops, nbytes, plain_reps=3) -> dict:
    """Hold one kernel against its plain version on ``S`` and time it, the
    library call and (``plain_reps`` > 0) its plain version in turns.
    ``kernel`` and ``plain`` return a tuple of tensors, L first."""
    batch, n, dtype = S.shape[0], S.shape[-1], S.dtype
    outs, refs = kernel(S), plain(S)
    torch.cuda.synchronize()
    max_abs_err = agreement(name, S, outs, refs)
    del outs, refs
    ms = cuda_ms(lambda: kernel(S), reps=10)
    plain_ms = cuda_ms(lambda: plain(S), reps=plain_reps) if plain_reps else None
    library_ms = cuda_ms(lambda: library(S), reps=10)
    b_ms, b_by = bound_ms(flops, nbytes, dtype)
    log(f"kernel {name} B={batch} N={n} {str(dtype)[6:]}: kernel {ms:.4f} ms, "
        f"plain {'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}, "
        f"library {library_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}")
    return dict(
        shape=[batch, n, n], dtype=str(dtype)[6:], max_abs_err=max_abs_err,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
    )


def kernel_cholesky(S):
    return (chol_inv.cholesky(S),)


def plain_cholesky(S):
    return (block_chol.cholesky(S),)


def check_shape(batch, n, dtype, gen, plain_reps=3):
    """Both kernels at one shape; returns their two rows."""
    S = random_spd(batch, n, dtype, gen)
    size = S.element_size()
    n3 = batch * float(n) ** 3
    words = batch * n * n
    row_inv = check_kernel(
        "chol_inv", S, chol_inv.chol_inv, block_chol.chol_inv, library_chol_inv,
        flops=2 * n3 / 3, nbytes=3 * words * size,  # factor + inverse; S in, L and Linv out
        plain_reps=plain_reps,
    )
    row_chol = check_kernel(
        "cholesky", S, kernel_cholesky, plain_cholesky, torch.linalg.cholesky_ex,
        flops=n3 / 3, nbytes=2 * words * size,  # factor alone; S in, L out
        plain_reps=plain_reps,
    )
    check(torch.equal(chol_inv.cholesky(S), chol_inv.chol_inv(S)[0]),
          f"the L of cholesky and of chol_inv differ in a bit at B={batch} N={n} {dtype}")
    return row_inv, row_chol


def check_mixed_batch(dtype, gen):
    """One indefinite lane among good ones: the good lanes come out as they
    do from a batch without it, bit for bit, and agree with the plain
    version; the bad lane is non-finite."""
    S = random_spd(6, 256, dtype, gen)
    good_L, good_W = chol_inv.chol_inv(S)
    good_C = chol_inv.cholesky(S)
    bad = 2
    S_mixed = S.clone()
    S_mixed[bad] = -torch.eye(256, device="cuda", dtype=dtype)
    L, W = chol_inv.chol_inv(S_mixed)
    C = chol_inv.cholesky(S_mixed)
    keep = [i for i in range(S.shape[0]) if i != bad]
    check(torch.equal(L[keep], good_L[keep]) and torch.equal(W[keep], good_W[keep])
          and torch.equal(C[keep], good_C[keep]),
          f"an indefinite lane changed its neighbours ({dtype})")
    agreement("chol_inv (mixed batch, good lanes)", S[keep], (L[keep], W[keep]),
              block_chol.chol_inv(S[keep]))
    check(not bool(torch.isfinite(L[bad]).all()) and not bool(torch.isfinite(C[bad]).all()),
          f"an indefinite lane came back finite ({dtype})")
    check(bool(linalg.cholesky_is_ok(L).tolist() == [i != bad for i in range(S.shape[0])]),
          f"cholesky_is_ok does not single out the indefinite lane ({dtype})")


def check_back_to_back(dtype, gen, calls=50):
    """``calls`` calls enqueued with no sync between them (the counters'
    scratch is handed out again by the allocator): all equal to the first."""
    S = random_spd(8, 512, dtype, gen)
    first = chol_inv.chol_inv(S)
    torch.cuda.synchronize()
    outs = [chol_inv.chol_inv(S) for _ in range(calls)]
    facs = [chol_inv.cholesky(S) for _ in range(calls)]
    torch.cuda.synchronize()
    check(all(torch.equal(L, first[0]) and torch.equal(W, first[1]) for L, W in outs)
          and all(torch.equal(L, first[0]) for L in facs),
          f"{calls} back-to-back calls did not all give the first call's bits ({dtype})")


def enqueued_operations(fn, S) -> int:
    """Device operations (kernels, memsets, copies) one call of ``fn`` puts
    on the stream, counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn(S)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(S)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


#: further shapes the kernels are held at: one tile, odd tile counts, two
#: block rows to a CTA, the largest size of the repo, more instances than a wave
EXTRA_SHAPES = ((1, 32), (2, 96), (1, 128), (16, 1024), (2, 4096), (600, 128))


def phase_kernel() -> dict:
    """Rows of the kernel table at the main paths' shape, keyed by
    (kernel, dtype)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = (chol_inv.launches, chol_inv.cholesky_launches)
    rows = {}
    for batch, n in ((8, 1024), (3, 256)):
        for dtype in (torch.float32, torch.float64):
            row_inv, row_chol = check_shape(batch, n, dtype, gen)
            if (batch, n) == (8, 1024):  # the main paths' shape
                rows["chol_inv", dtype] = row_inv
                rows["cholesky", dtype] = row_chol
    for batch, n in EXTRA_SHAPES:
        for dtype in (torch.float32, torch.float64):
            check_shape(batch, n, dtype, gen, plain_reps=0)
    for dtype in (torch.float32, torch.float64):
        bad = -torch.eye(256, device="cuda", dtype=dtype)
        L, W = chol_inv.chol_inv(bad)
        check(not bool(torch.isfinite(L).all()), f"chol_inv: indefinite S gave a finite factor ({dtype})")
        L = chol_inv.cholesky(bad)
        check(not bool(torch.isfinite(L).all()), f"cholesky: indefinite S gave a finite factor ({dtype})")
        check_mixed_batch(dtype, gen)
        check_back_to_back(dtype, gen)
    log("kernels: mixed batch (one indefinite lane), 50 back-to-back calls and the "
        "bit-identity of the two L pass in fp32 and fp64")
    counts = {}
    for n in (256, 1024):
        S = random_spd(8, n, torch.float64, gen)
        counts[n] = (enqueued_operations(chol_inv.chol_inv, S), enqueued_operations(chol_inv.cholesky, S))
    log(f"enqueued operations per call at N=1024: chol_inv {counts[1024][0]}, cholesky {counts[1024][1]} "
        f"(at N=256: {counts[256][0]}, {counts[256][1]})")
    check(counts[1024] == counts[256] == (chol_inv.ENQUEUED_OPS,) * 2,
          "the operations a call enqueues depend on N or are not the two the wrapper states")
    check(chol_inv.launches > before[0] and chol_inv.cholesky_launches > before[1],
          "a launch counter did not rise")
    return rows


def rel_kkt(qp, st) -> float:
    """Relative KKT residual of a returned primal-dual point, with the Q
    term in the dual residual (scripts/run_known_optimum.py)."""
    x, y, zl, zu = st.solution, st.multipliers, st.multipliers_L, st.multipliers_U
    A = qp.A
    r_p = np.max(np.abs(A @ x - qp.lcon)) / max(1.0, np.max(np.abs(qp.lcon)))
    r_d = qp.c + A.T @ y - zl + zu
    if qp.Q is not None:
        r_d = r_d + qp.Q @ x
    r_d = np.max(np.abs(r_d)) / max(1.0, np.max(np.abs(qp.c)))
    sl = np.where(np.isfinite(qp.lvar), x - qp.lvar, 0.0)
    su = np.where(np.isfinite(qp.uvar), qp.uvar - x, 0.0)
    compl = max(np.max(np.abs(sl * zl)), np.max(np.abs(su * zu))) / max(1.0, np.max(np.abs(qp.c)))
    return max(float(r_p), float(r_d), float(compl))


def timed_batch(label, models, device, options) -> dict:
    """One warm ``madipm_batch`` run, then a timed run on the rhs scaled by
    1+1e-4 with every counter set to 0 just before it and read just after.
    The timed run must solve every instance to finite solutions."""
    k, n = len(models), models[0].nvar
    warm = mtt.madipm_batch(models, device=device, **options)
    log(f"{label} warm run: {sum(s.success for s in warm)}/{k} solved, "
        f"iters {[s.iter for s in warm]}, {warm[0].solver_time:.3f} s")
    scaled = [dataclasses.replace(q, lcon=q.lcon * (1 + 1e-4), ucon=q.ucon * (1 + 1e-4))
              for q in models]
    chol_inv.launches = 0
    chol_inv.cholesky_launches = 0
    sync.count = 0
    stats = mtt.madipm_batch(scaled, device=device, **options)
    inv_launches, chol_launches, syncs = chol_inv.launches, chol_inv.cholesky_launches, sync.count
    iters = [s.iter for s in stats]
    wall = stats[0].solver_time
    kkt = [rel_kkt(q, s) for q, s in zip(scaled, stats)]
    log(f"{label} timed run: {sum(s.success for s in stats)}/{k} solved, "
        f"statuses {[s.status.name for s in stats]}")
    log(f"{label}: per-instance iterations {iters}, wall {wall:.4f} s, "
        f"{sum(iters) / wall:.2f} iter/s, rel-KKT max {max(kkt):.3e}")
    log(f"{label}: chol_inv launches {inv_launches}, cholesky launches {chol_launches}, "
        f"host syncs {syncs} ({syncs / max(iters):.2f} per batch iteration, "
        f"{(inv_launches + chol_launches) / max(iters):.2f} kernel launches per batch iteration, "
        f"{max(iters)} batch iterations)")
    check(all(s.success for s in stats), f"{label}: the suite did not solve {k}/{k}")
    check(all(np.all(np.isfinite(s.solution)) and s.solution.shape == (n,) for s in stats),
          f"{label}: non-finite or misshapen solutions")
    return dict(stats=stats, chol_inv=inv_launches, cholesky=chol_launches)


def phase_main_path(device, k=8, m=1024, n=2048, density=0.15) -> int:
    """The LP main path; returns its chol_inv launches (fp32)."""
    run = timed_batch("LP main path", make_suite(k=k, n=n, m=m, density=density),
                      device, BENCH_OPTIONS)
    check(run["chol_inv"] > 0, "the LP main path never launched the chol_inv kernel")
    return run["chol_inv"]


def phase_qp_main_path(device, k=8, m=512, n=1024, density=0.15):
    """The QP main path (K1), through each kernel in turn; returns the
    fp64 chol_inv launches of the first run and the cholesky launches of
    the second."""
    models = make_qp_suite(k=k, m=m, n=n, density=density)
    inv = timed_batch("QP main path (K1, CHOLESKY_INV)", models, device, QP_OPTIONS)
    check(inv["chol_inv"] > 0, "the QP main path never launched the chol_inv kernel")
    fac = timed_batch(
        "QP main path (K1, CHOLESKY, use_pallas)", models, device,
        dict(QP_OPTIONS, linear_solver=mtt.LinearSolver.CHOLESKY, use_pallas=True),
    )
    check(fac["cholesky"] > 0, "the QP main path never launched the cholesky kernel")
    check(fac["chol_inv"] == 0, "the CHOLESKY route launched the chol_inv kernel")
    gaps = [abs(a.objective - b.objective) / max(1.0, abs(a.objective))
            for a, b in zip(inv["stats"], fac["stats"])]
    log(f"QP main path: objectives of the two routes agree to {max(gaps):.3e} relative")
    check(max(gaps) <= 1e-7, "the two K1 routes disagree on the objectives")
    return inv["chol_inv"], fac["cholesky"]


def certify(qp, info, device, label, **options):
    st = mtt.madipm(qp, device=device, rethrow_error=True, **options)
    kkt = rel_kkt(qp, st)
    obj_err = abs(st.objective - info["obj"]) / max(1.0, abs(info["obj"]))
    log(f"certificate {label}: {st.status.name}, iter {st.iter}, "
        f"rel-KKT {kkt:.3e}, rel obj err {obj_err:.3e}, {st.total_time:.3f} s")
    check(st.success and kkt <= 1e-8, f"known optimum {label} failed")
    return kkt


def phase_certificate(device, m=1024, n=2048):
    worst = 0.0
    for deg in (False, True):
        for seed in (1, 2):
            qp, info = known_optimum_lp(m, n, seed=seed + m, degenerate=deg)
            worst = max(worst, certify(qp, info, device, f"{qp.name} seed {seed + m}",
                                       **CERT_OPTIONS))
    log(f"certificate: 4/4 LPs at rel-KKT <= 1e-8 (worst {worst:.3e})")


def phase_qp_certificate(device):
    """scripts/run_known_optimum.py --qp: K1 at 512 x 1024, K2 at 256 x 512
    (its LDL is a chain of small launches), and one K2 instance with two
    Gondzio corrections."""
    worst, count = 0.0, 0
    for tag, kind, (m, n) in (("k1", mtt.KKTSystem.CONDENSED, (512, 1024)),
                              ("k2", mtt.KKTSystem.AUGMENTED, (256, 512))):
        for deg in (False, True):
            for seed in (1, 2):
                qp, info = known_optimum_qp(m, n, seed=seed + m, degenerate=deg, sparse_q=True)
                worst = max(worst, certify(qp, info, device, f"{qp.name} seed {seed + m} {tag}",
                                           kkt_system=kind, **QP_CERT_OPTIONS))
                count += 1
    qp, info = known_optimum_qp(256, 512, seed=257, sparse_q=True)
    worst = max(worst, certify(qp, info, device, f"{qp.name} seed 257 k2 max_ncorr=2",
                               kkt_system=mtt.KKTSystem.AUGMENTED, max_ncorr=2, **QP_CERT_OPTIONS))
    log(f"certificate: {count + 1}/{count + 1} QPs at rel-KKT <= 1e-8 (worst {worst:.3e})")
    # the plain LDL' recursion at the K2 size above (n + m = 768): a chain of
    # small launches, 128 elimination steps for each of its 6 diagonal blocks
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    K = random_spd(1, 768, torch.float64, gen)
    K[:, 512:, 512:] *= -1.0  # quasi-definite, as the augmented matrix
    K[:, 512:, :512] = K[:, :512, 512:].mT
    ldl_ms = cuda_ms(lambda: linalg.ldl_factor(K), reps=2)
    lu_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(K), reps=10)
    log(f"ldl_factor (plain torch, 1 x 768 x 768 fp64): {ldl_ms:.3f} ms; "
        f"torch.linalg.lu_factor_ex on the same matrix {lu_ms:.3f} ms")


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

    rows = phase_kernel()
    lp_launches = phase_main_path("cuda")
    phase_certificate("cuda")
    qp_inv_launches, qp_chol_launches = phase_qp_main_path("cuda")
    phase_qp_certificate("cuda")
    log(f"total {time.time() - t0:.1f} s")

    source = "madipm_tpu_torch/csrc/chol_inv.cu"
    # one row for each (kernel, dtype) that a main path runs, with the
    # launches of that path's timed run
    kernels = [
        dict(name="chol_inv", route="cuda", source=source, path="LP main path (NORMAL)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=lp_launches,
             **rows["chol_inv", torch.float32]),
        dict(name="chol_inv", route="cuda", source=source, path="QP main path (K1, CHOLESKY_INV)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=qp_inv_launches,
             **rows["chol_inv", torch.float64]),
        dict(name="cholesky", route="cuda", source=source, path="QP main path (K1, CHOLESKY, use_pallas)",
             replaces="madipm_tpu/ops/pallas_chol.py:225", launches=qp_chol_launches,
             **rows["cholesky", torch.float64]),
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
