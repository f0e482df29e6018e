#!/usr/bin/env python3
"""Smoke test of madipm_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Runs, in order, and fails (non-zero exit) at the first phase that fails:

1. the device: a CUDA device must be present (no CPU fallback); prints its
   name and ``nvidia-smi``'s name and power limit;
2. the build: compiles the kernel library from ``madipm_tpu_torch/csrc``
   (``chol_inv.cu`` and ``ozaki.cu``, one nvcc each, started together);
3. the kernels against their plain torch versions on the card, in fp32 and
   fp64: ``chol_inv`` (L, L^-1) and ``cholesky`` (L alone) at the main
   paths' shapes (B=8, N=1024; B=4, N=2048 for the sparse LP path) and at
   (3, 256), each with its time, its plain version's, one torch.linalg
   call's and its bound; then at one
   tile (1, 32), odd tile counts (2, 96), (1, 128), (16, 1024), one
   instance at (1, 2048), (2, 4096) and more instances than one wave holds
   (600, 128), one instance alone also against its plain version's time;
   the L of the two
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
   in the dual residual; one K2 instance also with two Gondzio corrections;
8. the sparse (ELL) routes: the tall sparse LP suite (4 LPs, m=2048,
   n=32768, density 0.004) through ``madipm_batch(..., sparse=True)`` with
   the accelerator options, 4/4 through the fp32 ``chol_inv`` kernel at
   (4, 2048) to rel-KKT <= 1e-8; instance 0 alone with no ``sparse``
   argument, which must take the ELL route; two assemblies of one tall
   lane, bit-identical and equal to the dense product; the LP bench suite
   of phase 4 and the four K1 certificate QPs of phase 7 on the ELL route,
   against the dense results; ``from_mps`` on the two sample files;
9. the structured suite (``structured_suite(scale=4)``: transports up to
   128 x 192, network flows, staircases, two portfolio QPs) one instance at
   a time through the default (logged) driver with CHOLESKY and
   ``use_pallas=True`` (NORMAL for the LPs, CONDENSED for the QPs, both
   through the fp64 ``cholesky`` kernel), the tables to a file under
   ``madipm_tpu_torch/_build/``: 8/8, the LP objectives at HiGHS's to 1e-6,
   the QPs to rel-KKT <= 1e-8; then the largest transport rebuilt through
   ``Model``, at the generator instance's objective and duals to 1e-8;
10. the other drivers on one LP bench instance (1024 x 2048): the timed
   driver (its eval / linear-solve / step split), the chunked driver
   (``max_wall_time`` 0 and 300), ``trace_dir`` (a trace naming the
   kernel), a checkpoint after 5 iterations resumed, and a warm start of
   the instance with its rhs scaled by 1+1e-4;
11. the solver options ``pcg_flex``, ``precond_refine`` and
   ``factor_precision`` on the LP bench suite of phase 4, each run beside
   a plain one: 8/8 with the first two, the iterates of "highest" equal
   to the plain run's bit for bit, "high" and "default" reported;
12. the mesh path (``parallel/``) on a one-rank NCCL group that
   ``init_distributed`` starts: the LP bench
   instance through ``MPCSolver(mesh=make_mesh(1, ("cols",)))`` with the
   accelerator options and in fp64 (the normal matrix reduce-scattered
   into row strips, the diagonal block through ``chol_inv`` at (1, 1024)),
   the K1 QP bench instance likewise (the distributed K1 factor), each
   against its mesh-free solve (the same status, iterations equal or +-1,
   objective to 1e-8 relative); the four known-optimum LPs of phase 5
   through the mesh to rel-KKT <= 1e-8; the LP suite of phase 4 through
   ``madipm_batch(mesh=make_mesh(1, ("batch",)))``, 8/8 with each lane's
   iterations and objective those of phase 4; ``chol_inv`` at (1, 1024) in
   fp32 and fp64 against its plain version; and the functions of
   ``tools/dryrun_multichip.py`` (a (batch, cols) MPC step, a
   distributed-factor LP and a distributed K1 QP);
13. the Ozaki fp64 operator (``ops/ozaki.py``, ``csrc/ozaki.cu``): the LP
   suite of phase 4 with bench.py's accelerator options and
   ``fp64_matvec="ozaki", ozaki_slices=5``, then with ``"ozaki_i8"`` and
   shared slices, each 8/8 beside phase 4's native run (objectives to
   1e-7, the wall's ratio to native printed); the four known-optimum LPs
   of phase 5 through ``"ozaki"`` at 5 slices and through ``"ozaki_i8"``,
   both with shared slices, at rel-KKT <= 1e-8; the kernel's four entry
   points (bf16 and int8, A x and A' v) at (8, 1024, 2048), bf16 at 5 and
   7 slices and int8 at 8, and at every other shape those runs launched
   (A' of the suite through its stored transposed slices, one certificate
   instance), against their plain versions (exact pair partials: within
   1e-15 K rowmax|A| max|x|) and against torch.bmm in fp64 (within the
   operator's bound); two calls bit-equal; each entry point's own vector
   slices and scale bit-equal to ``vector_operands``' and at most two
   operations enqueued by a whole call; each with its device time (a CUDA
   graph of 20 calls), its time back to back, the whole call's, the plain
   version's, torch.bmm's (both ways) and its bound.

Each main path is driven with the launch counters set to 0 just before it
and read just after.  The last two lines are the kernel table and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import madipm_tpu_torch as mtt
from madipm_tpu_torch.modeling import matmul
from madipm_tpu_torch.models.generators import (
    known_optimum_lp,
    known_optimum_qp,
    make_qp_suite,
    make_suite,
    structured_suite,
)
from madipm_tpu_torch.ops import _cuda, block_chol, chol_inv, linalg, ozaki
from madipm_tpu_torch.parallel.batch import bucket_pad_sparse
from madipm_tpu_torch.parallel.mesh import init_distributed, make_mesh
from madipm_tpu_torch.solver import driver
from madipm_tpu_torch.utils import checkpoint, sync

#: where the logs, the trace and the checkpoint of phases 9-10 go (ignored by git)
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "madipm_tpu_torch", "_build")

#: the sample files and the objectives the CPU tests hold for them
MPS_FILES = {
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", name): obj
    for name, obj in (("simple.mps", 13.0), ("simple_qp.qps", -6.25))
}

#: (L, Linv) agreement of kernel and plain version, relative to max |.|
KERNEL_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}

#: the card's peaks for the kernels' bounds: NVIDIA's H100 SXM data sheet,
#: FLOP/s of what each dtype's products run on (fp32: outside the tensor
#: cores; fp64: the tensor cores, which the kernel's mma.sync uses), and
#: bytes/s of device memory
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_BYTES = 3.35e12

#: bench.py's accelerator options, without ozaki_slices: the matvecs are
#: native fp64 (phase 13 adds fp64_matvec="ozaki", ozaki_slices=5)
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


#: the runtime and driver calls that put an operation on a stream
ENQUEUE_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel", "cudaMemsetAsync",
                 "cudaMemcpyAsync", "cuLaunchKernel", "cuLaunchKernelEx")


def enqueued_operations(fn, S) -> int:
    """Device operations (kernels, memsets, copies) one call of ``fn`` puts
    on the stream, counted by torch.profiler as the runtime calls that
    enqueue them (ENQUEUE_CALLS).  The profiler's device-side records are
    not counted: on the H100, after earlier work in the process, they lost
    kernels of a call (a whole run of this script once counted none for a
    call that enqueues two), while the enqueue calls stay exact; and the
    count is held against the nodes of a CUDA graph of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn(S)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(S)
        torch.cuda.synchronize()
    calls = sum(e.count for e in prof.key_averages() if e.key in ENQUEUE_CALLS)
    nodes = graph_operations(lambda: fn(S))
    check(calls == nodes, f"the profiler counted {calls} enqueue calls, a CUDA graph of the call {nodes} nodes")
    return calls


def graph_operations(fn) -> int:
    """The nodes of a CUDA graph that captures one call of ``fn`` (after a
    warm call on a side stream), read by the driver's cuGraphGetNodes."""
    import ctypes

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                                     ctypes.byref(count))
    check(rc == 0, f"cuGraphGetNodes failed with CUresult {rc}")
    del graph
    return count.value


#: further shapes the kernels are held at: one tile, odd tile counts, two
#: block rows to a CTA, one instance of the sparse path's order, the largest
#: size of the repo, more instances than a wave (one instance alone also
#: times its plain version)
EXTRA_SHAPES = ((1, 32), (2, 96), (1, 128), (16, 1024), (1, 2048), (2, 4096), (600, 128))


def phase_kernel() -> dict:
    """Rows of the kernel table at the main paths' shapes, keyed by
    (kernel, dtype, N)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    before = (chol_inv.launches, chol_inv.cholesky_launches)
    rows = {}
    for batch, n in ((8, 1024), (4, 2048), (3, 256)):
        for dtype in (torch.float32, torch.float64):
            row_inv, row_chol = check_shape(batch, n, dtype, gen, plain_reps=1 if n == 2048 else 3)
            if n != 256:  # the main paths' shapes: dense (8, 1024), sparse LP (4, 2048)
                rows["chol_inv", dtype, n] = row_inv
                rows["cholesky", dtype, n] = row_chol
    for batch, n in EXTRA_SHAPES:
        for dtype in (torch.float32, torch.float64):
            check_shape(batch, n, dtype, gen, plain_reps=1 if batch == 1 else 0)
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


def timed_batch(label, models, device, options, sparse=False) -> dict:
    """One warm ``madipm_batch`` run, then a timed run on the rhs scaled by
    1+1e-4 with every counter set to 0 just before it and read just after.
    The timed run must solve every instance to finite solutions."""
    k, n = len(models), models[0].nvar
    warm = mtt.madipm_batch(models, device=device, sparse=sparse, **options)
    log(f"{label} warm run: {sum(s.success for s in warm)}/{k} solved, "
        f"iters {[s.iter for s in warm]}, {warm[0].solver_time:.3f} s")
    scaled = [dataclasses.replace(q, lcon=q.lcon * (1 + 1e-4), ucon=q.ucon * (1 + 1e-4))
              for q in models]
    chol_inv.launches = 0
    chol_inv.cholesky_launches = 0
    sync.count = 0
    t0 = time.time()
    stats = mtt.madipm_batch(scaled, device=device, sparse=sparse, **options)
    whole = time.time() - t0
    inv_launches, chol_launches, syncs = chol_inv.launches, chol_inv.cholesky_launches, sync.count
    iters = [s.iter for s in stats]
    wall = stats[0].solver_time
    kkt = [rel_kkt(q, s) for q, s in zip(scaled, stats)]
    log(f"{label} timed run: {sum(s.success for s in stats)}/{k} solved, "
        f"statuses {[s.status.name for s in stats]}")
    log(f"{label}: per-instance iterations {iters}, wall {wall:.4f} s, "
        f"{sum(iters) / wall:.2f} iter/s, rel-KKT max {max(kkt):.3e}; "
        f"packing and upload (outside the wall) {whole - wall:.2f} s")
    log(f"{label}: chol_inv launches {inv_launches}, cholesky launches {chol_launches}, "
        f"host syncs {syncs} ({syncs / max(iters):.2f} per batch iteration, "
        f"{(inv_launches + chol_launches) / max(iters):.2f} kernel launches per batch iteration, "
        f"{max(iters)} batch iterations)")
    check(all(s.success for s in stats), f"{label}: the suite did not solve {k}/{k}")
    check(all(np.all(np.isfinite(s.solution)) and s.solution.shape == (n,) for s in stats),
          f"{label}: non-finite or misshapen solutions")
    return dict(stats=stats, models=scaled, chol_inv=inv_launches, cholesky=chol_launches)


def phase_main_path(device, k=8, m=1024, n=2048, density=0.15) -> dict:
    """The LP main path; returns its timed run (``timed_batch``)."""
    run = timed_batch("LP main path", make_suite(k=k, n=n, m=m, density=density),
                      device, BENCH_OPTIONS)
    check(run["chol_inv"] > 0, "the LP main path never launched the chol_inv kernel")
    return run


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
    return kkt, obj_err


def phase_certificate(device, m=1024, n=2048):
    worst = 0.0
    for deg in (False, True):
        for seed in (1, 2):
            qp, info = known_optimum_lp(m, n, seed=seed + m, degenerate=deg)
            worst = max(worst, certify(qp, info, device, f"{qp.name} seed {seed + m}",
                                       **CERT_OPTIONS)[0])
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
                                           kkt_system=kind, **QP_CERT_OPTIONS)[0])
                count += 1
    qp, info = known_optimum_qp(256, 512, seed=257, sparse_q=True)
    worst = max(worst, certify(qp, info, device, f"{qp.name} seed 257 k2 max_ncorr=2",
                               kkt_system=mtt.KKTSystem.AUGMENTED, max_ncorr=2, **QP_CERT_OPTIONS)[0])
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


def rel_kkt_pd(qp, st) -> float:
    """Primal and dual relative residuals on the original model, as
    scripts/round3_measure.py computes them for the sparse suite."""
    x, y, zl, zu = st.solution, st.multipliers, st.multipliers_L, st.multipliers_U
    r_p = np.max(np.abs(qp.A @ x - qp.lcon)) / max(1.0, np.max(np.abs(qp.lcon)))
    r_d = np.max(np.abs(qp.c + qp.A.T @ y - zl + zu)) / max(1.0, np.max(np.abs(qp.c)))
    return max(float(r_p), float(r_d))


def index_megabytes(prob) -> float:
    """Device memory of one lane's pattern (pair and destination indices)."""
    names = ("pair_a", "pair_b", "pair_col", "seg_id", "s_low", "s_up", "seg_len")
    return sum(getattr(prob, f).numel() * getattr(prob, f).element_size() for f in names) / prob.batch / 2**20


def phase_sparse_tall(device, k=4, m=2048, n=32768, density=0.004):
    """The sparse LP path at the JAX package's tall shape: the suite through
    ``madipm_batch(sparse=True)`` (its NORMAL factor is fp32 ``chol_inv``
    at (4, 2048)); returns the timed run's chol_inv launches and the models."""
    t0 = time.time()
    models = make_suite(k=k, n=n, m=m, density=density)
    log(f"sparse LP tall suite: {k} x m={m}, n={n}, density {density}, "
        f"{models[0].A.nnz} nonzeros in instance 0; make_suite {time.time() - t0:.2f} s (host)")
    t0 = time.time()
    probs, _ = bucket_pad_sparse(models, device=device)
    torch.cuda.synchronize()
    log(f"sparse LP tall suite: bucket_pad_sparse {time.time() - t0:.2f} s (host pattern build, "
        f"int64 upload); per lane {probs.pair_a.shape[-1]} pairs, {probs.s_low.shape[-1]} entries of S, "
        f"ELL widths {probs.A_val.shape[-1]} / {probs.AT_val.shape[-1]}, "
        f"pattern indices {index_megabytes(probs):.1f} MiB per lane")
    check(probs.m == m and isinstance(probs, mtt.SparseTorchQP), "the tall bucket is not an m=2048 SparseTorchQP")
    del probs
    run = timed_batch("sparse LP tall suite (NORMAL, ELL)", models, device, BENCH_OPTIONS, sparse=True)
    kkt = [rel_kkt_pd(q, s) for q, s in zip(run["models"], run["stats"])]
    log(f"sparse LP tall suite: worst rel-KKT (primal, dual; scripts/round3_measure.py) {max(kkt):.3e}")
    check(max(kkt) <= 1e-8, "the tall sparse suite missed rel-KKT 1e-8")
    check(run["chol_inv"] > 0, "the sparse LP path never launched the chol_inv kernel")
    return run["chol_inv"], models


def phase_sparse_auto_and_determinism(model, device):
    """Instance 0 of the tall suite with no ``sparse`` argument: the
    automatic rule must take the ELL route.  Then two assemblies of its
    normal matrix, bit for bit, and against the dense product on the card."""
    solver = mtt.MPCSolver(model, device=device, rethrow_error=True, **BENCH_OPTIONS)
    check(isinstance(solver.prob, mtt.SparseTorchQP), "the automatic rule took the dense route")
    st = solver.solve()
    kkt = rel_kkt_pd(model, st)
    log(f"auto route: {type(solver.prob).__name__}, {st.status.name}, iter {st.iter}, "
        f"rel-KKT {kkt:.3e}, {st.solver_time:.3f} s")
    check(st.success and kkt <= 1e-8, "the auto-routed tall LP did not solve")
    prob = solver.prob
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    dinv = torch.rand(1, prob.n, generator=gen, device=device, dtype=torch.float64) + 0.5
    for dtype in (torch.float32, torch.float64):
        S1 = prob.assemble_normal_matrix(dinv, dtype)
        S2 = prob.assemble_normal_matrix(dinv, dtype)
        check(torch.equal(S1, S2), f"two sparse assemblies differ in a bit ({dtype})")
    A = torch.as_tensor(model.A.toarray(), device=device)
    dense = (A * dinv[:, : model.nvar]) @ A.T
    err = float((S1[0, : model.ncon, : model.ncon] - dense).abs().max() / dense.abs().max())
    ms = cuda_ms(lambda: prob.assemble_normal_matrix(dinv, torch.float32), reps=10)
    log(f"sparse assembly: bit-identical twice in fp32 and fp64; against the dense A D A' {err:.3e} "
        f"relative (fp64); one fp32 assembly of a {prob.m} x {prob.m} S from "
        f"{prob.pair_a.shape[-1]} pairs {ms:.4f} ms")
    check(err <= 1e-12, "the sparse assembly disagrees with the dense product")
    # the ELL products against cuSPARSE CSR (torch.sparse) on the same data
    x = torch.rand(1, prob.n, generator=gen, device=device, dtype=torch.float64)
    y = torch.rand(1, prob.m, generator=gen, device=device, dtype=torch.float64)
    csr = model.A.tocsr()
    A_csr = torch.sparse_csr_tensor(*(torch.as_tensor(a, device=device) for a in (
        csr.indptr.astype(np.int64), csr.indices.astype(np.int64), csr.data)), size=csr.shape)
    AT_csr = A_csr.t().to_sparse_csr()
    ax, aty = prob.matvec(x)[0], prob.rmatvec(y)[0]
    err = max(float((ax[: model.ncon] - A_csr @ x[0, : model.nvar]).abs().max() / ax.abs().max()),
              float((aty[: model.nvar] - AT_csr @ y[0, : model.ncon]).abs().max() / aty.abs().max()))
    times = [cuda_ms(fn, reps=50) for fn in (
        lambda: prob.matvec(x), lambda: A_csr @ x[0, : model.nvar],
        lambda: prob.rmatvec(y), lambda: AT_csr @ y[0, : model.ncon])]
    log(f"fp64 products of one tall lane: A x by the ELL gather {times[0]:.4f} ms, by cuSPARSE CSR "
        f"{times[1]:.4f} ms; A' y {times[2]:.4f} / {times[3]:.4f} ms; agreement {err:.3e} relative")
    check(err <= 1e-12, "the ELL products disagree with cuSPARSE")


def phase_sparse_against_dense(device, dense_run) -> int:
    """The LP bench suite of the main path on the ELL route, on the same
    (rhs-scaled) models: same statuses, iterations within one, objectives
    to 1e-7.  Returns its chol_inv launches."""
    models = dense_run["models"]
    chol_inv.launches = 0
    t0 = time.time()
    stats = mtt.madipm_batch(models, device=device, sparse=True, **BENCH_OPTIONS)
    whole = time.time() - t0
    launches = chol_inv.launches
    iters = [s.iter for s in stats]
    gaps = [abs(a.objective - b.objective) / max(1.0, abs(b.objective))
            for a, b in zip(stats, dense_run["stats"])]
    log(f"LP bench suite on the ELL route: {sum(s.success for s in stats)}/{len(stats)} solved, "
        f"iterations {iters} (dense {[s.iter for s in dense_run['stats']]}), wall "
        f"{stats[0].solver_time:.4f} s, {sum(iters) / stats[0].solver_time:.2f} iter/s, packing and "
        f"upload {whole - stats[0].solver_time:.2f} s, chol_inv launches {launches}; objectives "
        f"against the dense route {max(gaps):.3e} relative (worst)")
    check([s.status for s in stats] == [s.status for s in dense_run["stats"]],
          "the ELL and dense routes end in different statuses")
    check(all(abs(a.iter - b.iter) <= 1 for a, b in zip(stats, dense_run["stats"])),
          "the ELL and dense routes differ by more than one iteration")
    check(max(gaps) <= 1e-7, "the ELL and dense routes disagree on the objectives")
    return launches


def phase_sparse_qp_certificate(device):
    """The four K1 certificate QPs of phase 7 on the ELL route."""
    worst = 0.0
    for deg in (False, True):
        for seed in (1, 2):
            qp, info = known_optimum_qp(512, 1024, seed=seed + 512, degenerate=deg, sparse_q=True)
            kkt, obj_err = certify(qp, info, device, f"{qp.name} seed {seed + 512} k1 sparse",
                                   sparse=True, kkt_system=mtt.KKTSystem.CONDENSED, **QP_CERT_OPTIONS)
            check(obj_err <= 1e-6, f"sparse K1 certificate seed {seed + 512}: objective off")
            worst = max(worst, kkt)
    log(f"certificate: 4/4 K1 QPs on the ELL route at rel-KKT <= 1e-8 (worst {worst:.3e})")


def phase_from_mps(device):
    """``from_mps`` on the two sample files, dense and ELL."""
    for path, want in MPS_FILES.items():
        for sparse in (None, True):
            st = mtt.from_mps(path, device=device, sparse=sparse, rethrow_error=True,
                              print_level=mtt.PrintLevel.ERROR)
            log(f"from_mps {path} sparse={sparse}: {st.status.name}, iter {st.iter}, "
                f"objective {st.objective!r}")
            check(st.success and abs(st.objective - want) <= 1e-6, f"from_mps {path} failed")


def structured_options(model, log_file: str, first: bool) -> dict:
    """The structured suite's options: the default (logged) driver through
    the fp64 cholesky kernel; the first instance's table on the console
    and every table in ``log_file`` (with a quiet console the file sink
    still selects the logged driver)."""
    opts = dict(linear_solver=mtt.LinearSolver.CHOLESKY, use_pallas=True, output_file=log_file,
                rethrow_error=True)
    if model.Q is not None:
        opts["kkt_system"] = mtt.KKTSystem.CONDENSED
    if not first:
        opts.update(print_level=mtt.PrintLevel.ERROR, file_print_level=mtt.PrintLevel.INFO)
    return opts


def linprog_objective(qp) -> float:
    from scipy.optimize import linprog

    bounds = [(lo if np.isfinite(lo) else None, hi if np.isfinite(hi) else None)
              for lo, hi in zip(qp.lvar, qp.uvar)]
    res = linprog(qp.c, A_eq=qp.A, b_eq=qp.lcon, bounds=bounds, method="highs")
    check(res.status == 0, f"HiGHS did not solve {qp.name}")
    return float(res.fun)


def phase_structured(device):
    """Phase 9: the structured suite through the logged driver, one
    instance at a time; returns (cholesky launches, factor sizes, the
    largest transport and its stats, its options)."""
    log_file = os.path.join(OUT_DIR, "structured_suite.log")
    os.makedirs(OUT_DIR, exist_ok=True)
    if os.path.exists(log_file):
        os.remove(log_file)
    suite = structured_suite(scale=4)
    chol_inv.launches = chol_inv.cholesky_launches = 0
    sizes, results, t0 = set(), [], time.time()
    for i, qp in enumerate(suite):
        opts = structured_options(qp, log_file, first=i == 0)
        prob = mtt.MPCSolver(qp, device=device, **opts).prob
        sizes.add(prob.n if qp.Q is not None else prob.m)  # the factor's order
        del prob
        st = mtt.madipm(qp, device=device, **opts)
        if qp.Q is None:
            ref = linprog_objective(qp)
            err = abs(st.objective - ref) / max(1.0, abs(ref))
            log(f"structured {qp.name} ({qp.ncon} x {qp.nvar}): {st.status.name}, iter {st.iter}, "
                f"objective {st.objective!r} (HiGHS {ref!r}, rel err {err:.3e}), {st.solver_time:.3f} s")
            check(st.success and err <= 1e-6, f"structured {qp.name}: not at HiGHS's objective")
        else:
            kkt = rel_kkt(qp, st)
            log(f"structured {qp.name} ({qp.ncon} x {qp.nvar}, K1): {st.status.name}, iter {st.iter}, "
                f"objective {st.objective!r}, rel-KKT {kkt:.3e}, {st.solver_time:.3f} s")
            check(st.success and kkt <= 1e-8, f"structured {qp.name}: rel-KKT above 1e-8")
        results.append((qp, st, opts))
    launches = chol_inv.cholesky_launches
    with open(log_file) as fh:
        rows = sum(1 for line in fh if line[:4].strip().isdigit())
    log(f"structured suite: 8/8 solved in {time.time() - t0:.2f} s, {rows} table rows in {log_file}, "
        f"cholesky launches {launches}, chol_inv launches {chol_inv.launches}, factor sizes {sorted(sizes)}")
    check(launches > 0, "the structured suite never launched the cholesky kernel")
    check(rows == sum(st.iter + 1 for _, st, _ in results), "the log file lacks table rows")
    transport = max((r for r in results if r[0].name.startswith("transport")), key=lambda r: r[0].nvar)
    return launches, sorted(sizes), transport


def phase_model(device, transport):
    """Phase 9b: the largest transport rebuilt through Model and solved
    with the suite's options: its objective and duals against the
    generator instance's solve."""
    qp, ref, opts = transport
    m = mtt.Model(qp.name, device=device, **dict(opts, print_level=mtt.PrintLevel.ERROR,
                                                  file_print_level=mtt.PrintLevel.INFO))
    x = m.add_variables(qp.nvar, lb=qp.lvar, ub=qp.uvar)
    rows = m.add_constraint(matmul(qp.A, x) == qp.lcon)
    m.minimize(qp.c @ x)
    st = m.optimize()
    err = abs(st.objective - ref.objective) / max(1.0, abs(ref.objective))
    dual_err = float(np.max(np.abs(m.dual(rows) + ref.multipliers)) / max(1.0, np.max(np.abs(ref.multipliers))))
    log(f"Model {qp.name}: {st.status.name}, iter {st.iter} (generator instance {ref.iter}), objective "
        f"rel err {err:.3e}, duals rel err {dual_err:.3e}, {st.solver_time:.3f} s")
    check(st.success and err <= 1e-8 and dual_err <= 1e-8, "the Model solve disagrees with the generator's")


def phase_drivers(device):
    """Phase 10: the timed and chunked drivers, trace_dir, a checkpoint
    and a warm start on one LP bench instance (fp32 chol_inv).  Returns
    the timed run's split."""
    qp = make_suite(k=1, n=2048, m=1024, density=0.15)[0]
    solver = mtt.MPCSolver(qp, device=device, rethrow_error=True, **BENCH_OPTIONS)
    fused = solver.solve()
    check(fused.success, "the fused solve of the drivers' instance failed")
    gap = lambda st: abs(st.objective - fused.objective) / max(1.0, abs(fused.objective))
    timed = solver.solve(timed=True)
    tm = solver.timers
    log(f"timed driver: {timed.status.name}, iter {timed.iter} (fused {fused.iter}), wall "
        f"{timed.solver_time:.4f} s (fused {fused.solver_time:.4f} s); linear_solver_time "
        f"{tm['linear_solver_time']:.4f} s, eval_time {tm['eval_time']:.4f} s, step_time "
        f"{tm['step_time']:.4f} s; objective {gap(timed):.3e} from the fused solve")
    check(timed.success and 0.0 < timed.linear_solver_time <= timed.solver_time and gap(timed) <= 1e-8,
          "the timed driver failed its checks")
    zero = mtt.madipm(qp, device=device, max_wall_time=0.0, **BENCH_OPTIONS)
    budget = mtt.madipm(qp, device=device, max_wall_time=300.0, rethrow_error=True, **BENCH_OPTIONS)
    log(f"chunked driver: max_wall_time 0 -> {zero.status.name} at iter {zero.iter}; 300 -> "
        f"{budget.status.name}, iter {budget.iter}, {budget.solver_time:.4f} s, objective "
        f"{gap(budget):.3e} from the fused solve")
    check(zero.status == mtt.Status.MAXIMUM_WALLTIME_EXCEEDED, "max_wall_time=0 did not stop the solve")
    check(budget.success and gap(budget) <= 1e-8, "the chunked driver failed its checks")
    trace_dir = os.path.join(OUT_DIR, "trace")
    before = set(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else set()
    traced = solver.solve(trace_dir=trace_dir)
    new = sorted(set(os.listdir(trace_dir)) - before)
    check(traced.success and len(new) == 1, "trace_dir wrote no trace file")
    path = os.path.join(trace_dir, new[0])
    with open(path) as fh:
        text = fh.read()
    log(f"trace_dir: {path}, {len(text) / 2**20:.1f} MiB, names chol_kernel: {'chol_kernel' in text}")
    check("chol_kernel" in text, "the trace does not name the chol_kernel device kernel")
    prob_s, _, st = driver.initialize(solver.cfg, solver.prob)
    for _ in range(5):
        st = driver.iteration(solver.cfg, prob_s, st)
    ckpt = os.path.join(OUT_DIR, "checkpoint.npz")
    checkpoint.save_state(ckpt, st)
    resumed = checkpoint.resume(solver, checkpoint.load_state(ckpt, device=device))
    log(f"checkpoint after 5 iterations, resumed: {resumed.status.name}, iter {resumed.iter}, "
        f"objective {gap(resumed):.3e} from the uninterrupted solve")
    check(resumed.success and resumed.iter >= 5 and gap(resumed) <= 1e-8, "the resumed solve failed its checks")
    scaled = dataclasses.replace(qp, lcon=qp.lcon * (1 + 1e-4), ucon=qp.ucon * (1 + 1e-4))
    solver2 = mtt.MPCSolver(scaled, device=device, rethrow_error=True, **BENCH_OPTIONS)
    cold = solver2.solve()
    warm = checkpoint.resume(solver2, checkpoint.warm_start_state(solver2, x0=fused.solution,
                                                                  y0=fused.multipliers))
    log(f"warm start (rhs x (1+1e-4)): {warm.status.name}, {warm.iter} iterations against {cold.iter} "
        f"cold; objectives {abs(warm.objective - cold.objective) / max(1.0, abs(cold.objective)):.3e} apart")
    check(warm.success and cold.success, "the warm-started solve failed")
    return tm


def measured_batch(label, models, device, options) -> dict:
    """One madipm_batch run with the counters set to 0 just before it."""
    chol_inv.launches = chol_inv.cholesky_launches = 0
    sync.count = 0
    stats = mtt.madipm_batch(models, device=device, **options)
    iters = [s.iter for s in stats]
    run = dict(stats=stats, chol_inv=chol_inv.launches, syncs=sync.count / max(iters),
               wall=stats[0].solver_time, solved=sum(s.success for s in stats))
    statuses = sorted({s.status.name: None for s in stats})
    log(f"{label}: {run['solved']}/{len(stats)} solved ({', '.join(statuses)}), iterations {iters}, "
        f"wall {run['wall']:.4f} s, "
        f"{sum(iters) / run['wall']:.2f} iter/s, {run['syncs']:.2f} syncs per batch iteration, "
        f"chol_inv launches {run['chol_inv']}")
    return run


def phase_options(device, models) -> dict:
    """Phase 11: the A7b options on the LP bench suite (the rhs-scaled
    models of phase 4), each run after a plain one.  Returns the pcg_flex
    run."""
    plain = measured_batch("options: plain", models, device, BENCH_OPTIONS)
    runs = {}
    for name, extra in (("pcg_flex", dict(pcg_flex=True)), ("precond_refine", dict(precond_refine=True)),
                        ("highest", dict(factor_precision="highest")), ("high", dict(factor_precision="high")),
                        ("default", dict(factor_precision="default"))):
        runs[name] = measured_batch(f"options: {name}", models, device, dict(BENCH_OPTIONS, **extra))
        final = all(s.status not in (mtt.Status.REGULAR, mtt.Status.INITIAL) for s in runs[name]["stats"])
        finite = all(np.all(np.isfinite(s.solution)) for s in runs[name]["stats"] if s.success)
        check(final and finite, f"options {name}: a lane without a final status or with non-finite results")
    for name in ("pcg_flex", "precond_refine"):
        check(runs[name]["solved"] == len(models), f"options {name}: the suite did not solve 8/8")
    same = all(a.iter == b.iter and np.array_equal(a.solution, b.solution) and a.objective == b.objective
               for a, b in zip(runs["highest"]["stats"], plain["stats"]))
    log(f"options: factor_precision='highest' bit-equal to the plain run: {same}; torch default "
        f"float32 matmul precision after the runs: {torch.get_float32_matmul_precision()}")
    check(same, "factor_precision='highest' changed the iterates")
    check(torch.get_float32_matmul_precision() == "highest", "factor_precision leaked out of its scope")
    return runs["pcg_flex"]


#: the tensor cores' dense peaks (NVIDIA's H100 SXM data sheet) for the
#: Ozaki kernel's operation bound
OZAKI_PEAK_OPS = {"bf16": 989e12, "i8": 1979e12}
#: the TPU kernels each entry point of csrc/ozaki.cu replaces (XLA dots,
#: no Pallas ancestor)
OZAKI_REPLACES = {"bf16_fwd": "madipm_tpu/ops/ozaki.py:153", "bf16_t": "madipm_tpu/ops/ozaki.py:312",
                  "i8_fwd": "madipm_tpu/ops/ozaki.py:279", "i8_t": "madipm_tpu/ops/ozaki.py:336"}


def ozaki_bound(entry, sm, out_len) -> tuple:
    """(least milliseconds, what sets it) of one entry point: the slices,
    the fp64 vector (B, K) and the row scale read once, the fp64 output
    written once; 2 S 8 m n tensor-core operations (the n8 fragment).  The
    int8 entry points took the vector's eight int8 slices (B, 8, K) before
    they sliced it themselves: B 8 K bytes either way, the same number."""
    B, S, m, n = sm.slices.shape
    K = m if entry.endswith("_t") else n
    nbytes = sm.slices.numel() * sm.slices.element_size() + B * K * 8 + sm.row_scale.numel() * 8 + B * out_len * 8
    ops = 2.0 * B * S * 8 * m * n
    t_ops, t_bytes = ops / OZAKI_PEAK_OPS[entry.split("_")[0]], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def graph_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Mean device milliseconds per call of ``fn``: ``calls`` calls captured
    in one CUDA graph, replayed ``reps`` times between two events, so that
    the host's time per call does not set the pace."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


#: device operations a whole product may enqueue: the contraction, and the
#: combine of its partials
OZAKI_MAX_OPS = 2


def check_ozaki_entry(entry, A, vec, sm) -> dict:
    """One entry point of the Ozaki kernel on the card, against its plain
    version on ``vector_operands``' slices of the same vector (the pair
    partials are exact, so only the last fp64 sum differs: <= 1e-15 K
    rowmax|A| max|x|) and against torch.bmm in fp64 (the operator's bound,
    2K 2^-8(S-1) for bf16 and 2K 2^-7(S-1) for int8, relative to rowmax|A|
    max|x|).  Each entry point slices the vector itself: its slices and
    scale must be bit-equal to ``vector_operands``', and a whole call
    (``apply`` / ``apply_t``) may enqueue at most OZAKI_MAX_OPS
    operations.  Two calls must give the same bits.  Then, in turns, the
    kernel alone and torch.bmm (device time per call, from a CUDA graph,
    and the time per call of back-to-back calls on the stream), the whole
    call and the plain version (back to back)."""
    B, S, m, n = sm.slices.shape
    transposed = entry.endswith("_t")
    bf16 = entry.startswith("bf16")
    K = m if transposed else n
    apply = ozaki.apply_t if transposed else ozaki.apply
    vs, vscale = ozaki.vector_operands(entry, sm, vec)
    wrapper = ozaki.kernel_bf16 if bf16 else ozaki.kernel_i8
    kernel = lambda: wrapper(entry, sm, vec)  # noqa: E731
    y, kslices, kscale = wrapper(entry, sm, vec, keep_slices=True)
    torch.cuda.synchronize()
    raw = torch.int16 if bf16 else torch.int8
    slices_equal = torch.equal(kslices.view(raw), vs.view(raw)) and torch.equal(kscale, vscale)
    again = kernel()
    ref = ozaki.plain_contract(entry, sm, vs, vscale)
    call = apply(sm, vec)
    library = (lambda: torch.bmm(vec.unsqueeze(1), A).squeeze(1)) if transposed else \
        (lambda: torch.bmm(A, vec.unsqueeze(-1)).squeeze(-1))
    exact = library()
    torch.cuda.synchronize()
    ops = enqueued_operations(lambda _: apply(sm, vec), None)
    rowmax = A.abs().amax(dim=-1)  # (B, m)
    scale = (rowmax.amax(dim=-1, keepdim=True) if transposed else rowmax) * vec.abs().amax(dim=-1, keepdim=True)
    err_plain = float(((y - ref).abs() / scale).max())
    err_exact = float(((y - exact).abs() / scale).max())
    bits = 8 if bf16 else 7
    bound = 2.0 * K * 2.0 ** (-bits * (S - 1))
    label = f"ozaki {entry} S={S} at ({B}, {m}, {n})"
    log(f"{label}: relative to rowmax|A| max|x|, |kernel - plain| {err_plain:.3e} (tol 1e-15 K = "
        f"{1e-15 * K:.3e}), |kernel - bmm| {err_exact:.3e} (bound {bound:.3e}); "
        f"the kernel's vector slices and scale bit-equal to vector_operands': {slices_equal}; "
        f"two calls bit-equal: {torch.equal(y, again)}; whole call equal: {torch.equal(y, call)}; "
        f"operations a whole call enqueues: {ops}")
    check(slices_equal, f"{label}: the kernel's vector slices or scale differ from vector_operands'")
    check(err_plain <= 1e-15 * K, f"{label}: the kernel disagrees with its plain version")
    check(err_exact <= bound, f"{label}: the kernel is outside the operator's bound against torch.bmm")
    check(torch.equal(y, again), f"{label}: two calls of the kernel differ in a bit")
    check(torch.equal(y, call), f"{label}: the wrapper's call differs from the kernel on its own operands")
    check(ops <= OZAKI_MAX_OPS, f"{label}: a whole call enqueued {ops} operations, more than {OZAKI_MAX_OPS}")
    times = {}
    for turn in ("kernel", "library", "call", "plain", "plain", "call", "library", "kernel"):
        if turn in ("kernel", "library"):
            fn = kernel if turn == "kernel" else library
            times.setdefault(turn, []).append(graph_ms(fn))
            times.setdefault(turn + "_stream", []).append(cuda_ms(fn, reps=10))
        else:
            fn = (lambda: apply(sm, vec)) if turn == "call" else \
                (lambda: ozaki.plain_contract(entry, sm, vs, vscale))
            times.setdefault(turn, []).append(cuda_ms(fn, reps=2 if turn == "plain" else 10))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    b_ms, b_by = ozaki_bound(entry, sm, n if transposed else m)
    log(f"{label}: kernel {ms['kernel']:.4f} ms on the device ({ms['kernel_stream']:.4f} back to back), "
        f"whole call {ms['call']:.4f} ms back to back ({ms['call'] - ms['kernel']:+.4f} against the kernel), "
        f"plain {ms['plain']:.4f} ms, torch.bmm {ms['library']:.4f} ms on the device "
        f"({ms['library_stream']:.4f} back to back; kernel / bmm {ms['kernel'] / ms['library']:.2f}), "
        f"bound {b_ms:.4f} ms by {b_by} ({b_ms / ms['kernel']:.1%} of it)")
    return dict(shape=[B, m, n], dtype=entry.split("_")[0], slices=S, enqueued_operations=ops,
                max_abs_err=float((y - ref).abs().max()), ms=ms["kernel"], stream_ms=ms["kernel_stream"],
                call_ms=ms["call"], plain_ms=ms["plain"], bound_ms=b_ms, bound_by=b_by,
                library_ms=ms["library"], library_stream_ms=ms["library_stream"])


@contextlib.contextmanager
def ozaki_shapes(seen: set):
    """Adds to ``seen`` the (entry, slices' shape (B, S, m, n)) of every
    product the Ozaki kernel computes inside, so that each shape a main
    path gives the kernel is held against the plain version."""
    product = ozaki.kernel_product

    def record(entry, sm, vec):
        seen.add((entry, tuple(sm.slices.shape)))
        return product(entry, sm, vec)

    ozaki.kernel_product = record
    try:
        yield seen
    finally:
        ozaki.kernel_product = product


#: the LP suite's (B, m, n), where every entry point is timed for the table
OZAKI_MAIN_SHAPE = (8, 1024, 2048)


def phase_ozaki_kernel(seen: set) -> dict:
    """The four entry points of csrc/ozaki.cu at the LP suite's shape, bf16
    at 5 and 7 slices, int8 at 8, and each at every (entry, shape) that
    phase 13's runs launched (``seen``): A' of the suite through its stored
    transposed slices is bf16_fwd at (8, 2048, 1024), the certificates run
    one instance (B = 1) through both variants.  Rows keyed by (entry, S,
    (B, m, n))."""
    B, m, n = OZAKI_MAIN_SHAPE
    wanted = {(f"{variant}_{d}", (B, S, m, n)) for variant, counts in (("bf16", (5, 7)), ("i8", (8,)))
              for S in counts for d in ("fwd", "t")} | seen
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    rows = {}
    for shape in sorted({(b, mm, nn) for _, (b, _, mm, nn) in wanted}):
        b, mm, nn = shape
        A = torch.randn(b, mm, nn, generator=gen, device="cuda", dtype=torch.float64)
        A = A * (torch.rand(b, mm, nn, generator=gen, device="cuda") < 0.15)
        A = A * torch.exp(torch.rand(b, mm, 1, generator=gen, device="cuda", dtype=torch.float64) * 4 - 2)
        x = torch.randn(b, nn, generator=gen, device="cuda", dtype=torch.float64)
        v = torch.randn(b, mm, generator=gen, device="cuda", dtype=torch.float64)
        for variant in ("bf16", "i8"):
            for S in sorted({S for entry, (bb, S, m2, n2) in wanted
                             if entry.startswith(variant) and (bb, m2, n2) == shape}):
                sm = ozaki.slice_any(A, variant, S)
                check(tuple(sm.slices.shape) == (b, S, mm, nn), f"ozaki slices of {shape} at S={S}")
                for entry, vec in ((f"{variant}_fwd", x), (f"{variant}_t", v)):
                    if (entry, (b, S, mm, nn)) in wanted:
                        rows[entry, S, shape] = check_ozaki_entry(entry, A, vec, sm)
                del sm
    check(all((e, sh[1], (sh[0], sh[2], sh[3])) in rows for e, sh in seen),
          "an Ozaki kernel shape of the main path was not held against the plain version")
    return rows


def ozaki_batch(label, models, device, options, native) -> dict:
    """The LP suite with an Ozaki option, launch counters set to 0 just
    before and read just after: 8/8, each lane's iterations and objective
    beside the native run ``native``, objectives to 1e-7 relative."""
    ozaki.launches = dict.fromkeys(ozaki.ENTRIES, 0)
    chol_inv.launches = 0
    stats = mtt.madipm_batch(models, device=device, **options)
    launches = dict(ozaki.launches)
    iters = [s.iter for s in stats]
    gaps = [abs(a.objective - b.objective) / max(1.0, abs(b.objective)) for a, b in zip(stats, native)]
    wall = stats[0].solver_time
    log(f"{label}: {sum(s.success for s in stats)}/{len(stats)} solved, iterations {iters} "
        f"(native fp64 {[s.iter for s in native]}), wall {wall:.4f} s against native "
        f"{native[0].solver_time:.4f} s in this run ({wall / native[0].solver_time:.2f}x), "
        f"{sum(iters) / wall:.2f} iter/s; objectives against native "
        f"{max(gaps):.3e} relative (worst); ozaki launches {launches}, chol_inv launches {chol_inv.launches}")
    check(all(s.success for s in stats), f"{label}: the suite did not solve {len(stats)}/{len(stats)}")
    check(all(np.all(np.isfinite(s.solution)) for s in stats), f"{label}: non-finite solutions")
    check(max(gaps) <= 1e-7, f"{label}: objectives off the native run's")
    return dict(stats=stats, launches=launches, iters=iters, wall=wall, wall_ratio=wall / native[0].solver_time)


def phase_ozaki(device, lp_run) -> dict:
    """Phase 13: the Ozaki fp64 operator.  The LP suite of phase 4 (the
    rhs-scaled models) with bench.py's accelerator options, fp64_matvec=
    "ozaki" and 5 slices (A and A' stored: the bf16 forward entry), then
    with "ozaki_i8" and shared slices (the int8 forward and transposed
    entries); the four 1024 x 2048 known-optimum LPs through "ozaki" at 5
    slices and through "ozaki_i8", both with shared slices (the forward and
    transposed entries of each at B = 1), at rel-KKT <= 1e-8; then the
    kernel's four entry points against their plain versions and
    torch.bmm."""
    native = lp_run["stats"]
    ozaki_opts = dict(BENCH_OPTIONS, fp64_matvec="ozaki", ozaki_slices=5)
    seen = set()
    with ozaki_shapes(seen):
        out = {"bf16": ozaki_batch("Ozaki LP suite (bf16, S=5)", lp_run["models"], device, ozaki_opts, native)}
        check(out["bf16"]["launches"]["bf16_fwd"] > 0, "the Ozaki LP suite never launched the bf16 kernel")
        out["i8"] = ozaki_batch("Ozaki LP suite (int8, shared slices)", lp_run["models"], device,
                                dict(BENCH_OPTIONS, fp64_matvec="ozaki_i8", ozaki_share_slices=True), native)
        check(out["i8"]["launches"]["i8_fwd"] > 0 and out["i8"]["launches"]["i8_t"] > 0,
              "the int8 Ozaki LP suite never launched an int8 entry point")
        for key, label, opts in (("cert", "ozaki S=5 shared", dict(fp64_matvec="ozaki", ozaki_slices=5)),
                                 ("cert_i8", "ozaki_i8 shared", dict(fp64_matvec="ozaki_i8"))):
            ozaki.launches = dict.fromkeys(ozaki.ENTRIES, 0)
            worst = 0.0
            for deg in (False, True):
                for seed in (1, 2):
                    qp, info = known_optimum_lp(1024, 2048, seed=seed + 1024, degenerate=deg)
                    worst = max(worst, certify(qp, info, device, f"{qp.name} seed {seed + 1024} {label}",
                                               **dict(CERT_OPTIONS, ozaki_share_slices=True, **opts))[0])
            out[key] = dict(ozaki.launches)
            log(f"Ozaki certificate ({label}): 4/4 LPs at rel-KKT <= 1e-8 (worst {worst:.3e}); "
                f"ozaki launches {out[key]}")
    log(f"Ozaki kernel shapes (entry, (B, S, m, n)) launched in phase 13: {sorted(seen)}")
    log(f"Ozaki LP suite wall against the native run of this call: bf16 S=5 {out['bf16']['wall_ratio']:.2f}x, "
        f"int8 {out['i8']['wall_ratio']:.2f}x")
    check(out["cert"]["bf16_fwd"] > 0 and out["cert"]["bf16_t"] > 0,
          "the Ozaki certificates never launched a bf16 entry point")
    check(out["cert_i8"]["i8_fwd"] > 0 and out["cert_i8"]["i8_t"] > 0,
          "the int8 Ozaki certificates never launched an int8 entry point")
    out["rows"] = phase_ozaki_kernel(seen)
    return out


#: phase 12's fp64 configuration: the default CHOLESKY system in fp64 (the
#: distributed factor takes chol_inv for every diagonal block)
FP64_OPTIONS = dict(
    tol=1e-8,
    max_iter=300,
    regularization=mtt.FixedRegularization(1e-8, -1e-8),
    print_level=mtt.PrintLevel.ERROR,
)


def mesh_pair(label, qp, mesh, options) -> dict:
    """``qp`` through the mesh (launch counter set to 0 just before it,
    read just after) and without it; the same status, iterations equal or
    +-1 (the difference logged), objectives to 1e-8 relative."""
    plain = mtt.MPCSolver(qp, device="cuda", rethrow_error=True, **options).solve()
    chol_inv.launches = 0
    sync.count = 0
    st = mtt.MPCSolver(qp, mesh=mesh, rethrow_error=True, **options).solve()
    launches, syncs = chol_inv.launches, sync.count
    gap = abs(st.objective - plain.objective) / max(1.0, abs(plain.objective))
    log(f"{label}: mesh {st.status.name} in {st.iter} iterations, {st.solver_time:.4f} s, "
        f"{syncs / max(1, st.iter):.2f} syncs per iteration, chol_inv launches {launches}; "
        f"mesh-free {plain.status.name} in {plain.iter}, {plain.solver_time:.4f} s; objectives "
        f"{gap:.3e} apart")
    if st.iter != plain.iter:
        log(f"{label}: the iteration counts differ by {st.iter - plain.iter}: the distributed "
            f"factor forms the panel block as D W' and orders the K1 sums differently")
    check(st.status == plain.status and st.success and abs(st.iter - plain.iter) <= 1 and gap <= 1e-8,
          f"{label}: the mesh solve disagrees with the mesh-free one")
    check(launches > 0, f"{label}: the mesh solve never launched the chol_inv kernel")
    check(np.all(np.isfinite(st.solution)) and st.solution.shape == (qp.nvar,),
          f"{label}: non-finite or misshapen solution")
    return dict(stats=st, launches=launches)


def phase_mesh(lp_run) -> dict:
    """Phase 12: the mesh path on a one-rank NCCL group (the card's machine
    has one GPU, and NCCL takes one rank per GPU).  Returns the kernel rows
    and launches of its runs."""
    import torch.distributed as dist

    from madipm_tpu_torch.tools import dryrun_multichip

    os.makedirs(OUT_DIR, exist_ok=True)
    store = os.path.join(OUT_DIR, f"nccl_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    init_distributed(f"file://{store}", num_processes=1, process_id=0)
    out = {}
    try:
        check(dist.get_backend() == "nccl", f"the process group is {dist.get_backend()}, not nccl")
        # NCCL sets its communicator up at the first collective: not in a timed solve
        dist.all_reduce(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()
        cols = make_mesh(1, ("cols",))
        check(cols.device_type == "cuda", "the mesh is not on the CUDA device")
        lp = make_suite(k=1, n=2048, m=1024, density=0.15)[0]
        out["lp32"] = mesh_pair("mesh LP (accelerator options)", lp, cols, BENCH_OPTIONS)
        out["lp64"] = mesh_pair("mesh LP (fp64)", lp, cols, FP64_OPTIONS)
        qp = make_qp_suite(k=1, m=512, n=1024, density=0.15)[0]
        out["k1"] = mesh_pair("mesh K1 QP", qp, cols, QP_OPTIONS)
        worst = 0.0
        for deg in (False, True):
            for seed in (1, 2):
                model, info = known_optimum_lp(1024, 2048, seed=seed + 1024, degenerate=deg)
                kkt, _ = certify(model, info, "cuda", f"mesh {model.name} seed {seed + 1024}",
                                 mesh=cols, **CERT_OPTIONS)
                worst = max(worst, kkt)
        log(f"mesh certificate: 4/4 LPs at rel-KKT <= 1e-8 (worst {worst:.3e})")
        batch = make_mesh(1, ("batch",))
        chol_inv.launches = 0
        stats = mtt.madipm_batch(lp_run["models"], mesh=batch, **BENCH_OPTIONS)
        out["batch_launches"] = chol_inv.launches
        same = [a.iter == b.iter and a.objective == b.objective for a, b in zip(stats, lp_run["stats"])]
        gaps = [abs(a.objective - b.objective) / max(1.0, abs(b.objective))
                for a, b in zip(stats, lp_run["stats"])]
        log(f"mesh madipm_batch: {sum(s.success for s in stats)}/{len(stats)} solved, iterations "
            f"{[s.iter for s in stats]}, wall {stats[0].solver_time:.4f} s, chol_inv launches "
            f"{out['batch_launches']}; lanes equal to phase 4's: {sum(same)}/{len(same)} "
            f"(largest objective gap {max(gaps):.3e})")
        check(all(s.success for s in stats) and all(a.iter == b.iter for a, b in zip(stats, lp_run["stats"]))
              and max(gaps) <= 1e-12, "the mesh batch disagrees with the mesh-free batch")
        check(out["batch_launches"] > 0, "the mesh batch never launched the chol_inv kernel")
        dryrun_multichip.run(log=log)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    n = 1024
    for dtype in (torch.float32, torch.float64):
        S = random_spd(1, n, dtype, gen)
        out["row", dtype] = check_kernel(
            "chol_inv", S, chol_inv.chol_inv, block_chol.chol_inv, library_chol_inv,
            flops=2 * float(n) ** 3 / 3, nbytes=3 * n * n * S.element_size(), plain_reps=3)
    return out


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
    lib = _cuda.build()
    log(f"build: {lib.name} in {time.time() - t0:.2f} s")

    rows = phase_kernel()
    lp_run = phase_main_path("cuda")
    phase_certificate("cuda")
    qp_inv_launches, qp_chol_launches = phase_qp_main_path("cuda")
    phase_qp_certificate("cuda")
    sparse_launches, tall = phase_sparse_tall("cuda")
    phase_sparse_auto_and_determinism(tall[0], "cuda")
    del tall
    phase_sparse_against_dense("cuda", lp_run)
    phase_sparse_qp_certificate("cuda")
    phase_from_mps("cuda")
    structured_launches, sizes, transport = phase_structured("cuda")
    phase_model("cuda", transport)
    del transport
    phase_drivers("cuda")
    flex_run = phase_options("cuda", lp_run["models"])
    mesh = phase_mesh(lp_run)
    oz = phase_ozaki("cuda", lp_run)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for n in sizes:  # the structured suite's factors, the largest kept for the table
        S = random_spd(1, n, torch.float64, gen)
        structured_row = check_kernel("cholesky", S, kernel_cholesky, plain_cholesky, torch.linalg.cholesky_ex,
                                      flops=float(n) ** 3 / 3, nbytes=2 * n * n * 8, plain_reps=1)
    log(f"total {time.time() - t0:.1f} s")

    source = "madipm_tpu_torch/csrc/chol_inv.cu"
    # one row for each (kernel, dtype) that a main path runs, with the
    # launches of that path's timed run
    kernels = [
        dict(name="chol_inv", route="cuda", source=source, path="LP main path (NORMAL)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=lp_run["chol_inv"],
             **rows["chol_inv", torch.float32, 1024]),
        dict(name="chol_inv", route="cuda", source=source, path="QP main path (K1, CHOLESKY_INV)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=qp_inv_launches,
             **rows["chol_inv", torch.float64, 1024]),
        dict(name="cholesky", route="cuda", source=source, path="QP main path (K1, CHOLESKY, use_pallas)",
             replaces="madipm_tpu/ops/pallas_chol.py:225", launches=qp_chol_launches,
             **rows["cholesky", torch.float64, 1024]),
        dict(name="chol_inv", route="cuda", source=source, path="sparse LP path (NORMAL, ELL)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=sparse_launches,
             **rows["chol_inv", torch.float32, 2048]),
        dict(name="cholesky", route="cuda", source=source,
             path="structured suite (logged driver, NORMAL and K1 CHOLESKY, use_pallas), largest factor",
             replaces="madipm_tpu/ops/pallas_chol.py:225", launches=structured_launches, **structured_row),
        dict(name="chol_inv", route="cuda", source=source, path="LP main path with pcg_flex",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=flex_run["chol_inv"],
             **rows["chol_inv", torch.float32, 1024]),
        dict(name="chol_inv", route="cuda", source=source,
             path="mesh LP bench instance (one-rank NCCL, distributed NORMAL factor, accelerator options)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=mesh["lp32"]["launches"],
             **mesh["row", torch.float32]),
        dict(name="chol_inv", route="cuda", source=source,
             path="mesh LP bench instance (one-rank NCCL, distributed NORMAL factor, fp64)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=mesh["lp64"]["launches"],
             **mesh["row", torch.float64]),
        dict(name="chol_inv", route="cuda", source=source,
             path="mesh K1 QP bench instance (one-rank NCCL, distributed K1 factor, fp64)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=mesh["k1"]["launches"],
             **mesh["row", torch.float64]),
        dict(name="chol_inv", route="cuda", source=source,
             path="LP suite through madipm_batch(mesh=...) (one-rank NCCL)",
             replaces="madipm_tpu/ops/pallas_chol.py:239", launches=mesh["batch_launches"],
             **rows["chol_inv", torch.float32, 1024]),
    ]
    oz_source = "madipm_tpu_torch/csrc/ozaki.cu"
    for entry, path, launches in (
            ("bf16_fwd", "LP suite, fp64_matvec='ozaki', ozaki_slices=5 (bench.py's accelerator options)",
             oz["bf16"]["launches"]["bf16_fwd"]),
            ("bf16_t", "known-optimum LPs 1024 x 2048, 'ozaki' S=5, ozaki_share_slices=True",
             oz["cert"]["bf16_t"]),
            ("i8_fwd", "LP suite, fp64_matvec='ozaki_i8', ozaki_share_slices=True",
             oz["i8"]["launches"]["i8_fwd"]),
            ("i8_t", "LP suite, fp64_matvec='ozaki_i8', ozaki_share_slices=True",
             oz["i8"]["launches"]["i8_t"])):
        n_slices = 5 if entry.startswith("bf16") else ozaki.N8_SLICES
        row = dict(name=f"ozaki_{entry}", route="cuda", source=oz_source, path=path,
                   replaces=OZAKI_REPLACES[entry], launches=launches,
                   **oz["rows"][entry, n_slices, OZAKI_MAIN_SHAPE])
        # launches of the four certificates (B = 1) through this entry's variant
        row["certificate_launches"] = oz["cert" if entry.startswith("bf16") else "cert_i8"][entry]
        if entry.startswith("bf16"):
            row["at_7_slices"] = oz["rows"][entry, 7, OZAKI_MAIN_SHAPE]
        # the other shapes phase 13's runs gave this entry point
        row["path_shapes"] = [r for (e, S, shape), r in sorted(oz["rows"].items())
                              if e == entry and (S, shape) not in ((n_slices, OZAKI_MAIN_SHAPE),
                                                                    (7, OZAKI_MAIN_SHAPE))]
        kernels.append(row)
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
