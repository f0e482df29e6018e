"""Cholesky factors of SPD matrices: the hand-written CUDA kernel and its
wrappers.

``csrc/chol_inv.cu`` holds one persistent kernel with two entry points:
(L, L^-1), which replaces
``madipm_tpu/ops/pallas_chol.py::pallas_chol_inv``, and L alone, which
replaces ``pallas_cholesky``; the source note says what bounds them on an
H100 and how the kernel is laid out.  The kernel library is built and
loaded by ``ops/_cuda.py`` at first use.

The launch geometry is decided here, by :func:`plan`, from the batch, the
size, the element type and two figures of the device, and handed to the C
function as ints; the wrappers allocate the outputs and the scratch with
torch.  A call enqueues two operations (:data:`ENQUEUED_OPS`), whatever N.

:func:`chol_inv` and :func:`cholesky` launch the kernel for a CUDA tensor
and run the plain torch version (``ops/block_chol``) for a CPU tensor; a
CUDA tensor never falls back.  ``launches`` and ``cholesky_launches`` count
the kernel launches of each.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda, block_chol

#: tile edge of the kernel: N must be a multiple of it
PANEL = 32

#: operations one call puts on the stream: a memset of the counters and the kernel
ENQUEUED_OPS = 2

#: number of times :func:`chol_inv` launched the CUDA kernel
launches = 0
#: number of times :func:`cholesky` launched the CUDA kernel
cholesky_launches = 0

_lib = None

# the kernel's geometry (csrc/chol_inv.cu: WARPS, CTAS_PER_SM, struct Geo)
_WARPS = 4
_CTAS_PER_SM = 2
_UNIT_BYTES = 128
#: shared memory the runtime keeps for itself in every resident block
_RESERVED_SMEM = 1024


def smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of one CTA: per warp a two-stage ring of
    (A, B) units, 32 rows of 128 bytes each padded by 4 elements, and three
    32 x 36 tiles."""
    size = torch.empty((), dtype=dtype).element_size()
    stage = 2 * PANEL * (_UNIT_BYTES // size + 4)
    return (_WARPS * 2 * stage + 3 * PANEL * (PANEL + 4)) * size


def resident_ctas(dtype: torch.dtype, sm_count: int, smem_per_block: int) -> int:
    """CTAs of the kernel the device holds at once: the kernel is built for
    two per SM (registers), if the SM's shared memory (what one block may
    opt in to, plus its reserve) holds two."""
    per_sm = (smem_per_block + _RESERVED_SMEM) // (smem_bytes(dtype) + _RESERVED_SMEM)
    return sm_count * min(_CTAS_PER_SM, per_sm)


class Plan(NamedTuple):
    """Launch geometry of one call."""

    ctas_per_instance: int   # G: CTAs that share one instance
    instances_per_wave: int  # groups of G CTAs in the grid
    waves: int               # instances each group takes in turn, at most
    smem_bytes: int          # dynamic shared memory of a CTA
    counter_ints: int        # int32 scratch: one counter per (instance, block row)
    tile_elems: int          # scratch of the factor-only entry: (B, N/32, 32, 32)

    @property
    def grid(self) -> int:
        return self.ctas_per_instance * self.instances_per_wave


def plan(B: int, N: int, dtype: torch.dtype, sm_count: int, smem_per_block: int) -> Plan:
    """Geometry for a (B, N, N) stack on a device with ``sm_count`` SMs and
    ``smem_per_block`` bytes of opt-in shared memory per block.  Every CTA
    of the grid must be resident (CTAs wait on each other's counters).  As
    many CTAs as fit share an instance, at most one per block row; what
    does not fit in one wave is taken in turns."""
    if B < 1 or N < PANEL or N % PANEL != 0:
        raise ValueError(f"plan: need B >= 1 and N a positive multiple of {PANEL}, got B={B}, N={N}")
    smem = smem_bytes(dtype)
    if smem > smem_per_block:
        raise ValueError(f"plan: the kernel needs {smem} bytes of shared memory per block, "
                         f"the device offers {smem_per_block}")
    resident = resident_ctas(dtype, sm_count, smem_per_block)
    nb = N // PANEL
    group = min(nb, max(1, resident // B))
    per_wave = min(B, resident // group)
    return Plan(group, per_wave, -(-B // per_wave), smem, B * nb, B * nb * PANEL * PANEL)


def rows_of(cta: int, group: int, nb: int) -> range:
    """Block rows (and block columns of the inverse) that CTA ``cta`` of a
    group of ``group`` owns: block-cyclic, as ``chol_kernel`` takes them."""
    return range(cta, nb, group)


def _load():
    global _lib
    if _lib is None:
        lib = _cuda.library()
        for name in ("madipm_chol_inv_f32", "madipm_chol_inv_f64",
                     "madipm_cholesky_f32", "madipm_cholesky_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _stack_for_kernel(S: torch.Tensor, name: str) -> torch.Tensor:
    """Check what the kernel takes and return ``S`` as a (B, N, N) stack.
    The device comes last, so that a CPU run reaches the other checks."""
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype must be float32 or float64, got {S.dtype}")
    if S.ndim not in (2, 3) or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"{name}: expected (N,N) or (B,N,N), got {tuple(S.shape)}")
    n = S.shape[-1]
    if n == 0 or n % PANEL != 0:
        raise ValueError(f"{name}: N={n} must be a positive multiple of {PANEL}")
    if not S.is_contiguous():
        raise ValueError(f"{name}: S must be contiguous")
    S3 = S.unsqueeze(0) if S.ndim == 2 else S
    if S3.shape[0] == 0:
        raise ValueError(f"{name}: empty batch")
    if S.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {S.device}")
    return S3


def _device_plan(S3: torch.Tensor) -> Plan:
    props = torch.cuda.get_device_properties(S3.device)
    return plan(S3.shape[0], S3.shape[-1], S3.dtype, props.multi_processor_count,
                props.shared_memory_per_block_optin)


def _launch(fn_name: str, S3: torch.Tensor, L: torch.Tensor, W: torch.Tensor, geo: Plan):
    """Enqueue one call (counter memset + kernel) on the current stream of
    ``S3``'s device.  The counters come from ``torch.empty``; the C function
    clears them on the stream."""
    suffix = "f32" if S3.dtype == torch.float32 else "f64"
    fn = getattr(_load(), f"madipm_{fn_name}_{suffix}")
    counters = torch.empty(geo.counter_ints, dtype=torch.int32, device=S3.device)
    with torch.cuda.device(S3.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(S3.data_ptr(), L.data_ptr(), W.data_ptr(), counters.data_ptr(),
                S3.shape[0], S3.shape[-1], geo.ctas_per_instance, geo.instances_per_wave,
                geo.smem_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA kernel launch failed with cudaError {rc}")


def chol_inv(S: torch.Tensor):
    """(L, L^-1) of SPD ``S`` ((N,N) or (B,N,N)), upper triangles zero;
    NaN where S is not SPD.  CPU tensors take the plain version."""
    if S.device.type == "cpu":
        return block_chol.chol_inv(S)
    S3 = _stack_for_kernel(S, "chol_inv")
    L = torch.empty_like(S3)
    W = torch.empty_like(S3)
    _launch("chol_inv", S3, L, W, _device_plan(S3))
    global launches
    launches += 1
    if S.ndim == 2:
        return L[0], W[0]
    return L, W


def cholesky(S: torch.Tensor) -> torch.Tensor:
    """L of SPD ``S`` ((N,N) or (B,N,N)), upper triangle zero; NaN where S
    is not SPD.  No inverse is formed.  CPU tensors take the plain version."""
    if S.device.type == "cpu":
        return block_chol.cholesky(S)
    S3 = _stack_for_kernel(S, "cholesky")
    geo = _device_plan(S3)
    L = torch.empty_like(S3)
    # the inverted diagonal tiles that the products below them read
    tiles = torch.empty(geo.tile_elems, dtype=S3.dtype, device=S3.device)
    _launch("cholesky", S3, L, tiles, geo)
    global cholesky_launches
    cholesky_launches += 1
    return L[0] if S.ndim == 2 else L
