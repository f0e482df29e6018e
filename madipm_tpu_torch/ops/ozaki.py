"""The Ozaki fp64 operator: y = A x and y = A' v from error-free slices.

Port of ``madipm_tpu/ops/ozaki.py``.  A is split once per solve into S
fixed-point slices, each row against a power-of-two scale e_i:

- bf16 (``slice_matrix``): ``A_ij = e_i sum_k a_k[i,j]`` with slice k an
  integer of at most 8 bits times 2^-8(k+1), exact in bf16;
- int8 (``slice_matrix_i8``): ``A_ij = 2 e_i sum_k w_k[i,j] 2^-7(k+1)``
  with |w_k| <= 64.

The vector is sliced the same way against one power-of-two scale per
call.  Every slice-pair product is then an integer on the pair's
power-of-two grid, so each pair's contraction is exact (bf16: in fp32 over
128-deep chunks; int8: in int32 below 2^19), and the only rounding is the
final fp64 sum over the pairs.  With S bf16 slices the result carries
about 2n 2^-8(S-1) error relative to rowmax|A| max|x|.

Differences from the JAX module:

- every tensor has a leading batch dimension (B, ...), where JAX used
  ``vmap``: slices are (B, S, m, n), row scales (B, m), vectors (B, n);
- the bf16 slices are stored (B, S, m, n) row-major, where JAX kept
  (S, C, m, 128) chunk blocks for the MXU; the values are the same;
- ``N_SLICES`` is a constant; a different count is the solver's
  ``ozaki_slices`` option.

The four products take the hand-written kernel ``csrc/ozaki.cu`` for a
CUDA tensor (its note says what bounds it and how it is laid out) and
their plain versions, in fp64 and exact pair by pair, on
:func:`vector_operands`' slices, for a CPU tensor.  Every entry point
takes the fp64 vector and slices it on the device, bit-equal to
:func:`vector_operands`, with the launch geometry of :func:`plan`: a
product is one or two device operations.  ``launches`` counts the
kernel's launches by entry point.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda

#: slice width in bits of the bf16 slices (the bf16 significand): a product
#: of two slices fits 16 bits, so a 128-deep fp32 sum of them is exact
T_BITS = 8
#: bf16 slices per operand (error ~2n 2^-8(S-1) relative to rowmax|A| max|x|)
N_SLICES = 7
#: contraction depth of one exact fp32 sum (2^16 * 2^7 = 2^23 < 2^24)
CHUNK = 128
#: slice width in bits of the int8 slices (|slice| <= 64)
T8_BITS = 7
#: int8 slices per operand
N8_SLICES = 8
#: the most slices the kernel takes: the vector's slices are the n8 of a fragment
KERNEL_MAX_SLICES = 8
#: the int32 sums are exact while the contraction is shorter than this
I8_MAX_DEPTH = 2 ** 19

#: kernel launches by entry point (``csrc/ozaki.cu``)
ENTRIES = ("bf16_fwd", "bf16_t", "i8_fwd", "i8_t")
launches = dict.fromkeys(ENTRIES, 0)

_lib = None


class SlicedMatrix(NamedTuple):
    """bf16 Ozaki slices of a (B, m, n) fp64 matrix.

    slices: (B, S, m, npad) bf16, npad = n rounded up to CHUNK; slice k
        holds integers times 2^-8(k+1) (the significance is in the values).
    row_scale: (B, m) fp64, the power-of-two scale e_i of each row.
    """

    slices: torch.Tensor
    row_scale: torch.Tensor


class SlicedMatrixI8(NamedTuple):
    """int8 Ozaki slices of a (B, m, n) fp64 matrix.

    slices: (B, S, m, n) int8, integers in [-64, 64]; slice k carries the
        weight 2^-7(k+1) relative to row_scale.
    row_scale: (B, m) fp64, 2 e_i (the 2 halves the leading slice into
        int8 range).
    """

    slices: torch.Tensor
    row_scale: torch.Tensor


def _pow2_scale(mx: torch.Tensor) -> torch.Tensor:
    """Power of two in (mx, 2 mx] (1.0 where mx == 0), exactly as the JAX
    package builds it: mx (1 + 2^-20) rounded to fp32, at least 2^-120,
    and 2^(exponent + 1) made from its int32 exponent bits, clipped to
    [1, 254].  A scale one ulp below mx would overflow the leading slice."""
    mx = mx.to(torch.float64)
    m32 = torch.clamp((mx * (1.0 + 2.0 ** -20)).to(torch.float32), min=2.0 ** -120)
    expo = (m32.view(torch.int32) >> 23) & 0xFF
    pbits = (torch.clamp(expo + 1, 1, 254) << 23).to(torch.int32)
    p32 = pbits.view(torch.float32)
    return torch.where(mx > 0, p32.to(torch.float64), 1.0)


def _fixed_point_slices(v: torch.Tensor, n_slices: int) -> torch.Tensor:
    """``v`` (in [-1, 1]) as ``n_slices`` bf16 slices of T_BITS bits,
    stacked at dimension 1: (B, ...) -> (B, S, ...).  Matrix and vector
    operands share this loop, so their products sit on one grid."""
    out = torch.empty((v.shape[0], n_slices, *v.shape[1:]), dtype=torch.bfloat16, device=v.device)
    scale = 1.0
    for k in range(n_slices):
        w = torch.round(v * (2.0 ** T_BITS))
        v = v * (2.0 ** T_BITS) - w
        scale = scale / (2.0 ** T_BITS)
        out[:, k] = (w * scale).to(torch.bfloat16)
    return out


def _fixed_point_slices_i8(v: torch.Tensor, n_slices: int) -> torch.Tensor:
    """``v`` (in [-1/2, 1/2]) as ``n_slices`` int8 slices of T8_BITS bits,
    stacked at dimension 1 as :func:`_fixed_point_slices` stacks them;
    round to nearest keeps every slice in [-64, 64]."""
    out = torch.empty((v.shape[0], n_slices, *v.shape[1:]), dtype=torch.int8, device=v.device)
    for k in range(n_slices):
        w = torch.round(v * (2.0 ** T8_BITS))
        v = v * (2.0 ** T8_BITS) - w
        out[:, k] = w.to(torch.int8)
    return out


def _batched(A: torch.Tensor, name: str) -> torch.Tensor:
    if A.ndim != 3:
        raise ValueError(f"{name}: expected a (B, m, n) stack, got {tuple(A.shape)}")
    return A.to(torch.float64).contiguous()


def slice_matrix(A: torch.Tensor, n_slices: int = N_SLICES) -> SlicedMatrix:
    """bf16 slices of fp64 ``A`` (B, m, n), its columns padded to CHUNK."""
    A = _batched(A, "slice_matrix")
    n = A.shape[-1]
    npad = -(-n // CHUNK) * CHUNK
    if npad != n:
        A = F.pad(A, (0, npad - n))
    e = _pow2_scale(torch.amax(torch.abs(A), dim=-1))
    return SlicedMatrix(_fixed_point_slices(A / e.unsqueeze(-1), n_slices), e)


def slice_matrix_i8(A: torch.Tensor, n_slices: int = N8_SLICES) -> SlicedMatrixI8:
    """int8 slices of fp64 ``A`` (B, m, n)."""
    A = _batched(A, "slice_matrix_i8")
    e = _pow2_scale(torch.amax(torch.abs(A), dim=-1))
    S = _fixed_point_slices_i8(A / (2.0 * e.unsqueeze(-1)), n_slices)
    return SlicedMatrixI8(S, 2.0 * e)


def slice_any(A: torch.Tensor, variant: str = "bf16", n_slices=None):
    """Slices of ``A`` for ``variant`` ("bf16" or "i8"); ``n_slices``
    overrides N_SLICES for bf16 (the int8 count is N8_SLICES)."""
    if variant == "bf16":
        return slice_matrix(A, n_slices or N_SLICES)
    if variant == "i8":
        return slice_matrix_i8(A)
    raise ValueError(f"unknown ozaki variant {variant!r}")


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.to(torch.float64)


def _vector(x: torch.Tensor, length: int, name: str, pad: bool) -> torch.Tensor:
    x = _f64(x)
    if x.ndim != 2:
        raise ValueError(f"{name}: expected a (B, len) vector stack, got {tuple(x.shape)}")
    if x.shape[-1] > length or (x.shape[-1] != length and not pad):
        raise ValueError(f"{name}: vector of length {x.shape[-1]}, expected {length}")
    if x.shape[-1] != length:
        x = F.pad(x, (0, length - x.shape[-1]))
    return x


# ---------------------------------------------------------------------------
# Plain versions: each slice pair's partial exactly in fp64
# ---------------------------------------------------------------------------
#
# A pair's partial is at most K 2^16 (bf16) or K 2^12 (int8) units of its
# grid, far inside fp64's 53 bits, so an fp64 product of the slice values
# is exact pair by pair whatever its order of summation.


def _pairs(a: torch.Tensor, vs: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Exact pair partials: (B, S, m, n) slices and (B, T, K) vector
    slices -> (B, S, m, T) forward or (B, S, T, n) transposed, fp64."""
    a = a.to(torch.float64)
    vs = vs.to(torch.float64)
    if transposed:
        return torch.matmul(vs.unsqueeze(1), a)
    return torch.matmul(a, vs.mT.unsqueeze(1))


def _i8_weights(S: int, T: int, device) -> torch.Tensor:
    """w[s, t] = 2^-7(s+t+2), the pair significance of the int8 slices."""
    s = np.arange(S)[:, None]
    t = np.arange(T)[None, :]
    return torch.as_tensor(2.0 ** (-T8_BITS * (s + t + 2.0)), dtype=torch.float64, device=device)


def plain_contract(entry: str, sm, vs: torch.Tensor, vscale: torch.Tensor) -> torch.Tensor:
    """The plain version of entry point ``entry`` (one of ENTRIES): the
    fp64 sum of the exact pair partials of ``sm`` and the vector's slices
    ``vs`` (B, T, K), times ``vscale`` (B,) and, forward, the row scale."""
    transposed = entry.endswith("_t")
    P = _pairs(sm.slices, vs, transposed)
    if entry.startswith("bf16"):
        y = P.sum(dim=(1, 2) if transposed else (1, 3))
    else:
        W = _i8_weights(P.shape[1], vs.shape[1], P.device)
        y = torch.einsum("bstn,st->bn" if transposed else "bsmt,st->bm", P, W)
    y = vscale.to(torch.float64).unsqueeze(-1) * y
    return y if transposed else sm.row_scale * y


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

# the kernel's geometry (csrc/ozaki.cu: STAGES, MAX_SPAN, VPAD, smem_bytes
# and struct Geo for bf16; I8_STAGES, I8_VPAD, smem_bytes_i8 and struct
# Geo8 for int8)
#: outputs (rows forward, columns transposed) of one bf16 CTA; transposed
#: CTAs take WIDE_TILE where the grid still fills the card
TILE = 32
WIDE_TILE = 64
#: the tiles each (variant, transposed) takes, widest first
TILES = {("bf16", False): (TILE,), ("bf16", True): (WIDE_TILE, TILE),
         ("i8", False): (64, 32), ("i8", True): (128, 64, 32)}
#: blocks of a bf16 CTA's shared-memory ring, each one slice's tile x CHUNK block
STAGES = 3
#: blocks of an int8 CTA's ring
I8_STAGES = 3
#: most CHUNKs in one CTA's span: its vector slices stay in shared memory
MAX_SPAN = 16
#: padding of each vector-slice row in shared memory: bf16 elements, int8 bytes
VPAD = 8
I8_VPAD = 16
#: the fewest CTAs a launch aims at, per SM
CTAS_PER_SM = 2
#: the most groups an int8 call cuts the S slices into: each group re-slices
#: the vector and adds a partial to the combine (two beat four at B = 1)
MAX_GROUPS = 2


def smem_bytes(n_slices: int, span_chunks: int, tile: int = TILE, variant: str = "bf16") -> int:
    """Dynamic shared memory of one CTA: the ring, then the vector's slices
    over its span."""
    if variant == "i8":
        return I8_STAGES * tile * CHUNK + n_slices * (span_chunks * CHUNK + I8_VPAD)
    return STAGES * tile * CHUNK * 2 + n_slices * (span_chunks * CHUNK + VPAD) * 2


class Plan(NamedTuple):
    """Launch geometry of one call."""

    tile: int          # outputs of a CTA (one of TILES[variant, transposed])
    tiles: int         # output tiles of an instance
    split: int         # spans of whole chunks that one tile's contraction is cut into
    span_chunks: int   # CHUNKs in each span
    smem_bytes: int    # dynamic shared memory of a CTA
    work_doubles: int  # fp64 scratch: the partials (B, split groups, OUT) and B scales; 0 at one partial
    ctas: int          # the grid: B * tiles * split * groups
    groups: int        # equal groups of the S slices, each its own CTA (int8 only; else 1)


@functools.lru_cache(maxsize=1024)
def plan(B: int, n_slices: int, m: int, n: int, transposed: bool, sm_count: int,
         variant: str = "bf16") -> Plan:
    """Geometry of a call on (B, n_slices, m, n) slices of ``variant``
    ("bf16" or "i8") on a device with ``sm_count`` SMs.  A CTA takes the
    widest of TILES[variant, transposed] whose grid, split to whole
    chunks, can reach CTAS_PER_SM CTAs per SM (B * out / tile * K / CHUNK
    of them), else the narrowest: a transposed row segment of 64 (bf16)
    or 128 (int8) columns is 128 contiguous bytes of a slice row.  The
    contraction (K = n forward, m transposed) is split over the fewest
    CTAs that give the grid CTAS_PER_SM CTAs per SM and keep each span
    within MAX_SPAN chunks, rounded up to a divisor of K / CHUNK, so that
    every span is the same count of whole chunks.  Where the chunks run
    out first (int8 at B = 1), the S slices are also cut into MAX_GROUPS
    equal groups, each a CTA of its own whose partial is the pair sums of
    its slices; the tile is then the widest that fills the grid with
    them."""
    if (B < 1 or not 1 <= n_slices <= KERNEL_MAX_SLICES or sm_count < 1 or min(m, n) < CHUNK
            or m % CHUNK or n % CHUNK or variant not in ("bf16", "i8")):
        raise ValueError(f"plan: need B >= 1, 1 <= S <= {KERNEL_MAX_SLICES}, sm_count >= 1, "
                         f"(m, n) positive multiples of {CHUNK} and variant 'bf16' or 'i8'; got B={B}, "
                         f"S={n_slices}, (m, n)=({m}, {n}), sm_count={sm_count}, variant={variant!r}")
    K, out_len = (m, n) if transposed else (n, m)
    chunks, target = K // CHUNK, CTAS_PER_SM * sm_count
    groups = MAX_GROUPS if variant == "i8" and n_slices % MAX_GROUPS == 0 else 1
    widths = TILES[variant, transposed]
    tile = next((t for t in widths if B * (out_len // t) * chunks * groups >= target), widths[-1])
    tiles = out_len // tile
    least = max(-(-target // (B * tiles)), -(-chunks // MAX_SPAN))
    split = next(d for d in range(min(least, chunks), chunks + 1) if chunks % d == 0)
    if B * tiles * split >= target:
        groups = 1
    span, parts = chunks // split, split * groups
    work = B * parts * out_len + B if parts > 1 else 0
    return Plan(tile, tiles, split, span, smem_bytes(n_slices, span, tile, variant), work,
                B * tiles * parts, groups)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _load():
    global _lib
    if _lib is None:
        lib = _cuda.library()
        for entry in ENTRIES:
            fn = getattr(lib, f"madipm_ozaki_{entry}")
            fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_depth(entry: str, m: int, n: int):
    """The int8 pair sums are exact in int32 while the contraction is
    shorter than I8_MAX_DEPTH."""
    if entry == "i8_fwd" and n >= I8_MAX_DEPTH:
        raise ValueError(f"matvec_i8 exactness requires contraction length n < 2^19; got {n}")
    if entry == "i8_t" and m >= I8_MAX_DEPTH:
        raise ValueError(f"matvec_t_i8 exactness requires m < 2^19 rows; got {m}")


def _check_slices(entry: str, sm):
    B, S, m, n = sm.slices.shape
    dtype = torch.bfloat16 if entry.startswith("bf16") else torch.int8
    if sm.slices.dtype != dtype:
        raise ValueError(f"ozaki {entry}: the slices must be {dtype}, got {sm.slices.dtype}")
    if S > KERNEL_MAX_SLICES:
        raise ValueError(f"ozaki {entry}: the kernel takes at most {KERNEL_MAX_SLICES} slices, got {S}")
    if m % CHUNK or n % CHUNK:
        raise ValueError(f"ozaki {entry}: the kernel needs (m, n) multiples of {CHUNK}, got ({m}, {n})")
    _check_depth(entry, m, n)
    if not sm.slices.is_contiguous() or sm.slices.data_ptr() % 16:
        raise ValueError(f"ozaki {entry}: slices must be contiguous and 16-byte aligned")
    if tuple(sm.row_scale.shape) != (B, m):
        raise ValueError(f"ozaki {entry}: the row scale must be ({B}, {m}), got {tuple(sm.row_scale.shape)}")


def _check_device(entry: str, *tensors):
    """Checked last, so that a tensor off the card reaches the other checks."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"ozaki {entry}: slices and vector must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(fn, index, args) -> int:
    """``fn(*args, stream)`` on device ``index``'s current stream, made the
    current device for the call if it is not."""
    if index is None or index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(index):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _kernel(entry: str, sm, vec: torch.Tensor, keep_slices: bool):
    """One call of ``madipm_ozaki_<entry>`` on the fp64 ``vec`` with the
    geometry of :func:`plan`; every check comes before the device is
    asked for its SM count."""
    variant, transposed = entry.split("_")[0], entry.endswith("_t")
    _check_slices(entry, sm)
    B, S, m, n = sm.slices.shape
    K = m if transposed else n
    vec = _vector(vec, K, f"ozaki {entry}", pad=not transposed).contiguous()
    rs = _f64(sm.row_scale).contiguous()
    _check_device(entry, sm.slices, vec, rs)
    dev = vec.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    p = plan(B, S, m, n, transposed, _sm_count(index), variant)
    f64 = dict(dtype=torch.float64, device=dev)
    # one allocation: the output, then the partials' workspace
    out_len = n if transposed else m
    out = torch.empty(B * out_len + p.work_doubles, **f64)[:B * out_len].view(B, out_len)
    work = out.data_ptr() + 8 * B * out_len if p.work_doubles else None
    vs = torch.empty((B, S, K), dtype=sm.slices.dtype, device=dev) if keep_slices else None
    vscale = torch.empty(B, **f64) if keep_slices else None
    args = (sm.slices.data_ptr(), rs.data_ptr(), vec.data_ptr(), out.data_ptr(), work,
            _ptr(vs), _ptr(vscale), B, S, m, n, p.tile, p.split, p.groups)
    rc = _launch(getattr(_load(), f"madipm_ozaki_{entry}"), index, args)
    if rc != 0:
        raise RuntimeError(f"ozaki {entry}: CUDA kernel launch failed with cudaError {rc}")
    launches[entry] += 1
    return (out, vs, vscale) if keep_slices else out


def kernel_bf16(entry: str, sm: SlicedMatrix, vec: torch.Tensor, keep_slices: bool = False):
    """What :func:`plain_contract` computes on :func:`vector_operands`'
    slices of ``vec``, by the bf16 entry point ``madipm_ozaki_<entry>``,
    which slices the fp64 vector on the device: at most two device
    operations (the contraction, and the combine of the split partials
    when :func:`plan` splits the contraction).  With ``keep_slices`` it
    returns (y, the vector's slices (B, S, K) bf16, its scale (B,)) as the
    kernel made them."""
    if not entry.startswith("bf16"):
        raise ValueError(f"ozaki {entry}: not a bf16 entry point")
    return _kernel(entry, sm, vec, keep_slices)


def kernel_i8(entry: str, sm: SlicedMatrixI8, vec: torch.Tensor, keep_slices: bool = False):
    """:func:`kernel_bf16`'s counterpart for the int8 entry points: the
    fp64 vector in, cut on the device into int8 slices against the scale
    2 f, one or two device operations; with ``keep_slices`` also the
    vector's slices (B, S, K) int8 and 2 f (B,) as the kernel made them."""
    if not entry.startswith("i8"):
        raise ValueError(f"ozaki {entry}: not an int8 entry point")
    return _kernel(entry, sm, vec, keep_slices)


def kernel_product(entry: str, sm, vec: torch.Tensor) -> torch.Tensor:
    """The product of entry point ``entry`` on the card."""
    return (kernel_bf16 if entry.startswith("bf16") else kernel_i8)(entry, sm, vec)


def _on_cpu(sm, vec: torch.Tensor) -> bool:
    return sm.slices.device.type == "cpu" and vec.device.type == "cpu"


def _product(entry: str, sm, vec: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if _on_cpu(sm, vec):
        return plain_contract(entry, sm, *vector_operands(entry, sm, vec))
    return kernel_product(entry, sm, vec)


# ---------------------------------------------------------------------------
# The four products
# ---------------------------------------------------------------------------


def vector_operands(entry: str, sm, vec: torch.Tensor):
    """The vector's slices and scale for entry point ``entry``, sliced with
    plain elementwise ops (n S elements): forward x, zero-padded to the
    slices' width; transposed w = row_scale v, since A = diag(e) rec gives
    A' v = rec' (e v).  Returns (slices (B, S, K), scale (B,)).  The plain
    version of every product, and the reference of the kernel's own
    slicing."""
    S, m, n = sm.slices.shape[1:]
    i8 = entry.startswith("i8")
    _check_depth(entry, m, n)
    if entry.endswith("_t"):
        if not i8 and m % CHUNK:
            raise ValueError(f"matvec_t requires rows divisible by {CHUNK}; got {m}")
        w = sm.row_scale * _vector(vec, m, f"ozaki {entry}", pad=False)
    else:
        w = _vector(vec, n, f"ozaki {entry}", pad=True)
    f = _pow2_scale(torch.amax(torch.abs(w), dim=-1))
    if i8:
        return _fixed_point_slices_i8(w / (2.0 * f.unsqueeze(-1)), S), 2.0 * f
    return _fixed_point_slices(w / f.unsqueeze(-1), S), f


def matvec(sm: SlicedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x (B, m) from bf16 slices; x (B, n) fp64, zero-padded to the
    slices' padded width."""
    return _product("bf16_fwd", sm, x)


def matvec_t(sm: SlicedMatrix, v: torch.Tensor) -> torch.Tensor:
    """y = A' v (B, npad) from the FORWARD bf16 slices (no transposed copy).
    The contraction runs over m in 128-deep exact chunks, so m must divide
    by CHUNK."""
    return _product("bf16_t", sm, v)


def matvec_i8(sm: SlicedMatrixI8, x: torch.Tensor) -> torch.Tensor:
    """y = A x (B, m) from int8 slices (exact int32 sums: n < 2^19)."""
    return _product("i8_fwd", sm, x)


def matvec_t_i8(sm: SlicedMatrixI8, v: torch.Tensor) -> torch.Tensor:
    """y = A' v (B, n) from the forward int8 slices (m < 2^19)."""
    return _product("i8_t", sm, v)


def apply(sm, x: torch.Tensor) -> torch.Tensor:
    """y = A x, by the slices' type."""
    if isinstance(sm, SlicedMatrixI8):
        return matvec_i8(sm, x)
    return matvec(sm, x)


def apply_t(sm, v: torch.Tensor) -> torch.Tensor:
    """y = A' v from the forward slices, by their type."""
    if isinstance(sm, SlicedMatrixI8):
        return matvec_t_i8(sm, v)
    return matvec_t(sm, v)


def operator_bound(n: int, n_slices: int) -> float:
    """The bf16 operator's error bound 2n 2^-8(S-1), relative to
    rowmax|A| max|x|."""
    return 2.0 * n * 2.0 ** (-T_BITS * (n_slices - 1))
