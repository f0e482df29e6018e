"""The int8 Ozaki kernel's reference slicing and launch geometry, on the CPU.

The int8 entry points of csrc/ozaki.cu take the fp64 vector and slice it on
the device, and chip_smoke.py holds their slices bit-equal to
``ops/ozaki.vector_operands``.  Here ``vector_operands("i8_fwd" / "i8_t")``
is held bit-equal to the JAX package's own int8 vector slicing, which
``matvec_i8`` and ``matvec_t_i8`` do inline: f = ``_pow2_scale(max|w|)``
and ``_fixed_point_slices_i8(w / (2 f), S)``, with w = x forward and
w = row_scale v transposed.  The inputs are built for the 7-bit grid: exact
.5 ties at every slice depth, maxima that are exactly powers of two, a lane
of zeros in a batch, and values below 2^-120, where the scale's fp32 clamp
acts.

``ops/ozaki.plan(..., variant="i8")`` is plain Python: at the shapes the
int8 LP suite and the certificates launch, the grid has at least two CTAs
per SM of an H100 (132 SMs); the spans cover the contraction once in whole
128-deep chunks and the slice groups cover the S slices once; the same
arguments give the same plan; and its constants are the ones csrc/ozaki.cu
states.
"""

import numpy as np
import pytest
import torch

from madipm_tpu_torch.ops import _cuda, ozaki

torch.set_num_threads(2)

H100_SMS = 132
H100_SMEM = 232_448
K = 256
SLICES = (8, 3)


def _jax():
    import jax.numpy as jnp

    from madipm_tpu.ops import ozaki as jo

    return jnp, jo


def _ties(rng):
    """Every lane: an exact .5 tie on the 7-bit grid at slice depth d, for
    each d < 8, after up to six random digits (so that the value stays
    exact in fp64), with odd and even neighbours and both signs; max|x| =
    0.75, so 2 f = 2 and v = x / 2 carries the digits themselves."""
    x = np.zeros((2, K))
    for b in range(2):
        for e in range(K - 1):
            d = e % 8
            v = sum(int(rng.integers(-50, 51)) * 2.0 ** (-7 * (k + 1)) for k in range(max(0, d - 6), d))
            v += (int(rng.integers(-50, 50)) + 0.5) * 2.0 ** (-7 * (d + 1))
            x[b, e] = 2.0 * v
        x[b, -1] = 0.75 if b == 0 else -0.75
    return x


def _pow2_max(rng):
    """Lanes whose max|x| is exactly 1, 2^-30, 2^40 and -2^3."""
    x = rng.uniform(-1, 1, (4, K))
    for b, p in enumerate((1.0, 2.0 ** -30, 2.0 ** 40, -(2.0 ** 3))):
        x[b] *= abs(p) * 0.999
        x[b, 17 + b] = p
    return x


def _zero_lane(rng):
    x = rng.standard_normal((3, K)) * np.exp(rng.uniform(-5, 5, (3, 1)))
    x[1] = 0.0
    return x


def _tiny(rng):
    """Values below 2^-120, alone in a lane and beside a normal value."""
    x = rng.standard_normal((3, K)) * 2.0 ** -125
    x[1, ::3] = 2.0 ** -130
    x[2, 5] = 2.0 ** -119.5
    x[2, 9] = 1e-200
    return x


CASES = {"ties": _ties, "pow2_max": _pow2_max, "zero_lane": _zero_lane, "tiny": _tiny}


def _jax_slices(jnp, jo, w, S):
    """matvec_i8's inline slicing of w: (slices (S, K) int8, 2 f)."""
    f = jo._pow2_scale(jnp.max(jnp.abs(w)))
    return np.asarray(jo._fixed_point_slices_i8(w / (2.0 * f), S)), float(2.0 * f)


@pytest.mark.parametrize("case", list(CASES))
def test_vector_operands_i8_bit_equal_to_jax(case):
    """Slices and scale of ``vector_operands``, forward (x) and transposed
    (w = row_scale v), equal the JAX package's lane by lane at S = 8 (the
    solver's count) and S = 3."""
    jnp, jo = _jax()
    rng = np.random.default_rng(list(CASES).index(case))
    x = CASES[case](rng)
    B = x.shape[0]
    A = rng.standard_normal((B, K, K)) * np.exp(rng.uniform(-6, 6, (B, K, 1)))
    v = x[:, ::-1].copy()  # the transposed product's vector, length m = K
    for S in SLICES:
        sm = ozaki.slice_matrix_i8(torch.tensor(A), S)
        xs, f = ozaki.vector_operands("i8_fwd", sm, torch.tensor(x))
        ws, g = ozaki.vector_operands("i8_t", sm, torch.tensor(v))
        assert xs.shape == ws.shape == (B, S, K) and xs.dtype == ws.dtype == torch.int8
        for b in range(B):
            rs = np.asarray(jo.slice_matrix_i8(jnp.asarray(A[b]), S).row_scale)
            assert np.array_equal(sm.row_scale[b].numpy(), rs)
            jxs, jf = _jax_slices(jnp, jo, jnp.asarray(x[b]), S)
            jws, jg = _jax_slices(jnp, jo, jnp.asarray(rs) * jnp.asarray(v[b]), S)
            assert np.array_equal(xs[b].numpy(), jxs) and np.array_equal(ws[b].numpy(), jws)
            assert float(f[b]) == jf and float(g[b]) == jg
            assert np.abs(xs[b].numpy()).max() <= 64 and np.abs(ws[b].numpy()).max() <= 64
        if case == "zero_lane":
            assert float(f[1]) == 2.0 and not xs[1].any()
        if case == "ties":
            assert float(f[0]) == 2.0  # v = x / 2: the slices are the digits themselves


#: the (B, m, n) the int8 LP suite (A, and the unshared A') and the
#: certificates (one instance) launch
PATH_SHAPES = [(8, 1024, 2048), (8, 2048, 1024), (1, 1024, 2048)]


@pytest.mark.parametrize("B, m, n", PATH_SHAPES)
def test_plan_i8_fills_the_card(B, m, n):
    """At least 2 x 132 CTAs in both directions at every slice count, each
    CTA's shared memory within what an H100 block may opt in to, tiles
    from TILES and whole, at most MAX_GROUPS equal slice groups."""
    for transposed in (False, True):
        for S in range(1, ozaki.KERNEL_MAX_SLICES + 1):
            p = ozaki.plan(B, S, m, n, transposed, H100_SMS, "i8")
            out_len = n if transposed else m
            assert p.tile in ozaki.TILES["i8", transposed] and p.tiles * p.tile == out_len
            assert 1 <= p.groups <= ozaki.MAX_GROUPS and S % p.groups == 0
            assert p.ctas == B * p.tiles * p.split * p.groups >= 2 * H100_SMS
            assert 0 < p.smem_bytes <= H100_SMEM
            assert p.smem_bytes == ozaki.smem_bytes(S, p.span_chunks, p.tile, "i8")
            parts = p.split * p.groups
            assert p.work_doubles == (B * parts * out_len + B if parts > 1 else 0)
        # the solver's 8 slices: 128 contiguous bytes of a row where the card still fills
        assert ozaki.plan(B, 8, m, n, transposed, H100_SMS, "i8").tile == (128 if transposed and B > 1 else 64)


def test_plan_i8_covers_the_contraction_once_and_matches_the_source():
    """Spans take whole 128-deep chunks, at most MAX_SPAN, all alike, each
    chunk once; slice groups take each of the S slices once, all alike;
    as csrc/ozaki.cu's i8_kernel cuts them (span sp: chunks [sp C / split,
    (sp + 1) C / split); group sg: slices [sg S / groups, (sg + 1) S /
    groups)).  The same arguments give the same plan; what the kernel does
    not take raises; the geometry the wrapper assumes is the one the
    source states."""
    for B in (1, 2, 8, 64):
        for m in (128, 384, 1024, 2048, 4096):
            for n in (128, 1280, 2048, 8192):
                for transposed in (False, True):
                    for S in (8, 5):
                        p = ozaki.plan(B, S, m, n, transposed, H100_SMS, "i8")
                        chunks = (m if transposed else n) // ozaki.CHUNK
                        spans = [range(sp * chunks // p.split, (sp + 1) * chunks // p.split)
                                 for sp in range(p.split)]
                        assert sorted(c for span in spans for c in span) == list(range(chunks))
                        assert all(len(span) == p.span_chunks for span in spans)
                        assert 1 <= p.span_chunks <= ozaki.MAX_SPAN and p.split * p.span_chunks == chunks
                        groups = [range(g * S // p.groups, (g + 1) * S // p.groups) for g in range(p.groups)]
                        assert sorted(s for grp in groups for s in grp) == list(range(S))
                        assert len({len(grp) for grp in groups}) == 1
    args = (1, 8, 1024, 2048, True, H100_SMS, "i8")
    assert ozaki.plan(*args) == ozaki.plan(*args)
    assert ozaki.plan(*args)[:3] + (ozaki.plan(*args).groups,) == (64, 32, 8, 2)
    assert ozaki.plan(8, 8, 1024, 2048, False, 16, "i8").split == 1  # fewer SMs split less
    assert ozaki.plan(8, 8, 1024, 2048, False, H100_SMS) != ozaki.plan(8, 8, 1024, 2048, False, H100_SMS, "i8")
    for bad in ((0, 8, 128, 128), (1, 9, 128, 128), (1, 0, 128, 128), (1, 8, 100, 128), (1, 8, 128, 64)):
        with pytest.raises(ValueError, match="plan"):
            ozaki.plan(*bad, False, H100_SMS, "i8")
    with pytest.raises(ValueError, match="plan"):
        ozaki.plan(1, 8, 128, 128, True, H100_SMS, "fp8")
    src = (_cuda._CSRC / "ozaki.cu").read_text()
    for line in (f"constexpr int I8_STAGES = {ozaki.I8_STAGES};", f"constexpr int I8_VPAD = {ozaki.I8_VPAD};",
                 f"constexpr int MAX_SPAN = {ozaki.MAX_SPAN};",
                 "TW == 32 || TW == 64 || (TRANS && TW == 128)",
                 "(size_t)I8_STAGES * TW * CHUNK + (size_t)S * (span_chunks * CHUNK + I8_VPAD)",
                 "c.groups > (I8 ? c.S : 1)", "const int s0 = sg * S / groups, s1 = (sg + 1) * S / groups;",
                 "const int c0 = sp * chunks / split, nch = (sp + 1) * chunks / split - c0;"):
        assert line in src
    assert ozaki.TILES["i8", False] == (64, 32) and ozaki.TILES["i8", True] == (128, 64, 32)
