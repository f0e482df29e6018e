"""The bf16 Ozaki kernel's reference slicing and launch geometry, on the CPU.

The bf16 entry points of csrc/ozaki.cu slice the fp64 vector on the device,
and chip_smoke.py holds their slices bit-equal to
``ops/ozaki.vector_operands``.  Here ``vector_operands`` is held bit-equal
to the JAX package's ``_slice_vector`` (forward x, and the transposed
w = row_scale v) on the vectors where a slicing goes wrong first: exact .5
ties at every slice depth (torch.round and jnp.round round half to even),
a maximum that is exactly a power of two, a lane of zeros in a batch, and
values below 2^-120, where the scale's fp32 clamp acts.

``ops/ozaki.plan`` is plain Python: at the shapes the LP suite and the
certificates launch, the grid has at least two CTAs per SM of an H100
(132 SMs), the contraction is split in whole 128-deep chunks that cover it
once, and the same arguments give the same plan.
"""

import numpy as np
import pytest
import torch

from madipm_tpu_torch.ops import _cuda, ozaki

torch.set_num_threads(2)

H100_SMS = 132
H100_SMEM = 232_448
K = 256
SLICES = (5, 7)


def _jax():
    import jax.numpy as jnp

    from madipm_tpu.ops import ozaki as jo

    return jnp, jo


def _ties(rng):
    """Every lane: an exact .5 tie at slice depth d (after d random
    digits), for each d < 7, with odd and even neighbours and both signs;
    max|x| = 0.75, so the scale is 1 and the digits are the slices'."""
    x = np.zeros((2, K))
    for b in range(2):
        for e in range(K - 1):
            d = e % 7
            digits = rng.integers(-100, 101, d)
            val = sum(int(a) * 2.0 ** (-8 * (k + 1)) for k, a in enumerate(digits))
            x[b, e] = val + (int(rng.integers(-60, 60)) + 0.5) * 2.0 ** (-8 * (d + 1))
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


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("case", list(CASES))
def test_vector_operands_bit_equal_to_jax(case):
    """Slices (as bf16 bits) and scale of ``vector_operands``, forward and
    transposed, equal JAX's ``_slice_vector`` lane by lane at S = 5 and 7."""
    jnp, jo = _jax()
    rng = np.random.default_rng(list(CASES).index(case))
    x = CASES[case](rng)
    B = x.shape[0]
    A = rng.standard_normal((B, K, K)) * np.exp(rng.uniform(-6, 6, (B, K, 1)))
    v = x[:, ::-1].copy()  # the transposed product's vector, length m = K
    for S in SLICES:
        sm = ozaki.slice_matrix(torch.tensor(A), S)
        xs, f = ozaki.vector_operands("bf16_fwd", sm, torch.tensor(x))
        ws, g = ozaki.vector_operands("bf16_t", sm, torch.tensor(v))
        assert xs.shape == ws.shape == (B, S, K) and xs.dtype == torch.bfloat16
        for b in range(B):
            jxs, jf = jo._slice_vector(jnp.asarray(x[b]), S)
            rs = np.asarray(jo.slice_matrix(jnp.asarray(A[b]), S).row_scale)
            assert np.array_equal(sm.row_scale[b].numpy(), rs)
            jws, jg = jo._slice_vector(jnp.asarray(rs) * jnp.asarray(v[b]), S)
            assert np.array_equal(_bits(xs[b].view(torch.int16).numpy()), _bits(jxs.view(jnp.uint16)))
            assert np.array_equal(_bits(ws[b].view(torch.int16).numpy()), _bits(jws.view(jnp.uint16)))
            assert float(f[b]) == float(jf) and float(g[b]) == float(jg)
        if case == "zero_lane":
            assert float(f[1]) == 1.0 and not xs[1].any()
        if case == "ties":
            assert float(f[0]) == 1.0  # the slices are the digits themselves


#: the (B, m, n) the LP suite (A and its stored transpose) and the
#: certificates (one instance) launch
PATH_SHAPES = [(8, 1024, 2048), (8, 2048, 1024), (1, 1024, 2048)]


@pytest.mark.parametrize("B, m, n", PATH_SHAPES)
def test_plan_fills_the_card(B, m, n):
    """At least 2 x 132 CTAs in both directions at every slice count, each
    CTA's shared memory within what an H100 block may opt in to; only a
    transposed CTA takes the wide tile."""
    for transposed in (False, True):
        for S in range(1, ozaki.KERNEL_MAX_SLICES + 1):
            p = ozaki.plan(B, S, m, n, transposed, H100_SMS)
            out_len = n if transposed else m
            assert p.tile == ozaki.TILE or (transposed and p.tile == ozaki.WIDE_TILE)
            assert p.tiles * p.tile == out_len
            assert p.ctas == B * p.tiles * p.split >= 2 * H100_SMS
            assert 0 < p.smem_bytes <= H100_SMEM and p.smem_bytes == ozaki.smem_bytes(S, p.span_chunks, p.tile)
            assert p.work_doubles == (B * p.split * out_len + B if p.split > 1 else 0)


def test_plan_splits_cover_the_contraction_once():
    """Every split takes whole 128-deep chunks, at most MAX_SPAN of them,
    all splits alike, and together they take each chunk exactly once.  A
    CTA of split sp takes chunks [sp C / split, (sp + 1) C / split), C the
    chunk count, as csrc/ozaki.cu's bf16_kernel computes them."""
    for B in (1, 2, 8, 64):
        for m in (128, 384, 1024, 2048, 4096):
            for n in (128, 1280, 2048, 8192):
                for transposed in (False, True):
                    p = ozaki.plan(B, 5, m, n, transposed, H100_SMS)
                    chunks = (m if transposed else n) // ozaki.CHUNK
                    spans = [range(sp * chunks // p.split, (sp + 1) * chunks // p.split) for sp in range(p.split)]
                    assert sorted(c for span in spans for c in span) == list(range(chunks))
                    assert all(len(span) == p.span_chunks for span in spans)
                    assert 1 <= p.span_chunks <= ozaki.MAX_SPAN and p.split * p.span_chunks == chunks


def test_plan_is_deterministic_and_sized_by_the_device():
    """The same arguments give the same plan (the sum order, and so the
    bits of the result, follow from it); fewer SMs split less."""
    args = (1, 5, 1024, 2048, False)
    assert ozaki.plan(*args, H100_SMS) == ozaki.plan(*args, H100_SMS)
    assert ozaki.plan(*args, H100_SMS).split == 16
    assert ozaki.plan(*args, 16).split == 1 and ozaki.plan(*args, 16).work_doubles == 0
    # the wide transposed tile where it still fills the card, else the narrow one
    assert ozaki.plan(8, 5, 1024, 2048, True, H100_SMS).tile == ozaki.WIDE_TILE
    assert ozaki.plan(1, 5, 1024, 2048, True, H100_SMS).tile == ozaki.TILE
    # a long contraction is split for shared memory's sake alone
    assert ozaki.plan(64, 8, 256, 32768, False, 1).span_chunks == ozaki.MAX_SPAN


def test_plan_refuses_and_matches_the_source():
    """What the kernel does not take raises; the geometry the wrapper
    assumes is the one csrc/ozaki.cu states."""
    for bad in ((0, 5, 128, 128), (1, 9, 128, 128), (1, 0, 128, 128), (1, 5, 100, 128), (1, 5, 128, 64)):
        with pytest.raises(ValueError, match="plan"):
            ozaki.plan(*bad, False, H100_SMS)
    with pytest.raises(ValueError, match="plan"):
        ozaki.plan(1, 5, 128, 128, True, 0)
    src = (_cuda._CSRC / "ozaki.cu").read_text()
    for line in (f"constexpr int STAGES = {ozaki.STAGES};", f"constexpr int MAX_SPAN = {ozaki.MAX_SPAN};",
                 f"constexpr int VPAD = {ozaki.VPAD};",
                 f"TW == {ozaki.TILE} || (TRANS && TW == {ozaki.WIDE_TILE})",
                 "STAGES * TW * CHUNK * 2 + (size_t)S * (span_chunks * CHUNK + VPAD) * 2"):
        assert line in src
