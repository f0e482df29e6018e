"""The plain version of the chol_inv kernel (ops/block_chol.py) against the
JAX package's recursion and its Pallas kernel in interpret mode.

The recursion is the same sequence of products in both packages, so the
tolerances are tight: relative to max|L| (resp. max|Linv|), 1e-10 in fp64
and 1e-4 in fp32 (the JAX package's own Pallas tests allow 1e-3/1e-2 for
a different algorithm).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madipm_tpu.ops import block_chol as jb
from madipm_tpu.ops.pallas_chol import pallas_chol_inv
from madipm_tpu_torch.ops import block_chol as tb
from madipm_tpu_torch.ops import chol_inv

torch.set_num_threads(2)

TOL = {np.float32: 1e-4, np.float64: 1e-10}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _spd_stack(n, batch=3, seed=0):
    rng = np.random.default_rng(seed + n)
    G = rng.standard_normal((batch, n, n))
    return G @ G.transpose(0, 2, 1) / n + 0.1 * np.eye(n)


def _rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def plain():
    """(n, dtype) -> torch (L, W) for the batch of 3."""
    out = {}
    for n in (128, 256):
        for dt in (np.float32, np.float64):
            L, W = tb.chol_inv(torch.tensor(_spd_stack(n), dtype=TORCH[dt]))
            out[n, dt] = (L.numpy(), W.numpy())
    return out


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("n", [128, 256])
def test_plain_matches_jax_recursion(plain, n, dt):
    S = jnp.asarray(_spd_stack(n), dtype=dt)
    Lj, Wj = jax.vmap(jb.chol_inv)(S)
    L, W = plain[n, dt]
    assert _rel(L, Lj) <= TOL[dt]
    assert _rel(W, Wj) <= TOL[dt]
    assert L.dtype == dt and W.dtype == dt


# One interpret-mode call costs ~8 s at n=256 whatever the batch, so n=256
# runs in fp32 only, the dtype the TPU kernel factors in.
@pytest.mark.parametrize("n, dt", [(128, np.float32), (128, np.float64), (256, np.float32)],
                         ids=["128-fp32", "128-fp64", "256-fp32"])
def test_plain_matches_pallas_interpret(plain, n, dt):
    S = jnp.asarray(_spd_stack(n), dtype=dt)
    Lp, Wp = pallas_chol_inv(S, interpret=True)
    L, W = plain[n, dt]
    assert _rel(L, Lp) <= TOL[dt]
    assert _rel(W, Wp) <= TOL[dt]
    # both triangles as the TPU kernel leaves them: upper zero, W L = I
    assert np.all(np.triu(L, 1) == 0) and np.all(np.triu(W, 1) == 0)
    eye_err = np.max(np.abs(W.astype(np.float64) @ L.astype(np.float64) - np.eye(n)))
    assert eye_err <= TOL[dt]


@pytest.mark.parametrize("dt", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_nan_on_indefinite(dt):
    L, W = tb.chol_inv(-torch.eye(128, dtype=dt))
    assert torch.isnan(L).any() and torch.isnan(W).any()
    Lj, _ = jb.chol_inv(-jnp.eye(128, dtype=jnp.float32 if dt == torch.float32 else jnp.float64))
    assert bool(jnp.any(jnp.isnan(Lj)))


def test_chol_inv_solve_matches_jax():
    S = _spd_stack(128, batch=2, seed=3)
    rng = np.random.default_rng(1)
    b, B = rng.standard_normal((2, 128)), rng.standard_normal((2, 128, 5))
    _, W = tb.chol_inv(torch.tensor(S))
    _, Wj = jax.vmap(jb.chol_inv)(jnp.asarray(S))
    for rhs in (b, B):
        x = tb.chol_inv_solve(W, torch.tensor(rhs)).numpy()
        xj = jax.vmap(jb.chol_inv_solve)(Wj, jnp.asarray(rhs))
        assert _rel(x, xj) <= 1e-10
        resid = np.einsum("bij,bj...->bi...", S, x) - rhs
        assert np.max(np.abs(resid)) <= 1e-10 * np.max(np.abs(rhs))


def test_wrapper_takes_plain_version_on_cpu(plain):
    before = chol_inv.launches
    S = torch.tensor(_spd_stack(128))
    L, W = chol_inv.chol_inv(S)
    assert chol_inv.launches == before
    np.testing.assert_array_equal(L.numpy(), plain[128, np.float64][0])
    L1, W1 = chol_inv.chol_inv(S[1])
    np.testing.assert_array_equal(W1.numpy(), plain[128, np.float64][1][1])
