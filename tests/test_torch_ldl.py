"""madipm_tpu_torch's LDL', LU and refinement primitives (ops/linalg.py,
ops/block_chol.py) against madipm_tpu's on the same quasi-definite
matrices.

Matrices: K = [[H, A'], [A, -D]] with H, D SPD diagonal-dominant (the
shape of a regularized augmented KKT matrix), a batch of 3.  Tolerance
1e-10 relative to the largest entry of the JAX result, fp64: the two
packages run the same eliminations and products in another summation
order.  fp32 runs are held to 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from madipm_tpu.ops import block_chol as jb
from madipm_tpu.ops import linalg as jlin
from madipm_tpu_torch.ops import block_chol as tb
from madipm_tpu_torch.ops import linalg as tlin

torch.set_num_threads(2)

TOL = 1e-10


def _quasi_definite(n, m, batch=3, seed=0):
    rng = np.random.default_rng(seed + n)
    out = []
    for _ in range(batch):
        G = rng.standard_normal((n, n)) / np.sqrt(n)
        H = G @ G.T + np.diag(10.0 ** rng.uniform(-2, 1, n))
        A = rng.standard_normal((m, n)) * (rng.random((m, n)) < 0.5)
        D = np.diag(10.0 ** rng.uniform(-6, -2, m))
        out.append(np.block([[H, A.T], [A, -D]]))
    return np.stack(out)


def _rel(a, b):
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(np.asarray(a, dtype=np.float64) - b)) / max(1e-300, np.max(np.abs(b))))


# 192 = 128 + 64: one full block and a padded one; 256: two full blocks
@pytest.mark.parametrize("n, m", [(128, 64), (160, 96)], ids=["192-padded", "256"])
def test_ldl_factor_and_solve_match(n, m):
    K = _quasi_definite(n, m)
    L, d = tlin.ldl_factor(torch.tensor(K))
    assert L.shape == K.shape and d.shape == K.shape[:2]
    assert tlin.ldl_is_ok(L, d).tolist() == [True] * 3
    rng = np.random.default_rng(1)
    b, B = rng.standard_normal((3, n + m)), rng.standard_normal((3, n + m, 4))
    x = tlin.ldl_solve(L, d, torch.tensor(b))
    X = tlin.ldl_solve(L, d, torch.tensor(B))
    for i in range(3):
        jL, jd = jlin.ldl_factor(jnp.asarray(K[i]))
        assert bool(jlin.ldl_is_ok(jL, jd))
        assert _rel(L[i], jL) <= TOL and _rel(d[i], jd) <= TOL
        assert _rel(x[i], jlin.ldl_solve(jL, jd, jnp.asarray(b[i]))) <= TOL
        assert _rel(X[i], jlin.ldl_solve(jL, jd, jnp.asarray(B[i]))) <= TOL
    # K = L diag(d) L', unit lower L, and the solve solves
    Ln, dn = L.numpy(), d.numpy()
    assert np.all(np.triu(Ln, 1) == 0) and np.all(np.diagonal(Ln, axis1=1, axis2=2) == 1)
    recon = np.einsum("bij,bj,bkj->bik", Ln, dn, Ln)
    assert np.max(np.abs(recon - K)) <= 1e-10 * np.max(np.abs(K))
    assert np.max(np.abs(np.einsum("bij,bj->bi", K, x.numpy()) - b)) <= 1e-8
    assert (dn[:, :n] > 0).all() and (dn[:, n:] < 0).all()  # quasi-definite inertia


def test_ldl_factor_unbatched_and_fp32():
    K = _quasi_definite(48, 16, batch=1)[0]
    L, d = tlin.ldl_factor(torch.tensor(K))
    jL, jd = jlin.ldl_factor(jnp.asarray(K))
    assert L.shape == (64, 64) and _rel(L, jL) <= TOL and _rel(d, jd) <= TOL
    L32, d32 = tlin.ldl_factor(torch.tensor(K, dtype=torch.float32))
    assert L32.dtype == torch.float32 and _rel(L32, jL) <= 1e-4 and _rel(d32, jd) <= 1e-4
    x32 = tlin.ldl_solve(L32, d32, torch.ones(64, dtype=torch.float64))
    assert x32.dtype == torch.float32  # the solve runs in the factor dtype


def test_ldl_failed_factor_per_lane():
    """A zero pivot in one lane: that lane's (L, d) are not ok, the other
    lane is untouched; as in the JAX package."""
    K = _quasi_definite(32, 16, batch=2, seed=4)
    K[1, 0, :] = 0.0
    K[1, :, 0] = 0.0  # first pivot exactly 0 -> division by zero
    L, d = tlin.ldl_factor(torch.tensor(K))
    assert tlin.ldl_is_ok(L, d).tolist() == [True, False]
    jL, jd = jlin.ldl_factor(jnp.asarray(K[1]))
    assert not bool(jlin.ldl_is_ok(jL, jd))
    jL0, jd0 = jlin.ldl_factor(jnp.asarray(K[0]))
    assert _rel(L[0], jL0) <= TOL and _rel(d[0], jd0) <= TOL


@pytest.mark.parametrize("n, m", [(96, 32), (24, 8)], ids=["128", "32"])
def test_ldl_inv_matches(n, m):
    K = _quasi_definite(n, m, seed=2)
    L, d, W = tb.ldl_inv(torch.tensor(K))
    rng = np.random.default_rng(3)
    b = rng.standard_normal((3, n + m))
    x = tb.ldl_inv_solve(W, d, torch.tensor(b))
    for i in range(3):
        jL, jd, jW = jb.ldl_inv(jnp.asarray(K[i]))
        assert _rel(L[i], jL) <= TOL and _rel(d[i], jd) <= TOL and _rel(W[i], jW) <= TOL
        assert _rel(x[i], jb.ldl_inv_solve(jW, jd, jnp.asarray(b[i]))) <= TOL
    eye = np.eye(n + m)
    assert np.max(np.abs(np.einsum("bij,bjk->bik", W.numpy(), L.numpy()) - eye)) <= 1e-9
    assert np.max(np.abs(np.einsum("bij,bj->bi", K, x.numpy()) - b)) <= 1e-7
    # one lane alone, unbatched
    L1, d1, W1 = tb.ldl_inv(torch.tensor(K[2]))
    assert _rel(L1, L[2]) <= TOL and _rel(W1, W[2]) <= TOL and _rel(d1, d[2]) <= TOL


def test_lu_matches():
    K = _quasi_definite(40, 24, seed=5)
    K[2] = 0.0  # singular lane
    lu, piv = tlin.lu_factor(torch.tensor(K))
    assert tlin.lu_is_ok(lu).tolist() == [True, True, False]
    assert piv.dtype == torch.int32
    rng = np.random.default_rng(6)
    b = rng.standard_normal((3, 64))
    x = tlin.lu_solve(lu, piv, torch.tensor(b))
    for i in range(2):
        jlu, jpiv = jlin.lu_factor(jnp.asarray(K[i]))
        assert bool(jlin.lu_is_ok(jlu))
        assert _rel(lu[i], jlu) <= TOL
        np.testing.assert_array_equal(piv[i].numpy() - 1, np.asarray(jpiv))  # torch pivots are 1-based
        assert _rel(x[i], jlin.lu_solve(jlu, jpiv, jnp.asarray(b[i]))) <= TOL
    assert not bool(jlin.lu_is_ok(jlin.lu_factor(jnp.asarray(K[2]))[0]))


def _refine_system(seed):
    rng = np.random.default_rng(seed)
    n = 48
    G = rng.standard_normal((n, n))
    S = G @ G.T / n + np.diag(10.0 ** rng.uniform(-3, 1, n))
    return S, rng.standard_normal(n)


@pytest.mark.parametrize("min_reduction", [None, 0.5])
def test_refine_matches_per_lane(min_reduction):
    """Three lanes: an fp32 factor of the exact matrix (converges in a few
    sweeps), a perturbed one (uses the whole budget) and an exact fp64 one
    (leaves before the first sweep).  Each equals the unbatched JAX refine."""
    Ss, bs = zip(*[_refine_system(s) for s in (1, 2, 3)])
    S, b = np.stack(Ss), np.stack(bs)
    P = S.copy()
    P[1] += 0.3 * np.diag(np.diag(S[1]))
    Lf = np.linalg.cholesky(P)
    Lf[:2] = Lf[:2].astype(np.float32)
    TS, TL = torch.tensor(S), torch.tensor(Lf)
    solve = lambda r: tlin.cholesky_solve(TL, r)
    matvec = lambda v: (TS @ v.unsqueeze(-1)).squeeze(-1)
    x = tlin.refine(solve, matvec, torch.tensor(b), 5, min_reduction=min_reduction)
    x0 = tlin.refine(solve, matvec, torch.tensor(b), 0)
    res = lambda v: np.max(np.abs(np.einsum("bij,bj->bi", S, v.numpy()) - b), axis=1)
    assert (res(x) <= res(x0)).all() and res(x)[0] < 1e-3 * res(x0)[0]
    for i in range(3):
        JS, JL = jnp.asarray(S[i]), jnp.asarray(Lf[i])
        jx = jlin.refine(lambda r: jlin.cholesky_solve(JL, r), lambda v: JS @ v, jnp.asarray(b[i]), 5,
                         min_reduction=min_reduction)
        assert _rel(x[i], jx) <= 1e-12, i
        jx0 = jlin.refine(lambda r: jlin.cholesky_solve(JL, r), lambda v: JS @ v, jnp.asarray(b[i]), 0)
        assert _rel(x0[i], jx0) <= 1e-12, i
