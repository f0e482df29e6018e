"""Dense factorization/solve primitives, iterative refinement and the fp64
PCG.

Port of ``madipm_tpu/ops/linalg.py``: ``cholesky_factor``,
``cholesky_is_ok``, ``cholesky_solve`` and the LU helpers (torch.linalg, as
the JAX package leaves these to XLA and jax.scipy), the unpivoted blocked
``ldl_factor`` (plain torch, as it is plain JAX there), ``refine``,
``pcg`` and the two loops of the flexible PCG (``pcg_lowp``, ``pcg_flex``),
batched over a leading lane dimension.
"""

from __future__ import annotations

import torch

from ..utils import sync
from ..utils.logging import spanned

#: trips of the fp64 Krylov loop of :func:`pcg` and :func:`pcg_flex`: one
#: per loop body entered by the batch, whatever its lanes (not
#: :func:`pcg_lowp` or :func:`refine`)
pcg_trips = 0


def cholesky_factor(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD ``S`` ((N,N) or (B,N,N)); a lane whose
    factorization fails comes back all-NaN, as ``jnp.linalg.cholesky``."""
    L, info = torch.linalg.cholesky_ex(S)
    failed = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(failed, float("nan"), L)


def cholesky_is_ok(L: torch.Tensor) -> torch.Tensor:
    """True per lane iff the factor is finite with a positive diagonal."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d > 0), dim=-1)


def cholesky_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b given S = L L'."""
    vec = b.ndim == L.ndim - 1
    b2 = (b.unsqueeze(-1) if vec else b).to(L.dtype)
    y = torch.linalg.solve_triangular(L, b2, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x.squeeze(-1) if vec else x


def _unblocked_ldl(Akk: torch.Tensor):
    """LDL' of one diagonal block by elementwise elimination: one step per
    column, each a handful of small tensor ops."""
    b = Akk.shape[-1]
    rng = torch.arange(b, device=Akk.device)
    M = Akk
    for j in range(b):
        below = rng > j
        col = torch.where(below, M[..., :, j] / M[..., j, j].unsqueeze(-1), 0.0)
        row = torch.where(below, M[..., j, :], 0.0)
        M = M - col.unsqueeze(-1) * row.unsqueeze(-2)
        M[..., :, j] = torch.where(below, col, M[..., :, j])
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    L = torch.tril(M, -1) + torch.eye(b, dtype=M.dtype, device=M.device)
    return L, d


def ldl_factor(K: torch.Tensor, block: int = 128):
    """Unpivoted LDL' of a symmetric quasi-definite ``K`` ((N,N) or
    (B,N,N)): (L, d) with K = L diag(d) L', L unit lower triangular.

    Right-looking blocked sweep.  No pivoting: the regularized augmented
    KKT matrix [Sigma+Q, A'; A, -delta] is quasi-definite.  A zero or
    non-finite pivot shows in ``d`` (``ldl_is_ok``).  N is padded to a
    multiple of ``block`` with identity, whose pivots are 1 and decouple.
    """
    n = K.shape[-1]
    nb = -(-n // block)
    npad = nb * block
    if npad == n:
        A = K.clone()
    else:
        A = torch.zeros(K.shape[:-2] + (npad, npad), dtype=K.dtype, device=K.device)
        A[..., :n, :n] = K
        idx = torch.arange(n, npad, device=K.device)
        A[..., idx, idx] = 1.0
    L = torch.zeros_like(A)
    dparts = []
    for k in range(nb):
        j0, j1 = k * block, (k + 1) * block
        Lkk, dk = _unblocked_ldl(A[..., j0:j1, j0:j1])
        L[..., j0:j1, j0:j1] = Lkk
        dparts.append(dk)
        if j1 < npad:
            # L_panel = panel (Lkk')^-1 diag(1/dk)
            Lpanel = torch.linalg.solve_triangular(
                Lkk.mT, A[..., j1:, j0:j1], upper=True, left=False
            ) / dk.unsqueeze(-2)
            A[..., j1:, j1:] -= (Lpanel * dk.unsqueeze(-2)) @ Lpanel.mT
            L[..., j1:, j0:j1] = Lpanel
    d = torch.cat(dparts, dim=-1)
    return L[..., :n, :n], d[..., :n]


def ldl_is_ok(L: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """True per lane iff every pivot is finite and nonzero and L is finite."""
    return torch.all(torch.isfinite(d) & (d != 0), dim=-1) & torch.all(
        torch.isfinite(L), dim=(-2, -1)
    )


def ldl_solve(L: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve K x = b given K = L diag(d) L'."""
    vec = b.ndim == L.ndim - 1
    b2 = (b.unsqueeze(-1) if vec else b).to(L.dtype)
    y = torch.linalg.solve_triangular(L, b2, upper=False, unitriangular=True)
    y = y / d.unsqueeze(-1)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True, unitriangular=True)
    return x.squeeze(-1) if vec else x


def lu_factor(K: torch.Tensor):
    """Partially pivoted LU: (packed LU, pivots).  The pivots are
    torch.linalg's (int32, 1-based); a singular lane shows as a zero on
    the diagonal of U (``lu_is_ok``)."""
    if K.ndim == 3 and K.device.type == "cpu":
        # A multithreaded batched getrf can hang in torch's CPU LAPACK (seen
        # with MKL at N=256): factor a CPU stack lane by lane.
        parts = [torch.linalg.lu_factor_ex(Ki)[:2] for Ki in K]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])
    lu, piv, _info = torch.linalg.lu_factor_ex(K)
    return lu, piv


def lu_is_ok(lu: torch.Tensor) -> torch.Tensor:
    d = torch.diagonal(lu, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d != 0), dim=-1)


def lu_solve(lu: torch.Tensor, piv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    vec = b.ndim == lu.ndim - 1
    b2 = (b.unsqueeze(-1) if vec else b).to(lu.dtype)
    x = torch.linalg.lu_solve(lu, piv, b2)
    return x.squeeze(-1) if vec else x


def refine(solve_fn, matvec_fn, rhs: torch.Tensor, steps: int, rtol: float = 1e-14,
           min_reduction: float = None) -> torch.Tensor:
    """Iteratively refined solve, x <- x + solve(rhs - K x), one system per
    lane of ``rhs`` (B, N).

    ``solve_fn`` runs in the factor precision, ``matvec_fn`` evaluates K x
    in the precision of ``rhs``.  Each lane runs up to ``steps`` sweeps and
    leaves once its residual is under ``rtol * max(1, ||rhs||)`` (or, with
    ``min_reduction``, once a sweep fails to shrink the residual by that
    factor); a sweep that does not improve the residual is rejected, so the
    best iterate is returned.  A lane that has left keeps its carry bit for
    bit while the others go on.
    """
    x = solve_fn(rhs).to(rhs.dtype)
    if steps <= 0:
        return x
    amax = lambda v: torch.amax(torch.abs(v), dim=-1, keepdim=True)
    tol = rtol * torch.clamp(amax(rhs), min=1.0)
    r = rhs - matvec_fn(x)
    rn = amax(r)
    i = torch.zeros_like(rn, dtype=torch.int32)
    keep_on = torch.ones_like(rn, dtype=torch.bool)
    while True:
        go = (i < steps) & (rn > tol) & keep_on
        if not sync.any_true(go):
            break
        x_new = x + solve_fn(r).to(rhs.dtype)
        r_new = rhs - matvec_fn(x_new)
        rn_new = amax(r_new)
        take = go & (rn_new < rn)
        x = torch.where(take, x_new, x)
        r = torch.where(take, r_new, r)
        if min_reduction is not None:
            keep_on = torch.where(go, rn_new < min_reduction * rn, keep_on)
        rn = torch.where(go, torch.minimum(rn_new, rn), rn)
        i = torch.where(go, i + 1, i)
    return x


@spanned("madipm.linalg.pcg")
def pcg(solve_fn, matvec_fn, rhs: torch.Tensor, max_iters: int, rtol=1e-14,
        return_residual: bool = False):
    """Preconditioned CG in fp64 with a low-precision factor as
    preconditioner, one system per lane of ``rhs`` (B, m).

    ``solve_fn`` applies the preconditioner, ``matvec_fn`` the exact fp64
    operator; ``rtol`` is a float or a (B, 1) tensor.  Each lane runs the
    loop of ``madipm_tpu.ops.linalg.pcg`` and exits on its own condition:
    a lane whose condition fails keeps its carry bit for bit (the
    ``vmap``-of-``while_loop`` semantics), while the others go on.  The
    iterate with the smallest residual seen is returned; a non-finite
    recurrence ends the lane on that iterate.  ``return_residual=True``
    also returns the residual vector tracked with ``best_x``.
    """
    global pcg_trips
    norm_rhs = torch.amax(torch.abs(rhs), dim=-1, keepdim=True)
    tol = rtol * torch.clamp(norm_rhs, min=1.0)

    x = solve_fn(rhs).to(rhs.dtype)
    r = rhs - matvec_fn(x)
    z = solve_fn(r).to(rhs.dtype)
    rn0 = torch.amax(torch.abs(r), dim=-1, keepdim=True)
    i = torch.zeros_like(rn0, dtype=torch.int32)
    p = z
    rz = torch.sum(r * z, dim=-1, keepdim=True)
    best_x, best_r, best_rn = x, r, rn0

    while True:
        go = (
            (i < max_iters)
            & (torch.amax(torch.abs(r), dim=-1, keepdim=True) > tol)
            & (best_rn > tol)
        )
        if not sync.any_true(go):
            break
        pcg_trips += 1
        Ap = matvec_fn(p)
        pAp = torch.sum(p * Ap, dim=-1, keepdim=True)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = solve_fn(r_n).to(rhs.dtype)
        rz_n = torch.sum(r_n * z_n, dim=-1, keepdim=True)
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        p_n = z_n + beta * p
        rn = torch.amax(torch.abs(r_n), dim=-1, keepdim=True)
        better = (rn < best_rn) & torch.all(torch.isfinite(x_n), dim=-1, keepdim=True)
        bx_n = torch.where(better, x_n, best_x)
        br_n = torch.where(better, r_n, best_r)
        brn_n = torch.where(better, rn, best_rn)
        # Breakdown: a non-finite recurrence ends the lane on its best
        # iterate (r = 0 fails the loop test).
        bad = ~torch.all(torch.isfinite(r_n), dim=-1, keepdim=True)
        x_n = torch.where(bad, bx_n, x_n)
        r_n = torch.where(bad, 0.0, r_n)
        # Lanes that did not enter this trip keep their carry exactly.
        i = torch.where(go, i + 1, i)
        x = torch.where(go, x_n, x)
        r = torch.where(go, r_n, r)
        p = torch.where(go, p_n, p)
        rz = torch.where(go, rz_n, rz)
        best_x = torch.where(go, bx_n, best_x)
        best_r = torch.where(go, br_n, best_r)
        best_rn = torch.where(go, brn_n, best_rn)
    if return_residual:
        return best_x, best_r
    return best_x


def _amax(v):
    return torch.amax(torch.abs(v), dim=-1, keepdim=True)


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


#: loop trips of :func:`pcg_lowp` between two reads of its exit flag
PCG_LOWP_READ_EVERY = 4


def pcg_lowp(solve_fn, matvec_fn, b: torch.Tensor, max_iters: int, rtol: float = 2e-6):
    """Preconditioned CG entirely in the low (factor) precision, one system
    per lane of ``b`` (B, m): the inner loop of the flexible PCG.

    The loop of ``madipm_tpu.ops.linalg.pcg_lowp``: operator, preconditioner
    and dot products all in the dtype of ``b``, which the caller scales to
    unit magnitude; ``rtol`` sits just above that precision's noise floor.
    The best iterate wins and a non-finite recurrence ends the lane on it.

    Each lane exits on its own condition and keeps its carry bit for bit
    from then on, so a trip that no lane needs changes nothing.  The host
    therefore reads the exit flag only every ``PCG_LOWP_READ_EVERY`` trips
    (before trips 0, 4, ...): at most two reads for the inner budget of 8,
    where one read per trip would sync the inner loop of every outer trip.
    """
    x = solve_fn(b)
    r = b - matvec_fn(x)
    z = solve_fn(r)
    tol = rtol * torch.clamp(_amax(b), min=1.0)
    i = torch.zeros(b.shape[:-1] + (1,), dtype=torch.int32, device=b.device)
    p, rz = z, _dot(r, z)
    best_x, best_rn = x, _amax(r)
    for trip in range(max_iters):
        go = (i < max_iters) & (_amax(r) > tol) & (best_rn > tol)
        if trip % PCG_LOWP_READ_EVERY == 0 and not sync.any_true(go):
            break
        Ap = matvec_fn(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = solve_fn(r_n)
        rz_n = _dot(r_n, z_n)
        beta = rz_n / torch.where(rz != 0, rz, 1.0)
        p_n = z_n + beta * p
        rn = _amax(r_n)
        better = (rn < best_rn) & torch.all(torch.isfinite(x_n), dim=-1, keepdim=True)
        bx_n = torch.where(better, x_n, best_x)
        brn_n = torch.where(better, rn, best_rn)
        bad = ~torch.all(torch.isfinite(r_n), dim=-1, keepdim=True)
        x_n = torch.where(bad, bx_n, x_n)
        r_n = torch.where(bad, 0.0, r_n)
        i = torch.where(go, i + 1, i)
        x = torch.where(go, x_n, x)
        r = torch.where(go, r_n, r)
        p = torch.where(go, p_n, p)
        rz = torch.where(go, rz_n, rz)
        best_x = torch.where(go, bx_n, best_x)
        best_rn = torch.where(go, brn_n, best_rn)
    return best_x


@spanned("madipm.linalg.pcg")
def pcg_flex(precond_fn, matvec_fn, rhs: torch.Tensor, max_iters: int, rtol=1e-14):
    """Flexible PCG in fp64 with a variable (inner-iterative)
    preconditioner, one system per lane of ``rhs`` (B, m).

    The loop of ``madipm_tpu.ops.linalg.pcg_flex``: ``matvec_fn`` applies
    the exact fp64 operator, ``precond_fn`` may be an inner low-precision
    CG (:func:`pcg_lowp`) whose output varies between applications, so
    beta is Polak-Ribiere, z_{k+1}'(r_{k+1} - r_k) / (z_k' r_k).  Lanes exit
    as in :func:`pcg` (one flag read per trip); the best iterate wins.
    """
    global pcg_trips
    tol = rtol * torch.clamp(_amax(rhs), min=1.0)
    x = precond_fn(rhs).to(rhs.dtype)
    r = rhs - matvec_fn(x)
    z = precond_fn(r).to(rhs.dtype)
    i = torch.zeros_like(tol, dtype=torch.int32)
    p, rz = z, _dot(r, z)
    best_x, best_rn = x, _amax(r)
    while True:
        go = (i < max_iters) & (_amax(r) > tol) & (best_rn > tol)
        if not sync.any_true(go):
            break
        pcg_trips += 1
        Ap = matvec_fn(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z_n = precond_fn(r_n).to(rhs.dtype)
        rz_n = _dot(r_n, z_n)
        beta = _dot(z_n, r_n - r) / torch.where(rz != 0, rz, 1.0)
        p_n = z_n + beta * p
        rn = _amax(r_n)
        better = (rn < best_rn) & torch.all(torch.isfinite(x_n), dim=-1, keepdim=True)
        bx_n = torch.where(better, x_n, best_x)
        brn_n = torch.where(better, rn, best_rn)
        bad = ~torch.all(torch.isfinite(r_n), dim=-1, keepdim=True)
        x_n = torch.where(bad, bx_n, x_n)
        r_n = torch.where(bad, 0.0, r_n)
        i = torch.where(go, i + 1, i)
        x = torch.where(go, x_n, x)
        r = torch.where(go, r_n, r)
        p = torch.where(go, p_n, p)
        rz = torch.where(go, rz_n, rz)
        best_x = torch.where(go, bx_n, best_x)
        best_rn = torch.where(go, brn_n, best_rn)
    return best_x
