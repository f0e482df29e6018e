"""Dense factorization/solve primitives and the fp64 PCG.

Port of the NORMAL-path part of ``madipm_tpu/ops/linalg.py``:
``cholesky_factor``, ``cholesky_is_ok``, ``cholesky_solve`` (torch.linalg,
as the JAX package leaves these to XLA) and ``pcg``, batched over a
leading lane dimension.  LDL, LU, ``refine``, ``pcg_lowp`` and
``pcg_flex`` are ROADMAP item A7.
"""

from __future__ import annotations

import torch

from ..utils import sync


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
