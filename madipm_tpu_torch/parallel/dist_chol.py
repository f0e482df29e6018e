"""Distributed blocked Cholesky over a mesh axis: the port of
``madipm_tpu/parallel/dist_chol.py``.

Row-strip layout: rank ``p`` of ``P`` on the axis holds rows
``[p*mb, (p+1)*mb)`` (mb = m / P) of the matrix and of its factor.  Every
function here is the body that ``shard_map`` ran per device in the JAX
package: it takes this rank's strip (and the replicated vectors) and is
called by every rank of the axis in the same order.  Every tensor carries a
leading lane dimension.

Right-looking panel algorithm, one panel per strip:

    for k in 0..P-1:
        D     = broadcast(owner k's diagonal block)      # (mb, mb)
        Lkk, W = chol_inv(D)        (replicated: the CUDA kernel on the card)
        B_p   = strip_p[:, kcols] @ W'                   # local panel block
        panel = all_gather(B_p)                          # (m, mb)
        strip_p[:, trailing] -= B_p @ panel'             # local update

The owner's block needs no special case: D W' = Lkk Lkk' Lkk^-T = Lkk.  The
solves use only the inverse diagonal blocks W kept at factor time: P
broadcasts of (mb,) blocks forward, P reductions and P broadcasts backward,
with products as the only local work.  Every collective sits on the
latency path, one after another, so P > 1 is latency-bound by design.

The numerical contract is ``ops/linalg.cholesky``'s (no pivoting; the
caller owns the regularization retries).  Where the JAX package psums a
value masked to its owner, a broadcast from the owner gives the same bits;
``ok`` is a minimum over the ranks, the same on all of them.
"""

from __future__ import annotations

import torch

from ..ops import chol_inv
from ..utils import comm


def _strip(group, width: int):
    p = comm.rank(group)
    return p, slice(p * width, (p + 1) * width)


def _local_cholesky(group, S_p: torch.Tensor):
    """(L_p, W_p) of this rank's strip ``S_p`` (B, mb, m): the rows of the
    lower factor it holds (upper part zero) and the inverse of its diagonal
    block (B, mb, mb)."""
    p = comm.rank(group)
    P = comm.size(group)
    B, mb, m = S_p.shape
    L_p = S_p.clone()
    W_own = None
    for k in range(P):
        kc = slice(k * mb, (k + 1) * mb)
        if p == k:
            D = L_p[..., kc].contiguous()
        else:
            D = torch.empty((B, mb, mb), dtype=S_p.dtype, device=S_p.device)
        comm.broadcast_from(D, k, group)
        _, W = chol_inv.chol_inv(D)
        if p == k:
            W_own = W
        if p >= k:
            B_p = L_p[..., kc] @ W.mT
        else:  # rows above the panel are zero in L
            B_p = torch.zeros((B, mb, mb), dtype=S_p.dtype, device=S_p.device)
        panel = comm.gather_rows(B_p, group)  # (B, m, mb)
        if p > k:  # the trailing update of the strip's lower part
            tr = slice((k + 1) * mb, (p + 1) * mb)
            L_p[..., tr] -= B_p @ panel[..., tr, :].mT
        L_p[..., kc] = B_p
    L_p[..., (p + 1) * mb:] = 0.0
    L_p[..., p * mb:(p + 1) * mb] = torch.tril(L_p[..., p * mb:(p + 1) * mb])
    return L_p, W_own


def dist_cholesky(mesh, S_p: torch.Tensor, axis: str = "cols"):
    """Factor the SPD matrix whose row strip this rank holds (``S_p``
    (B, m/P, m) or (m/P, m)): returns this rank's strip of the lower factor
    and the inverse of its diagonal block, for :func:`dist_chol_solve`."""
    squeeze = S_p.ndim == 2
    L_p, W_p = _local_cholesky(mesh.get_group(axis), S_p.unsqueeze(0) if squeeze else S_p)
    return (L_p[0], W_p[0]) if squeeze else (L_p, W_p)


def _local_solve(group, L_p: torch.Tensor, W_p: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with L L' x = b; ``b`` (B, m) replicated, x replicated."""
    p = comm.rank(group)
    P = comm.size(group)
    B, mb, m = L_p.shape
    empty = lambda: torch.empty((B, mb), dtype=b.dtype, device=b.device)
    mv = lambda M, v: (M @ v.unsqueeze(-1)).squeeze(-1)

    # Forward: y = L^-1 b, the owner of each block solves it and shares it.
    y = torch.zeros_like(b)
    for k in range(P):
        kc = slice(k * mb, (k + 1) * mb)
        if p == k:
            y_k = mv(W_p, b[..., kc] - mv(L_p[..., : k * mb], y[..., : k * mb]))
        else:
            y_k = empty()
        y[..., kc] = comm.broadcast_from(y_k, k, group)

    # Backward: x = L^-T y.  sum_{j>k} L_jk' x_j is a sum over the ranks
    # below block k of products with the strips they hold.
    x = torch.zeros_like(b)
    own = slice(p * mb, (p + 1) * mb)
    for k in range(P - 1, -1, -1):
        kc = slice(k * mb, (k + 1) * mb)
        if p > k:
            t = mv(L_p[..., kc].mT, x[..., own])
        else:
            t = torch.zeros((B, mb), dtype=b.dtype, device=b.device)
        comm.reduce_to(t, k, group)
        x_k = mv(W_p.mT, y[..., kc] - t) if p == k else empty()
        x[..., kc] = comm.broadcast_from(x_k, k, group)
    return x


def dist_chol_solve(mesh, L_p: torch.Tensor, W_p: torch.Tensor, b: torch.Tensor,
                    axis: str = "cols") -> torch.Tensor:
    """Solve L L' x = b with this rank's part of :func:`dist_cholesky`'s
    factor; ``b`` replicated ((m,) or (B, m)), x replicated."""
    if L_p.ndim == 2:
        return _local_solve(mesh.get_group(axis), L_p[None], W_p[None], b[None])[0]
    return _local_solve(mesh.get_group(axis), L_p, W_p, b)


def _diag_index(width: int, p: int, device):
    rows = torch.arange(width, device=device)
    return rows, p * width + rows


def _factor_ok(group, L_p, W_p, diag_L) -> torch.Tensor:
    """(B,) bool, True where every rank's strip is finite with a positive
    diagonal; the same on every rank."""
    ok = (torch.isfinite(L_p).all(dim=(-2, -1)) & torch.isfinite(W_p).all(dim=(-2, -1))
          & (diag_L > 0).all(dim=-1))
    return comm.all_min(ok.to(torch.int32), group) > 0


def dist_factor_normal(mesh, A_k, dinv_k, row_mask, del_c, shift, factor_dtype,
                       axis: str = "cols"):
    """Distributed NORMAL-KKT factorization: the column-sharded Schur
    assembly reduce-scattered into row strips, then the panel Cholesky.

    ``A_k`` (B, m, n/P) is this rank's column block of A and ``dinv_k``
    (B, n/P) its block of Sigma^-1 (zero on fixed and padded columns);
    ``row_mask`` (B, m), ``del_c`` (B, 1) replicated.  Reproduces
    ``ops/kkt._assemble_normal``, the Jacobi scaling and PRECOND_SHIFT
    (``shift``, 0 for none) without the m x m matrix on one device:

        S_strip = reduce_scatter(A_k D_k A_k')      (B, m/P, m)
        live / diagonal pinning, Jacobi D^-1/2 S D^-1/2, + shift
        L, W = _local_cholesky(strips)

    Returns (L_p, W_p, jac, live, ok): L_p, W_p this rank's; jac (B, m),
    live (B, m) and ok (B,) replicated.
    """
    group = mesh.get_group(axis)
    fdt = factor_dtype
    Af = A_k.to(fdt)
    S_part = torch.matmul(Af * dinv_k.to(fdt).unsqueeze(-2), Af.mT)
    S_strip = comm.scatter_rows_sum(S_part, group)
    mb = S_strip.shape[-2]
    p, own = _strip(group, mb)
    r, c = _diag_index(mb, p, S_strip.device)
    dS = comm.gather_last(S_strip[..., r, c], group)  # (B, m) replicated
    live = row_mask & (dS > 0)
    diag_add = torch.where(live, -del_c.to(fdt), 1.0 - dS)
    S_strip[..., r, c] += diag_add[..., own]
    jac = torch.rsqrt(torch.clamp(dS + diag_add, min=torch.finfo(fdt).tiny))
    Shat = S_strip * jac[..., own].unsqueeze(-1) * jac.unsqueeze(-2)
    if shift:
        Shat[..., r, c] += shift
    L_p, W_p = _local_cholesky(group, Shat)
    ok = _factor_ok(group, L_p, W_p, L_p[..., r, c])
    return L_p, W_p, jac, live, ok


def dist_factor_condensed(mesh, A_p, Q_p, sigma, live_p, gamma, shift, factor_dtype,
                          axis: str = "cols"):
    """Distributed K1 (CONDENSED) factorization: the size-n SPD system
    ``C = diag(sigma) + Q + gamma A' diag(live) A`` of
    ``ops/kkt._assemble_condensed``, assembled from A's row blocks.

    ``A_p`` (B, m/P, n) is this rank's row block of A, free-column-masked
    by the caller; ``live_p`` (B, m/P) its rows' live indicator; ``Q_p``
    (B, n/P, n) its row strip of the free-masked Q, or None for an LP;
    ``sigma`` (B, n) and ``gamma`` (B, 1) replicated.  Each rank forms
    ``gamma A_p' L_p A_p`` (B, n, n), a reduce-scatter lands the row strips
    of C on the ranks that factor them, the Q and sigma strips are added
    locally, and the panel Cholesky factors in place.  Returns (L_p, W_p,
    jac, ok), jac (B, n) and ok (B,) replicated.
    """
    group = mesh.get_group(axis)
    fdt = factor_dtype
    Ar = A_p.to(fdt)
    C_part = torch.matmul((Ar * live_p.to(fdt).unsqueeze(-1)).mT, Ar)
    C_part = C_part * gamma.to(fdt).unsqueeze(-1)
    C_strip = comm.scatter_rows_sum(C_part, group)
    if Q_p is not None:
        C_strip = C_strip + Q_p.to(fdt)
    nb = C_strip.shape[-2]
    p, own = _strip(group, nb)
    r, c = _diag_index(nb, p, C_strip.device)
    C_strip[..., r, c] += sigma[..., own].to(fdt)
    dC = comm.gather_last(C_strip[..., r, c], group)
    jac = torch.rsqrt(torch.clamp(dC, min=torch.finfo(fdt).tiny))
    Chat = C_strip * jac[..., own].unsqueeze(-1) * jac.unsqueeze(-2)
    if shift:
        Chat[..., r, c] += shift
    L_p, W_p = _local_cholesky(group, Chat)
    ok = _factor_ok(group, L_p, W_p, L_p[..., r, c])
    return L_p, W_p, jac, ok


def schur_normal_solve_dist(mesh, A_k, dinv_k, rx_k, rp, row_mask, del_c, axis: str = "cols"):
    """Column-sharded Schur assembly (parallel/schur.py) with the m x m
    factor distributed too: the partial normal matrices reduce-scattered
    into row strips, factored in place, the back-substitution on the column
    blocks.  ``A_k`` (B, m, n/P), ``dinv_k`` and ``rx_k`` (B, n/P) this
    rank's; ``rp``, ``row_mask`` (B, m) and ``del_c`` replicated.  Returns
    (dx_k, dy): dx this rank's block, dy replicated.  m must divide by P."""
    group = mesh.get_group(axis)
    S_part = torch.matmul(A_k * dinv_k.unsqueeze(-2), A_k.mT)
    S_strip = comm.scatter_rows_sum(S_part, group)
    r_full = comm.all_sum((A_k @ (dinv_k * rx_k).unsqueeze(-1)).squeeze(-1), group)
    mb = S_strip.shape[-2]
    p, own = _strip(group, mb)
    r, c = _diag_index(mb, p, S_strip.device)
    dS = S_strip[..., r, c]
    S_strip[..., r, c] += torch.where(row_mask[..., own], -del_c, 1.0 - dS)
    r2 = torch.where(row_mask, r_full - rp, 0.0)
    L_p, W_p = _local_cholesky(group, S_strip)
    dy = torch.where(row_mask, _local_solve(group, L_p, W_p, r2), 0.0)
    dx_k = dinv_k * (rx_k - (A_k.mT @ dy.unsqueeze(-1)).squeeze(-1))
    return dx_k, dy
