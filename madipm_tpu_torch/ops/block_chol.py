"""Recursive blocked Cholesky and LDL' with explicit inverse factor, in
plain torch.

Port of ``madipm_tpu/ops/block_chol.py`` (``chol_inv``, ``_chol_base``,
``_tri_inv_base``, ``chol_inv_solve``, ``_ldl_base``, ``ldl_inv``,
``ldl_inv_solve``).  The divide-and-conquer recursion

    S = [[S11, S21'], [S21, S22]]
    L11, W1 = chol_inv(S11);  L21 = S21 W1';  L22, W2 = chol_inv(S22 - L21 L21')
    Linv = [[W1, 0], [-W2 L21 W1, W2]]

is the same sequence of products as the JAX version, so on the CPU the two
agree to rounding.  ``chol_inv`` and ``cholesky`` (the same recursion
without the inverse blocks nobody reads) are the plain versions of the two
CUDA kernels in ``ops/chol_inv.py``: the wrappers there run them for CPU
tensors, and ``chip_smoke.py`` holds the kernels against them on the card.
Every function takes (N, N) or (B, N, N) tensors.
"""

from __future__ import annotations

import torch

_BASE = 16  # base-case size for the unrolled elimination


def _tri_inv_base(L: torch.Tensor) -> torch.Tensor:
    """Invert a lower-triangular block by Neumann doubling (pure matmuls):
    L = D (I - N), (I - N)^-1 = sum N^i by repeated squaring."""
    s = L.shape[-1]
    if s == 1:
        return 1.0 / L
    eye = torch.eye(s, dtype=L.dtype, device=L.device)
    dcol = torch.sum(L * eye, dim=-1, keepdim=True)  # (s,1) diagonal
    M = L / dcol  # unit lower: I - N
    N = eye - M  # strictly lower
    S = eye + N
    R = N
    for _ in range(max(0, (s - 1).bit_length() - 1)):
        R = R @ R
        S = S + R @ S
    drow = torch.sum(L * eye, dim=-2, keepdim=True)  # (1,s)
    return S / drow


def _chol_base(S: torch.Tensor):
    """Unblocked Cholesky of a small tile by masked elimination; returns
    (L, Linv).  A non-positive pivot gives NaN (rsqrt), which propagates."""
    s = S.shape[-1]
    if s == 1:
        L = torch.sqrt(S)
        return L, 1.0 / L
    rows_c = torch.arange(s, device=S.device).unsqueeze(-1)  # (s,1)
    cols_r = torch.arange(s, device=S.device).unsqueeze(0)  # (1,s)
    M = S
    L = torch.zeros_like(S)
    for j in range(s):
        dinv = torch.rsqrt(M[..., j : j + 1, j : j + 1])
        col = torch.where(rows_c >= j, M[..., :, j : j + 1] * dinv, 0.0)
        onehot = (cols_r == j).to(S.dtype)
        L = L + col @ onehot
        M = M - col @ col.mT
    return L, _tri_inv_base(L)


def _block2(A11, A21, A22):
    """[[A11, 0], [A21, A22]]."""
    Z = torch.zeros_like(A21.mT)
    return torch.cat([torch.cat([A11, Z], dim=-1), torch.cat([A21, A22], dim=-1)], dim=-2)


def _chol_rec(S: torch.Tensor, base: int, need_inv: bool):
    """(L, Linv) of SPD ``S``; Linv is None unless ``need_inv``.  The
    leading block's inverse is always formed (L21 needs it); the trailing
    block's only when the caller reads the inverse."""
    n = S.shape[-1]
    if n <= base or n % 2 != 0:
        return _chol_base(S)
    h = n // 2
    S21 = S[..., h:, :h]
    L11, W1 = _chol_rec(S[..., :h, :h], base, True)
    L21 = S21 @ W1.mT
    T = S[..., h:, h:] - L21 @ L21.mT
    L22, W2 = _chol_rec(T, base, need_inv)
    L = _block2(L11, L21, L22)
    if not need_inv:
        return L, None
    W21 = -(W2 @ (L21 @ W1))
    return L, _block2(W1, W21, W2)


def chol_inv(S: torch.Tensor, base: int = _BASE):
    """(L, Linv) of SPD ``S`` via the matmul recursion."""
    return _chol_rec(S, base, True)


def cholesky(S: torch.Tensor, base: int = _BASE) -> torch.Tensor:
    """L of SPD ``S`` (upper triangle zero, NaN where S is not SPD): the L
    of :func:`chol_inv`, without the inverse blocks that only Linv needs."""
    return _chol_rec(S, base, False)[0]


def _ldl_base(S: torch.Tensor):
    """Unpivoted LDL' of a small tile: (L unit-lower, d, Linv)."""
    s = S.shape[-1]
    rows = torch.arange(s, device=S.device)
    M = S
    cols, ds = [], []
    for j in range(s):
        dj = M[..., j, j]
        l = torch.where(rows > j, M[..., :, j] / dj.unsqueeze(-1), 0.0)
        cf = torch.where(rows == j, 1.0, l)
        M = M - dj[..., None, None] * cf.unsqueeze(-1) * cf.unsqueeze(-2)
        cols.append(cf)
        ds.append(dj)
    L = torch.stack(cols, dim=-1)
    return L, torch.stack(ds, dim=-1), _tri_inv_base(L)


def ldl_inv(S: torch.Tensor, base: int = _BASE):
    """(L, d, Linv) of a symmetric quasi-definite ``S`` via the matmul
    recursion (unpivoted LDL', valid for the regularized augmented KKT
    matrix)."""
    n = S.shape[-1]
    if n <= base or n % 2 != 0:
        return _ldl_base(S)
    h = n // 2
    L11, d1, W1 = ldl_inv(S[..., :h, :h], base)
    d1r = d1.unsqueeze(-2)
    L21 = (S[..., h:, :h] @ W1.mT) / d1r
    T = S[..., h:, h:] - (L21 * d1r) @ L21.mT
    L22, d2, W2 = ldl_inv(T, base)
    W21 = -(W2 @ (L21 @ W1))
    return _block2(L11, L21, L22), torch.cat([d1, d2], dim=-1), _block2(W1, W21, W2)


def ldl_inv_solve(Linv: torch.Tensor, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b ((N,) or (B, N)) given Linv = L^-1 and d:
    x = Linv' diag(1/d) Linv b."""
    y = (Linv @ b.unsqueeze(-1)).squeeze(-1) / d
    return (Linv.mT @ y.unsqueeze(-1)).squeeze(-1)


def chol_inv_solve(Linv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b given Linv = L^-1: x = Linv' (Linv b) — two products."""
    if b.ndim == Linv.ndim - 1:
        y = (Linv @ b.unsqueeze(-1)).squeeze(-1)
        return (Linv.mT @ y.unsqueeze(-1)).squeeze(-1)
    return Linv.mT @ (Linv @ b)
