"""Recursive blocked Cholesky with explicit inverse factor, in plain torch.

Port of ``madipm_tpu/ops/block_chol.py`` (``chol_inv``, ``_chol_base``,
``_tri_inv_base``, ``chol_inv_solve``).  The divide-and-conquer recursion

    S = [[S11, S21'], [S21, S22]]
    L11, W1 = chol_inv(S11);  L21 = S21 W1';  L22, W2 = chol_inv(S22 - L21 L21')
    Linv = [[W1, 0], [-W2 L21 W1, W2]]

is the same sequence of products as the JAX version, so on the CPU the two
agree to rounding.  This is the plain version of the CUDA kernel in
``ops/chol_inv.py``: the wrapper there runs it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.  Every function
takes (N, N) or (B, N, N) tensors.
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


def chol_inv(S: torch.Tensor, base: int = _BASE):
    """(L, Linv) of SPD ``S`` via the matmul recursion."""
    n = S.shape[-1]
    if n <= base or n % 2 != 0:
        return _chol_base(S)
    h = n // 2
    S11 = S[..., :h, :h]
    S21 = S[..., h:, :h]
    S22 = S[..., h:, h:]
    L11, W1 = chol_inv(S11, base)
    L21 = S21 @ W1.mT
    T = S22 - L21 @ L21.mT
    L22, W2 = chol_inv(T, base)
    Z = torch.zeros_like(S21.mT)
    W21 = -(W2 @ (L21 @ W1))
    L = torch.cat([torch.cat([L11, Z], dim=-1), torch.cat([L21, L22], dim=-1)], dim=-2)
    W = torch.cat([torch.cat([W1, Z], dim=-1), torch.cat([W21, W2], dim=-1)], dim=-2)
    return L, W


def chol_inv_solve(Linv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b given Linv = L^-1: x = Linv' (Linv b) — two products."""
    if b.ndim == Linv.ndim - 1:
        y = (Linv @ b.unsqueeze(-1)).squeeze(-1)
        return (Linv.mT @ y.unsqueeze(-1)).squeeze(-1)
    return Linv.mT @ (Linv @ b)
