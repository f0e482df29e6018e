"""Ruiz equilibration scaling: the port of ``madipm_tpu/models/scale.py``.

Alternately divide the rows and the columns of A by the square roots of
their infinity norms until both are ~1 (the inf-norm Ruiz iteration of HSL
``mc77``).  :func:`ruiz_factors` and :func:`scale_qp` are numpy copies;
:func:`ruiz_scale_dense`, the on-device dense sweep of the JAX package, is
torch here.

Scaled data (the convention of the JAX package):

    A_s[i,j] = A[i,j] / (Dr[i] * Dc[j]),  H_s[i,j] = H[i,j] / (Dc[i] * Dc[j])
    c_s = c ./ Dc, lvar_s = lvar .* Dc, lcon_s = lcon ./ Dr,  x_hat = Dc .* x

and a scaled solution maps back by x = x_hat / Dc, y = y_hat / Dr,
zl = zl_hat * Dc, zu = zu_hat * Dc.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .qp import QuadraticModel


@dataclasses.dataclass
class RuizScaling:
    Dr: np.ndarray  # [m]
    Dc: np.ndarray  # [n]

    def unscale_solution(self, x=None, y=None, zl=None, zu=None):
        out = []
        if x is not None:
            out.append(np.asarray(x) / self.Dc)
        if y is not None:
            out.append(np.asarray(y) / self.Dr)
        if zl is not None:
            out.append(np.asarray(zl) * self.Dc)
        if zu is not None:
            out.append(np.asarray(zu) * self.Dc)
        return tuple(out) if len(out) > 1 else out[0]


def ruiz_factors(A: sp.spmatrix, max_iter: int = 20, tol: float = 1e-2):
    """Inf-norm Ruiz equilibration factors (Dr, Dc)."""
    m, n = A.shape
    Dr = np.ones(m)
    Dc = np.ones(n)
    if m == 0 or n == 0 or A.nnz == 0:
        return Dr, Dc  # nothing to equilibrate (fully presolved problems)
    B = A.tocsr(copy=True).astype(np.float64)
    for _ in range(max_iter):
        Babs = abs(B)
        r = np.sqrt(Babs.max(axis=1).toarray().ravel())
        c = np.sqrt(Babs.max(axis=0).toarray().ravel())
        r[r == 0] = 1.0
        c[c == 0] = 1.0
        if max(np.abs(r * r - 1).max(initial=0), np.abs(c * c - 1).max(initial=0)) < tol:
            break
        B = sp.diags(1.0 / r) @ B @ sp.diags(1.0 / c)
        Dr *= r
        Dc *= c
    return Dr, Dc


def scale_qp(qp: QuadraticModel, max_iter: int = 20):
    """Ruiz-equilibrate a QP; returns (scaled_model, RuizScaling)."""
    Dr, Dc = ruiz_factors(qp.A, max_iter=max_iter)
    A_s = sp.diags(1.0 / Dr) @ qp.A @ sp.diags(1.0 / Dc)
    Q_s = None
    if qp.Q is not None:
        Q_s = sp.diags(1.0 / Dc) @ qp.Q @ sp.diags(1.0 / Dc)
    scaled = QuadraticModel(
        c=qp.c / Dc,
        A=A_s.tocsr(),
        lcon=qp.lcon / Dr,
        ucon=qp.ucon / Dr,
        lvar=qp.lvar * Dc,
        uvar=qp.uvar * Dc,
        Q=None if Q_s is None else Q_s.tocsr(),
        c0=qp.c0,
        x0=qp.x0 * Dc,
        y0=qp.y0 / Dr,
        name=qp.name,
        minimize=qp.minimize,
    )
    return scaled, RuizScaling(Dr=Dr, Dc=Dc)


def ruiz_scale_dense(A: torch.Tensor, max_iter: int = 10):
    """Dense Ruiz sweep on the tensor's device, a fixed number of passes
    (no data-dependent control flow).  ``A`` is (m, n) or a (B, m, n)
    stack; returns (A_scaled, dr, dc) with A_scaled = A / (dr dc')."""
    dr = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device)
    dc = torch.ones(A.shape[:-2] + A.shape[-1:], dtype=A.dtype, device=A.device)
    B = A
    for _ in range(max_iter):
        r = torch.sqrt(torch.clamp(torch.amax(torch.abs(B), dim=-1), min=1e-30))
        r = torch.where(r < 1e-15, 1.0, r)
        B = B / r.unsqueeze(-1)
        dr = dr * r
        c = torch.sqrt(torch.clamp(torch.amax(torch.abs(B), dim=-2), min=1e-30))
        c = torch.where(c < 1e-15, 1.0, c)
        B = B / c.unsqueeze(-2)
        dc = dc * c
    return B, dr, dc
