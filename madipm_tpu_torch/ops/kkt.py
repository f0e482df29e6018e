"""KKT system: the NORMAL slice of ``madipm_tpu/ops/kkt.py``.

NORMAL (LP only): condense the augmented system onto the dual block and
factorize the SPD normal matrix ``S = A Sigma^-1 A' - del_c I`` of size m,
one per lane.  The matrix is Jacobi-scaled before the factor; with a
factor dtype below the solve dtype the factor is only the preconditioner
of an fp64 PCG on the exact operator and is shifted by PRECOND_SHIFT.
CHOLESKY_INV factors through ``ops/chol_inv.chol_inv`` (the CUDA kernel on
the GPU), CHOLESKY through ``torch.linalg``.

The distributed, CONDENSED and AUGMENTED branches, the flexible PCG and
``precond_refine`` are ROADMAP items A7 and A11; ``solver.driver.make_config``
rejects them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.qp import TorchQP
from ..utils import sync
from ..utils.options import KKTSystem, LinearSolver
from . import block_chol, chol_inv, linalg


@dataclasses.dataclass(frozen=True)
class KKTConfig:
    """Static configuration of the per-iteration linear solve."""

    kind: KKTSystem
    linear_solver: LinearSolver
    factor_dtype: torch.dtype
    refinement_steps: int = 2
    max_factor_trials: int = 3


class NormalFactors(NamedTuple):
    L: torch.Tensor  # Cholesky factor (CHOLESKY) or its inverse (CHOLESKY_INV), factor dtype
    jac: torch.Tensor  # Jacobi scale d_i = 1/sqrt(S_ii) (factor dtype)
    dinv: torch.Tensor  # Sigma^-1 with fixed/padded columns zeroed (solve dtype)
    del_c: torch.Tensor  # (B, 1) dual regularization used in this factorization
    live: torch.Tensor  # rows coupled to variables (excludes padded and empty rows)


def build_sigma(prob: TorchQP, x, zl, zu, del_w):
    """Sigma = del_w + Zl (X - Xl)^-1 + Zu (Xu - X)^-1 on free columns,
    pinned to 1 elsewhere."""
    has_lb, has_ub = prob.has_lb, prob.has_ub
    sl = torch.where(has_lb, x - prob.lb, 1.0)
    su = torch.where(has_ub, prob.ub - x, 1.0)
    sigma = del_w + torch.where(has_lb, zl / sl, 0.0) + torch.where(has_ub, zu / su, 0.0)
    return torch.where(prob.free_mask, sigma, 1.0)


def _assemble_normal(prob: TorchQP, sigma, del_c, factor_dtype):
    """S = A Sigma^-1 A' - del_c I in the factor dtype, with non-live rows
    (padded, or structurally empty: diagonal <= 0) pinned to identity."""
    dinv = torch.where(prob.free_mask, 1.0 / sigma, 0.0)
    S = prob.assemble_normal_matrix(dinv, factor_dtype)
    dS = torch.diagonal(S, dim1=-2, dim2=-1).clone()
    live = prob.row_mask & (dS > 0)
    diag_add = torch.where(live, -del_c.to(factor_dtype), 1.0 - dS)
    torch.diagonal(S, dim1=-2, dim2=-1).add_(diag_add)
    return S, dinv, live


#: Diagonal shift of the Jacobi-scaled matrix before a low-precision
#: factorization (only when the fp64 PCG runs on the exact operator): the
#: factor is just a preconditioner there, and the shift keeps its pivots
#: healthy in fp32 when rows are nearly dependent.
PRECOND_SHIFT = 1e-6


def _lanes(mask, like):
    """Reshape a (B, 1) lane mask to broadcast against ``like``."""
    return mask.reshape(mask.shape[:1] + (1,) * (like.ndim - 1))


def factorize(cfg: KKTConfig, prob: TorchQP, x, zl, zu, del_w, del_c, force_ok=None):
    """Factorize each lane's system, bumping its regularization x100 on
    failure, up to ``max_factor_trials`` attempts.  Returns (factors,
    del_w, del_c, ok) with (B, 1) ``ok``.

    ``force_ok`` (B, 1) accepts a lane's first attempt unconditionally
    (finished-lane neutralization).  A lane leaves the retry loop on its
    own; the ones that stay keep theirs updated (the ``vmap`` semantics).
    """
    if cfg.kind != KKTSystem.NORMAL:
        raise NotImplementedError(f"kkt_system={cfg.kind.name} is ROADMAP item A7")
    rdtype = prob.dtype
    fdt = cfg.factor_dtype

    def attempt(dw, dc):
        sigma = build_sigma(prob, x, zl, zu, dw)
        S, dinv, live = _assemble_normal(prob, sigma, dc, fdt)
        # Jacobi scaling before the (possibly low-precision) factor.
        dS = torch.diagonal(S, dim1=-2, dim2=-1)
        jac = torch.rsqrt(torch.clamp(dS, min=torch.finfo(fdt).tiny))
        Shat = S * jac.unsqueeze(-1) * jac.unsqueeze(-2)
        if cfg.refinement_steps > 0 and fdt != rdtype:
            torch.diagonal(Shat, dim1=-2, dim2=-1).add_(PRECOND_SHIFT)
        if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
            Lc, W = chol_inv.chol_inv(Shat)
            ok = linalg.cholesky_is_ok(Lc) & torch.all(torch.isfinite(W), dim=(-2, -1))
            fac = W  # the inverse factor: solves are products
        else:
            fac = linalg.cholesky_factor(Shat)
            ok = linalg.cholesky_is_ok(fac)
        factors = NormalFactors(L=fac, jac=jac, dinv=dinv, del_c=dc.to(rdtype), live=live)
        return factors, ok.unsqueeze(-1)

    dw = del_w.to(rdtype)
    dc = del_c.to(rdtype)
    factors, ok = attempt(dw, dc)
    if force_ok is not None:
        ok = ok | force_ok
    trial = torch.ones_like(ok, dtype=torch.int32)
    while True:
        go = (~ok) & (trial < cfg.max_factor_trials)
        if not sync.any_true(go):
            break
        dw_n = dw * 100.0
        # The SPD system factors S - del_c I: retries force the stabilizing
        # (negative) sign of del_c.
        dc_n = -torch.clamp(torch.abs(dc), min=1e-12) * 100.0
        f_n, ok_n = attempt(dw_n, dc_n)
        trial = torch.where(go, trial + 1, trial)
        dw = torch.where(go, dw_n, dw)
        dc = torch.where(go, dc_n, dc)
        ok = torch.where(go, ok_n, ok)
        factors = NormalFactors(*(
            torch.where(_lanes(go, new), new, old) for new, old in zip(f_n, factors)
        ))
    return factors, dw, dc, ok


def solve_condensed(
    cfg: KKTConfig,
    prob: TorchQP,
    factors: NormalFactors,
    rx,
    rp,
    pcg_budget: Optional[int] = None,
    pcg_rtol=None,
    return_products: bool = False,
):
    """Solve [Sigma, A'; A, del_c][dx; dy] = [rx; rp] per lane through the
    normal equations: r2 = A Sigma^-1 rx - rp, S dy = r2, dx = Sigma^-1
    (rx - A' dy).

    With a low-precision factor the dy solve is an fp64 PCG on the exact
    operator (``pcg_budget`` iterations, default 4 x refinement_steps;
    ``pcg_budget == 0`` applies the factor only).  ``pcg_rtol`` (float or
    (B, 1)) overrides the exit tolerance.  ``return_products=True`` also
    returns (A dx, A' dy); on the PCG path A dx comes from the tracked
    residual, ``rp + r_pcg - del_c dy``, and drifts by O(eps64) per call.
    """
    if not isinstance(factors, NormalFactors):
        raise NotImplementedError("only NORMAL factors are ported (ROADMAP A7)")
    live = factors.live
    dinv = factors.dinv
    r2 = prob.matvec(dinv * rx) - rp
    r2 = torch.where(live, r2, 0.0)
    jac = factors.jac
    L = factors.L
    r_pcg = None

    def solve_fn(b):
        # S = D^1/2 Shat D^1/2  =>  S^-1 b = D^-1/2 Shat^-1 D^-1/2 b
        bf = (b * jac).to(L.dtype)
        if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
            z = block_chol.chol_inv_solve(L, bf)
        else:
            z = linalg.cholesky_solve(L, bf)
        return z * jac

    def matvec(v):
        # Exact fp64 operator, applied through A twice.
        sv = prob.matvec(dinv * prob.rmatvec(v)) - factors.del_c * v
        return torch.where(live, sv, v)

    if cfg.refinement_steps > 0:
        if pcg_budget == 0:
            dy = torch.where(live, solve_fn(r2).to(r2.dtype), 0.0)
            atdy = prob.rmatvec(dy)
            dx = dinv * (rx - atdy)
            if return_products:
                return dx, dy, torch.where(live, prob.matvec(dx), 0.0), atdy
            return dx, dy
        if pcg_budget is not None:
            rt = 1e-12 if pcg_rtol is None else pcg_rtol
            iters = pcg_budget
        else:
            rt = 1e-14 if pcg_rtol is None else pcg_rtol
            iters = 4 * cfg.refinement_steps
        out = linalg.pcg(solve_fn, matvec, r2, max_iters=iters, rtol=rt,
                         return_residual=return_products)
        dy, r_pcg = out if return_products else (out, None)
    else:
        dy = solve_fn(r2).to(r2.dtype)
    dy = torch.where(live, dy, 0.0)

    atdy = prob.rmatvec(dy)
    dx = dinv * (rx - atdy)
    if return_products:
        if r_pcg is not None:
            adx = torch.where(live, rp + r_pcg - factors.del_c * dy, 0.0)
        else:
            adx = torch.where(live, prob.matvec(dx), 0.0)
        return dx, dy, adx, atdy
    return dx, dy


def solve_residual(prob: TorchQP, factors: NormalFactors, rx, rp, dx, dy):
    """||K d - r||_inf / max(1, ||r||_inf) of the regularized KKT solve,
    per lane (B, 1)."""
    free = prob.free_mask
    dinv = factors.dinv
    sigma = torch.where(free, 1.0 / torch.where(dinv == 0, 1.0, dinv), 1.0)
    hx = torch.where(dinv == 0, 0.0, sigma * dx)
    top = torch.where(free, hx + prob.rmatvec(dy) - rx, 0.0)
    bot = torch.where(
        factors.live,
        prob.matvec(torch.where(free, dx, 0.0)) + factors.del_c * dy - rp,
        0.0,
    )
    amax = lambda v: torch.amax(torch.abs(v), dim=-1, keepdim=True)
    num = torch.maximum(amax(top), amax(bot))
    den = torch.clamp(torch.maximum(amax(rx * free), amax(rp * prob.row_mask)), min=1.0)
    return num / den
