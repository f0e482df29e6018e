"""Per-iteration vector math of the predictor-corrector solver.

Port of ``madipm_tpu/solver/kernels.py`` to batched torch: every function
takes (B, n) / (B, m) tensors and returns per-lane scalars as (B, 1)
columns.  Masked reductions replace index views, as in the JAX package.

Sign conventions:

    r_d = grad + A' y - zl + zu                 (dual residual)
    r_p = A x - b                               (primal residual)
    (3)  zl dx + sl dzl = rl,  sl = x - lb      (lower complementarity row)
    (4) -zu dx + su dzu = ru,  su = ub - x      (upper complementarity row)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.qp import TorchQP

_BIG = float("inf")


def _masked_max_abs(vals, mask):
    return torch.amax(torch.where(mask, torch.abs(vals), 0.0), dim=-1, keepdim=True)


def _masked_sum(vals, mask):
    return torch.sum(torch.where(mask, vals, 0.0), dim=-1, keepdim=True)


def _count(mask):
    return torch.sum(mask, dim=-1, keepdim=True)


def _dot(u, v):
    return torch.sum(u * v, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# Problem evaluations
# ---------------------------------------------------------------------------


def slacks(prob: TorchQP, x):
    sl = torch.where(prob.has_lb, x - prob.lb, 1.0)
    su = torch.where(prob.has_ub, prob.ub - x, 1.0)
    return sl, su


def eval_obj(prob: TorchQP, x):
    v = prob.c0 + _dot(prob.c, x)
    if prob.is_qp:
        v = v + 0.5 * _dot(x, prob.qmatvec(x))
    return v


def eval_grad(prob: TorchQP, x):
    g = prob.c
    if prob.is_qp:
        g = g + prob.qmatvec(x)
    return g


def eval_cons_residual(prob: TorchQP, x, ax=None):
    """A x - b, zeroed on padded rows; ``ax`` may supply A x."""
    r = (prob.matvec(x) if ax is None else ax) - prob.b
    return torch.where(prob.row_mask, r, 0.0)


def eval_jty(prob: TorchQP, y):
    return prob.rmatvec(y)


def dual_residual(prob: TorchQP, x, y, zl, zu, aty=None):
    """grad + A'y - zl + zu on free columns; ``aty`` may supply A' y."""
    r = eval_grad(prob, x) + (eval_jty(prob, y) if aty is None else aty) - zl + zu
    return torch.where(prob.free_mask, r, 0.0)


# ---------------------------------------------------------------------------
# Convergence measures
# ---------------------------------------------------------------------------


def primal_infeasibility(prob: TorchQP, x, ax=None):
    return _masked_max_abs(eval_cons_residual(prob, x, ax), prob.row_mask)


def dual_infeasibility(prob: TorchQP, x, y, zl, zu, aty=None):
    return _masked_max_abs(dual_residual(prob, x, y, zl, zu, aty), prob.free_mask)


def ls_infeasibility_certificate(prob: TorchQP, x, ax=None, min_residual=0.0):
    """Is x (approximately) a stationary point of min ||A x - b||^2 over the
    box, with a residual above ``min_residual``?  Gates the
    infeasibility-by-stall exit (driver.update_termination)."""
    r = eval_cons_residual(prob, x, ax)
    g = prob.rmatvec(r)
    r_inf = _masked_max_abs(r, prob.row_mask)
    sl = x - prob.lb
    su = prob.ub - x
    act_l = prob.has_lb & (sl <= 1e-6 * (1.0 + torch.abs(x)))
    act_u = prob.has_ub & (su <= 1e-6 * (1.0 + torch.abs(x)))
    pg = torch.where(
        act_l, torch.clamp(g, max=0.0), torch.where(act_u, torch.clamp(g, min=0.0), g)
    )
    pg_inf = _masked_max_abs(pg, prob.free_mask)
    return (pg_inf <= 1e-2 * r_inf) & (r_inf > min_residual)


def complementarity_inf(prob: TorchQP, x, zl, zu, mu=0.0):
    """max |s.z - mu| over both bound families."""
    sl, su = slacks(prob, x)
    cl = _masked_max_abs(sl * zl - mu, prob.has_lb)
    cu = _masked_max_abs(su * zu - mu, prob.has_ub)
    return torch.maximum(cl, cu)


def complementarity_measure(prob: TorchQP, x, zl, zu):
    """mu = sum(s.z)/(m1+m2)."""
    sl, su = slacks(prob, x)
    m12 = _count(prob.has_lb) + _count(prob.has_ub)
    tot = _masked_sum(sl * zl, prob.has_lb) + _masked_sum(su * zu, prob.has_ub)
    return torch.where(m12 == 0, 0.0, tot / torch.clamp(m12, min=1))


def affine_complementarity_measure(prob: TorchQP, x, zl, zu, dx, dzl, dzu, alpha_p, alpha_d):
    """Complementarity at the trial point."""
    sl, su = slacks(prob, x)
    m12 = _count(prob.has_lb) + _count(prob.has_ub)
    tl = (sl + alpha_p * dx) * (zl + alpha_d * dzl)
    tu = (su - alpha_p * dx) * (zu + alpha_d * dzu)
    tot = _masked_sum(tl, prob.has_lb) + _masked_sum(tu, prob.has_ub)
    return torch.where(m12 == 0, 0.0, tot / torch.clamp(m12, min=1))


def dual_objective(prob: TorchQP, y, zl, zu):
    """dobj = -y'b + zl'lb - zu'ub."""
    dobj = -_dot(y, torch.where(prob.row_mask, prob.b, 0.0))
    dobj = dobj + _masked_sum(zl * prob.lb, prob.has_lb)
    return dobj - _masked_sum(zu * prob.ub, prob.has_ub)


# ---------------------------------------------------------------------------
# Right-hand sides
# ---------------------------------------------------------------------------


class CondensedRHS(NamedTuple):
    rx: torch.Tensor  # [B, n] condensed primal rhs
    rp: torch.Tensor  # [B, m] dual-block rhs (= b - A x)
    rl: torch.Tensor  # [B, n] lower complementarity rhs (eq. 3)
    ru: torch.Tensor  # [B, n] upper complementarity rhs (eq. 4)


def predictor_rhs(prob: TorchQP, x, y, zl, zu, ax=None, aty=None) -> CondensedRHS:
    """Affine-scaling rhs."""
    sl, su = slacks(prob, x)
    rl = torch.where(prob.has_lb, -sl * zl, 0.0)
    ru = torch.where(prob.has_ub, -su * zu, 0.0)
    return _condense(prob, x, y, zl, zu, rl, ru, ax, aty)


def corrector_rhs(prob: TorchQP, x, y, zl, zu, mu, corr_l, corr_u, ax=None, aty=None) -> CondensedRHS:
    """Corrector rhs with centering + complementarity correction."""
    sl, su = slacks(prob, x)
    rl = torch.where(prob.has_lb, mu - sl * zl - corr_l, 0.0)
    ru = torch.where(prob.has_ub, mu - su * zu - corr_u, 0.0)
    return _condense(prob, x, y, zl, zu, rl, ru, ax, aty)


def _condense(prob, x, y, zl, zu, rl, ru, ax=None, aty=None) -> CondensedRHS:
    sl, su = slacks(prob, x)
    px = -dual_residual(prob, x, y, zl, zu, aty)
    rx = px + torch.where(prob.has_lb, rl / sl, 0.0) - torch.where(prob.has_ub, ru / su, 0.0)
    rx = torch.where(prob.free_mask, rx, 0.0)
    rp = -eval_cons_residual(prob, x, ax)
    return CondensedRHS(rx=rx, rp=rp, rl=rl, ru=ru)


def recover_bound_duals(prob: TorchQP, x, zl, zu, rhs: CondensedRHS, dx):
    """dzl, dzu from the complementarity rows."""
    sl, su = slacks(prob, x)
    dzl = torch.where(prob.has_lb, (rhs.rl - zl * dx) / sl, 0.0)
    dzu = torch.where(prob.has_ub, (rhs.ru + zu * dx) / su, 0.0)
    return dzl, dzu


def mehrotra_correction(prob: TorchQP, dx, dzl, dzu):
    """corr_l = dx.dzl, corr_u = -dx.dzu."""
    corr_l = torch.where(prob.has_lb, dx * dzl, 0.0)
    corr_u = torch.where(prob.has_ub, -dx * dzu, 0.0)
    return corr_l, corr_u


def gondzio_extra_correction(prob: TorchQP, x, zl, zu, dx, dzl, dzu, corr_l, corr_u,
                             alpha_p, alpha_d, beta_min, beta_max, mu):
    """Gondzio centrality correction: clip the trial pairwise products into
    [beta_min*mu, beta_max*mu]."""
    sl, su = slacks(prob, x)
    tmin, tmax = beta_min * mu, beta_max * mu

    def shortfall(v):
        return torch.where(v < tmin, tmin - v, torch.where(v > tmax, tmax - v, 0.0))

    vl = (sl + alpha_p * dx) * (zl + alpha_d * dzl)
    corr_l = torch.where(prob.has_lb, corr_l - shortfall(vl), 0.0)
    vu = (su - alpha_p * dx) * (zu + alpha_d * dzu)
    corr_u = torch.where(prob.has_ub, corr_u - shortfall(vu), 0.0)
    return corr_l, corr_u


# ---------------------------------------------------------------------------
# Step lengths
# ---------------------------------------------------------------------------


class AlphaMax(NamedTuple):
    alpha_xl: torch.Tensor
    alpha_xu: torch.Tensor
    alpha_zl: torch.Tensor
    alpha_zu: torch.Tensor
    i_xl: torch.Tensor  # (B, 1) argmin positions, for GTSF
    i_xu: torch.Tensor
    i_zl: torch.Tensor
    i_zu: torch.Tensor


def _masked_argmin_ratio(vals, mask):
    """(min(1, masked min), argmin position); the first minimum wins, as
    with ``jnp.argmin``, and an all-masked lane gives (1, 0)."""
    v = torch.where(mask, vals, _BIG)
    i = torch.argmin(v, dim=-1, keepdim=True)
    return torch.clamp(torch.gather(v, -1, i), max=1.0), i


def alpha_max(prob: TorchQP, x, zl, zu, dx, dzl, dzu, tau) -> AlphaMax:
    """Blocking step ratios per bound family, argmin-tracked."""
    sl, su = slacks(prob, x)
    a_xl, i_xl = _masked_argmin_ratio(-sl * tau / dx, prob.has_lb & (dx < 0))
    a_xu, i_xu = _masked_argmin_ratio(su * tau / dx, prob.has_ub & (dx > 0))
    a_zl, i_zl = _masked_argmin_ratio(-zl * tau / dzl, prob.has_lb & (dzl < 0))
    # The upper-dual test also requires zu + dzu < 0, as in the reference.
    a_zu, i_zu = _masked_argmin_ratio(
        -zu * tau / dzu, prob.has_ub & (dzu < 0) & (zu + dzu < 0)
    )
    return AlphaMax(a_xl, a_xu, a_zl, a_zu, i_xl, i_xu, i_zl, i_zu)


def fraction_to_boundary(prob: TorchQP, x, zl, zu, dx, dzl, dzu, tau):
    """(alpha_p, alpha_d)."""
    am = alpha_max(prob, x, zl, zu, dx, dzl, dzu, tau)
    return torch.minimum(am.alpha_xl, am.alpha_xu), torch.minimum(am.alpha_zl, am.alpha_zu)


def mehrotra_adaptive_step(prob: TorchQP, x, zl, zu, dx, dzl, dzu, gamma_f):
    """Mehrotra's boundary-point heuristic (Procedure GTSF)."""
    gamma_a = 1.0 / (1.0 - gamma_f)
    am = alpha_max(prob, x, zl, zu, dx, dzl, dzu, 1.0)
    max_alpha_p = torch.minimum(am.alpha_xl, am.alpha_xu)
    max_alpha_d = torch.minimum(am.alpha_zl, am.alpha_zu)
    mu_full = affine_complementarity_measure(
        prob, x, zl, zu, dx, dzl, dzu, max_alpha_p, max_alpha_d
    ) / gamma_a
    sl, su = slacks(prob, x)
    at = lambda v, i: torch.gather(v, -1, i)

    tmp_l = mu_full / (at(zl, am.i_xl) + max_alpha_d * at(dzl, am.i_xl))
    ap_l = (at(sl, am.i_xl) - tmp_l) / (-at(dx, am.i_xl))
    tmp_u = mu_full / (at(zu, am.i_xu) + max_alpha_d * at(dzu, am.i_xu))
    ap_u = (at(su, am.i_xu) - tmp_u) / at(dx, am.i_xu)
    alpha_p = torch.where(
        max_alpha_p < 1.0, torch.where(am.alpha_xl <= am.alpha_xu, ap_l, ap_u), 1.0
    )

    tmp_zl = mu_full / (at(sl, am.i_zl) + max_alpha_p * at(dx, am.i_zl))
    ad_l = -(at(zl, am.i_zl) - tmp_zl) / at(dzl, am.i_zl)
    tmp_zu = mu_full / (at(su, am.i_zu) - max_alpha_p * at(dx, am.i_zu))
    ad_u = -(at(zu, am.i_zu) - tmp_zu) / at(dzu, am.i_zu)
    alpha_d = torch.where(
        max_alpha_d < 1.0, torch.where(am.alpha_zl <= am.alpha_zu, ad_l, ad_u), 1.0
    )

    alpha_p = torch.maximum(alpha_p, gamma_f * max_alpha_p)
    alpha_d = torch.maximum(alpha_d, gamma_f * max_alpha_d)
    return alpha_p, alpha_d


# ---------------------------------------------------------------------------
# Barrier update
# ---------------------------------------------------------------------------


def mehrotra_barrier(prob: TorchQP, x, zl, zu, mu_affine, mu_min,
                     power=3.0, sigma_min=1e-6, sigma_max=10.0):
    """Mehrotra centering, gated on any bounded variable existing."""
    n_bounded = _count(prob.has_lb) + _count(prob.has_ub)
    mu_curr = complementarity_measure(prob, x, zl, zu)
    sigma = torch.where(
        n_bounded > 0,
        torch.clamp(
            (mu_affine / torch.clamp(mu_curr, min=1e-300)) ** power, sigma_min, sigma_max
        ),
        1.0,
    )
    mu_new = torch.clamp(sigma * mu_curr, min=mu_min)
    return mu_new, mu_curr


# ---------------------------------------------------------------------------
# Boundary adjustment
# ---------------------------------------------------------------------------


def adjust_boundary(prob: TorchQP, x, mu):
    """Push bounds out where the slack fell below eps*mu; returns (lb, ub)."""
    eps = torch.finfo(x.dtype).eps
    c1 = eps * mu
    c2 = eps ** 0.75
    lb, ub = prob.lb, prob.ub
    pad = c2 * torch.clamp(torch.abs(x), min=1.0)
    lb_new = torch.where(prob.has_lb & (x - lb < c1), x - pad, lb)
    ub_new = torch.where(prob.has_ub & (ub - x < c1), x + pad, ub)
    return lb_new, ub_new
