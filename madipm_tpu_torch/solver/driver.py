"""Mehrotra predictor-corrector driver.

Port of the fused path of ``madipm_tpu/solver/driver.py``: configuration,
scaling, initialization, termination, the three phases of one iteration
and ``solve_device``.  Where the JAX package traces one XLA program and
``vmap``s it over instances, this driver runs a host loop over a batch of
lanes.  Every data-dependent exit is a lane mask; the host reads one flag
per exit test (``utils/sync.py``) and a lane that has left a loop keeps
its state bit for bit, so each lane follows the trajectory that
``vmap(solve_device)`` gives it.  LPs and convex QPs run through every
dense KKT system (NORMAL, CONDENSED, AUGMENTED, SCALED_AUGMENTED), with
Gondzio corrections on request.  The logged, timed and chunked drivers
are ROADMAP item A10.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..models.qp import TorchQP
from ..ops import kkt as kkt_ops
from ..ops.kkt import KKTConfig
from ..utils import sync
from ..utils.options import (
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    IPMOptions,
    KKTSystem,
    Mehrotra,
    MehrotraAdaptiveStep,
    NoRegularization,
)
from ..utils.status import Status
from . import kernels as K
from .state import IPMState, init_state

_REGULAR = int(Status.REGULAR)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Solver configuration derived from IPMOptions."""

    kkt: KKTConfig
    tol: float
    acceptable_tol: float
    acceptable_iter: int
    max_iter: int
    divergence_tol: float
    mu_init: float
    mu_min: float
    max_ncorr: int
    s_max: float
    scaling: bool
    bound_push: float
    bound_fac: float
    bound_relax_factor: float
    step_rule: object
    regularization: object
    barrier_update: Mehrotra
    check_residual: bool
    tol_linear_solve: float
    pcg_adaptive_tol: bool = False
    pcg_tol_cap: float = 1e-9
    pcg_tol_floor: float = 1e-13
    mu_balance: float = 1e-2
    predictor_pcg_budget: Optional[int] = None
    product_recurrence: bool = True


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    found = {"float32": torch.float32, "float64": torch.float64}.get(str(d))
    if found is None:
        raise ValueError(f"factor_dtype must be 'float32' or 'float64', got {d!r}")
    return found


def make_config(opt: IPMOptions, is_qp: bool, dtype: torch.dtype = torch.float64) -> SolverConfig:
    """Resolve the options into a SolverConfig; options whose code path is
    not ported raise NotImplementedError naming their ROADMAP item."""
    kind = opt.resolved_kkt(is_qp)
    if kind == KKTSystem.NORMAL and is_qp:
        raise ValueError(
            "NormalKKT supports only linear programs; use kkt_system=AUGMENTED for QPs."
        )
    for name, unported in (
        ("pcg_flex", opt.pcg_flex),
        ("precond_refine", opt.precond_refine),
        ("factor_precision", opt.factor_precision is not None),
    ):
        if unported:
            raise NotImplementedError(f"option {name} is ROADMAP item A7b")
    if opt.fp64_matvec in ("ozaki", "ozaki_i8"):
        raise NotImplementedError(
            f"fp64_matvec={opt.fp64_matvec!r} is ROADMAP item A12; fp64 matvecs are native here"
        )
    if opt.fp64_matvec not in ("auto", "emulated"):
        raise ValueError(
            "fp64_matvec must be 'auto', 'ozaki', 'ozaki_i8' or 'emulated', "
            f"got {opt.fp64_matvec!r}"
        )
    if not isinstance(opt.barrier_update, Mehrotra):
        raise ValueError(f"barrier_update must be a Mehrotra instance, got {opt.barrier_update!r}")
    factor_dtype = _torch_dtype(opt.factor_dtype) if opt.factor_dtype else dtype
    # The PCG only pays off when the factor runs below the solve precision,
    # except for K1, whose gamma-relaxation (cond(C) ~ 1e8) needs the polish
    # even with an fp64 factor.
    if factor_dtype != dtype or kind == KKTSystem.CONDENSED:
        refinement = opt.refinement_steps
    else:
        refinement = 0
    kcfg = KKTConfig(
        kind=kind,
        linear_solver=opt.resolved_linear_solver(kind),
        factor_dtype=factor_dtype,
        refinement_steps=refinement,
        max_factor_trials=3,
        use_pallas=bool(opt.use_pallas),  # None (auto) = off
    )
    return SolverConfig(
        kkt=kcfg,
        tol=opt.tol,
        acceptable_tol=opt.acceptable_tol,
        acceptable_iter=opt.acceptable_iter,
        max_iter=opt.max_iter,
        divergence_tol=opt.divergence_tol,
        mu_init=opt.mu_init,
        mu_min=opt.mu_min,
        max_ncorr=opt.max_ncorr,
        s_max=opt.s_max,
        scaling=opt.scaling,
        bound_push=opt.bound_push,
        bound_fac=opt.bound_fac,
        bound_relax_factor=opt.bound_relax_factor,
        step_rule=opt.step_rule,
        regularization=opt.regularization,
        barrier_update=opt.barrier_update,
        check_residual=opt.check_residual,
        tol_linear_solve=opt.tol_linear_solve,
        pcg_adaptive_tol=opt.pcg_adaptive_tol,
        pcg_tol_cap=opt.pcg_tol_cap,
        pcg_tol_floor=opt.pcg_tol_floor,
        mu_balance=opt.mu_balance,
        predictor_pcg_budget=opt.predictor_pcg_budget,
        product_recurrence=opt.product_recurrence,
    )


# ---------------------------------------------------------------------------
# Scaling
# ---------------------------------------------------------------------------


class ScaleInfo(NamedTuple):
    """Objective (B, 1) and row (B, m) scaling factors."""

    obj_scale: torch.Tensor
    con_scale: torch.Tensor


def _apply_scaling(cfg: SolverConfig, prob: TorchQP, x_init):
    """Max-norm row scaling capped at s_max; objective likewise."""
    if cfg.scaling:
        row_norm = prob.row_inf_norm()
        con_scale = torch.where(
            prob.row_mask,
            torch.clamp(cfg.s_max / torch.clamp(row_norm, min=1e-30), max=1.0),
            1.0,
        )
        g0 = K.eval_grad(prob, x_init)
        gnorm = torch.amax(torch.where(prob.free_mask, torch.abs(g0), 0.0), dim=-1, keepdim=True)
        obj_scale = torch.clamp(cfg.s_max / torch.clamp(gnorm, min=1e-30), max=1.0)
    else:
        con_scale = torch.ones_like(prob.b)
        obj_scale = torch.ones_like(prob.c0)
    prob_s = dataclasses.replace(
        prob.scale_rows(con_scale).scale_quad(obj_scale),
        b=prob.b * con_scale,
        c=prob.c * obj_scale,
        c0=prob.c0 * obj_scale,
    )
    return prob_s, ScaleInfo(obj_scale, con_scale)


# ---------------------------------------------------------------------------
# Regularization policies
# ---------------------------------------------------------------------------


def _init_regularization(cfg: SolverConfig, like: torch.Tensor):
    reg = cfg.regularization
    full = lambda v: torch.full_like(like, v)
    if isinstance(reg, NoRegularization):
        return full(1.0), full(0.0), full(0.0), full(0.0)
    if isinstance(reg, (FixedRegularization, AdaptiveRegularization)):
        return full(1.0), full(reg.delta_d), full(reg.delta_p), full(reg.delta_d)
    raise TypeError(f"unknown regularization {reg!r}")


def _update_regularization(cfg: SolverConfig, state: IPMState):
    reg = cfg.regularization
    if isinstance(reg, NoRegularization):
        zero = torch.zeros_like(state.del_w)
        return zero, zero, state.reg_p, state.reg_d
    if isinstance(reg, FixedRegularization):
        return (
            torch.full_like(state.del_w, reg.delta_p),
            torch.full_like(state.del_w, reg.delta_d),
            state.reg_p,
            state.reg_d,
        )
    if isinstance(reg, AdaptiveRegularization):
        reg_p = torch.clamp(state.reg_p / 10.0, min=reg.delta_min)
        reg_d = torch.clamp(state.reg_d / 10.0, max=-reg.delta_min)
        return reg_p, reg_d, reg_p, reg_d
    raise TypeError(f"unknown regularization {reg!r}")


# ---------------------------------------------------------------------------
# Initialization (Mehrotra starting point)
# ---------------------------------------------------------------------------


def _lane_min0(v):
    return torch.clamp(torch.amin(v, dim=-1, keepdim=True), max=0.0)


def initialize(cfg: SolverConfig, prob: TorchQP) -> Tuple[TorchQP, ScaleInfo, IPMState]:
    dtype = prob.dtype
    free = prob.free_mask

    # Bound relaxation
    brf = cfg.bound_relax_factor
    lb = torch.where(
        free & torch.isfinite(prob.lb),
        prob.lb - brf * torch.clamp(torch.abs(prob.lb), min=1.0),
        prob.lb,
    )
    ub = torch.where(
        free & torch.isfinite(prob.ub),
        prob.ub + brf * torch.clamp(torch.abs(prob.ub), min=1.0),
        prob.ub,
    )
    prob = dataclasses.replace(prob, lb=lb, ub=ub)

    # Push x0 strictly inside its bounds
    k1, k2 = cfg.bound_push, cfg.bound_fac
    width = ub - lb
    pl = torch.minimum(k1 * torch.clamp(torch.abs(lb), min=1.0), k2 * width)
    pu = torch.minimum(k1 * torch.clamp(torch.abs(ub), min=1.0), k2 * width)
    x = prob.x0
    x = torch.where(free & torch.isfinite(lb), torch.maximum(x, lb + pl), x)
    x = torch.where(free & torch.isfinite(ub), torch.minimum(x, ub - pu), x)
    # Fixed/padded columns pinned to their (lower) bound value.
    x = torch.where(free, x, torch.where(prob.col_mask, prob.lb, 0.0))
    y = prob.y0

    prob_s, scale = _apply_scaling(cfg, prob, x)

    del_w, del_c, reg_p, reg_d = _init_regularization(cfg, prob.c0)
    g0 = K.eval_grad(prob_s, x)
    norm_b = torch.amax(torch.where(prob_s.row_mask, torch.abs(prob_s.b), 0.0), dim=-1, keepdim=True)
    norm_c = torch.amax(torch.where(prob_s.free_mask, torch.abs(g0), 0.0), dim=-1, keepdim=True)

    # Initial KKT factorization with Sigma = del_w (zl = zu = 0)
    zeros_n = torch.zeros_like(x)
    factors, del_w, del_c, _ok = kkt_ops.factorize(
        cfg.kkt, prob_s, x, zeros_n, zeros_n, del_w, del_c
    )

    # Step 1: x <- x + dx, dx the least-squares solution of A dx = b - A x
    rp = -K.eval_cons_residual(prob_s, x)
    dx, _ = kkt_ops.solve_condensed(cfg.kkt, prob_s, factors, zeros_n, rp)
    x = x + dx

    # Step 2: y = least-squares solution of A' y = -grad
    rx = torch.where(prob_s.free_mask, -g0, 0.0)
    _, dy = kkt_ops.solve_condensed(cfg.kkt, prob_s, factors, rx, torch.zeros_like(prob_s.b))
    y = dy

    # Step 3: bound multipliers from res = grad + A'y
    res = g0 + K.eval_jty(prob_s, y)
    fin_l, fin_u = torch.isfinite(lb), torch.isfinite(ub)
    both = fin_l & fin_u
    zl = torch.where(both, 0.5 * res, torch.where(fin_l, res, 0.0))
    zu = torch.where(both, -0.5 * res, torch.where(fin_u, -res, 0.0))
    has_lb, has_ub = prob.has_lb, prob.has_ub
    zl = torch.where(has_lb, zl, 0.0)
    zu = torch.where(has_ub, zu, 0.0)

    # Interiority shifts
    inf = float("inf")
    sl = torch.where(has_lb, x - lb, inf)
    su = torch.where(has_ub, ub - x, inf)
    delta_x = torch.clamp(torch.maximum(-1.5 * _lane_min0(sl), -1.5 * _lane_min0(su)), min=0.0)
    delta_s = torch.clamp(
        torch.maximum(
            -1.5 * _lane_min0(torch.where(has_lb, zl, inf)),
            -1.5 * _lane_min0(torch.where(has_ub, zu, inf)),
        ),
        min=0.0,
    )
    sign = has_lb.to(dtype) - has_ub.to(dtype)
    x = x + delta_x * sign
    zl = torch.where(has_lb, zl + 1.0 + delta_s, 0.0)
    zu = torch.where(has_ub, zu + 1.0 + delta_s, 0.0)

    sl = torch.where(has_lb, x - lb, 0.0)
    su = torch.where(has_ub, ub - x, 0.0)
    lane_sum = lambda v: torch.sum(v, dim=-1, keepdim=True)
    mu_sum = lane_sum(sl * zl) + lane_sum(su * zu)
    nz = lane_sum(torch.where(has_lb, zl, 0.0)) + lane_sum(torch.where(has_ub, zu, 0.0))
    nsl = lane_sum(sl) + lane_sum(su)
    delta_x2 = torch.where(nz > 0, mu_sum / (2.0 * nz), 0.0)
    delta_s2 = torch.where(nsl > 0, mu_sum / (2.0 * nsl), 0.0)
    x = x + delta_x2 * sign
    zl = torch.where(has_lb, zl + delta_s2, 0.0)
    zu = torch.where(has_ub, zu + delta_s2, 0.0)

    # Ipopt projection back into [l, u] (max(1, l), not |l|, as the reference)
    kappa = cfg.bound_fac
    pl = torch.minimum(kappa * torch.clamp(lb, min=1.0), kappa * (ub - lb))
    pu = torch.minimum(kappa * torch.clamp(ub, min=1.0), kappa * (ub - lb))
    x_proj = torch.where(x < lb, lb + pl, torch.where(ub < x, ub - pu, x))
    x = torch.where(free, x_proj, x)

    st = init_state(prob.batch, prob.n, prob.m, dtype, prob.device)
    st = st.replace(
        x=x, y=y, zl=zl, zu=zu, lb=lb, ub=ub,
        mu=torch.full_like(st.mu, cfg.mu_init),
        del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
        obj_val=K.eval_obj(prob_s, x),
        norm_b=norm_b, norm_c=norm_c,
        status=torch.full_like(st.status, _REGULAR),
    )
    return prob_s, scale, st


# ---------------------------------------------------------------------------
# Termination
# ---------------------------------------------------------------------------


def update_termination(cfg: SolverConfig, prob: TorchQP, state: IPMState, ax=None, aty=None) -> IPMState:
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    x, y, zl, zu = state.x, state.y, state.zl, state.zu
    obj = K.eval_obj(prob, x)
    dobj = K.dual_objective(prob, y, zl, zu)
    inf_pr = K.primal_infeasibility(prob, x, ax) / torch.clamp(state.norm_b, min=1.0)
    norm_c = torch.clamp(state.norm_c, min=1.0)
    inf_du = K.dual_infeasibility(prob, x, y, zl, zu, aty) / norm_c
    inf_compl = K.complementarity_inf(prob, x, zl, zu) / norm_c
    best = torch.minimum(state.best_compl, inf_compl)

    res_max = torch.maximum(torch.maximum(inf_pr, inf_du), inf_compl)
    converged = res_max <= cfg.tol
    in_acc = res_max <= cfg.acceptable_tol
    n_acc = torch.where(in_acc, state.n_acceptable + 1, 0).to(torch.int32)
    acceptable = in_acc & (n_acc >= cfg.acceptable_iter)
    infeasible = (inf_compl > cfg.divergence_tol * best) & (
        dobj > torch.clamp(10.0 * torch.abs(obj), min=1.0)
    )
    # Infeasibility by primal stall, gated by the least-squares certificate.
    improved = inf_pr < 0.99 * state.best_pr
    best_pr = torch.minimum(state.best_pr, inf_pr)
    n_stall = torch.where(improved, 0, state.n_stall + 1).to(torch.int32)
    compl_floor = torch.clamp(10.0 * cfg.mu_balance * inf_pr, min=cfg.acceptable_tol)
    stall_infeasible = (
        (n_stall >= 100)
        & (inf_pr > math.sqrt(cfg.tol))
        & (inf_du <= cfg.acceptable_tol)
        & (inf_compl <= compl_floor)
        & state.ls_cert
    )
    infeasible = infeasible | stall_infeasible
    diverging = obj < -cfg.divergence_tol * torch.clamp(torch.abs(dobj), min=10.0)
    max_iter = state.k >= cfg.max_iter

    status = torch.where(
        converged,
        int(Status.SOLVE_SUCCEEDED),
        torch.where(
            acceptable,
            int(Status.SOLVED_TO_ACCEPTABLE_LEVEL),
            torch.where(
                infeasible,
                int(Status.INFEASIBLE_PROBLEM_DETECTED),
                torch.where(
                    diverging,
                    int(Status.DIVERGING_ITERATES),
                    torch.where(max_iter, int(Status.MAXIMUM_ITERATIONS_EXCEEDED), state.status),
                ),
            ),
        ),
    ).to(torch.int32)
    return state.replace(
        obj_val=obj, inf_pr=inf_pr, inf_du=inf_du, inf_compl=inf_compl,
        best_compl=best, status=status, n_acceptable=n_acc,
        best_pr=best_pr, n_stall=n_stall,
    )


# ---------------------------------------------------------------------------
# One MPC iteration
# ---------------------------------------------------------------------------


def _factor_phase(cfg: SolverConfig, prob: TorchQP, state: IPMState, active=None):
    """Regularization update + KKT factorization.

    ``active`` (B, 1): a finished lane factors a benign system (zl = zu = 0,
    del_w = 1, del_c = 0) with the retry loop disarmed, so that it cannot
    keep the retry loop going for the lanes still running.
    """
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    del_w, del_c, reg_p, reg_d = _update_regularization(cfg, state)
    zl, zu = state.zl, state.zu
    force_ok = None
    if active is not None:
        zl = torch.where(active, zl, 0.0)
        zu = torch.where(active, zu, 0.0)
        del_w = torch.where(active, del_w, 1.0)
        del_c = torch.where(active, del_c, 0.0)
        force_ok = ~active
    factors, del_w, del_c, _ok = kkt_ops.factorize(
        cfg.kkt, prob, state.x, zl, zu, del_w, del_c, force_ok=force_ok
    )
    return factors, del_w, del_c, reg_p, reg_d


def _lane_all_finite(v):
    return torch.all(torch.isfinite(v), dim=-1, keepdim=True)


def _direction_phase(cfg: SolverConfig, prob: TorchQP, state: IPMState, factors, ax, aty,
                     active=None, return_products=False):
    """Predictor + Mehrotra corrector (+ Gondzio) solves; returns the
    accepted direction and the new barrier parameter (and its (A dx, A' dy)
    with ``return_products``).
    A finished lane (``active`` False) solves with a zero rhs, so its PCG
    exits on the first test."""
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    x, y, zl, zu = state.x, state.y, state.zl, state.zu

    def solve(rx, rp, **kw):
        if active is not None:
            rx = torch.where(active, rx, 0.0)
            rp = torch.where(active, rp, 0.0)
        return kkt_ops.solve_condensed(cfg.kkt, prob, factors, rx, rp, **kw)

    rtol_pred = rtol_corr = None
    if cfg.pcg_adaptive_tol:
        rtol_pred = torch.clamp(0.05 * state.mu, 1e-11, 1e-8)

    # Predictor (affine scaling); a reduced PCG budget.
    rhs_aff = K.predictor_rhs(prob, x, y, zl, zu, ax, aty)
    pred_budget = (
        cfg.predictor_pcg_budget
        if cfg.predictor_pcg_budget is not None
        else max(2, cfg.kkt.refinement_steps // 2)
    )
    dx, dy = solve(rhs_aff.rx, rhs_aff.rp, pcg_budget=pred_budget, pcg_rtol=rtol_pred)
    dzl, dzu = K.recover_bound_duals(prob, x, zl, zu, rhs_aff, dx)

    a_aff_p, a_aff_d = K.fraction_to_boundary(prob, x, zl, zu, dx, dzl, dzu, 1.0)
    mu_aff = K.affine_complementarity_measure(prob, x, zl, zu, dx, dzl, dzu, a_aff_p, a_aff_d)
    corr_l, corr_u = K.mehrotra_correction(prob, dx, dzl, dzu)
    bu = cfg.barrier_update
    mu_new, mu_curr = K.mehrotra_barrier(
        prob, x, zl, zu, mu_aff, cfg.mu_min,
        power=bu.power, sigma_min=bu.sigma_min, sigma_max=bu.sigma_max,
    )
    # Balanced central path: floor mu at mu_balance x the scaled
    # infeasibility (no floor until the residuals have been measured).
    if cfg.mu_balance > 0:
        res_bal = torch.maximum(state.inf_pr, state.inf_du)
        floor = torch.where(torch.isfinite(res_bal), cfg.mu_balance * res_bal, 0.0)
        mu_new = torch.maximum(mu_new, floor)

    # Mehrotra corrector
    if cfg.pcg_adaptive_tol:
        rtol_corr = torch.clamp(0.01 * mu_new, cfg.pcg_tol_floor, cfg.pcg_tol_cap)
    rhs_c = K.corrector_rhs(prob, x, y, zl, zu, mu_new, corr_l, corr_u, ax, aty)
    adx = atdy = None
    if return_products:
        dx, dy, adx, atdy = solve(rhs_c.rx, rhs_c.rp, pcg_rtol=rtol_corr, return_products=True)
    else:
        dx, dy = solve(rhs_c.rx, rhs_c.rp, pcg_rtol=rtol_corr)
    dzl, dzu = K.recover_bound_duals(prob, x, zl, zu, rhs_c, dx)

    solve_bad = torch.zeros_like(state.ls_cert)
    if cfg.check_residual:
        res = kkt_ops.solve_residual(prob, factors, rhs_c.rx, rhs_c.rp, dx, dy)
        solve_bad = res > cfg.tol_linear_solve

    # Gondzio multiple centrality corrections: a fixed number of extra
    # solves; a lane stops taking them at its first rejected one.
    if cfg.max_ncorr > 0:
        delta = 0.1
        beta_min, beta_max = 0.1, 10.0
        tau_g = 0.995
        alpha_p_g, alpha_d_g = K.fraction_to_boundary(prob, x, zl, zu, dx, dzl, dzu, tau_g)
        stopped = torch.zeros_like(state.ls_cert)
        for _ in range(cfg.max_ncorr):
            t_ap = torch.clamp(alpha_p_g + delta, max=1.0)
            t_ad = torch.clamp(alpha_d_g + delta, max=1.0)
            ga = K.affine_complementarity_measure(prob, x, zl, zu, dx, dzl, dzu, t_ap, t_ad)
            mu_g = (ga / mu_curr) ** 2 * ga
            corr_l2, corr_u2 = K.gondzio_extra_correction(
                prob, x, zl, zu, dx, dzl, dzu, corr_l, corr_u,
                t_ap, t_ad, beta_min, beta_max, mu_g,
            )
            rhs_g = K.corrector_rhs(prob, x, y, zl, zu, mu_g, corr_l2, corr_u2, ax, aty)
            adx2 = atdy2 = None
            if return_products:
                dx2, dy2, adx2, atdy2 = solve(
                    rhs_g.rx, rhs_g.rp, pcg_rtol=rtol_corr, return_products=True
                )
            else:
                dx2, dy2 = solve(rhs_g.rx, rhs_g.rp, pcg_rtol=rtol_corr)
            dzl2, dzu2 = K.recover_bound_duals(prob, x, zl, zu, rhs_g, dx2)
            hat_ap, hat_ad = K.fraction_to_boundary(prob, x, zl, zu, dx2, dzl2, dzu2, tau_g)
            # Reject when the step sizes fail to grow or the extra solve
            # gave non-finite values (NaN alphas would compare False).
            finite = (
                _lane_all_finite(dx2) & _lane_all_finite(dy2)
                & torch.isfinite(hat_ap) & torch.isfinite(hat_ad)
            )
            reject = (hat_ap < 1.005 * alpha_p_g) | (hat_ad < 1.005 * alpha_d_g) | ~finite
            accept = (~stopped) & (~reject)
            dx, dy = torch.where(accept, dx2, dx), torch.where(accept, dy2, dy)
            dzl, dzu = torch.where(accept, dzl2, dzl), torch.where(accept, dzu2, dzu)
            if return_products:
                adx = torch.where(accept, adx2, adx)
                atdy = torch.where(accept, atdy2, atdy)
            corr_l = torch.where(accept, corr_l2, corr_l)
            corr_u = torch.where(accept, corr_u2, corr_u)
            alpha_p_g = torch.where(accept, hat_ap, alpha_p_g)
            alpha_d_g = torch.where(accept, hat_ad, alpha_d_g)
            stopped = stopped | reject

    if return_products:
        return dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad, adx, atdy
    return dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad


def _step_phase(cfg: SolverConfig, prob: TorchQP, state: IPMState,
                dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad,
                del_w, del_c, reg_p, reg_d, products=None):
    """Step rule + apply step + failure/salvage mapping.  With
    ``products=(ax, aty, adx, atdy)`` also returns the recurrence-advanced
    (A x, A' y) pair: kept on a salvaged lane, NaN on a failed one."""
    prob = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    x, y, zl, zu = state.x, state.y, state.zl, state.zu

    rule = cfg.step_rule
    if isinstance(rule, ConservativeStep):
        alpha_p, alpha_d = K.fraction_to_boundary(prob, x, zl, zu, dx, dzl, dzu, rule.tau)
    elif isinstance(rule, AdaptiveStep):
        tau = torch.clamp(1.0 - mu_new, min=rule.tau_min)
        alpha_p, alpha_d = K.fraction_to_boundary(prob, x, zl, zu, dx, dzl, dzu, tau)
    elif isinstance(rule, MehrotraAdaptiveStep):
        alpha_p, alpha_d = K.mehrotra_adaptive_step(prob, x, zl, zu, dx, dzl, dzu, rule.gamma_f)
    else:
        raise TypeError(f"unknown step rule {rule!r}")

    x = x + alpha_p * dx
    y = y + alpha_d * dy
    zl = torch.where(prob.has_lb, zl + alpha_d * dzl, 0.0)
    zu = torch.where(prob.has_ub, zu + alpha_d * dzu, 0.0)
    lb_new, ub_new = K.adjust_boundary(prob, x, mu_new)

    # NaN in the new iterate -> ERROR_IN_STEP_COMPUTATION, unless the
    # previous iterate already met acceptable_tol (salvage: keep it).
    bad = solve_bad | ~(
        _lane_all_finite(x) & _lane_all_finite(y) & _lane_all_finite(zl) & _lane_all_finite(zu)
    )
    res_prev = torch.maximum(torch.maximum(state.inf_pr, state.inf_du), state.inf_compl)
    salvage = bad & (res_prev <= cfg.acceptable_tol)
    status = torch.where(
        salvage,
        int(Status.SOLVED_TO_ACCEPTABLE_LEVEL),
        torch.where(bad, int(Status.ERROR_IN_STEP_COMPUTATION), state.status),
    ).to(torch.int32)
    keep = lambda new, old: torch.where(salvage, old, new)
    x, y = keep(x, state.x), keep(y, state.y)
    zl, zu = keep(zl, state.zl), keep(zu, state.zu)
    lb_new, ub_new = keep(lb_new, state.lb), keep(ub_new, state.ub)

    new_state = state.replace(
        x=x, y=y, zl=zl, zu=zu, lb=lb_new, ub=ub_new,
        dx=dx, dy=dy, dzl=dzl, dzu=dzu,
        mu=mu_new, mu_curr=mu_curr,
        alpha_p=alpha_p, alpha_d=alpha_d,
        del_w=del_w, del_c=del_c, reg_p=reg_p, reg_d=reg_d,
        k=state.k + 1,
        status=status,
    )
    if products is None:
        return new_state
    ax0, aty0, adx, atdy = products
    nan = float("nan")
    ax_new = torch.where(salvage, ax0, torch.where(bad, nan, ax0 + alpha_p * adx))
    aty_new = torch.where(salvage, aty0, torch.where(bad, nan, aty0 + alpha_d * atdy))
    return new_state, ax_new, aty_new


def iteration(cfg: SolverConfig, prob: TorchQP, state: IPMState, ax=None, aty=None,
              active=None, return_products=False):
    """One MPC iteration: factor, direction, step.  ``ax``/``aty`` supply
    the A x / A' y pair of the current iterate (computed here if absent)."""
    if ax is None or aty is None:
        prob_b = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
        if ax is None:
            ax = prob_b.matvec(state.x)
        if aty is None:
            aty = prob_b.rmatvec(state.y)
    factors, del_w, del_c, reg_p, reg_d = _factor_phase(cfg, prob, state, active)
    if return_products:
        (dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad, adx, atdy) = _direction_phase(
            cfg, prob, state, factors, ax, aty, active, return_products=True
        )
        return _step_phase(
            cfg, prob, state, dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad,
            del_w, del_c, reg_p, reg_d, products=(ax, aty, adx, atdy),
        )
    dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad = _direction_phase(
        cfg, prob, state, factors, ax, aty, active
    )
    return _step_phase(
        cfg, prob, state, dx, dy, dzl, dzu, mu_new, mu_curr, solve_bad,
        del_w, del_c, reg_p, reg_d,
    )


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

#: loop trips between least-squares-certificate refreshes and, with the
#: product recurrence, exact resyncs of the A x / A' y pair
CERT_PERIOD = 16


def _refresh_cert(cfg: SolverConfig, prob: TorchQP, state: IPMState) -> IPMState:
    """Re-evaluate the least-squares infeasibility certificate; iterates
    closer to feasibility than sqrt(tol)*max(1, ||b||) get no certificate."""
    p = dataclasses.replace(prob, lb=state.lb, ub=state.ub)
    min_res = math.sqrt(cfg.tol) * torch.clamp(state.norm_b, min=1.0)
    return state.replace(ls_cert=K.ls_infeasibility_certificate(p, state.x, min_residual=min_res))


def _loop_body(cfg: SolverConfig, prob: TorchQP, state: IPMState, ax=None, aty=None):
    """Termination check + one iteration on the lanes still REGULAR after
    it; the others keep their checked state.  With a carried (ax, aty)
    pair, returns ``(state, ax', aty')``."""
    carried = ax is not None and aty is not None
    if not carried:
        ax = prob.matvec(state.x)
        aty = prob.rmatvec(state.y)
    state = update_termination(cfg, prob, state, ax, aty)
    active = state.status == _REGULAR
    if carried:
        new, ax_n, aty_n = iteration(cfg, prob, state, ax, aty, active=active, return_products=True)
        return (
            new.where(active, state),
            torch.where(active, ax_n, ax),
            torch.where(active, aty_n, aty),
        )
    new = iteration(cfg, prob, state, ax, aty, active=active)
    return new.where(active, state)


def solve_device(cfg: SolverConfig, prob: TorchQP) -> Tuple[TorchQP, ScaleInfo, IPMState]:
    """Solve every lane of ``prob``; returns (scaled problem, scaling, state).

    The loop nest of the JAX ``solve_device``: each outer trip refreshes the
    certificate (and resyncs A x / A' y exactly) on the lanes still
    running, then runs up to CERT_PERIOD iterations.  A lane that stops
    keeps its state; the loops end when no lane is REGULAR.
    """
    prob_s, scale, state = initialize(cfg, prob)
    while True:
        running = state.status == _REGULAR
        if not sync.any_true(running):
            break
        state = _refresh_cert(cfg, prob_s, state).where(running, state)
        ax = aty = None
        if cfg.product_recurrence:
            ax = prob_s.matvec(state.x)
            aty = prob_s.rmatvec(state.y)
        for _ in range(CERT_PERIOD):
            go = state.status == _REGULAR
            if not sync.any_true(go):
                break
            if cfg.product_recurrence:
                new, ax, aty = _loop_body(cfg, prob_s, state, ax, aty)
            else:
                new = _loop_body(cfg, prob_s, state)
            state = new.where(go, state)
    return prob_s, scale, state
