"""Mehrotra predictor-corrector driver.

Port of ``madipm_tpu/solver/driver.py``: configuration, scaling,
initialization, termination, the three phases of one iteration and the
four drivers.  Where the JAX package traces one XLA program and ``vmap``s
it over instances, this driver runs a host loop over a batch of lanes.
Every data-dependent exit is a lane mask; the host reads one flag per exit
test (``utils/sync.py``) and a lane that has left a loop keeps its state
bit for bit, so each lane follows the trajectory that
``vmap(solve_device)`` gives it.  LPs and convex QPs run through every
dense KKT system (NORMAL, CONDENSED, AUGMENTED, SCALED_AUGMENTED), with
Gondzio corrections on request.

- :func:`solve_device`: the fused loop nest (:func:`run_loop`), the
  benchmark path and the one ``checkpoint.resume`` continues;
- :func:`solve_device_chunked`: the same nest in chunks, with a wall-clock
  guard between chunks (a finite ``max_wall_time``);
- :func:`solve_logged`: the per-iteration table, without the A x / A' y
  recurrence;
- :func:`solve_timed`: the eval / linear-solve / step split of each
  iteration, each phase ended by a sync.
The last three solve one instance (a one-lane batch), as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..models.qp import TorchQP
from ..ops import kkt as kkt_ops
from ..ops import ozaki
from ..ops.kkt import KKTConfig
from ..utils import comm, sync
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
    #: fp64 products of A, A' and Q through the Ozaki slices (ops/ozaki.py);
    #: resolved from IPMOptions.fp64_matvec
    use_ozaki: bool = False
    #: "bf16" or "i8"
    ozaki_variant: str = "bf16"
    #: bf16 slices per operand (None: ozaki.N_SLICES)
    ozaki_slices: Optional[int] = None
    #: None: share the forward slices for A' products once the two copies
    #: would pass SHARE_SLICES_BYTES (see ozaki_share)
    ozaki_share_slices: Optional[bool] = None


#: device memory above which the stored transposed Ozaki slices are dropped
#: and A' products contract the forward slices
SHARE_SLICES_BYTES = 1 << 30


def _torch_dtype(d) -> torch.dtype:
    if isinstance(d, torch.dtype):
        return d
    found = {"float32": torch.float32, "float64": torch.float64}.get(str(d))
    if found is None:
        raise ValueError(f"factor_dtype must be 'float32' or 'float64', got {d!r}")
    return found


def make_config(opt: IPMOptions, is_qp: bool, dtype: torch.dtype = torch.float64,
                mesh=None, dist_axis: str = "cols") -> SolverConfig:
    """Resolve the options into a SolverConfig.  ``fp64_matvec``: "auto"
    and "emulated" mean native fp64 products (this backend has fp64),
    "ozaki" the bf16 Ozaki slices and "ozaki_i8" the int8 ones, both only
    when ``dtype`` is fp64.  ``mesh`` (a DeviceMesh) splits the NORMAL or
    CONDENSED factor over its axis ``dist_axis`` (parallel/dist_chol.py)
    instead of factoring the whole matrix in every process."""
    kind = opt.resolved_kkt(is_qp)
    if kind == KKTSystem.NORMAL and is_qp:
        raise ValueError(
            "NormalKKT supports only linear programs; use kkt_system=AUGMENTED for QPs."
        )
    if mesh is not None and kind not in (KKTSystem.NORMAL, KKTSystem.CONDENSED):
        raise ValueError(
            f"the distributed factorization supports the NORMAL (LP) and "
            f"CONDENSED (QP) KKT systems, got {kind} "
            f"(use kkt_system=NORMAL/CONDENSED or mesh=None)"
        )
    if opt.factor_precision is not None and opt.factor_precision not in kkt_ops.MATMUL_PRECISION:
        raise ValueError(
            f"factor_precision must be None or one of {sorted(kkt_ops.MATMUL_PRECISION)}, "
            f"got {opt.factor_precision!r}"
        )
    if opt.fp64_matvec not in ("auto", "emulated", "ozaki", "ozaki_i8"):
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
        use_flex_pcg=opt.pcg_flex,
        factor_precision=opt.factor_precision,
        precond_refine=opt.precond_refine,
        dist_mesh=mesh,
        dist_axis=dist_axis,
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
        use_ozaki=opt.fp64_matvec in ("ozaki", "ozaki_i8") and dtype == torch.float64,
        ozaki_variant="i8" if opt.fp64_matvec == "ozaki_i8" else "bf16",
        ozaki_slices=opt.ozaki_slices,
        ozaki_share_slices=opt.ozaki_share_slices,
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


def ozaki_share(cfg: SolverConfig, m: int, n: int) -> bool:
    """Whether A' products contract the forward Ozaki slices of an (m, n)
    block instead of a stored transposed copy: as configured, or (None)
    once the two copies of one instance would pass SHARE_SLICES_BYTES,
    counted with the variant's real slice count and element size."""
    if cfg.ozaki_share_slices is not None:
        return cfg.ozaki_share_slices
    if cfg.ozaki_variant == "i8":
        slices, size = ozaki.N8_SLICES, 1
    else:
        slices, size = cfg.ozaki_slices or ozaki.N_SLICES, 2
    return 2 * slices * size * m * n > SHARE_SLICES_BYTES


def _check_ozaki_slices(cfg: SolverConfig, n: int, device_type: str):
    """Refuse a bf16 slice count the kernel cannot take on CUDA, and warn
    when the bf16 operator's error bound at the padded ``n`` is above a
    tenth of the tolerance, naming a slice count that meets it and that
    the device takes (the plain CPU version takes any up to 63)."""
    if cfg.ozaki_variant != "bf16":
        return
    slices = cfg.ozaki_slices or ozaki.N_SLICES
    most = ozaki.KERNEL_MAX_SLICES if device_type == "cuda" else 63
    if slices > most:
        raise ValueError(f"ozaki_slices={slices}: the CUDA kernel takes at most {most} slices; "
                         f"use fp64_matvec='auto' for native fp64 products")
    if ozaki.operator_bound(n, slices) <= 0.1 * cfg.tol:
        return
    enough = next((s for s in range(slices + 1, most + 1) if ozaki.operator_bound(n, s) <= 0.1 * cfg.tol),
                  None)
    advice = f"use ozaki_slices={enough}" if enough is not None else "use native fp64 products"
    warnings.warn(
        f"the bf16 Ozaki operator with {slices} slices has error bound 2n 2^-8(S-1) = "
        f"{ozaki.operator_bound(n, slices):.3g} at n={n}, above 0.1 * tol = {0.1 * cfg.tol:.3g}; "
        f"{advice}", stacklevel=3)


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
    # The Ozaki slices snapshot the scaled matrices: from here on every
    # fp64 product of A, A' and Q runs through them.  The sparse (ELL)
    # problem has no with_ozaki and keeps its native fp64 products.
    if cfg.use_ozaki and hasattr(prob_s, "with_ozaki"):
        _check_ozaki_slices(cfg, prob_s.n, prob_s.A.device.type)
        share = ozaki_share(cfg, *prob_s.A.shape[-2:])
        prob_s = prob_s.with_ozaki(cfg.ozaki_variant, share_slices=share, n_slices=cfg.ozaki_slices)

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
                     active=None, rhs_aff=None, return_products=False):
    """Predictor + Mehrotra corrector (+ Gondzio) solves; returns the
    accepted direction and the new barrier parameter (and its (A dx, A' dy)
    with ``return_products``).
    A finished lane (``active`` False) solves with a zero rhs, so its PCG
    exits on the first test.  ``rhs_aff``, the predictor rhs, may come from
    the caller (the timed driver builds it in its eval phase)."""
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
    if rhs_aff is None:
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


def _cert_trip(cfg: SolverConfig, prob: TorchQP, state: IPMState, trips: int) -> IPMState:
    """One trip of the outer loop: refresh the certificate (and resync
    A x / A' y exactly) on the lanes still running, then run up to
    ``trips`` iterations."""
    running = state.status == _REGULAR
    state = _refresh_cert(cfg, prob, state).where(running, state)
    ax = aty = None
    if cfg.product_recurrence:
        ax = prob.matvec(state.x)
        aty = prob.rmatvec(state.y)
    for _ in range(trips):
        go = state.status == _REGULAR
        if not sync.any_true(go):
            break
        if cfg.product_recurrence:
            new, ax, aty = _loop_body(cfg, prob, state, ax, aty)
        else:
            new = _loop_body(cfg, prob, state)
        state = new.where(go, state)
    return state


def run_loop(cfg: SolverConfig, prob: TorchQP, state: IPMState) -> IPMState:
    """The loop nest of the JAX ``solve_device`` from a given state of the
    scaled problem ``prob``: each outer trip refreshes the certificate (and
    resyncs A x / A' y exactly) on the lanes still running, then runs up to
    CERT_PERIOD iterations.  A lane that stops keeps its state; the loops
    end when no lane is REGULAR."""
    while sync.any_true(state.status == _REGULAR):
        state = _cert_trip(cfg, prob, state, CERT_PERIOD)
    return state


def solve_device(cfg: SolverConfig, prob: TorchQP) -> Tuple[TorchQP, ScaleInfo, IPMState]:
    """Solve every lane of ``prob``; returns (scaled problem, scaling, state)."""
    prob_s, scale, state = initialize(cfg, prob)
    return prob_s, scale, run_loop(cfg, prob_s, state)


#: a ``max_wall_time`` at or above this is no budget
NO_WALL_BUDGET = 1e6


def _out_of_time(prob, t0: float, max_wall_time: float) -> bool:
    """Whether the wall-clock budget is spent.  On a column-sharded problem
    the ranks' clocks differ, so they agree through the group: the first
    rank out of time stops them all (a rank-local answer would part them).
    Without a budget no rank can run out, and the group is not asked."""
    late = time.time() - t0 >= max_wall_time
    group = getattr(prob, "group", None)
    if group is None:
        return late
    if max_wall_time >= NO_WALL_BUDGET:
        return False
    flag = torch.tensor([int(late)], dtype=torch.int32, device=prob.device)
    return sync.any_true(comm.all_max(flag, group) > 0)


def solve_device_chunked(cfg: SolverConfig, prob: TorchQP, max_wall_time: float,
                         chunk: int = 25) -> Tuple[TorchQP, ScaleInfo, IPMState]:
    """The fused solve with a wall-clock guard: chunks of up to ``chunk``
    iterations (the certificate refreshed, and with the recurrence the
    exact A x / A' y pair taken, once per chunk), the clock read between
    chunks.  When the budget is spent, one last termination check (the
    last iterate may already meet a tolerance), then
    MAXIMUM_WALLTIME_EXCEEDED on the lanes still REGULAR."""
    t0 = time.time()
    prob_s, scale, state = initialize(cfg, prob)
    while sync.any_true(state.status == _REGULAR):
        if _out_of_time(prob_s, t0, max_wall_time):
            state = update_termination(cfg, prob_s, state)
            status = torch.where(state.status == _REGULAR, int(Status.MAXIMUM_WALLTIME_EXCEEDED),
                                 state.status)
            return prob_s, scale, state.replace(status=status.to(torch.int32))
        state = _cert_trip(cfg, prob_s, state, chunk)
    return prob_s, scale, state


#: the header of the per-iteration table, printed every 10 iterations
LOG_HEADER = "iter    objective    inf_pr   inf_du lg(mu)  ||d||  lg(rg) alpha_du alpha_pr"


def _log_row(state: IPMState, scale: ScaleInfo) -> Tuple[int, int, str]:
    """(k, status, table row) of lane 0, read from the device in one copy."""
    vals = sync.to_host(torch.cat([
        t[:1, :1].to(torch.float64) for t in (
            state.k, state.status, state.obj_val, scale.obj_scale, state.inf_pr, state.inf_du,
            state.mu, torch.amax(torch.abs(state.dx), dim=-1, keepdim=True), state.del_w,
            state.alpha_d, state.alpha_p,
        )
    ], dim=-1))[0]
    k, status, obj, osc, inf_pr, inf_du, mu, dmax, dw, alpha_d, alpha_p = vals.tolist()
    k, status = int(k), int(status)
    dnorm = dmax if k > 0 else 0.0
    lg_rg = "   - " if dw == 0 else f"{math.log10(dw):5.1f}"
    row = (
        f"{k:4d}  {obj / osc: 10.7e} {inf_pr:6.2e} "
        f"{inf_du:6.2e} {math.log10(max(mu, 1e-300)):5.1f} "
        f"{dnorm:6.2e} {lg_rg} {alpha_d:6.2e} {alpha_p:6.2e}"
    )
    return k, status, row


def solve_logged(cfg: SolverConfig, prob: TorchQP, print_fn: Callable[[str], None] = print,
                 max_wall_time: float = NO_WALL_BUDGET) -> Tuple[TorchQP, ScaleInfo, IPMState]:
    """The JAX ``solve_logged``: a host loop of ``update_termination`` then
    ``iteration``, the products taken anew each trip (no recurrence), the
    certificate refreshed every CERT_PERIOD trips, one table row per
    iteration (lane 0) with the header every 10 rows, and the wall-clock
    guard before each iteration."""
    t0 = time.time()
    prob_s, scale, state = initialize(cfg, prob)
    trip = 0
    while True:
        if trip % CERT_PERIOD == 0:
            state = _refresh_cert(cfg, prob_s, state)
        trip += 1
        state = update_termination(cfg, prob_s, state)
        k, status, row = _log_row(state, scale)
        if k % 10 == 0:
            print_fn(LOG_HEADER)
        print_fn(row)
        if status != _REGULAR:
            break
        if _out_of_time(prob_s, t0, max_wall_time):
            state = state.replace(status=torch.full_like(state.status, int(Status.MAXIMUM_WALLTIME_EXCEEDED)))
            break
        state = iteration(cfg, prob_s, state)
    return prob_s, scale, state


def _phase_end(t: torch.Tensor) -> int:
    """End a timed phase: wait for the device (on CUDA) and read lane 0 of
    ``t``, a status (B, 1)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return int(sync.to_host(t[:1, 0])[0])


def solve_timed(cfg: SolverConfig, prob: TorchQP,
                max_wall_time: float = NO_WALL_BUDGET) -> Tuple[TorchQP, ScaleInfo, IPMState, dict]:
    """The JAX ``solve_timed``: the loop of :func:`solve_logged` split in
    three phases with wall timers, each phase ended by a sync.  Returns
    ``(prob_s, scale, state, timers)``; ``timers`` holds
    ``linear_solver_time`` (the factor and the direction solves),
    ``eval_time`` (the A x / A' y pair, the predictor rhs and the
    termination check) and ``step_time`` (step rule and update), in
    seconds.  The initialization's factor and solves are not counted."""
    t0 = time.time()
    prob_s, scale, state = initialize(cfg, prob)
    _phase_end(state.status)
    timers = {"linear_solver_time": 0.0, "eval_time": 0.0, "step_time": 0.0}
    trip = 0
    while True:
        t1 = time.time()
        if trip % CERT_PERIOD == 0:
            state = _refresh_cert(cfg, prob_s, state)
        trip += 1
        p = dataclasses.replace(prob_s, lb=state.lb, ub=state.ub)
        ax, aty = p.matvec(state.x), p.rmatvec(state.y)
        rhs_aff = K.predictor_rhs(p, state.x, state.y, state.zl, state.zu, ax, aty)
        state = update_termination(cfg, prob_s, state, ax, aty)
        status = _phase_end(state.status)
        timers["eval_time"] += time.time() - t1
        if status != _REGULAR:
            break
        if _out_of_time(prob_s, t0, max_wall_time):
            state = state.replace(status=torch.full_like(state.status, int(Status.MAXIMUM_WALLTIME_EXCEEDED)))
            break
        t1 = time.time()
        factors, del_w, del_c, reg_p, reg_d = _factor_phase(cfg, prob_s, state)
        out = _direction_phase(cfg, prob_s, state, factors, ax, aty, rhs_aff=rhs_aff)
        _phase_end(state.status)
        timers["linear_solver_time"] += time.time() - t1
        t1 = time.time()
        state = _step_phase(cfg, prob_s, state, *out, del_w, del_c, reg_p, reg_d)
        _phase_end(state.status)
        timers["step_time"] += time.time() - t1
    return prob_s, scale, state, timers
