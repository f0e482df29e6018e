"""KKT systems: the dense part of ``madipm_tpu/ops/kkt.py``.

- NORMAL (LP only): condense the augmented system onto the dual block and
  factorize the SPD normal matrix ``S = A Sigma^-1 A' - del_c I`` of size m.
- CONDENSED (K1, LP and QP): eliminate dy instead and factorize the SPD
  ``C = Sigma + Q + gamma A'A`` of size n, gamma = 1/|del_c|.
- AUGMENTED / SCALED_AUGMENTED (K2 / K2.5, LP and QP): factorize the
  quasi-definite ``[Sigma+Q, A'; A, del_c I]`` of size n+m with unpivoted
  LDL' (LDL, LDL_INV) or LU, after a symmetric diagonal scaling for K2.5.

One system per lane, on a dense ``TorchQP`` or a sparse ``SparseTorchQP``
(models/sparse.py): NORMAL and CONDENSED reach the Jacobian only through
the problem's operators; AUGMENTED needs ``dense_A``, which the sparse
class refuses with NotImplementedError.  The SPD matrices are Jacobi-scaled before the factor;
with a factor dtype below the solve dtype the factor is only the
preconditioner of an fp64 PCG on the exact operator and is shifted by
PRECOND_SHIFT (K1 keeps the PCG even with an fp64 factor).  CHOLESKY_INV
factors through ``ops/chol_inv.chol_inv`` (the CUDA kernel on the GPU);
CHOLESKY through ``torch.linalg`` or, with ``use_pallas``, through
``ops/chol_inv.cholesky`` (the factor-only CUDA kernel).

Three options apply when the factor runs below the solve precision:
``use_flex_pcg`` (an fp64 flexible PCG whose preconditioner is a short
low-precision CG on the retained matrix ``Smat``), ``precond_refine`` (one
correction against ``Smat`` per preconditioner application, NORMAL only)
and ``factor_precision`` (the float32 matmul precision of the factor
attempt and the preconditioner applications on CUDA).

With ``KKTConfig.dist_mesh`` the NORMAL and CONDENSED factors are split
over a mesh axis (``parallel/dist_chol.py``): the matrix is assembled into
row strips and factored by the panel Cholesky, and the preconditioner is
its distributed substitution.  The factor tuples are then
DistNormalFactors and DistCondensedFactors; the solves are those of the
replicated factors, with neither ``use_flex_pcg`` nor ``precond_refine``
(there is no whole matrix to keep), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.qp import TorchQP, _nbytes
from ..utils import sync
from ..utils.logging import span, spanned
from ..utils.options import KKTSystem, LinearSolver
from . import block_chol, chol_inv, linalg

#: work of the assembly product (``madipm.kkt.assemble``) of the dense
#: problems, counted from its shapes: the operations of the symmetric half
#: (NORMAL: B m(m+1) n for A D A'; CONDENSED: B n(n+1) m for A' W A; the
#: augmented build none), and the bytes of A read once in its stored dtype
#: plus the assembled matrix written once in the factor's
assembly_flops = 0
assembly_bytes = 0


def _count_assembly(A: torch.Tensor, flops: int, out: torch.Tensor) -> None:
    global assembly_flops, assembly_bytes
    assembly_flops += flops
    assembly_bytes += _nbytes(A) + _nbytes(out)


@dataclasses.dataclass(frozen=True)
class KKTConfig:
    """Static configuration of the per-iteration linear solve."""

    kind: KKTSystem
    linear_solver: LinearSolver
    factor_dtype: torch.dtype
    refinement_steps: int = 2
    max_factor_trials: int = 3
    #: factor CHOLESKY systems through the hand-written factor-only kernel
    #: (``ops/chol_inv.cholesky``) instead of ``torch.linalg``
    use_pallas: bool = False
    #: precondition the fp64 PCG with an inner factor-precision CG on
    #: ``Smat`` (flexible PCG, Polak-Ribiere), NORMAL and CONDENSED
    use_flex_pcg: bool = False
    #: the JAX package's matmul-precision name for the factor attempt and
    #: the preconditioner applications ("default", "high", "highest"; see
    #: MATMUL_PRECISION); None leaves the global setting
    factor_precision: Optional[str] = None
    #: one correction per preconditioner application against the unshifted
    #: Jacobi-scaled S, z + M^-1 (b - Smat z) (NORMAL only)
    precond_refine: bool = False
    #: a DeviceMesh that splits the NORMAL / CONDENSED factor over its axis
    #: ``dist_axis`` (parallel/dist_chol.py); None: one process factors
    dist_mesh: Optional[object] = None
    dist_axis: str = "cols"


class NormalFactors(NamedTuple):
    L: torch.Tensor  # Cholesky factor (CHOLESKY) or its inverse (CHOLESKY_INV), factor dtype
    jac: torch.Tensor  # Jacobi scale d_i = 1/sqrt(S_ii) (factor dtype)
    dinv: torch.Tensor  # Sigma^-1 with fixed/padded columns zeroed (solve dtype)
    del_c: torch.Tensor  # (B, 1) dual regularization used in this factorization
    live: torch.Tensor  # rows coupled to variables (excludes padded and empty rows)
    #: the Jacobi-scaled S before PRECOND_SHIFT (factor dtype), kept only for
    #: use_flex_pcg / precond_refine with a factor below the solve dtype
    Smat: Optional[torch.Tensor] = None


class CondensedFactors(NamedTuple):
    """K1 condensed factors."""

    L: torch.Tensor  # Cholesky factor of the Jacobi-scaled C, or its inverse (factor dtype)
    jac: torch.Tensor  # Jacobi scale 1/sqrt(C_ii) (factor dtype)
    sigma: torch.Tensor  # barrier diagonal (solve dtype, for the PCG operator)
    gamma: torch.Tensor  # (B, 1) 1/|del_c_eff| (solve dtype)
    del_c: torch.Tensor  # (B, 1) effective (negative) dual regularization
    live: torch.Tensor  # structurally nonempty constraint rows
    #: the Jacobi-scaled C the factor was taken of, shift included (factor
    #: dtype), kept only for use_flex_pcg with a factor below the solve dtype
    Smat: Optional[torch.Tensor] = None


class DistNormalFactors(NamedTuple):
    """NORMAL factors with the Cholesky split in row strips over the mesh
    axis (``parallel/dist_chol.dist_factor_normal``)."""

    L: torch.Tensor  # this rank's row strip (B, m/P, m) of the factor of the scaled S
    W: torch.Tensor  # the inverse of its diagonal block (B, m/P, m/P)
    jac: torch.Tensor  # Jacobi scale (B, m), replicated (factor dtype)
    dinv: torch.Tensor  # Sigma^-1, fixed and padded columns zeroed (solve dtype)
    del_c: torch.Tensor  # (B, 1)
    live: torch.Tensor


class DistCondensedFactors(NamedTuple):
    """K1 factors with the size-n Cholesky split in row strips over the
    mesh axis (``parallel/dist_chol.dist_factor_condensed``)."""

    L: torch.Tensor  # this rank's row strip (B, n/P, n)
    W: torch.Tensor  # the inverse of its diagonal block (B, n/P, n/P)
    jac: torch.Tensor  # Jacobi scale (B, n), replicated (factor dtype)
    sigma: torch.Tensor
    gamma: torch.Tensor
    del_c: torch.Tensor
    live: torch.Tensor


_NORMAL = (NormalFactors, DistNormalFactors)
_CONDENSED = (CondensedFactors, DistCondensedFactors)


class AugmentedFactors(NamedTuple):
    Lfac: torch.Tensor  # LDL: unit-lower L; LDL_INV: L^-1; LU: packed LU (factor dtype)
    dfac: torch.Tensor  # LDL, LDL_INV: the diagonal d; LU: pivots (int32, 1-based)
    sigma: torch.Tensor  # barrier diagonal (solve dtype, for the refinement operator)
    del_c: torch.Tensor  # (B, 1)
    live: torch.Tensor  # structurally nonempty constraint rows
    jac: torch.Tensor  # K2.5 symmetric scaling |diag(K)|^-1/2 (ones for plain K2)


def factors_from_numpy(cls, fields: dict, device=None, dtype=torch.float64):
    """Build NormalFactors, CondensedFactors or AugmentedFactors from numpy
    arrays named as the JAX package's factor tuples, one lane (unbatched
    arrays) each.  Floating fields keep their own precision when it is
    float32 (the factor dtype); per-lane scalars become (1, 1).  LU pivots
    (an integer ``dfac``) are shifted from 0-based to torch's 1-based.  An
    absent ``Smat``, or the JAX package's 0-d placeholder, is None."""
    kw = {}
    for name in cls._fields:
        if name == "Smat" and np.ndim(fields.get(name, 0)) == 0:
            kw[name] = None
            continue
        v = np.array(fields[name])  # a writable copy
        if name == "live":
            dt = torch.bool
        elif np.issubdtype(v.dtype, np.integer):
            v, dt = v + 1, torch.int32
        else:
            dt = torch.float32 if v.dtype == np.float32 else dtype
        t = torch.as_tensor(v, dtype=dt, device=device)
        kw[name] = t.reshape(1, 1) if t.ndim == 0 else t.unsqueeze(0)
    return cls(**kw)


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
    with span("madipm.kkt.assemble"):
        S = prob.assemble_normal_matrix(dinv, factor_dtype)
    if isinstance(prob, TorchQP):
        B, m, n = prob.A.shape
        _count_assembly(prob.A, B * m * (m + 1) * n, S)
    dS = torch.diagonal(S, dim1=-2, dim2=-1).clone()
    live = prob.row_mask & (dS > 0)
    diag_add = torch.where(live, -del_c.to(factor_dtype), 1.0 - dS)
    torch.diagonal(S, dim1=-2, dim2=-1).add_(diag_add)
    return S, dinv, live


#: Floor on |del_c| for the CONDENSED formulation: the equality relaxation
#: gamma = 1/|del_c| must stay finite and the SPD factor conditioned.
CONDENSED_RELAX_MIN = 1e-8


def _assemble_condensed(prob: TorchQP, sigma, del_c, factor_dtype):
    """C = diag(sigma) + Q + gamma A'A per lane.  Structurally empty rows
    carry dy = 0 and are masked out of the A'A product; non-free columns
    keep sigma = 1 and nothing else (A'A and Q are free-masked)."""
    gamma = 1.0 / torch.clamp(torch.abs(del_c), min=CONDENSED_RELAX_MIN)
    live = prob.live_rows()
    # gamma ~ 1e8 is folded in after the product, so that the squared
    # entries stay inside the range of a float32 factor dtype.
    with span("madipm.kkt.assemble"):
        C = prob.assemble_ata(live.to(prob.dtype), factor_dtype)
        C = C * gamma.to(factor_dtype).unsqueeze(-1)
        torch.diagonal(C, dim1=-2, dim2=-1).add_(sigma.to(factor_dtype))
        C = prob.add_quad(C, factor_dtype)
    if isinstance(prob, TorchQP):
        A = prob.A if prob.group is None else prob.A_rows
        B, m, n = A.shape
        _count_assembly(A, B * n * (n + 1) * m, C)
    return C, gamma, live


@spanned("madipm.kkt.assemble")
def _assemble_augmented(prob: TorchQP, sigma, del_c, factor_dtype):
    """K = [Sigma+Q, A'; A, del_c I] per lane, masked columns and rows
    pinned: structurally empty rows get a unit pivot like padded rows (with
    a tiny del_c theirs would be ~0)."""
    free = prob.free_mask
    A_eff = (prob.dense_A * free.unsqueeze(-2)).to(factor_dtype)
    H = prob.add_quad(torch.diag_embed(sigma.to(factor_dtype)), factor_dtype)
    live = prob.row_mask & (torch.sum(A_eff * A_eff, dim=-1) > 0)
    du = torch.where(live, del_c.to(factor_dtype), 1.0)
    K = torch.cat(
        [torch.cat([H, A_eff.mT], dim=-1), torch.cat([A_eff, torch.diag_embed(du)], dim=-1)],
        dim=-2,
    )
    _count_assembly(prob.A, 0, K)
    return K, live


#: Diagonal shift of the Jacobi-scaled matrix before a low-precision
#: factorization (only when the fp64 PCG runs on the exact operator): the
#: factor is just a preconditioner there, and the shift keeps its pivots
#: healthy in fp32 when rows are nearly dependent.
PRECOND_SHIFT = 1e-6

#: torch.set_float32_matmul_precision for each of the JAX package's
#: factor_precision names: one bf16 pass on the TPU ("default") becomes
#: bf16 ("medium"), three passes ("high") TF32, six ("highest") full fp32.
MATMUL_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


@contextlib.contextmanager
def matmul_precision(name: Optional[str], device: torch.device):
    """Scope ``torch.set_float32_matmul_precision(MATMUL_PRECISION[name])``
    to the block on a CUDA ``device`` and restore the global setting after
    it, also when the block raises.  On the CPU it changes nothing: there
    "medium" would route float32 products through oneDNN's bf16, which the
    JAX package's CPU backend never does; float32 products stay float32, as
    the reference's CPU runs keep them.  ``name`` None changes nothing."""
    if name is None or device.type != "cuda":
        yield
        return
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(MATMUL_PRECISION[name])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _factor_precision(cfg: KKTConfig, rdtype: torch.dtype) -> Optional[str]:
    """cfg.factor_precision where the factor runs below ``rdtype``."""
    return cfg.factor_precision if cfg.factor_dtype != rdtype else None


def _with_precision(f, name: Optional[str], device: torch.device):
    """``f`` run under :func:`matmul_precision`."""
    if name is None:
        return f

    def g(b):
        with matmul_precision(name, device):
            return f(b)

    return g


def _lanes(mask, like):
    """Reshape a (B, 1) lane mask to broadcast against ``like``."""
    return mask.reshape(mask.shape[:1] + (1,) * (like.ndim - 1))


def _factor_spd(cfg: KKTConfig, Mhat: torch.Tensor):
    """Factor the Jacobi-scaled SPD matrix of the NORMAL or CONDENSED
    system: (factor to store, ok (B,))."""
    if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
        with span("madipm.kkt.factor"):
            Lc, W = chol_inv.chol_inv(Mhat)
        ok = linalg.cholesky_is_ok(Lc) & torch.all(torch.isfinite(W), dim=(-2, -1))
        return W, ok  # the inverse factor: solves are products
    with span("madipm.kkt.factor"):
        if cfg.use_pallas:
            fac = chol_inv.cholesky(Mhat)
        else:
            fac = linalg.cholesky_factor(Mhat)
    return fac, linalg.cholesky_is_ok(fac)


def _jacobi_scaled(cfg: KKTConfig, M: torch.Tensor, rdtype, keep_unshifted=False):
    """(jac, Mhat, Mraw): Mraw = D^-1/2 M D^-1/2 with D = diag(M), and
    Mhat the same shifted by PRECOND_SHIFT when the factor is only a
    preconditioner.  Mraw is None unless ``keep_unshifted``; unshifted,
    the two are one tensor."""
    fdt = cfg.factor_dtype
    dM = torch.diagonal(M, dim1=-2, dim2=-1)
    jac = torch.rsqrt(torch.clamp(dM, min=torch.finfo(fdt).tiny))
    Mhat = M * jac.unsqueeze(-1) * jac.unsqueeze(-2)
    Mraw = Mhat if keep_unshifted else None
    if cfg.refinement_steps > 0 and fdt != rdtype:
        if keep_unshifted:
            Mhat = Mhat.clone()
        torch.diagonal(Mhat, dim1=-2, dim2=-1).add_(PRECOND_SHIFT)
    return jac, Mhat, Mraw


def _attempt_dist(cfg: KKTConfig, prob: TorchQP, sigma, dc, rdtype):
    """One factor attempt of the distributed NORMAL or CONDENSED system on
    the column-sharded ``prob``; (factors, ok (B, 1)), ok replicated."""
    from ..parallel import dist_chol

    fdt = cfg.factor_dtype
    shift = PRECOND_SHIFT if cfg.refinement_steps > 0 and fdt != rdtype else 0.0
    free = prob.free_mask
    if cfg.kind == KKTSystem.NORMAL:
        # dinv = 0 on fixed and padded columns masks them out of A D A'.
        dinv = torch.where(free, 1.0 / sigma, 0.0)
        L, W, jac, live, ok = dist_chol.dist_factor_normal(
            cfg.dist_mesh, prob.A, prob.cols(dinv), prob.row_mask, dc, shift, fdt,
            axis=cfg.dist_axis)
        factors = DistNormalFactors(L=L, W=W, jac=jac, dinv=dinv, del_c=dc.to(rdtype), live=live)
    else:
        gamma = 1.0 / torch.clamp(torch.abs(dc), min=CONDENSED_RELAX_MIN)
        live = prob.live_rows()
        L, W, jac, ok = dist_chol.dist_factor_condensed(
            cfg.dist_mesh, prob.A_rows * free.unsqueeze(-2), prob.quad_strip(fdt), sigma,
            prob.rows(live), gamma, shift, fdt, axis=cfg.dist_axis)
        dc_eff = -torch.clamp(torch.abs(dc.to(rdtype)), min=CONDENSED_RELAX_MIN)
        factors = DistCondensedFactors(L=L, W=W, jac=jac, sigma=sigma, gamma=gamma.to(rdtype),
                                       del_c=dc_eff, live=live)
    return factors, ok.unsqueeze(-1)


def factorize(cfg: KKTConfig, prob: TorchQP, x, zl, zu, del_w, del_c, force_ok=None):
    """Factorize each lane's system, bumping its regularization x100 on
    failure, up to ``max_factor_trials`` attempts.  Returns (factors,
    del_w, del_c, ok) with (B, 1) ``ok``.

    ``force_ok`` (B, 1) accepts a lane's first attempt unconditionally
    (finished-lane neutralization).  A lane leaves the retry loop on its
    own; the ones that stay keep theirs updated (the ``vmap`` semantics).
    """
    rdtype = prob.dtype
    fdt = cfg.factor_dtype
    spd = cfg.kind in (KKTSystem.NORMAL, KKTSystem.CONDENSED)
    low = fdt != rdtype
    precision = _factor_precision(cfg, rdtype)

    def attempt(dw, dc):
        with matmul_precision(precision, x.device):
            return _attempt(dw, dc)

    def _attempt(dw, dc):
        sigma = build_sigma(prob, x, zl, zu, dw)
        if spd and cfg.dist_mesh is not None:
            return _attempt_dist(cfg, prob, sigma, dc, rdtype)
        if cfg.kind == KKTSystem.NORMAL:
            S, dinv, live = _assemble_normal(prob, sigma, dc, fdt)
            # Smat is the pre-shift Shat, as in the JAX package (its
            # ``Shat_raw``): precond_refine corrects toward the true scaled
            # S, and the flexible PCG's inner CG solves with the operator
            # whose inverse the outer fp64 Krylov wants.  With the shifted
            # matrix the inner CG would reproduce the factor's own solve.
            need = (cfg.use_flex_pcg or cfg.precond_refine) and low
            jac, Shat, Sraw = _jacobi_scaled(cfg, S, rdtype, keep_unshifted=need)
            fac, ok = _factor_spd(cfg, Shat)
            factors = NormalFactors(L=fac, jac=jac, dinv=dinv, del_c=dc.to(rdtype), live=live,
                                    Smat=Sraw)
        elif cfg.kind == KKTSystem.CONDENSED:
            C, gamma, live = _assemble_condensed(prob, sigma, dc, fdt)
            jac, Chat, _ = _jacobi_scaled(cfg, C, rdtype)
            fac, ok = _factor_spd(cfg, Chat)
            dc_eff = -torch.clamp(torch.abs(dc.to(rdtype)), min=CONDENSED_RELAX_MIN)
            # K1 keeps the shifted Chat, as the JAX package does.
            need = cfg.use_flex_pcg and low
            factors = CondensedFactors(L=fac, jac=jac, sigma=sigma, gamma=gamma.to(rdtype),
                                       del_c=dc_eff, live=live, Smat=Chat if need else None)
        else:
            K, live = _assemble_augmented(prob, sigma, dc, fdt)
            if cfg.kind == KKTSystem.SCALED_AUGMENTED:
                # K2.5: the factor holds Khat = J K J; solves unscale through J.
                dK = torch.abs(torch.diagonal(K, dim1=-2, dim2=-1))
                jac = torch.rsqrt(torch.clamp(dK, min=torch.finfo(fdt).tiny))
                K = K * jac.unsqueeze(-1) * jac.unsqueeze(-2)
            else:
                jac = torch.ones(K.shape[:-1], dtype=fdt, device=K.device)
            if cfg.linear_solver == LinearSolver.LU:
                with span("madipm.kkt.factor"):
                    Lfac, dfac = linalg.lu_factor(K)
                ok = linalg.lu_is_ok(Lfac)
            elif cfg.linear_solver == LinearSolver.LDL_INV:
                with span("madipm.kkt.factor"):
                    _, dfac, Lfac = block_chol.ldl_inv(K)
                ok = (
                    torch.all(torch.isfinite(dfac) & (dfac != 0), dim=-1)
                    & torch.all(torch.isfinite(Lfac), dim=(-2, -1))
                )
            else:
                with span("madipm.kkt.factor"):
                    Lfac, dfac = linalg.ldl_factor(K)
                ok = linalg.ldl_is_ok(Lfac, dfac)
            factors = AugmentedFactors(Lfac=Lfac, dfac=dfac, sigma=sigma,
                                       del_c=dc.to(rdtype), live=live, jac=jac)
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
        if spd:
            # The SPD systems factor S - del_c I: a non-negative del_c can
            # never rescue a singular S, so retries force the stabilizing
            # (negative) sign.
            dc_n = -torch.clamp(torch.abs(dc), min=1e-12) * 100.0
        else:
            dc_n = dc * 100.0
        f_n, ok_n = attempt(dw_n, dc_n)
        trial = torch.where(go, trial + 1, trial)
        dw = torch.where(go, dw_n, dw)
        dc = torch.where(go, dc_n, dc)
        ok = torch.where(go, ok_n, ok)
        factors = type(factors)(*(
            None if new is None else torch.where(_lanes(go, new), new, old)
            for new, old in zip(f_n, factors)
        ))
    return factors, dw, dc, ok


def solve_condensed(
    cfg: KKTConfig,
    prob: TorchQP,
    factors,
    rx,
    rp,
    pcg_budget: Optional[int] = None,
    pcg_rtol=None,
    return_products: bool = False,
):
    """Solve [Sigma+Q, A'; A, del_c][dx; dy] = [rx; rp] per lane.

    NORMAL: r2 = A Sigma^-1 rx - rp, S dy = r2, dx = Sigma^-1 (rx - A' dy).
    CONDENSED: (Sigma + Q + gamma A'A) dx = rx + gamma A' rp, then
    dy = -gamma (rp - A dx).  AUGMENTED: the whole system at once, with
    iterative refinement on the exact operator.

    On the SPD paths with ``refinement_steps > 0`` the solve is an fp64 PCG
    on the exact operator (``pcg_budget`` iterations, default 4 x
    refinement_steps; ``pcg_budget == 0`` applies the factor only).
    ``pcg_rtol`` (float or (B, 1)) overrides the exit tolerance.
    ``return_products=True`` also returns (A dx, A' dy); on the NORMAL PCG
    path A dx comes from the tracked residual, ``rp + r_pcg - del_c dy``,
    and drifts by O(eps64) per call; the other paths form the products.
    """
    if isinstance(factors, _NORMAL):
        return _solve_normal(cfg, prob, factors, rx, rp, pcg_budget, pcg_rtol, return_products)
    if isinstance(factors, _CONDENSED):
        return _solve_k1(cfg, prob, factors, rx, rp, pcg_budget, pcg_rtol, return_products)
    return _solve_k2(cfg, prob, factors, rx, rp, return_products)


def _factor_solve(cfg: KKTConfig, L: torch.Tensor):
    """b -> Mhat^-1 b with the stored factor (L, or L^-1 for CHOLESKY_INV)."""
    if cfg.linear_solver == LinearSolver.CHOLESKY_INV:
        return lambda b: block_chol.chol_inv_solve(L, b)
    return lambda b: linalg.cholesky_solve(L, b)


def _spd_solve_fn(cfg: KKTConfig, factors, rdtype):
    """b -> M^-1 b through the Jacobi scaling of a NORMAL or CONDENSED
    factor: M = D^1/2 Mhat D^1/2  =>  M^-1 b = D^-1/2 Mhat^-1 D^-1/2 b.
    With precond_refine (NORMAL) one correction against the unshifted
    Smat follows each application: z + Mhat^-1 (b - Smat z).  Runs under
    the factor precision."""
    L, jac = factors.L, factors.jac
    if isinstance(factors, (DistNormalFactors, DistCondensedFactors)):
        from ..parallel import dist_chol

        W = factors.W
        base = lambda b: dist_chol.dist_chol_solve(cfg.dist_mesh, L, W, b, cfg.dist_axis)
    else:
        base = _factor_solve(cfg, L)
    refine = isinstance(factors, NormalFactors) and cfg.precond_refine and factors.Smat is not None

    @spanned("madipm.kkt.precond")
    def solve_fn(b):
        bf = (b * jac).to(L.dtype)
        z = base(bf)
        if refine:
            z = z + base(bf - (factors.Smat @ z.unsqueeze(-1)).squeeze(-1))
        return z * jac

    return _with_precision(solve_fn, _factor_precision(cfg, rdtype), L.device)


#: iteration budget of the inner low-precision CG of the flexible PCG
MIXED_INNER_ITERS = 8


def _mixed_inner_solver(cfg: KKTConfig, factors):
    """r -> d with S d ~ r, computed in the factor precision alone: the
    preconditioner of the flexible PCG (``madipm_tpu.ops.kkt``'s).

    Each lane's residual is scaled to unit magnitude, moved into the
    Jacobi-scaled space where ``Smat`` and its factor live, solved by
    :func:`linalg.pcg_lowp` with ``Smat`` as the operator and the factor as
    the preconditioner, and mapped back.
    """
    L, jac, Smat = factors.L, factors.jac, factors.Smat
    fdt = L.dtype
    solve_lp = _factor_solve(cfg, L)

    def matvec_lp(v):
        return (Smat @ v.unsqueeze(-1)).squeeze(-1)

    def inner(r):
        s = torch.clamp(torch.amax(torch.abs(r), dim=-1, keepdim=True), min=torch.finfo(r.dtype).tiny)
        b_lp = ((r / s) * jac).to(fdt)
        yhat = linalg.pcg_lowp(solve_lp, matvec_lp, b_lp, max_iters=MIXED_INNER_ITERS)
        return s * (jac * yhat).to(r.dtype)

    return inner


def _solve_normal(cfg, prob, factors, rx, rp, pcg_budget, pcg_rtol, return_products):
    live = factors.live
    dinv = factors.dinv
    r2 = prob.matvec(dinv * rx) - rp
    r2 = torch.where(live, r2, 0.0)
    r_pcg = None
    solve_fn = _spd_solve_fn(cfg, factors, rx.dtype)

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
        if cfg.use_flex_pcg and factors.L.dtype != r2.dtype and isinstance(factors, NormalFactors):
            # Flexible PCG: the outer Krylov on the exact fp64 operator,
            # each preconditioner application an inner CG in the factor
            # precision; no tracked residual, so A dx is formed below.
            dy = linalg.pcg_flex(_mixed_inner_solver(cfg, factors), matvec, r2,
                                 max_iters=iters, rtol=rt)
        else:
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


def _solve_k1(cfg, prob, factors, rx, rp, pcg_budget, pcg_rtol, return_products):
    free = prob.free_mask
    live = factors.live
    gamma = factors.gamma
    rhs = torch.where(free, rx + gamma * prob.rmatvec(torch.where(live, rp, 0.0)), 0.0)
    solve_fn = _spd_solve_fn(cfg, factors, rx.dtype)

    def matvec(v):
        vx = torch.where(free, v, 0.0)
        cv = factors.sigma * vx + gamma * prob.rmatvec(torch.where(live, prob.matvec(vx), 0.0))
        if prob.is_qp:
            cv = cv + prob.qmatvec(vx)
        return torch.where(free, cv, v)

    if cfg.refinement_steps > 0 and pcg_budget != 0:
        rt = 1e-14 if pcg_rtol is None else pcg_rtol
        iters = pcg_budget if pcg_budget is not None else 4 * cfg.refinement_steps
        if cfg.use_flex_pcg and factors.L.dtype != rhs.dtype and isinstance(factors, CondensedFactors):
            dx = linalg.pcg_flex(_mixed_inner_solver(cfg, factors), matvec, rhs,
                                 max_iters=iters, rtol=rt)
        else:
            dx = linalg.pcg(solve_fn, matvec, rhs, max_iters=iters, rtol=rt)
    else:
        dx = solve_fn(rhs).to(rhs.dtype)
    dx = torch.where(free, dx, 0.0)
    adx = prob.matvec(dx)
    dy = torch.where(live, -gamma * (rp - adx), 0.0)
    if return_products:
        # A dx comes with the dy recovery; A' dy is one more product.
        return dx, dy, torch.where(live, adx, 0.0), prob.rmatvec(dy)
    return dx, dy


def _solve_k2(cfg, prob, factors, rx, rp, return_products):
    n = prob.n
    free = prob.free_mask
    live = factors.live
    rhs = torch.cat([torch.where(free, rx, 0.0), torch.where(live, rp, 0.0)], dim=-1)
    # K2.5 scaling: K = J^-1 Khat J^-1 with the factor holding Khat, so
    # K^-1 b = J Khat^-1 J b (jac is ones for plain K2).
    jac = factors.jac
    Lfac, dfac = factors.Lfac, factors.dfac
    if cfg.linear_solver == LinearSolver.LU:
        raw = lambda b: linalg.lu_solve(Lfac, dfac, b)
    elif cfg.linear_solver == LinearSolver.LDL_INV:
        raw = lambda b: block_chol.ldl_inv_solve(Lfac, dfac, b)
    else:
        raw = lambda b: linalg.ldl_solve(Lfac, dfac, b)
    solve_fn = _with_precision(
        lambda b: (jac * raw((b * jac).to(Lfac.dtype))).to(rx.dtype),
        _factor_precision(cfg, rx.dtype), Lfac.device,
    )

    def matvec(v):
        # Exact fp64 augmented operator from the original pieces.
        vx, vy = v[..., :n], v[..., n:]
        vxf = torch.where(free, vx, 0.0)
        hx = factors.sigma * vx
        if prob.is_qp:
            hx = hx + prob.qmatvec(vxf)
        ax = prob.matvec(vxf)
        aty = prob.rmatvec(torch.where(live, vy, 0.0))
        top = torch.where(free, hx + aty, vx)
        bot = torch.where(live, ax + factors.del_c * vy, vy)
        return torch.cat([top, bot], dim=-1)

    sol = linalg.refine(solve_fn, matvec, rhs, cfg.refinement_steps)
    dx = torch.where(free, sol[..., :n], 0.0)
    dy = torch.where(live, sol[..., n:], 0.0)
    if return_products:
        return dx, dy, torch.where(live, prob.matvec(dx), 0.0), prob.rmatvec(dy)
    return dx, dy


def solve_residual(prob: TorchQP, factors, rx, rp, dx, dy):
    """||K d - r||_inf / max(1, ||r||_inf) of the regularized KKT solve,
    per lane (B, 1): top block Sigma dx + Q dx + A' dy - rx, bottom block
    A dx + del_c dy - rp, masked to free columns and live rows."""
    free = prob.free_mask
    dxf = torch.where(free, dx, 0.0)
    if isinstance(factors, _NORMAL):
        dinv = factors.dinv
        sigma = torch.where(free, 1.0 / torch.where(dinv == 0, 1.0, dinv), 1.0)
        hx = torch.where(dinv == 0, 0.0, sigma * dx)
        atdy = prob.rmatvec(dy)
    else:
        hx = factors.sigma * dx
        atdy = prob.rmatvec(torch.where(factors.live, dy, 0.0))
    if prob.is_qp:
        hx = hx + prob.qmatvec(dxf)
    top = torch.where(free, hx + atdy - rx, 0.0)
    bot = torch.where(factors.live, prob.matvec(dxf) + factors.del_c * dy - rp, 0.0)
    amax = lambda v: torch.amax(torch.abs(v), dim=-1, keepdim=True)
    num = torch.maximum(amax(top), amax(bot))
    den = torch.clamp(torch.maximum(amax(rx * free), amax(rp * prob.row_mask)), min=1.0)
    return num / den
