"""Solver options.

Field-for-field copy of ``madipm_tpu/utils/options.py`` (the JAX package
cannot be imported without jax).  The history and measurements behind
each default live there; what differs in this package is noted on the
field.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Optional


class StepRuleKind(enum.Enum):
    CONSERVATIVE = "conservative"
    ADAPTIVE = "adaptive"
    MEHROTRA_ADAPTIVE = "mehrotra_adaptive"


@dataclasses.dataclass(frozen=True)
class ConservativeStep:
    """Fixed fraction-to-boundary factor tau."""

    tau: float = 0.995
    kind: StepRuleKind = StepRuleKind.CONSERVATIVE


@dataclasses.dataclass(frozen=True)
class AdaptiveStep:
    """tau = max(1 - mu, tau_min)."""

    tau_min: float = 0.99
    kind: StepRuleKind = StepRuleKind.ADAPTIVE


@dataclasses.dataclass(frozen=True)
class MehrotraAdaptiveStep:
    """Mehrotra's boundary-point heuristic (Procedure GTSF)."""

    gamma_f: float = 0.99
    kind: StepRuleKind = StepRuleKind.MEHROTRA_ADAPTIVE


@dataclasses.dataclass(frozen=True)
class NoRegularization:
    """del_w = del_c = 0 in the loop."""


@dataclasses.dataclass(frozen=True)
class FixedRegularization:
    """Constant (delta_p, delta_d); delta_d is applied with its own sign."""

    delta_p: float = 1e-10
    delta_d: float = 1e-10


@dataclasses.dataclass(frozen=True)
class AdaptiveRegularization:
    """Decay delta/10 each iteration down to delta_min."""

    delta_p: float = 1e-8
    delta_d: float = -1e-8
    delta_min: float = 1e-9


@dataclasses.dataclass(frozen=True)
class Mehrotra:
    """sigma = clamp((mu_aff/mu)^power, sigma_min, sigma_max)."""

    power: float = 3.0
    sigma_min: float = 1e-6
    sigma_max: float = 10.0


class KKTSystem(enum.Enum):
    """Linear-system formulation factorized each iteration: NORMAL (the SPD
    normal equations A Sigma^-1 A' - del_c I, LP only), CONDENSED (K1, the
    SPD Sigma + Q + gamma A'A), AUGMENTED (K2, the quasi-definite
    [Sigma+Q, A'; A, del_c I]) and SCALED_AUGMENTED (K2.5, K2 after a
    symmetric diagonal scaling)."""

    NORMAL = "normal"
    AUGMENTED = "augmented"
    SCALED_AUGMENTED = "scaled_augmented"
    CONDENSED = "condensed"


class LinearSolver(enum.Enum):
    """Factorization of the KKT matrix.  For the SPD systems: CHOLESKY
    (torch.linalg, or the factor-only CUDA kernel with ``use_pallas``) and
    CHOLESKY_INV (the explicit inverse factor from ops/chol_inv.py, a CUDA
    kernel on the GPU).  For the augmented systems: LDL (unpivoted blocked
    LDL'), LDL_INV (its explicit inverse factor) and LU (torch.linalg)."""

    CHOLESKY = "cholesky"
    CHOLESKY_INV = "cholesky_inv"
    LDL = "ldl"
    LDL_INV = "ldl_inv"
    LU = "lu"


class PrintLevel(enum.IntEnum):
    TRACE = 1
    DEBUG = 2
    INFO = 3
    NOTICE = 4
    WARN = 5
    ERROR = 6


@dataclasses.dataclass
class IPMOptions:
    """Options for the Mehrotra predictor-corrector solver (same fields and
    defaults as the JAX package)."""

    # Main options
    tol: float = 1e-8
    kkt_system: Optional[KKTSystem] = None  # None = auto (NORMAL for LP, AUGMENTED for QP)
    linear_solver: Optional[LinearSolver] = None  # None = auto from kkt_system

    # Output options
    output_file: str = ""
    print_level: PrintLevel = PrintLevel.INFO
    file_print_level: PrintLevel = PrintLevel.INFO
    rethrow_error: bool = False

    # Termination options
    max_iter: int = 3000
    max_wall_time: float = 1e6
    divergence_tol: float = 1e4
    acceptable_tol: float = 1e-6
    acceptable_iter: int = 15

    # Initialization options
    scaling: bool = True
    bound_push: float = 1e-2
    bound_fac: float = 1e-2
    bound_relax_factor: float = 1e-12

    # Regularization
    regularization: object = dataclasses.field(
        default_factory=lambda: FixedRegularization(1e-10, 1e-10)
    )

    # Step
    step_rule: object = dataclasses.field(default_factory=lambda: AdaptiveStep(0.99))

    # Barrier
    barrier_update: object = dataclasses.field(default_factory=Mehrotra)
    max_ncorr: int = 0  # Gondzio centrality corrections per iteration
    s_max: float = 100.0
    mu_init: float = 1e-1
    mu_min: float = 1e-12
    #: floor the barrier at mu_balance * max(inf_pr, inf_du); 0 disables
    mu_balance: float = 1e-2

    # Linear solve
    tol_linear_solve: float = 1e-8
    check_residual: bool = False
    #: mu-proportional PCG exit tolerances (inexact Newton)
    pcg_adaptive_tol: bool = False
    #: upper clamp of the corrector's adaptive PCG tolerance
    pcg_tol_cap: float = 1e-9
    #: lower clamp of the corrector's adaptive PCG tolerance
    pcg_tol_floor: float = 1e-13
    #: fp64 PCG budget when the factor runs below the residual precision
    #: (the corrector's cap is 4x this)
    refinement_steps: int = 12
    #: predictor PCG budget; None = max(2, refinement_steps // 2);
    #: 0 = apply the factor only, no fp64 PCG
    predictor_pcg_budget: Optional[int] = None
    #: advance the memoized A x / A' y pair by recurrence, resynced exactly
    #: every CERT_PERIOD trips
    product_recurrence: bool = True

    #: dtype of the factorization, e.g. "float32"; None = the solve dtype
    factor_dtype: Optional[str] = None
    #: second-order preconditioner of the NORMAL fp32-factor path: one
    #: correction per preconditioner application against the unshifted
    #: Jacobi-scaled S (an (m, m) buffer per lane more)
    precond_refine: bool = False
    #: float32 matmul precision of the factor attempt and the
    #: preconditioner applications when the factor runs below the solve
    #: dtype, on CUDA: "default" -> bf16 ("medium"), "high" -> TF32,
    #: "highest" -> full fp32 (``torch.set_float32_matmul_precision``,
    #: restored after each use); None leaves float32 products in float32
    #: (the package switches TF32 off).  The chol_inv kernel's fp32
    #: products are its own FMAs and are not affected; on the CPU nothing
    #: changes, as on XLA's CPU backend.
    factor_precision: Optional[str] = None
    #: True: a CHOLESKY factor of the NORMAL or CONDENSED system runs
    #: through the factor-only kernel of ops/chol_inv.py, not torch.linalg
    #: (None = False).  A CHOLESKY_INV factor runs through its kernel on
    #: CUDA whatever this says.
    use_pallas: Optional[bool] = None
    #: flexible PCG: the fp64 PCG preconditioned by an inner CG of
    #: MIXED_INNER_ITERS trips in the factor precision (fp32 factor only)
    pcg_flex: bool = False
    #: fp64 products of A, A' and Q: "auto" and "emulated" mean native fp64
    #: (the card has it); "ozaki" the error-free bf16 slices and "ozaki_i8"
    #: the int8 slices of ops/ozaki.py, through the tensor-core kernel
    #: csrc/ozaki.cu on CUDA (fp64 solves only)
    fp64_matvec: str = "auto"
    #: bf16 Ozaki slices per operand (None = ops/ozaki.N_SLICES = 7); the
    #: operator's error bound is 2n 2^-8(S-1), and the solve warns when it
    #: passes 0.1 * tol (at most 8 on CUDA)
    ozaki_slices: Optional[int] = None
    #: True: A' products contract the forward slices (no transposed copy);
    #: None: only once the two copies of an instance pass 1 GiB
    ozaki_share_slices: Optional[bool] = None

    def resolved_kkt(self, is_qp: bool) -> KKTSystem:
        if self.kkt_system is not None:
            return self.kkt_system
        return KKTSystem.AUGMENTED if is_qp else KKTSystem.NORMAL

    def resolved_linear_solver(self, kkt: KKTSystem) -> LinearSolver:
        if self.linear_solver is not None:
            return self.linear_solver
        if kkt in (KKTSystem.NORMAL, KKTSystem.CONDENSED):
            return LinearSolver.CHOLESKY
        return LinearSolver.LDL


def load_options(**kwargs) -> IPMOptions:
    """Build IPMOptions from keyword arguments, warning on unknown keys."""
    known = {f.name for f in dataclasses.fields(IPMOptions)}
    opts = {k: v for k, v in kwargs.items() if k in known}
    ignored = {k: v for k, v in kwargs.items() if k not in known}
    if ignored:
        warnings.warn(f"Ignoring unsupported options: {sorted(ignored)}")
    return IPMOptions(**opts)
