"""Execution statistics (copy of ``madipm_tpu/utils/stats.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .status import SUCCESS_STATUSES, Status, get_status_output


@dataclasses.dataclass
class IPMStats:
    status: Status
    objective: float
    solution: np.ndarray
    constraints: np.ndarray
    multipliers: np.ndarray  # equality multipliers y
    multipliers_L: np.ndarray  # lower-bound duals zl >= 0
    multipliers_U: np.ndarray  # upper-bound duals zu >= 0
    iter: int
    primal_feas: float
    dual_feas: float
    complementarity: float
    total_time: float = 0.0
    init_time: float = 0.0
    solver_time: float = 0.0
    #: wall time in factorizations + solves; only the timed driver
    #: measures it (ROADMAP A10), so it stays None here
    linear_solver_time: Optional[float] = None
    dual_objective: Optional[float] = None

    @property
    def success(self) -> bool:
        return self.status in SUCCESS_STATUSES

    def message(self) -> str:
        return get_status_output(self.status)

    def __repr__(self) -> str:
        return (
            f"IPMStats(status={Status(self.status).name}, obj={self.objective:.8e}, "
            f"iter={self.iter}, inf_pr={self.primal_feas:.2e}, inf_du={self.dual_feas:.2e}, "
            f"time={self.total_time:.3f}s)"
        )
