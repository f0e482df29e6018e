"""Solver status codes (copy of ``madipm_tpu/utils/status.py``).

Statuses are plain ints so they can live in int32 tensors inside the
batched loop.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Termination status of the interior-point solver."""

    # Running states
    INITIAL = 0
    REGULAR = 1  # still iterating

    # Successful exits
    SOLVE_SUCCEEDED = 2
    SOLVED_TO_ACCEPTABLE_LEVEL = 3

    # Failure exits
    INFEASIBLE_PROBLEM_DETECTED = 4
    DIVERGING_ITERATES = 5
    MAXIMUM_ITERATIONS_EXCEEDED = 6
    MAXIMUM_WALLTIME_EXCEEDED = 7
    ERROR_IN_STEP_COMPUTATION = 8
    NOT_ENOUGH_DEGREES_OF_FREEDOM = 9
    INVALID_NUMBER_DETECTED = 10
    INVALID_NUMBER_OBJECTIVE = 11
    INVALID_NUMBER_GRADIENT = 12
    INVALID_NUMBER_CONSTRAINTS = 13
    INVALID_NUMBER_JACOBIAN = 14
    INVALID_NUMBER_HESSIAN_LAGRANGIAN = 15
    USER_REQUESTED_STOP = 16
    INTERNAL_ERROR = 17

    # Presolve-level results
    PRESOLVE_SOLVED = 18
    PRESOLVE_INFEASIBLE = 19
    PRESOLVE_UNBOUNDED = 20


#: Statuses considered a successful solve.
SUCCESS_STATUSES = frozenset(
    {Status.SOLVE_SUCCEEDED, Status.SOLVED_TO_ACCEPTABLE_LEVEL, Status.PRESOLVE_SOLVED}
)


STATUS_MESSAGES = {
    Status.INITIAL: "Solver not run yet.",
    Status.REGULAR: "Solver is running.",
    Status.SOLVE_SUCCEEDED: "Optimal Solution Found.",
    Status.SOLVED_TO_ACCEPTABLE_LEVEL: "Solved To Acceptable Level.",
    Status.INFEASIBLE_PROBLEM_DETECTED: "Converged to a point of local infeasibility.",
    Status.DIVERGING_ITERATES: "Iterates diverging; problem might be unbounded.",
    Status.MAXIMUM_ITERATIONS_EXCEEDED: "Maximum Number of Iterations Exceeded.",
    Status.MAXIMUM_WALLTIME_EXCEEDED: "Maximum wall-clock Time Exceeded.",
    Status.ERROR_IN_STEP_COMPUTATION: "Error in step computation.",
    Status.NOT_ENOUGH_DEGREES_OF_FREEDOM: "Problem has too few degrees of freedom.",
    Status.INVALID_NUMBER_DETECTED: "Invalid number in NLP function or derivative detected.",
    Status.INVALID_NUMBER_OBJECTIVE: "Invalid number in objective function detected.",
    Status.INVALID_NUMBER_GRADIENT: "Invalid number in objective gradient detected.",
    Status.INVALID_NUMBER_CONSTRAINTS: "Invalid number in constraints detected.",
    Status.INVALID_NUMBER_JACOBIAN: "Invalid number in constraint Jacobian detected.",
    Status.INVALID_NUMBER_HESSIAN_LAGRANGIAN: "Invalid number in Hessian of the Lagrangian detected.",
    Status.USER_REQUESTED_STOP: "Stopping optimization at current point as requested by user.",
    Status.INTERNAL_ERROR: "Internal error.",
    Status.PRESOLVE_SOLVED: "Problem solved by presolve.",
    Status.PRESOLVE_INFEASIBLE: "Presolve detected an infeasible problem.",
    Status.PRESOLVE_UNBOUNDED: "Presolve detected an unbounded problem.",
}


def get_status_output(status: Status) -> str:
    """Human-readable EXIT message."""
    return STATUS_MESSAGES.get(Status(status), f"Unknown status {status}.")
