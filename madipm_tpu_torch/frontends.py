"""Modeling front ends: a copy of ``madipm_tpu/frontends.py`` that calls
the port's :func:`madipm_tpu_torch.madipm`.

- :func:`solve_linprog`: the shape of ``scipy.optimize.linprog`` (c, A_ub,
  b_ub, A_eq, b_eq, bounds), returning a scipy-style result.
- :func:`solve_qp`: the (P, q, G, h, A, b, lb, ub) QP convention of
  qpsolvers/OSQP-style APIs.
- :func:`from_mps`: the file pipeline: read MPS/QPS -> presolve -> Ruiz
  scaling -> standard form -> solve (``sparse`` passed through) ->
  postsolve of the primal and the multipliers.

Every front end builds a host ``QuadraticModel`` and calls ``madipm``; the
options (``device`` among them) go through unchanged, so each runs on the
CUDA device unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp

from .api import madipm
from .models.qp import INF, QuadraticModel
from .utils.stats import IPMStats
from .utils.status import Status


@dataclasses.dataclass
class LinprogResult:
    """scipy.optimize.linprog-shaped result."""

    x: Optional[np.ndarray]
    fun: Optional[float]
    status: int  # 0 ok, 1 iteration limit, 2 infeasible, 3 unbounded, 4 other
    success: bool
    message: str
    nit: int
    slack: Optional[np.ndarray] = None
    con: Optional[np.ndarray] = None
    ipm_stats: Optional[IPMStats] = None


_STATUS_MAP = {
    Status.SOLVE_SUCCEEDED: 0,
    Status.SOLVED_TO_ACCEPTABLE_LEVEL: 0,
    Status.PRESOLVE_SOLVED: 0,
    Status.MAXIMUM_ITERATIONS_EXCEEDED: 1,
    Status.MAXIMUM_WALLTIME_EXCEEDED: 1,
    Status.INFEASIBLE_PROBLEM_DETECTED: 2,
    Status.PRESOLVE_INFEASIBLE: 2,
    Status.DIVERGING_ITERATES: 3,
    Status.PRESOLVE_UNBOUNDED: 3,
}


def solve_linprog(
    c,
    A_ub=None,
    b_ub=None,
    A_eq=None,
    b_eq=None,
    bounds=None,
    **options,
) -> LinprogResult:
    """Solve ``min c'x  s.t. A_ub x <= b_ub, A_eq x = b_eq, bounds`` with the
    MPC interior-point solver; mirrors scipy.optimize.linprog's signature."""
    c = np.asarray(c, dtype=np.float64).ravel()
    n = c.size

    rows = []
    lcon = []
    ucon = []
    if A_ub is not None and len(np.atleast_2d(A_ub)):
        A_ub = sp.csr_matrix(np.atleast_2d(np.asarray(A_ub, dtype=np.float64)))
        rows.append(A_ub)
        lcon.append(np.full(A_ub.shape[0], -INF))
        ucon.append(np.asarray(b_ub, dtype=np.float64).ravel())
    if A_eq is not None and len(np.atleast_2d(A_eq)):
        A_eq = sp.csr_matrix(np.atleast_2d(np.asarray(A_eq, dtype=np.float64)))
        rows.append(A_eq)
        beq = np.asarray(b_eq, dtype=np.float64).ravel()
        lcon.append(beq)
        ucon.append(beq)
    if rows:
        A = sp.vstack(rows, format="csr")
        lcon = np.concatenate(lcon)
        ucon = np.concatenate(ucon)
    else:
        A = sp.csr_matrix((0, n))
        lcon = np.zeros(0)
        ucon = np.zeros(0)

    if bounds is None:
        lvar = np.zeros(n)
        uvar = np.full(n, INF)
    else:
        blist = list(bounds)
        if len(blist) == 1 and n > 1:
            blist = blist * n
        lvar = np.array([(-INF if b[0] is None else b[0]) for b in blist])
        uvar = np.array([(INF if b[1] is None else b[1]) for b in blist])

    qp = QuadraticModel(c=c, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar)
    stats = madipm(qp, **options)
    code = _STATUS_MAP.get(stats.status, 4)
    con = A_eq @ stats.solution - np.asarray(b_eq).ravel() if A_eq is not None else None
    slack = (
        np.asarray(b_ub).ravel() - A_ub @ stats.solution if A_ub is not None else None
    )
    return LinprogResult(
        x=stats.solution if code == 0 else None,
        fun=stats.objective if code == 0 else None,
        status=code,
        success=code == 0,
        message=stats.message(),
        nit=stats.iter,
        slack=slack,
        con=con,
        ipm_stats=stats,
    )


def solve_qp(
    P=None,
    q=None,
    G=None,
    h=None,
    A=None,
    b=None,
    lb=None,
    ub=None,
    **options,
) -> IPMStats:
    """Solve ``min 1/2 x'Px + q'x  s.t. Gx <= h, Ax = b, lb <= x <= ub``
    (qpsolvers-style convention)."""
    q = np.asarray(q, dtype=np.float64).ravel()
    n = q.size
    rows, lcon, ucon = [], [], []
    if G is not None:
        G = sp.csr_matrix(np.atleast_2d(np.asarray(G, dtype=np.float64)))
        rows.append(G)
        lcon.append(np.full(G.shape[0], -INF))
        ucon.append(np.asarray(h, dtype=np.float64).ravel())
    if A is not None:
        A = sp.csr_matrix(np.atleast_2d(np.asarray(A, dtype=np.float64)))
        rows.append(A)
        bb = np.asarray(b, dtype=np.float64).ravel()
        lcon.append(bb)
        ucon.append(bb)
    if rows:
        Am = sp.vstack(rows, format="csr")
        lcon = np.concatenate(lcon)
        ucon = np.concatenate(ucon)
    else:
        Am = sp.csr_matrix((0, n))
        lcon = np.zeros(0)
        ucon = np.zeros(0)
    lvar = np.full(n, -INF) if lb is None else np.asarray(lb, dtype=np.float64)
    uvar = np.full(n, INF) if ub is None else np.asarray(ub, dtype=np.float64)
    Qm = None if P is None else sp.csr_matrix(np.asarray(P, dtype=np.float64))
    qp = QuadraticModel(c=q, A=Am, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar, Q=Qm)
    return madipm(qp, **options)


def from_mps(
    path: str,
    presolve: bool = True,
    scale: bool = True,
    reformulate: bool = True,
    sparse: Optional[bool] = None,
    **options,
) -> IPMStats:
    """Full reference pipeline from an MPS/QPS file: import -> presolve ->
    Ruiz scaling -> standard form -> solve -> postsolve
    (reference: scripts/benchmarks_gpu.jl:13-65)."""
    from .models.mps import read_mps
    from .models.presolve import presolve_qp
    from .models.qp import standard_form
    from .models.scale import scale_qp

    qp0 = read_mps(path)
    qp = qp0
    sign = 1.0 if qp0.minimize else -1.0
    if not qp0.minimize:
        qp = QuadraticModel(
            c=-qp.c, A=qp.A, lcon=qp.lcon, ucon=qp.ucon, lvar=qp.lvar,
            uvar=qp.uvar, Q=None if qp.Q is None else -qp.Q, c0=-qp.c0,
            x0=qp.x0, y0=qp.y0, name=qp.name,
        )

    post = None
    if presolve:
        qp, flag, post = presolve_qp(qp)
        if not flag:
            if post.status == Status.PRESOLVE_SOLVED:
                # Fully solved in presolve: recover the primal through the
                # elimination replay (free-singleton/duplicate columns are
                # DYNAMIC — fixed_vals alone is not the solution) and the
                # duals through the same machinery with an empty reduced
                # solution (surviving rows, if any, are empty: y = 0).
                x = post.x(np.empty(0))
                y, zl, zu = post.duals(
                    x,
                    np.zeros(post.keep_rows.size),
                    np.zeros(post.keep_cols.size),
                    np.zeros(post.keep_cols.size),
                )
                return IPMStats(
                    status=Status.PRESOLVE_SOLVED,
                    objective=sign * qp.obj(x),
                    solution=x,
                    constraints=qp.cons(x),
                    multipliers=y,
                    multipliers_L=zl,
                    multipliers_U=zu,
                    iter=0,
                    primal_feas=0.0,
                    dual_feas=np.nan,
                    complementarity=np.nan,
                )
            return IPMStats(
                status=post.status,
                objective=np.nan,
                solution=np.full(qp.nvar, np.nan),
                constraints=np.full(qp.ncon, np.nan),
                multipliers=np.zeros(qp.ncon),
                multipliers_L=np.zeros(qp.nvar),
                multipliers_U=np.zeros(qp.nvar),
                iter=0,
                primal_feas=np.nan,
                dual_feas=np.nan,
                complementarity=np.nan,
            )

    ruiz = None
    if scale:
        qp, ruiz = scale_qp(qp)
    sf_map = None
    if reformulate:
        qp, sf_map = standard_form(qp, return_map=True)

    stats = madipm(qp, sparse=sparse, **options)

    # Postsolve (reverse order of the forward transforms): standard form ->
    # Ruiz -> presolve, for the primal AND the multipliers (y, zl, zu) —
    # the reference's postsolve semantics (src/kernels.jl:403-430 dual
    # conventions; QuadraticModels.postsolve role).
    nred = (post.keep_cols.size if post is not None else qp0.nvar)
    if sf_map is not None:
        x = sf_map.x(stats.solution)
        y, zl, zu = sf_map.duals(
            stats.multipliers, stats.multipliers_L, stats.multipliers_U
        )
    else:
        x = stats.solution[:nred]
        y = stats.multipliers
        zl = stats.multipliers_L[:nred]
        zu = stats.multipliers_U[:nred]
    if ruiz is not None:
        x, y, zl, zu = ruiz.unscale_solution(x=x, y=y, zl=zl, zu=zu)
    if post is not None:
        x = post.x(x)
        y, zl, zu = post.duals(x, y, zl, zu)
    # qp0 is the ORIGINAL model (max convention included), so its objective
    # value is already in user units — no sign flip here (the flip only
    # applies where the negated model's value is reported).
    stats.solution = x
    stats.objective = qp0.obj(x)
    stats.constraints = qp0.cons(x)
    # Multipliers are reported for the MINIMIZATION form (for a maximize
    # model they satisfy stationarity with -c), matching update_solution!
    # flipping only the objective (reference src/utils.jl:150-156).
    stats.multipliers = y
    stats.multipliers_L = zl
    stats.multipliers_U = zu
    return stats
