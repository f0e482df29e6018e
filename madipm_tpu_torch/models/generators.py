"""Synthetic LP and QP generators (numpy only).

``known_optimum_lp``, ``known_optimum_qp``, ``portfolio_qp`` and the
structured generators (``transportation_lp``, ``min_cost_flow_lp``,
``staircase_lp``, ``structured_suite``) are copies of
``madipm_tpu/models/generators.py``'s; ``make_suite`` is a copy of
``bench.py:make_suite`` and ``make_qp_suite`` of
``scripts/ablate_predictor_qp.py:make_qp_suite``, which cannot be imported
without jax.  All build the same instances from the same seeds as their
originals.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .qp import QuadraticModel, from_dense


def make_suite(k=16, n=384, m=192, density=0.3, seed0=1234):
    """Random sparse standard-form LPs, feasible by construction."""
    models = []
    for i in range(k):
        rng = np.random.default_rng(seed0 + i)
        A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
        empty = np.flatnonzero(np.abs(A).sum(axis=1) == 0)
        for r in empty:
            A[r, rng.integers(n)] = 1.0
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        c = rng.random(n) + 0.1
        uvar = np.full(n, np.inf)
        ub_idx = rng.random(n) < 0.25
        uvar[ub_idx] = xstar[ub_idx] + 3 * rng.random(ub_idx.sum())
        models.append(
            from_dense(
                c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=uvar,
                name=f"synth{i}",
            )
        )
    return models


def make_qp_suite(k, m, n, density, seed0=977):
    """Random convex QPs (low-rank-plus-diagonal Hessian), feasible by
    construction: the K1 bench suite of the JAX package."""
    models = []
    for i in range(k):
        rng = np.random.default_rng(seed0 + i)
        A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
        empty = np.flatnonzero(np.abs(A).sum(axis=1) == 0)
        for r in empty:
            A[r, rng.integers(n)] = 1.0
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        P = rng.standard_normal((n, n // 8)) / np.sqrt(n)
        Q = P @ P.T + 0.1 * np.eye(n)
        uvar = np.full(n, np.inf)
        ub = rng.random(n) < 0.25
        uvar[ub] = xstar[ub] + 3 * rng.random(ub.sum())
        models.append(
            from_dense(
                c=rng.standard_normal(n), A=A, lcon=b, ucon=b,
                lvar=np.zeros(n), uvar=uvar, Q=Q, name=f"qp{i}",
            )
        )
    return models


def portfolio_qp(n_assets: int, n_factors: int, seed: int = 0,
                 name: str = None) -> QuadraticModel:
    """Markowitz portfolio QP with a factor risk model (sparse-plus-low-rank
    SPD Hessian, one budget equality, box bounds).

        min -mu'x + (lam/2) x'(F D F' + diag(s))x
        s.t. 1'x = 1,  0 <= x <= w_max
    """
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n_assets, n_factors)) / np.sqrt(n_factors)
    D = np.diag(rng.random(n_factors) + 0.5)
    s = rng.random(n_assets) * 0.2 + 0.05
    Q = sp.csr_matrix(F @ D @ F.T + np.diag(s))
    mu = rng.random(n_assets) * 0.1
    A = sp.csr_matrix(np.ones((1, n_assets)))
    return QuadraticModel(
        c=-mu, Q=2.0 * Q, A=A, lcon=np.array([1.0]), ucon=np.array([1.0]),
        lvar=np.zeros(n_assets), uvar=np.full(n_assets, 4.0 / max(1, n_assets) + 0.25),
        name=name or f"portfolio_{n_assets}a{n_factors}f",
    )


def known_optimum_lp(m: int, n: int, seed: int = 0, density: float = 0.2,
                     degenerate: bool = False, name: str = None):
    """LP with an exactly-constructed primal-dual optimal pair
    (stationarity c + A'y - zl = 0 holds by construction).

    ``degenerate=True`` zeroes some basic x* and some nonbasic zl*.
    Returns (model, info) with info = dict(x=x*, y=y*, zl=zl*, obj=c'x*).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    empty = np.flatnonzero(np.abs(A).sum(axis=1) == 0)
    for r in empty:
        A[r, rng.integers(n)] = 1.0
    n_basic = min(n, m + max(1, n // 4))
    basic = np.zeros(n, dtype=bool)
    basic[rng.permutation(n)[:n_basic]] = True
    x = np.where(basic, rng.random(n) + 0.5, 0.0)
    y = rng.standard_normal(m)
    zl = np.where(basic, 0.0, rng.random(n) + 0.2)
    if degenerate:
        bidx = np.flatnonzero(basic)
        nidx = np.flatnonzero(~basic)
        x[rng.choice(bidx, size=max(1, bidx.size // 8), replace=False)] = 0.0
        if nidx.size:
            zl[rng.choice(nidx, size=max(1, nidx.size // 8), replace=False)] = 0.0
    c = zl - A.T @ y
    b = A @ x
    model = QuadraticModel(
        c=c, A=sp.csr_matrix(A), lcon=b, ucon=b, lvar=np.zeros(n),
        uvar=np.full(n, np.inf),
        name=name or f"known_{m}x{n}{'_deg' if degenerate else ''}",
    )
    info = dict(x=x, y=y, zl=zl, obj=float(c @ x))
    return model, info


def known_optimum_qp(m: int, n: int, seed: int = 0, density: float = 0.2,
                     q_rank: int = None, degenerate: bool = False,
                     sparse_q: bool = False, name: str = None):
    """Convex QP with an exactly-constructed primal-dual optimal pair
    (stationarity c + Qx + A'y - zl + zu = 0 holds by construction).

    Q = B'B + d I (SPD; ``sparse_q`` makes B sparse); x* is split into
    interior / at-lower / at-upper thirds, zl* > 0 exactly on the at-lower
    set and zu* > 0 on the at-upper set.  Convexity makes the KKT point the
    global optimum.  ``degenerate=True`` zeroes some active-set multipliers
    and pins some interior x* to a bound.

    Returns (model, info) with info = dict(x=x*, y=y*, zl=zl*, zu=zu*,
    obj=c'x* + x*'Qx*/2).
    """
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) * (rng.random((m, n)) < density)
    empty = np.flatnonzero(np.abs(A).sum(axis=1) == 0)
    for r in empty:
        A[r, rng.integers(n)] = 1.0
    if q_rank is None:
        q_rank = max(1, n // 4)
    B = rng.standard_normal((q_rank, n)) / np.sqrt(q_rank)
    if sparse_q:
        B *= rng.random((q_rank, n)) < 0.3
    Q = B.T @ B + np.diag(rng.random(n) * 0.5 + 0.1)

    uvar = np.full(n, np.inf)
    fin = rng.permutation(n)[: n // 2]
    uvar[fin] = rng.random(n // 2) * 2.0 + 1.0

    kinds = rng.integers(0, 3, n)  # 0 interior, 1 at lower, 2 at upper
    kinds[~np.isfinite(uvar)] = np.where(
        kinds[~np.isfinite(uvar)] == 2, 0, kinds[~np.isfinite(uvar)]
    )
    x = np.where(
        kinds == 0,
        rng.random(n) * np.where(np.isfinite(uvar), 0.8 * uvar, 1.0) + 0.1,
        np.where(kinds == 1, 0.0, uvar),
    )
    x = np.where(np.isfinite(uvar), np.minimum(x, uvar), x)
    y = rng.standard_normal(m)
    zl = np.where(kinds == 1, rng.random(n) + 0.2, 0.0)
    zu = np.where(kinds == 2, rng.random(n) + 0.2, 0.0)
    if degenerate:
        low = np.flatnonzero(kinds == 1)
        if low.size:
            zl[rng.choice(low, size=max(1, low.size // 6), replace=False)] = 0.0
        inter = np.flatnonzero(kinds == 0)
        if inter.size:
            pin = rng.choice(inter, size=max(1, inter.size // 8), replace=False)
            x[pin] = 0.0  # primal-degenerate: at the bound with zl = 0
    c = zl - zu - Q @ x - A.T @ y  # stationarity exact by construction
    b = A @ x
    model = QuadraticModel(
        c=c, A=sp.csr_matrix(A), lcon=b, ucon=b, lvar=np.zeros(n),
        uvar=uvar, Q=sp.csr_matrix(Q),
        name=name or f"knownqp_{m}x{n}{'_deg' if degenerate else ''}",
    )
    obj = float(c @ x + 0.5 * x @ (Q @ x))
    info = dict(x=x, y=y, zl=zl, zu=zu, obj=obj)
    return model, info


def transportation_lp(ns: int, nd: int, seed: int = 0, name: str = None) -> QuadraticModel:
    """Classic transportation problem: ship from ``ns`` supplies to ``nd``
    demands at minimum cost.

        min sum_ij c_ij x_ij
        s.t.  sum_j x_ij = s_i   (supply rows)
              sum_i x_ij = d_j   (demand rows)
              x >= 0

    Every variable appears in exactly 2 constraints (node-arc structure,
    the archetypal Netlib pattern).  Balanced by construction.
    """
    rng = np.random.default_rng(seed)
    supply = rng.random(ns) + 0.5
    demand = rng.random(nd) + 0.5
    demand *= supply.sum() / demand.sum()  # balance
    n = ns * nd
    c = (rng.random((ns, nd)) + 0.1 + 0.05 * (rng.random((ns, 1)) + rng.random((1, nd)))).ravel()

    rows, cols = [], []
    for i in range(ns):
        rows.extend([i] * nd)
        cols.extend(range(i * nd, (i + 1) * nd))
    for j in range(nd):
        rows.extend([ns + j] * ns)
        cols.extend(range(j, n, nd))
    A = sp.csr_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(ns + nd, n)
    )
    b = np.concatenate([supply, demand])
    # Balanced transportation constraints have rank ns+nd-1 (supply rows sum
    # to demand rows): drop the last demand row, the standard full-rank form.
    A = A[:-1]
    b = b[:-1]
    return QuadraticModel(
        c=c, A=A, lcon=b, ucon=b, lvar=np.zeros(n), uvar=np.full(n, np.inf),
        name=name or f"transport_{ns}x{nd}",
    )


def min_cost_flow_lp(n_nodes: int, arcs_per_node: int = 4, seed: int = 0,
                     name: str = None) -> QuadraticModel:
    """Min-cost flow on a random connected digraph (node-arc incidence A:
    each column has exactly one +1 and one -1 — MIPLIB-relaxation texture).

    Feasibility by construction: flows are sampled first and divergences
    become the node balances."""
    rng = np.random.default_rng(seed)
    # ring backbone (connectivity) + random chords
    tail = list(range(n_nodes))
    head = [(i + 1) % n_nodes for i in range(n_nodes)]
    n_extra = n_nodes * (arcs_per_node - 1)
    t = rng.integers(0, n_nodes, n_extra)
    h = (t + 1 + rng.integers(0, n_nodes - 1, n_extra)) % n_nodes
    tail = np.concatenate([tail, t])
    head = np.concatenate([head, h])
    n_arcs = tail.size

    flows = rng.random(n_arcs) * 2.0
    cap = flows + rng.random(n_arcs) * 3.0 + 0.5
    cost = rng.random(n_arcs) + 0.05

    rows = np.concatenate([tail, head])
    cols = np.concatenate([np.arange(n_arcs), np.arange(n_arcs)])
    vals = np.concatenate([np.ones(n_arcs), -np.ones(n_arcs)])
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n_nodes, n_arcs))
    b = A @ flows  # divergence of the sampled flow
    # Node-arc incidence rows sum to zero (rank n_nodes - 1 on a connected
    # graph): drop one node balance, the standard full-rank form.
    A = A[:-1]
    b = b[:-1]
    return QuadraticModel(
        c=cost, A=A, lcon=b, ucon=b, lvar=np.zeros(n_arcs), uvar=cap,
        name=name or f"netflow_{n_nodes}n{n_arcs}a",
    )


def staircase_lp(T: int, nx: int, nu: int, seed: int = 0, name: str = None) -> QuadraticModel:
    """Multistage (block-bidiagonal) LP: dynamics x_{t+1} = A x_t + B u_t
    over T stages — the staircase structure of dynamic/MPC LPs (and of
    many Netlib instances like the GROW/SCSD families).

    Variables z = [x_0, u_0, x_1, u_1, ..., x_T]; constraints are the T
    dynamic equalities plus the x_0 pin."""
    rng = np.random.default_rng(seed)
    Ad = np.eye(nx) + 0.1 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    Bd = rng.standard_normal((nx, nu)) / np.sqrt(nu)

    nz = (T + 1) * nx + T * nu
    off_x = lambda t: t * (nx + nu)
    off_u = lambda t: t * (nx + nu) + nx

    blocks_r, blocks_c, blocks_v = [], [], []

    def put(block, r0, c0):
        r, c = np.nonzero(block)
        blocks_r.extend((r + r0).tolist())
        blocks_c.extend((c + c0).tolist())
        blocks_v.extend(block[r, c].tolist())

    # x_0 = x0_val
    put(np.eye(nx), 0, 0)
    for t in range(T):
        r0 = nx + t * nx
        put(Ad, r0, off_x(t))
        put(Bd, r0, off_u(t))
        put(-np.eye(nx), r0, off_x(t + 1))
    m = (T + 1) * nx
    A = sp.csr_matrix((blocks_v, (blocks_r, blocks_c)), shape=(m, nz))

    # Feasible trajectory: simulate forward from a random start/controls.
    x0 = rng.random(nx)
    us = rng.random((T, nu)) * 0.5
    b = np.zeros(m)
    b[:nx] = x0
    xs = [x0]
    for t in range(T):
        xs.append(Ad @ xs[-1] + Bd @ us[t])
    # dynamics rows: A x_t + B u_t - x_{t+1} = 0
    lvar = np.full(nz, -np.inf)
    uvar = np.full(nz, np.inf)
    for t in range(T):
        lvar[off_u(t): off_u(t) + nu] = 0.0
        uvar[off_u(t): off_u(t) + nu] = 1.0
    # keep states loosely bounded so the LP is bounded
    for t in range(T + 1):
        lvar[off_x(t): off_x(t) + nx] = -10.0 * (1.0 + np.abs(xs[t]).max())
        uvar[off_x(t): off_x(t) + nx] = 10.0 * (1.0 + np.abs(xs[t]).max())
    c = rng.random(nz) * 0.1
    for t in range(T):
        c[off_u(t): off_u(t) + nu] = rng.random(nu) + 0.5  # control effort
    return QuadraticModel(
        c=c, A=A, lcon=b, ucon=b, lvar=lvar, uvar=uvar,
        name=name or f"staircase_T{T}_nx{nx}",
    )


def structured_suite(scale: int = 1, seed0: int = 7):
    """A mixed suite of structured instances at roughly Netlib scale
    (multiply dimensions by ``scale``)."""
    s = scale
    return [
        transportation_lp(24 * s, 36 * s, seed=seed0),
        transportation_lp(32 * s, 48 * s, seed=seed0 + 1),
        min_cost_flow_lp(96 * s, 4, seed=seed0 + 2),
        min_cost_flow_lp(128 * s, 5, seed=seed0 + 3),
        staircase_lp(12 * s, 8, 4, seed=seed0 + 4),
        staircase_lp(16 * s, 10, 5, seed=seed0 + 5),
        portfolio_qp(80 * s, 12, seed=seed0 + 6),
        portfolio_qp(120 * s, 16, seed=seed0 + 7),
    ]
