"""Synthetic LP generators (numpy only).

``known_optimum_lp`` is a copy of ``madipm_tpu/models/generators.py``'s;
``make_suite`` is a copy of ``bench.py:make_suite``, which cannot be
imported without jax.  Both build the same instances from the same seeds
as their originals.
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
