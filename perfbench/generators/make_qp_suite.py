"""Random convex QPs with a low-rank-plus-diagonal Hessian, feasible by
construction: a copy of ``madipm_tpu_torch.models.generators.make_qp_suite``
(itself a copy of ``scripts/ablate_predictor_qp.py:make_qp_suite``), drawing
the same numbers in the same order and returning the instances raw."""

from __future__ import annotations

import numpy as np

from perfbench.generators import raw_instance


def generate(k, seed0, m, n, density) -> list:
    out = []
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
        c = rng.standard_normal(n)
        out.append(raw_instance(c, A, b, uvar, Q, f"qp{i}"))
    return out
