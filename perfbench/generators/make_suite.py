"""Random sparse standard-form LPs, feasible by construction: a copy of
``madipm_tpu_torch.models.generators.make_suite`` (itself a copy of
``bench.py:make_suite``).  It draws the same numbers in the same order
from the same seeds, so it builds the same instances, but returns them
raw: the benchmark owns its inputs, and the reference reads them without
the program."""

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
        c = rng.random(n) + 0.1
        uvar = np.full(n, np.inf)
        ub_idx = rng.random(n) < 0.25
        uvar[ub_idx] = xstar[ub_idx] + 3 * rng.random(ub_idx.sum())
        out.append(raw_instance(c, A, b, uvar, None, f"synth{i}"))
    return out
