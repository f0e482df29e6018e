"""Random sparse standard-form LPs, feasible by construction, drawn by
rows: the law of ``make_suite`` without its dense draws.

Each entry of A is nonzero with probability ``density``: a row draws its
count of nonzeros (binomial over the n columns) and then that many
distinct columns, uniformly, and N(0, 1) values for them.  A row left
empty gets one unit entry in a random column.  Then x* ~ U[0.5, 1.5),
b = A x*, c ~ U[0.1, 1.1), and a quarter of the columns an upper bound
x*_j + 3 u.  Instance i draws from ``default_rng(seed0 + i)``.  A is
built sparse and returned dense, as ``generators.raw_instance`` has it.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from perfbench.generators import raw_instance


def sparse_lp(rng: np.random.Generator, m: int, n: int, density: float) -> sp.csr_matrix:
    """The m x n constraint matrix of one instance, as CSR with sorted rows."""
    counts = rng.binomial(n, density, size=m)
    empty = counts == 0
    counts[empty] = 1
    cols = np.concatenate([np.sort(rng.choice(n, size=int(k), replace=False)) for k in counts])
    vals = rng.standard_normal(cols.size)
    vals[np.repeat(empty, counts)] = 1.0
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return sp.csr_matrix((vals, cols, indptr), shape=(m, n))


def dense(A: sp.csr_matrix) -> np.ndarray:
    """A as a dense float64 array (twice as fast as ``toarray`` at this size)."""
    out = np.zeros(A.shape)
    out[np.repeat(np.arange(A.shape[0]), np.diff(A.indptr)), A.indices] = A.data
    return out


def generate(k, seed0, m, n, density) -> list:
    out = []
    for i in range(k):
        rng = np.random.default_rng(seed0 + i)
        A = sparse_lp(rng, m, n, density)
        xstar = rng.random(n) + 0.5
        b = A @ xstar
        c = rng.random(n) + 0.1
        uvar = np.full(n, np.inf)
        ub = rng.random(n) < 0.25
        uvar[ub] = xstar[ub] + 3 * rng.random(ub.sum())
        out.append(raw_instance(c, dense(A), b, uvar, None, f"sparse{i}"))
    return out
