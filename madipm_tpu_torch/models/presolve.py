"""Presolve pass: a copy of ``madipm_tpu/models/presolve.py`` (numpy and
scipy only), with the port's ``QuadraticModel`` and ``Status``.

Equivalent of the reference's ``presolve_qp`` (reference: src/utils.jl:319-343),
which delegates to QuadraticModels.presolve.  Implements the same class of
reductions natively:

- empty rows (0 = b: drop if consistent, else infeasible),
- singleton rows (a_ij x_j ~ b_i: fold into the bounds of x_j, drop the row),
- **redundant rows** (activity bounds inside [lcon, ucon]: drop, y = 0),
- **forcing rows** (activity bound touches lcon/ucon: fix every variable in
  the row at its forcing end, drop the row),
- **duplicate rows** (row_i = s * row_k: intersect the implied bounds on the
  shared linear form, drop row i),
- fixed variables (lvar == uvar: substitute into b and the objective),
- empty columns (variable in no constraint: pin to the bound selected by the
  gradient sign, detect unboundedness),
- **free / implied-free singleton columns** (x_j in exactly one equality
  row, its bounds implied inactive by the row: substitute
  x_j = (b_i - rest)/a_ij into the objective, drop row AND column),
- **duplicate columns** (col_j = s * col_k with c_j = s c_k, LP part:
  merge into one variable with interval-summed bounds),
- bound conflicts (lvar > uvar: infeasible).

The starred reductions are the QuadraticModels set that actually shrinks
Netlib instances (VERDICT round-2 directive #4).  Every reduction carries
an exact dual postsolve (:meth:`Postsolve.duals`); the original-model KKT
stationarity is pinned by tests/test_postsolve.py on randomized mixes.

Returns ``(model, flag, Postsolve)``; ``flag=False`` means presolve fully
resolved the problem (solved / infeasible / unbounded — matching the
reference's flag semantics) and ``Postsolve.status`` says which.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ..utils.status import Status
from .qp import INF, QuadraticModel


@dataclasses.dataclass
class Postsolve:
    """Maps a reduced-space solution back to the original variables/rows.

    Dual mapping (:meth:`duals`) reverses each reduction's effect on the
    multipliers — the role QuadraticModels.postsolve plays for the
    reference (consumed via src/utils.jl:327-343; stationarity convention
    ``c + Qx + A'y - zl + zu = 0`` as in src/kernels.jl:403-430):

    - dropped empty/redundant rows get y = 0 (never binding);
    - a singleton row folded into a variable bound reclaims the bound
      multiplier: if x_j ended active at the bound the ROW introduced,
      the row dual is ``y_i = -zl_j / a_ij`` (lower) / ``zu_j / a_ij``
      (upper) and the variable-bound dual is zeroed;
    - a duplicate row reclaims the kept row's dual when the binding
      merged bound was the one IT contributed: ``y_i = y_k / s``;
    - a free-singleton column's row recovers its dual from the original
      column's stationarity: ``y_i = -(c_j + (Qx)_j + sum_{i'!=i}
      a_i'j y_i') / a_ij`` (zl_j = zu_j = 0, the bounds were implied
      inactive);
    - a forcing row recovers ``y_i`` from dual feasibility of the
      variables it fixed: each needs its reduced cost on the correct side
      of zero for the single bound it sits at, which pins y_i to a
      nonempty interval (LP duality guarantees one);
    - eliminated (fixed / empty / forcing-fixed / duplicate) columns
      recover their reduced cost from original-data stationarity:
      ``r_j = c_j + (Qx)_j + (A'y)_j``, split as ``zl_j = max(r_j, 0)``,
      ``zu_j = max(-r_j, 0)``.
    """

    n_orig: int
    m_orig: int
    keep_cols: np.ndarray  # indices of surviving variables
    keep_rows: np.ndarray  # indices of surviving rows
    fixed_vals: np.ndarray  # [n_orig] values for eliminated variables (0 elsewhere)
    fixed_mask: np.ndarray  # [n_orig] bool
    status: Optional[Status] = None  # set when presolve resolved the problem
    #: singleton-row folds: (row, col, a_ij, lo, hi, tight_lo, tight_hi)
    #: where lo/hi are the bound candidates the row imposed on x_col and
    #: tight_* say whether they strictly tightened the variable's bound.
    singleton_rows: list = dataclasses.field(default_factory=list)
    #: chronological column eliminations with DYNAMIC values, replayed in
    #: reverse by :meth:`x`/:meth:`duals`.  Entries:
    #:   ("fs", j, i)                      free-singleton col j via row i
    #:   ("dup", j, k, s, anchor)          col j merged into col k
    #: (static-value eliminations — fixed/empty/forcing — live in
    #: fixed_vals/fixed_mask instead; their values need no replay.)
    col_elims: list = dataclasses.field(default_factory=list)
    #: duplicate-row merges: (i_dropped, k_kept, s, lo_from_i, hi_from_i)
    dup_rows: list = dataclasses.field(default_factory=list)
    #: forcing rows: (i, cols, at_lower_bool_array) — vars fixed by row i
    #: and which of their bounds they were forced to.
    forcing_rows: list = dataclasses.field(default_factory=list)
    #: the pre-reduction model (original data for dual stationarity).
    qp_orig: Optional[QuadraticModel] = None
    #: duplicate-column bounds snapshot at merge time: j -> (lj, uj, lk, uk)
    dup_bounds: dict = dataclasses.field(default_factory=dict)

    def x(self, x_red: np.ndarray) -> np.ndarray:
        out = self.fixed_vals.copy()
        out[self.keep_cols] = x_red
        qp = self.qp_orig
        A = qp.A.tocsr() if qp is not None else None
        for entry in reversed(self.col_elims):
            if entry[0] == "fs":
                _, j, i = entry
                # Row i was an equality at elimination: a_ij x_j + rest = b.
                # Original data + the (already recovered) other variables
                # reproduce the same equation (fixed-variable rhs shifts
                # cancel exactly).
                lo, hi = A.indptr[i], A.indptr[i + 1]
                cols, vals = A.indices[lo:hi], A.data[lo:hi]
                aij = vals[cols == j][0]
                rest = float(vals[cols != j] @ out[cols[cols != j]])
                out[j] = (0.5 * (qp.lcon[i] + qp.ucon[i]) - rest) / aij
            else:  # "dup": split w = x_k + s x_j back into (x_k, x_j)
                _, j, k, s, anchor = entry
                lj, uj, lk, uk = self.dup_bounds[j]
                w = out[k]
                xj = (w - anchor) / s
                xj = min(max(xj, lj), uj)
                out[j] = xj
                out[k] = w - s * xj
        return out

    def y(self, y_red: np.ndarray) -> np.ndarray:
        out = np.zeros(self.m_orig)
        out[self.keep_rows] = y_red
        return out

    def duals(self, x_full, y_red, zl_red, zu_red, tol: float = 1e-7):
        """Map reduced duals (y, zl, zu) back to the original space; see
        class docstring.  ``x_full`` is the already-postsolved primal."""
        y = self.y(np.asarray(y_red))
        zl = np.zeros(self.n_orig)
        zu = np.zeros(self.n_orig)
        zl[self.keep_cols] = np.asarray(zl_red)
        zu[self.keep_cols] = np.asarray(zu_red)
        qp = self.qp_orig
        A_csr = qp.A.tocsr() if qp is not None else None
        A_csc = qp.A.tocsc() if qp is not None else None

        # Duplicate rows (reverse order): if the binding merged bound was
        # contributed by the dropped row i (form s-scaled), move the kept
        # row's dual to it: constraint i is lcon_i <= s*form <= ucon_i, so
        # d/dx contributions satisfy y_k * a_k = (y_k / s) * a_i.
        for i, k, s, lo_from_i, hi_from_i in reversed(self.dup_rows):
            if y[k] == 0.0:
                continue
            # Which side is binding follows from the kept dual's sign under
            # the convention r = c + A'y (+Qx) - zl + zu = 0: an active
            # lower row bound has y < 0, an active upper one y > 0.
            # lo_from_i/hi_from_i were recorded AFTER mapping row i's
            # bounds onto the kept row's form (the s<0 swap already
            # happened at merge time), so they refer directly to the
            # merged interval's ends.
            binding_hi = y[k] > 0
            from_i = hi_from_i if binding_hi else lo_from_i
            if from_i:
                y[i] = y[k] / s
                y[k] = 0.0

        # Singleton rows (reverse order: later folds saw earlier bounds).
        for i, j, aij, lo, hi, tight_lo, tight_hi in reversed(self.singleton_rows):
            xs = abs(x_full[j]) + 1.0
            if tight_lo and np.isfinite(lo) and abs(x_full[j] - lo) <= tol * xs and zl[j] > 0:
                y[i] = -zl[j] / aij
                zl[j] = 0.0
            elif tight_hi and np.isfinite(hi) and abs(x_full[j] - hi) <= tol * xs and zu[j] > 0:
                y[i] = zu[j] / aij
                zu[j] = 0.0

        # Free-singleton columns (FORWARD chronological order): the
        # eliminated row's dual from the original column's stationarity.
        # zl_j = zu_j = 0 — the column's bounds were (implied) inactive by
        # construction.  Forward because column j's OTHER original entries
        # live in rows dropped before its elimination (else j was not a
        # singleton) — including earlier fs rows, whose y must be computed
        # first.
        for entry in self.col_elims:
            if entry[0] != "fs":
                continue
            _, j, i = entry
            lo, hi = A_csc.indptr[j], A_csc.indptr[j + 1]
            rows, vals = A_csc.indices[lo:hi], A_csc.data[lo:hi]
            aij = vals[rows == i][0]
            r0 = qp.c[j] + float(vals[rows != i] @ y[rows[rows != i]])
            if qp.Q is not None:
                r0 += float((qp.Q[j, :] @ x_full).ravel()[0])
            y[i] = -r0 / aij

        # Forcing rows (reverse order): pick y_i inside the dual-feasible
        # interval pinned by the variables the row fixed.  A variable at
        # its LOWER bound needs r_j = r_j^0 + a_ij y_i >= 0; at its UPPER
        # bound r_j <= 0.
        for i, cols, at_lower in reversed(self.forcing_rows):
            y_lo, y_hi = -np.inf, np.inf
            r0s = []
            for j, atl in zip(cols, at_lower):
                lo, hi = A_csc.indptr[j], A_csc.indptr[j + 1]
                rows, vals = A_csc.indices[lo:hi], A_csc.data[lo:hi]
                aij = float(vals[rows == i][0])
                mask = rows != i
                r0 = qp.c[j] + float(vals[mask] @ y[rows[mask]])
                if qp.Q is not None:
                    r0 += float((qp.Q[j, :] @ x_full).ravel()[0])
                r0s.append(r0)
                # want: r0 + aij*y_i >= 0 (lower) / <= 0 (upper)
                bound = -r0 / aij
                if (atl and aij > 0) or ((not atl) and aij < 0):
                    y_lo = max(y_lo, bound)
                else:
                    y_hi = min(y_hi, bound)
            if y_lo > y_hi + 1e-7 * (1.0 + abs(y_lo)):
                # Degenerate numerics: fall back to the closest point.
                yi = 0.5 * (y_lo + y_hi)
            else:
                yi = min(max(0.0, y_lo), y_hi)
            y[i] = yi

        # Eliminated columns: reduced cost from original-data stationarity.
        # Covers fixed / empty / forcing-fixed variables (fixed_mask) AND
        # both halves of each duplicate-column merge (the merged variable's
        # bounds differ from either original's, so its zl/zu are recomputed
        # from scratch too).
        stat_cols = set(np.flatnonzero(self.fixed_mask).tolist())
        for entry in self.col_elims:
            if entry[0] == "dup":
                stat_cols.add(entry[1])
                stat_cols.add(entry[2])
        def _recover_stationarity(idx):
            r = qp.c[idx] + np.asarray(qp.A[:, idx].T @ y).ravel()
            if qp.Q is not None:
                r = r + np.asarray(qp.Q[idx, :] @ x_full).ravel()
            zl[idx] = np.maximum(r, 0.0)
            zu[idx] = np.maximum(-r, 0.0)

        if stat_cols and qp is not None:
            _recover_stationarity(np.array(sorted(stat_cols), dtype=int))

        # Second singleton-row reclaim pass, for ELIMINATED columns: a
        # variable whose only row was a singleton row can later be fixed
        # (empty-column elimination) AT the row-imposed bound — strictly
        # inside its original bounds, where original zl/zu must be 0 and
        # the whole reduced cost belongs to the dropped row's dual.  The
        # first reclaim ran before the stationarity recovery (surviving
        # columns had their zl/zu from the solver); this one needs the
        # recovered r_j, so it runs after, then refreshes the remaining
        # stationarity columns (a reclaimed y_i can shift their r).
        if qp is not None:
            reclaimed = False
            for i, j, aij, lo, hi, tight_lo, tight_hi in reversed(self.singleton_rows):
                if not self.fixed_mask[j] or y[i] != 0.0:
                    continue
                xs = abs(x_full[j]) + 1.0
                at_lo = tight_lo and np.isfinite(lo) and abs(x_full[j] - lo) <= tol * xs
                at_hi = tight_hi and np.isfinite(hi) and abs(x_full[j] - hi) <= tol * xs
                if not (at_lo or at_hi):
                    continue
                r_j = qp.c[j] + float(qp.A[:, j].T @ y)
                if qp.Q is not None:
                    r_j += float((qp.Q[j, :] @ x_full).ravel()[0])
                if (at_lo and r_j > 0) or (at_hi and r_j < 0):
                    y[i] = -r_j / aij
                    zl[j] = 0.0
                    zu[j] = 0.0
                    stat_cols.discard(int(j))
                    reclaimed = True
            if reclaimed and stat_cols:
                _recover_stationarity(np.array(sorted(stat_cols), dtype=int))
        return y, zl, zu


def _row_activity_bounds(Ac, lvar, uvar):
    """Per-row [L, U] activity interval (inf-safe, vectorized).

    Eliminated columns are already structurally zero in ``Ac`` (every
    reduction zeroes the column), so no alive-masking is needed.
    """
    Ap = Ac.copy()
    Ap.data = np.maximum(Ap.data, 0.0)
    Ap.eliminate_zeros()
    An = Ac.copy()
    An.data = np.minimum(An.data, 0.0)
    An.eliminate_zeros()
    with np.errstate(invalid="ignore"):
        L = np.asarray(Ap @ lvar + An @ uvar).ravel()
        U = np.asarray(Ap @ uvar + An @ lvar).ravel()
    # inf - inf inside a row: the interval end is unknown -> unbounded.
    L[np.isnan(L)] = -np.inf
    U[np.isnan(U)] = np.inf
    return L, U


def presolve_qp(qp: QuadraticModel, max_passes: int = 5):
    """Run presolve reductions; see module docstring.

    Returns (reduced_model, flag, Postsolve).
    """
    n0, m0 = qp.nvar, qp.ncon
    lvar = qp.lvar.copy()
    uvar = qp.uvar.copy()
    lcon = qp.lcon.copy()
    ucon = qp.ucon.copy()
    c = qp.c.copy()
    c0 = qp.c0
    A = qp.A.tocsc(copy=True)
    Q = qp.Q.tocsc(copy=True) if qp.Q is not None else None

    col_alive = np.ones(n0, dtype=bool)
    row_alive = np.ones(m0, dtype=bool)
    fixed_vals = np.zeros(n0)
    fixed_mask = np.zeros(n0, dtype=bool)

    singleton_rows: list = []
    col_elims: list = []
    dup_rows: list = []
    forcing_rows: list = []
    dup_bounds: dict = {}

    def make_post(status=None):
        return Postsolve(
            n_orig=n0,
            m_orig=m0,
            keep_cols=np.flatnonzero(col_alive),
            keep_rows=np.flatnonzero(row_alive),
            fixed_vals=fixed_vals,
            fixed_mask=fixed_mask,
            status=status,
            singleton_rows=singleton_rows,
            col_elims=col_elims,
            dup_rows=dup_rows,
            forcing_rows=forcing_rows,
            qp_orig=qp,
            dup_bounds=dup_bounds,
        )

    def fail(status):
        return qp, False, make_post(status)

    def fix_variables(idx, vals):
        """Move columns ``idx`` into the rhs/objective at values ``vals``."""
        nonlocal A, Q, c0, c
        contrib = A[:, idx] @ vals
        lcon_ = np.isfinite(lcon)
        ucon_ = np.isfinite(ucon)
        lcon[lcon_] -= np.asarray(contrib).ravel()[lcon_]
        ucon[ucon_] -= np.asarray(contrib).ravel()[ucon_]
        c0_add = float(c[idx] @ vals)
        if Q is not None:
            qcol = Q[:, idx] @ vals
            c[:] = c + np.asarray(qcol).ravel()
            c0_add -= 0.5 * float(vals @ np.asarray(Q[np.ix_(idx, idx)].todense()) @ vals)
            Q = Q.tolil()
            Q[:, idx] = 0.0
            Q[idx, :] = 0.0
            Q = Q.tocsc()
        A = A.tolil()
        A[:, idx] = 0.0
        A = A.tocsc()
        fixed_vals[idx] = vals
        fixed_mask[idx] = True
        col_alive[idx] = False
        c[idx] = 0.0
        return c0_add

    tol = 1e-12
    for _ in range(max_passes):
        changed = False

        # Bound conflicts
        bad = col_alive & (lvar > uvar + tol)
        if bad.any():
            return fail(Status.PRESOLVE_INFEASIBLE)

        # Fix variables with equal bounds: move their column into the rhs.
        fix = col_alive & (np.abs(uvar - lvar) <= tol)
        if fix.any():
            idx = np.flatnonzero(fix)
            c0 += fix_variables(idx, 0.5 * (lvar[idx] + uvar[idx]))
            changed = True

        Ac = A.tocsr()
        row_nnz = np.diff(Ac.indptr)

        # Empty rows
        empty = row_alive & (row_nnz == 0)
        if empty.any():
            idx = np.flatnonzero(empty)
            viol = (lcon[idx] > 1e-9) | (ucon[idx] < -1e-9)
            if viol.any():
                return fail(Status.PRESOLVE_INFEASIBLE)
            row_alive[idx] = False
            changed = True

        # Singleton rows -> bounds
        single = row_alive & (row_nnz == 1)
        if single.any():
            for i in np.flatnonzero(single):
                j = Ac.indices[Ac.indptr[i]]
                aij = Ac.data[Ac.indptr[i]]
                if abs(aij) < tol:
                    continue
                lo, hi = lcon[i] / aij, ucon[i] / aij
                if aij < 0:
                    lo, hi = hi, lo
                tight_lo = np.isfinite(lo) and lo > lvar[j]
                tight_hi = np.isfinite(hi) and hi < uvar[j]
                singleton_rows.append(
                    (int(i), int(j), float(aij), float(lo), float(hi),
                     bool(tight_lo), bool(tight_hi))
                )
                lvar[j] = max(lvar[j], lo) if np.isfinite(lo) else lvar[j]
                uvar[j] = min(uvar[j], hi) if np.isfinite(hi) else uvar[j]
                row_alive[i] = False
                changed = True
            if (lvar > uvar + 1e-9).any():
                return fail(Status.PRESOLVE_INFEASIBLE)
            Ac = A.tocsr()
            row_nnz = np.diff(Ac.indptr)

        # Redundant / forcing rows via row-activity interval arithmetic.
        live_idx = np.flatnonzero(row_alive & (row_nnz > 0))
        if live_idx.size:
            L, U = _row_activity_bounds(Ac, lvar, uvar)
            ftol = 1e-9
            for i in live_idx:
                scale_i = 1.0 + max(abs(lcon[i]) if np.isfinite(lcon[i]) else 0.0,
                                    abs(ucon[i]) if np.isfinite(ucon[i]) else 0.0)
                if L[i] > ucon[i] + ftol * scale_i or U[i] < lcon[i] - ftol * scale_i:
                    return fail(Status.PRESOLVE_INFEASIBLE)
                lo_, hi_ = Ac.indptr[i], Ac.indptr[i + 1]
                cols, vals = Ac.indices[lo_:hi_], Ac.data[lo_:hi_]
                alive_sel = col_alive[cols]
                cols, vals = cols[alive_sel], vals[alive_sel]
                if cols.size == 0:
                    continue
                if np.isfinite(ucon[i]) and L[i] >= ucon[i] - ftol * scale_i:
                    # Forcing at the row's MINIMUM activity: every variable
                    # sits at its minimizing end (a>0 -> lower, a<0 -> upper).
                    at_lower = vals > 0
                    fvals = np.where(at_lower, lvar[cols], uvar[cols])
                    if not np.all(np.isfinite(fvals)):
                        continue  # infinite bound in a tight row: skip
                    forcing_rows.append((int(i), cols.tolist(), at_lower.tolist()))
                    c0 += fix_variables(cols, fvals)
                    row_alive[i] = False
                    changed = True
                elif np.isfinite(lcon[i]) and U[i] <= lcon[i] + ftol * scale_i:
                    at_lower = vals < 0
                    fvals = np.where(at_lower, lvar[cols], uvar[cols])
                    if not np.all(np.isfinite(fvals)):
                        continue
                    forcing_rows.append((int(i), cols.tolist(), at_lower.tolist()))
                    c0 += fix_variables(cols, fvals)
                    row_alive[i] = False
                    changed = True
                elif (L[i] >= lcon[i] - ftol * scale_i) and (
                    U[i] <= ucon[i] + ftol * scale_i
                ):
                    # Redundant: can never be violated; y = 0 is always
                    # dual-feasible for it.
                    row_alive[i] = False
                    changed = True
            if changed:
                Ac = A.tocsr()
                row_nnz = np.diff(Ac.indptr)

        # Duplicate rows: row_i = s * row_k -> merge bound intervals.
        live_idx = np.flatnonzero(row_alive & (row_nnz > 1))
        if live_idx.size > 1:
            sigs: dict = {}
            for i in live_idx:
                lo_, hi_ = Ac.indptr[i], Ac.indptr[i + 1]
                cols = Ac.indices[lo_:hi_]
                sel = col_alive[cols]
                cols_a = cols[sel]
                if cols_a.size < 2:
                    continue
                key = (cols_a.size, int(cols_a[0]), int(cols_a[-1]))
                sigs.setdefault(key, []).append(i)
            for key, rows_ in sigs.items():
                if len(rows_) < 2:
                    continue
                for a_pos in range(len(rows_)):
                    k = rows_[a_pos]
                    if not row_alive[k]:
                        continue
                    lo_, hi_ = Ac.indptr[k], Ac.indptr[k + 1]
                    colsk = Ac.indices[lo_:hi_]
                    selk = col_alive[colsk]
                    colsk, valsk = colsk[selk], Ac.data[lo_:hi_][selk]
                    for i in rows_[a_pos + 1:]:
                        if not row_alive[i]:
                            continue
                        lo2, hi2 = Ac.indptr[i], Ac.indptr[i + 1]
                        colsi = Ac.indices[lo2:hi2]
                        seli = col_alive[colsi]
                        colsi, valsi = colsi[seli], Ac.data[lo2:hi2][seli]
                        if colsi.size != colsk.size or not np.array_equal(colsi, colsk):
                            continue
                        s = valsi[0] / valsk[0]
                        if not np.allclose(valsi, s * valsk, rtol=1e-12, atol=1e-14):
                            continue
                        # Row i: lcon_i <= s*form <= ucon_i.  Intersect
                        # with row k's interval on `form`.
                        lo_i, hi_i = lcon[i] / s, ucon[i] / s
                        if s < 0:
                            lo_i, hi_i = hi_i, lo_i
                        lo_from_i = np.isfinite(lo_i) and lo_i > lcon[k]
                        hi_from_i = np.isfinite(hi_i) and hi_i < ucon[k]
                        new_lo = max(lcon[k], lo_i) if np.isfinite(lo_i) else lcon[k]
                        new_hi = min(ucon[k], hi_i) if np.isfinite(hi_i) else ucon[k]
                        if new_lo > new_hi + 1e-9 * (1.0 + abs(new_lo)):
                            return fail(Status.PRESOLVE_INFEASIBLE)
                        lcon[k], ucon[k] = new_lo, new_hi
                        dup_rows.append(
                            (int(i), int(k), float(s), bool(lo_from_i), bool(hi_from_i))
                        )
                        row_alive[i] = False
                        changed = True
            if changed:
                Ac = A.tocsr()
                row_nnz = np.diff(Ac.indptr)

        # Free / implied-free singleton columns on equality rows.
        col_nnz_alive = np.zeros(n0, dtype=int)
        Acc = A.tocsc()
        for j in np.flatnonzero(col_alive):
            lo_, hi_ = Acc.indptr[j], Acc.indptr[j + 1]
            rows = Acc.indices[lo_:hi_]
            col_nnz_alive[j] = int(np.sum(row_alive[rows] & (Acc.data[lo_:hi_] != 0)))
        qcol_zero = (
            np.ones(n0, dtype=bool)
            if Q is None
            else (np.abs(Q).sum(axis=0).A1 <= tol)
        )
        cand = np.flatnonzero(col_alive & (col_nnz_alive == 1) & qcol_zero)
        for j in cand:
            if not col_alive[j]:
                continue
            lo_, hi_ = Acc.indptr[j], Acc.indptr[j + 1]
            rows = Acc.indices[lo_:hi_]
            vals = Acc.data[lo_:hi_]
            sel = row_alive[rows] & (vals != 0)
            if np.sum(sel) != 1:
                # An earlier elimination in this same sweep dropped the
                # candidate's row (now an empty column: next pass) or the
                # count changed; re-examine later.
                continue
            i = int(rows[sel][0])
            aij = float(vals[sel][0])
            if not (np.isfinite(lcon[i]) and np.isfinite(ucon[i])
                    and abs(ucon[i] - lcon[i]) <= tol):
                continue  # equality rows only
            b_i = 0.5 * (lcon[i] + ucon[i])
            # Implied interval of x_j from the row & the other bounds.
            rlo, rhi = Ac.indptr[i], Ac.indptr[i + 1]
            rcols, rvals = Ac.indices[rlo:rhi], Ac.data[rlo:rhi]
            rsel = col_alive[rcols] & (rcols != j) & (rvals != 0)
            ocols, ovals = rcols[rsel], rvals[rsel]
            pos = ovals > 0
            lo_ends = np.where(pos, lvar[ocols], uvar[ocols])
            hi_ends = np.where(pos, uvar[ocols], lvar[ocols])
            if np.all(np.isfinite(lo_ends)) and np.all(np.isfinite(hi_ends)):
                Lr = float(ovals @ lo_ends)
                Ur = float(ovals @ hi_ends)
            else:
                Lr, Ur = -np.inf, np.inf
            imp_lo = (b_i - Ur) / aij
            imp_hi = (b_i - Lr) / aij
            if aij < 0:
                imp_lo, imp_hi = imp_hi, imp_lo
            stol = 1e-9 * (1.0 + abs(imp_lo) + abs(imp_hi))
            implied_free = (
                (not np.isfinite(lvar[j]) or (np.isfinite(imp_lo) and imp_lo >= lvar[j] - stol))
                and (not np.isfinite(uvar[j]) or (np.isfinite(imp_hi) and imp_hi <= uvar[j] + stol))
            )
            if not implied_free:
                continue
            # Substitute x_j = (b_i - rest)/a_ij into the objective.
            cj = float(c[j])
            c0 += cj * b_i / aij
            c[ocols] -= cj * ovals / aij
            c[j] = 0.0
            col_elims.append(("fs", int(j), int(i)))
            col_alive[j] = False
            row_alive[i] = False
            A = A.tolil()
            A[:, j] = 0.0
            A = A.tocsc()
            Ac = A.tocsr()
            Acc = A.tocsc()
            changed = True

        # Duplicate columns (LP part only): col_j = s * col_k, c_j = s c_k.
        if Q is None:
            Acc = A.tocsc()
            csigs: dict = {}
            for j in np.flatnonzero(col_alive):
                lo_, hi_ = Acc.indptr[j], Acc.indptr[j + 1]
                rows = Acc.indices[lo_:hi_]
                sel = row_alive[rows] & (Acc.data[lo_:hi_] != 0)
                rows_a = rows[sel]
                if rows_a.size == 0:
                    continue
                key = (rows_a.size, int(rows_a[0]), int(rows_a[-1]))
                csigs.setdefault(key, []).append(j)
            for key, cols_ in csigs.items():
                if len(cols_) < 2:
                    continue
                for a_pos in range(len(cols_)):
                    k = cols_[a_pos]
                    if not col_alive[k]:
                        continue
                    lo_, hi_ = Acc.indptr[k], Acc.indptr[k + 1]
                    rk = Acc.indices[lo_:hi_]
                    selk = row_alive[rk] & (Acc.data[lo_:hi_] != 0)
                    rk_, vk = rk[selk], Acc.data[lo_:hi_][selk]
                    for j in cols_[a_pos + 1:]:
                        if not (col_alive[j] and col_alive[k]):
                            continue
                        lo2, hi2 = Acc.indptr[j], Acc.indptr[j + 1]
                        rj = Acc.indices[lo2:hi2]
                        selj = row_alive[rj] & (Acc.data[lo2:hi2] != 0)
                        rj_, vj = rj[selj], Acc.data[lo2:hi2][selj]
                        if rj_.size != rk_.size or not np.array_equal(rj_, rk_):
                            continue
                        s = vj[0] / vk[0]
                        if not np.allclose(vj, s * vk, rtol=1e-12, atol=1e-14):
                            continue
                        if abs(c[j] - s * c[k]) > 1e-12 * (1.0 + abs(c[j])):
                            continue
                        # Merge: w = x_k + s x_j carried in slot k.
                        lj, uj, lk, uk = lvar[j], uvar[j], lvar[k], uvar[k]
                        slo = s * lj if s > 0 else s * uj
                        shi = s * uj if s > 0 else s * lj
                        new_lo = lk + slo  # -inf propagates correctly
                        new_hi = uk + shi
                        # Anchor for the primal split (see Postsolve.x):
                        # finite x_k bound preferred, else 0.
                        anchor = lk if np.isfinite(lk) else (uk if np.isfinite(uk) else 0.0)
                        dup_bounds[int(j)] = (float(lj), float(uj), float(lk), float(uk))
                        col_elims.append(("dup", int(j), int(k), float(s), float(anchor)))
                        lvar[k], uvar[k] = new_lo, new_hi
                        col_alive[j] = False
                        c[j] = 0.0
                        A = A.tolil()
                        A[:, j] = 0.0
                        A = A.tocsc()
                        Acc = A.tocsc()
                        changed = True

        # Empty columns (objective-only variables)
        col_nnz = np.zeros(n0, dtype=int)
        Acc = A.tocsc()
        for j in np.flatnonzero(col_alive):
            lo_, hi_ = Acc.indptr[j], Acc.indptr[j + 1]
            rows = Acc.indices[lo_:hi_]
            col_nnz[j] = int(np.sum(row_alive[rows] & (Acc.data[lo_:hi_] != 0)))
        qdiag_zero = (
            np.ones(n0, dtype=bool) if Q is None else (abs(Q).sum(axis=0).A1 <= tol)
        )
        empty_col = col_alive & (col_nnz == 0) & qdiag_zero
        if empty_col.any():
            idx = np.flatnonzero(empty_col)
            for j in idx:
                if c[j] > tol:
                    if not np.isfinite(lvar[j]):
                        return fail(Status.PRESOLVE_UNBOUNDED)
                    v = lvar[j]
                elif c[j] < -tol:
                    if not np.isfinite(uvar[j]):
                        return fail(Status.PRESOLVE_UNBOUNDED)
                    v = uvar[j]
                else:
                    v = np.clip(0.0, lvar[j], uvar[j])
                fixed_vals[j] = v
                fixed_mask[j] = True
                c0 += c[j] * v
                c[j] = 0.0
                col_alive[j] = False
            changed = True

        if not changed:
            break

    keep_cols = np.flatnonzero(col_alive)
    keep_rows = np.flatnonzero(row_alive)

    if keep_cols.size == 0:
        # Fully solved by presolve.
        post = make_post(Status.PRESOLVE_SOLVED)
        return qp, False, post

    A_red = A[:, keep_cols][keep_rows, :]
    Q_red = None
    if Q is not None:
        Q_red = Q[:, keep_cols][keep_cols, :]
        if Q_red.nnz == 0:
            Q_red = None

    reduced = QuadraticModel(
        c=c[keep_cols],
        A=A_red.tocsr(),
        lcon=lcon[keep_rows],
        ucon=ucon[keep_rows],
        lvar=lvar[keep_cols],
        uvar=uvar[keep_cols],
        Q=Q_red.tocsr() if Q_red is not None else None,
        c0=c0,
        x0=qp.x0[keep_cols],
        y0=qp.y0[keep_rows],
        name=qp.name,
        minimize=qp.minimize,
    )
    return reduced, True, make_post()
