"""Algebraic modeling front end: a copy of ``madipm_tpu/modeling.py``
whose ``Model.optimize`` calls the port's :func:`madipm_tpu_torch.madipm`.

    import madipm_tpu_torch as mtt

    m = mtt.Model("diet", device="cpu")      # device: a solver option
    x = m.add_variables(3, lb=0.0, name="x")
    m.add_constraint(x[0] + x[1] + x[2] == 1.0, name="budget")
    m.add_constraint(2.0 * x[0] - x[2] <= 0.5)
    m.minimize(x[0] + 2.0 * x[1] + 0.5 * x[0] * x[0])
    m.optimize()                              # or m.optimize(device="cuda")
    m.value(x), m.objective_value(), m.dual(...)

Expressions are affine/quadratic over scalar ``Var`` handles; the
``VarBlock`` of :meth:`Model.add_variables` takes ``A @ x``, ``c @ x`` and
elementwise bounds, so medium-size models build no Python expression
trees.  Maximization is a sign flip at solve time; keyword arguments of
``Model`` and ``optimize`` go to ``madipm`` (solver options, ``device``,
``dtype``, ``sparse``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

from .api import madipm
from .models.qp import INF, QuadraticModel
from .utils.stats import IPMStats
from .utils.status import Status

Number = (int, float, np.integer, np.floating)


def matmul(A, x: "VarBlock") -> "MatExpr":
    """``A @ x`` for a scipy.sparse ``A`` — sparse matrices raise inside
    their own ``__matmul__`` instead of returning NotImplemented, so Python
    never falls back to ``VarBlock.__rmatmul__``; use this helper for sparse
    constraint matrices (dense arrays dispatch through ``A @ x`` directly)."""
    return x.__rmatmul__(A)


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class AffExpr:
    """Scalar affine expression  sum_i coef_i x_i + const."""

    __slots__ = ("coefs", "const")
    __array_priority__ = 100.0  # beat numpy broadcasting in mixed ops

    def __init__(self, coefs: Optional[Dict[int, float]] = None, const: float = 0.0):
        self.coefs = coefs or {}
        self.const = float(const)

    # -- algebra ------------------------------------------------------------
    def _add(self, other, sign: float) -> "AffExpr":
        if isinstance(other, Number):
            return AffExpr(dict(self.coefs), self.const + sign * float(other))
        if isinstance(other, AffExpr):
            coefs = dict(self.coefs)
            for i, v in other.coefs.items():
                coefs[i] = coefs.get(i, 0.0) + sign * v
            return AffExpr(coefs, self.const + sign * other.const)
        if isinstance(other, QuadExpr):
            return QuadExpr._promote(self)._add(other, sign)
        return NotImplemented

    def __add__(self, other):
        return self._add(other, 1.0)

    __radd__ = __add__

    def __sub__(self, other):
        return self._add(other, -1.0)

    def __rsub__(self, other):
        return self.__neg__().__add__(other)

    def __neg__(self):
        return AffExpr({i: -v for i, v in self.coefs.items()}, -self.const)

    def __mul__(self, other):
        if isinstance(other, Number):
            s = float(other)
            return AffExpr({i: v * s for i, v in self.coefs.items()}, self.const * s)
        if isinstance(other, AffExpr):
            return QuadExpr.from_product(self, other)
        return NotImplemented

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Number):
            return self * (1.0 / float(other))
        return NotImplemented

    # -- comparisons build constraints ---------------------------------------
    def __le__(self, other):
        return _make_constraint(self, other, "<=")

    def __ge__(self, other):
        return _make_constraint(self, other, ">=")

    def __eq__(self, other):  # type: ignore[override]
        return _make_constraint(self, other, "==")

    def __hash__(self):  # keep AffExpr usable as dict key despite __eq__
        return id(self)

    def __repr__(self):
        terms = " + ".join(f"{v:g}*x[{i}]" for i, v in sorted(self.coefs.items()))
        return f"AffExpr({terms or '0'} + {self.const:g})"


class Var(AffExpr):
    """A single decision variable (an affine expression with one term)."""

    __slots__ = ("model", "index", "name")

    def __init__(self, model: "Model", index: int, name: str):
        super().__init__({index: 1.0}, 0.0)
        self.model = model
        self.index = index
        self.name = name

    def __repr__(self):
        return f"Var({self.name})"

    def __hash__(self):
        return hash((id(self.model), self.index))


class QuadExpr:
    """Scalar quadratic expression  1/2-free form: sum q_ij x_i x_j + affine.

    Quadratic coefficients are stored for unordered pairs (i<=j) as the FULL
    coefficient of the monomial x_i x_j (the reference stores the lower
    triangle of Q with JuMP's convention, parse_moi.jl:120-160; conversion to
    the solver's symmetric Q happens in :meth:`Model._build_qp`).
    """

    __slots__ = ("quad", "aff")
    __array_priority__ = 100.0

    def __init__(self, quad: Optional[Dict[Tuple[int, int], float]] = None,
                 aff: Optional[AffExpr] = None):
        self.quad = quad or {}
        self.aff = aff if aff is not None else AffExpr()

    @staticmethod
    def _promote(aff: AffExpr) -> "QuadExpr":
        return QuadExpr({}, AffExpr(dict(aff.coefs), aff.const))

    @staticmethod
    def from_product(a: AffExpr, b: AffExpr) -> "QuadExpr":
        quad: Dict[Tuple[int, int], float] = {}
        for i, vi in a.coefs.items():
            for j, vj in b.coefs.items():
                key = (i, j) if i <= j else (j, i)
                quad[key] = quad.get(key, 0.0) + vi * vj
        aff = AffExpr(
            {i: v * b.const for i, v in a.coefs.items()}, a.const * b.const
        )
        for j, v in b.coefs.items():
            aff.coefs[j] = aff.coefs.get(j, 0.0) + v * a.const
        return QuadExpr(quad, aff)

    def _add(self, other, sign: float) -> "QuadExpr":
        if isinstance(other, Number) or isinstance(other, AffExpr):
            return QuadExpr(dict(self.quad), self.aff._add(other, sign))
        if isinstance(other, QuadExpr):
            quad = dict(self.quad)
            for k, v in other.quad.items():
                quad[k] = quad.get(k, 0.0) + sign * v
            return QuadExpr(quad, self.aff._add(other.aff, sign))
        return NotImplemented

    def __add__(self, other):
        return self._add(other, 1.0)

    __radd__ = __add__

    def __sub__(self, other):
        return self._add(other, -1.0)

    def __rsub__(self, other):
        return (-self).__add__(other)

    def __neg__(self):
        return QuadExpr({k: -v for k, v in self.quad.items()}, -self.aff)

    def __mul__(self, other):
        if isinstance(other, Number):
            s = float(other)
            return QuadExpr({k: v * s for k, v in self.quad.items()}, self.aff * s)
        return NotImplemented

    __rmul__ = __mul__

    def __repr__(self):
        return f"QuadExpr({len(self.quad)} quad terms, {self.aff!r})"


# ---------------------------------------------------------------------------
# Vectorized variable block
# ---------------------------------------------------------------------------


class VarBlock:
    """A contiguous block of variables supporting vectorized modeling.

    ``A @ x`` (A a 2-D array / sparse matrix) and ``c @ x`` avoid scalar
    expression trees entirely: they produce :class:`MatExpr` / AffExpr built
    from the array data, so million-nonzero models assemble at numpy speed
    (the analogue of the reference's vectorized ``parse_constraints``
    COO assembly, parse_moi.jl:60-118).
    """

    __array_priority__ = 100.0

    def __init__(self, model: "Model", start: int, size: int, name: str):
        self.model = model
        self.start = start
        self.size = size
        self.name = name

    def __len__(self):
        return self.size

    def __iter__(self):
        return (self[i] for i in range(self.size))

    def __getitem__(self, i) -> Union[Var, "VarBlock"]:
        if isinstance(i, slice):
            idx = range(*i.indices(self.size))
            blk = VarBlock(self.model, self.start + idx.start, len(idx), self.name)
            if idx.step != 1:
                raise IndexError("VarBlock slices must be contiguous (step 1)")
            return blk
        i = int(i)
        if i < 0:
            i += self.size
        if not 0 <= i < self.size:
            raise IndexError(i)
        return self.model._vars[self.start + i]

    @property
    def indices(self) -> np.ndarray:
        return np.arange(self.start, self.start + self.size)

    # -- vectorized algebra ---------------------------------------------------
    def __rmatmul__(self, other):
        other = np.asarray(other) if not sp.issparse(other) else other
        if sp.issparse(other) or other.ndim == 2:
            M = sp.csr_matrix(other)
            if M.shape[1] != self.size:
                raise ValueError(f"shape mismatch: {M.shape} @ ({self.size},)")
            return MatExpr(self.model, self._expand(M), np.zeros(M.shape[0]))
        if other.ndim == 1:
            if other.shape[0] != self.size:
                raise ValueError(f"shape mismatch: {other.shape} @ ({self.size},)")
            return AffExpr(
                {int(self.start + i): float(v) for i, v in enumerate(other) if v != 0.0}
            )
        return NotImplemented

    def _expand(self, M: sp.csr_matrix) -> sp.csr_matrix:
        """Pad columns of M (size of this block) out to the full model width."""
        n = self.model.num_variables
        coo = M.tocoo()
        return sp.csr_matrix(
            (coo.data, (coo.row, coo.col + self.start)), shape=(M.shape[0], n)
        )

    def sum(self) -> AffExpr:
        return AffExpr({int(i): 1.0 for i in self.indices})

    def _vec(self) -> "MatExpr":
        return MatExpr(
            self.model,
            self._expand(sp.identity(self.size, format="csr")),
            np.zeros(self.size),
        )

    def __add__(self, other):
        return self._vec() + other

    __radd__ = __add__

    def __sub__(self, other):
        return self._vec() - other

    def __rsub__(self, other):
        return (-self._vec()) + other

    def __neg__(self):
        return -self._vec()

    def __mul__(self, other):
        return self._vec() * other

    __rmul__ = __mul__

    def __le__(self, other):
        return self._vec() <= other

    def __ge__(self, other):
        return self._vec() >= other

    def __eq__(self, other):  # type: ignore[override]
        return self._vec() == other

    def __hash__(self):
        return hash((id(self.model), self.start, self.size))


class MatExpr:
    """Vector-valued affine expression  M x + const (rows share the model)."""

    __array_priority__ = 100.0

    def __init__(self, model: "Model", M: sp.csr_matrix, const: np.ndarray):
        self.model = model
        self.M = M
        self.const = np.asarray(const, dtype=np.float64)

    def _coerce(self, other):
        if isinstance(other, Number):
            return np.full(self.M.shape[0], float(other))
        arr = np.asarray(other, dtype=np.float64)
        if arr.shape != (self.M.shape[0],):
            raise ValueError(f"shape mismatch: {arr.shape} vs ({self.M.shape[0]},)")
        return arr

    def __add__(self, other):
        if isinstance(other, MatExpr):
            return MatExpr(self.model, self.M + other.M, self.const + other.const)
        if isinstance(other, VarBlock):
            return self + other._vec()
        return MatExpr(self.model, self.M, self.const + self._coerce(other))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, (MatExpr, VarBlock)):
            return self + (-other)
        return MatExpr(self.model, self.M, self.const - self._coerce(other))

    def __rsub__(self, other):
        return (-self) + other

    def __neg__(self):
        return MatExpr(self.model, -self.M, -self.const)

    def __mul__(self, other):
        if isinstance(other, Number):
            return MatExpr(self.model, self.M * float(other), self.const * float(other))
        return NotImplemented

    __rmul__ = __mul__

    def __le__(self, other):
        return VecConstraint(self, np.full(self.M.shape[0], -INF), self._coerce(other) - self.const)

    def __ge__(self, other):
        return VecConstraint(self, self._coerce(other) - self.const, np.full(self.M.shape[0], INF))

    def __eq__(self, other):  # type: ignore[override]
        rhs = self._coerce(other) - self.const
        return VecConstraint(self, rhs.copy(), rhs.copy())

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# Constraints
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ScalarConstraint:
    expr: AffExpr
    lb: float
    ub: float


@dataclasses.dataclass
class VecConstraint:
    expr: MatExpr
    lb: np.ndarray
    ub: np.ndarray


@dataclasses.dataclass
class ConstraintRef:
    """Handle into the model's row space; use :meth:`Model.dual` /
    :meth:`Model.constraint_value` with it."""

    model: "Model"
    rows: np.ndarray
    name: str

    def __len__(self):
        return self.rows.size


def _make_constraint(lhs: AffExpr, rhs, sense: str) -> ScalarConstraint:
    if isinstance(rhs, AffExpr):
        expr = lhs._add(rhs, -1.0)
        val = -expr.const
        expr = AffExpr(expr.coefs, 0.0)
    elif isinstance(rhs, Number):
        expr = AffExpr(dict(lhs.coefs), 0.0)
        val = float(rhs) - lhs.const
    else:
        return NotImplemented
    if sense == "<=":
        return ScalarConstraint(expr, -INF, val)
    if sense == ">=":
        return ScalarConstraint(expr, val, INF)
    return ScalarConstraint(expr, val, val)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


class Model:
    """Algebraic model: variables, linear constraints, LP/QP objective.

    The Python analogue of building a JuMP model over ``MadIPM.Optimizer``
    (reference: README.md:24-34, ext/MadIPMMathOptInterfaceExt/).  Collects
    the same data ``copy_to`` extracts (parse_moi.jl:168-215) and hands a
    ``QuadraticModel`` to :func:`madipm`.
    """

    def __init__(self, name: str = "model", **options):
        self.name = name
        self.options = dict(options)
        self._vars: list = []
        self._lb: list = []
        self._ub: list = []
        self._start: list = []
        self._rows: list = []  # list of (csr block over current width | dict, lb, ub)
        self._row_names: list = []
        self._objective: Union[AffExpr, QuadExpr, None] = None
        self._sense = "min"
        self._stats: Optional[IPMStats] = None

    # -- variables ------------------------------------------------------------
    @property
    def num_variables(self) -> int:
        return len(self._vars)

    @property
    def num_constraints(self) -> int:
        return sum(r.lb.size if isinstance(r, VecConstraint) else 1 for r in self._rows)

    def add_variable(self, lb: float = -INF, ub: float = INF, name: Optional[str] = None,
                     start: float = 0.0) -> Var:
        """Add one variable with bounds (MOI add_variable + VariableIndex-in-
        Interval, parse_moi.jl:22-58)."""
        i = len(self._vars)
        v = Var(self, i, name or f"x[{i}]")
        self._vars.append(v)
        self._lb.append(float(lb))
        self._ub.append(float(ub))
        self._start.append(float(start))
        return v

    def add_variables(self, size: int, lb=-INF, ub=INF, name: str = "x",
                      start=0.0) -> VarBlock:
        """Add a contiguous block of ``size`` variables; bounds/starts may be
        scalars or arrays."""
        lb = np.broadcast_to(np.asarray(lb, dtype=np.float64), (size,))
        ub = np.broadcast_to(np.asarray(ub, dtype=np.float64), (size,))
        start = np.broadcast_to(np.asarray(start, dtype=np.float64), (size,))
        blk = VarBlock(self, len(self._vars), size, name)
        for i in range(size):
            v = Var(self, len(self._vars), f"{name}[{i}]")
            self._vars.append(v)
            self._lb.append(float(lb[i]))
            self._ub.append(float(ub[i]))
            self._start.append(float(start[i]))
        return blk

    def set_lower_bound(self, v: Var, lb: float):
        self._lb[v.index] = float(lb)

    def set_upper_bound(self, v: Var, ub: float):
        self._ub[v.index] = float(ub)

    def set_start_value(self, v: Var, x0: float):
        """Warm start (MOI VariablePrimalStart, parse_moi.jl:40-44)."""
        self._start[v.index] = float(x0)

    # -- constraints ------------------------------------------------------------
    def add_constraint(self, con: Union[ScalarConstraint, VecConstraint],
                       name: Optional[str] = None) -> ConstraintRef:
        """Add ``expr <= / >= / ==`` constraint(s) built by expression
        comparison (MOI ScalarAffineFunction/VectorAffineFunction-in-set
        ingestion, parse_moi.jl:60-118)."""
        if not isinstance(con, (ScalarConstraint, VecConstraint)):
            raise TypeError(
                f"add_constraint expects a comparison of expressions, got {type(con)}"
            )
        row0 = self.num_constraints
        self._rows.append(con)
        k = con.lb.size if isinstance(con, VecConstraint) else 1
        ref = ConstraintRef(self, np.arange(row0, row0 + k), name or f"c[{row0}]")
        self._row_names.append(ref.name)
        return ref

    def add_constraints(self, cons: Sequence, name: Optional[str] = None):
        return [self.add_constraint(c, name=name) for c in cons]

    # -- objective ------------------------------------------------------------
    def set_objective(self, expr, sense: str = "min"):
        if isinstance(expr, VarBlock):
            expr = expr.sum()
        if isinstance(expr, Number):
            expr = AffExpr({}, float(expr))
        if not isinstance(expr, (AffExpr, QuadExpr)):
            raise TypeError(f"objective must be affine or quadratic, got {type(expr)}")
        if sense not in ("min", "max"):
            raise ValueError(sense)
        self._objective = expr
        self._sense = sense

    def minimize(self, expr):
        self.set_objective(expr, "min")

    def maximize(self, expr):
        self.set_objective(expr, "max")

    # -- assembly ------------------------------------------------------------
    def _build_qp(self) -> QuadraticModel:
        n = self.num_variables
        m = self.num_constraints
        blocks, lcon, ucon = [], [], []
        for con in self._rows:
            if isinstance(con, VecConstraint):
                M = con.expr.M
                if M.shape[1] < n:  # model grew after the expression was built
                    M = sp.csr_matrix(
                        (M.tocoo().data, (M.tocoo().row, M.tocoo().col)),
                        shape=(M.shape[0], n),
                    )
                blocks.append(M)
                lcon.append(con.lb)
                ucon.append(con.ub)
            else:
                idx = np.fromiter(con.expr.coefs.keys(), dtype=np.int64,
                                  count=len(con.expr.coefs))
                val = np.fromiter(con.expr.coefs.values(), dtype=np.float64,
                                  count=len(con.expr.coefs))
                blocks.append(
                    sp.csr_matrix((val, (np.zeros_like(idx), idx)), shape=(1, n))
                )
                lcon.append(np.array([con.lb]))
                ucon.append(np.array([con.ub]))
        A = sp.vstack(blocks, format="csr") if blocks else sp.csr_matrix((0, n))
        lcon = np.concatenate(lcon) if lcon else np.zeros(0)
        ucon = np.concatenate(ucon) if ucon else np.zeros(0)

        obj = self._objective if self._objective is not None else AffExpr()
        if isinstance(obj, QuadExpr):
            aff, quad = obj.aff, obj.quad
        else:
            aff, quad = obj, {}
        c = np.zeros(n)
        for i, v in aff.coefs.items():
            c[i] = v
        Q = None
        if quad:
            ii = np.fromiter((k[0] for k in quad), dtype=np.int64, count=len(quad))
            jj = np.fromiter((k[1] for k in quad), dtype=np.int64, count=len(quad))
            vv = np.fromiter(quad.values(), dtype=np.float64, count=len(quad))
            # monomial coefficient q_ij (i<j) contributes Q_ij = Q_ji = q_ij;
            # diagonal x_i^2 coefficient d contributes Q_ii = 2 d  (so that
            # 1/2 x'Qx reproduces the modeled polynomial).
            vv = np.where(ii == jj, 2.0 * vv, vv)
            Q = sp.csr_matrix((vv, (ii, jj)), shape=(n, n))
        return QuadraticModel(
            c=c,
            A=A,
            lcon=lcon,
            ucon=ucon,
            lvar=np.asarray(self._lb, dtype=np.float64),
            uvar=np.asarray(self._ub, dtype=np.float64),
            Q=Q,
            c0=aff.const,
            x0=np.asarray(self._start, dtype=np.float64),
            name=self.name,
            minimize=self._sense == "min",
        )

    # -- solve & results --------------------------------------------------------
    def optimize(self, **options) -> IPMStats:
        """Build the QuadraticModel and solve (MOI.optimize!,
        MOI_wrapper.jl:99-113)."""
        opts = {**self.options, **options}
        self._stats = madipm(self._build_qp(), **opts)
        return self._stats

    def _require_solved(self) -> IPMStats:
        if self._stats is None:
            raise RuntimeError("call optimize() first")
        return self._stats

    def value(self, x) -> Union[float, np.ndarray]:
        """Primal value of a Var / VarBlock / expression (MOI VariablePrimal,
        MOI_wrapper.jl:162-170)."""
        st = self._require_solved()
        sol = st.solution
        if isinstance(x, Var):
            return float(sol[x.index])
        if isinstance(x, VarBlock):
            return sol[x.indices].copy()
        if isinstance(x, AffExpr):
            return float(
                sum(v * sol[i] for i, v in x.coefs.items()) + x.const
            )
        if isinstance(x, QuadExpr):
            base = self.value(x.aff)
            return float(
                base + sum(v * sol[i] * sol[j] for (i, j), v in x.quad.items())
            )
        if isinstance(x, MatExpr):
            return x.M[:, : sol.size] @ sol + x.const
        raise TypeError(type(x))

    def objective_value(self) -> float:
        return self._require_solved().objective

    def dual(self, ref: ConstraintRef) -> np.ndarray:
        """Constraint duals as shadow prices, d(objective)/d(rhs) — the
        JuMP sign convention for a minimization problem (the reference's MOI
        wrapper leaves ConstraintDual unimplemented — MOI_wrapper.jl:172-175
        returns NO_SOLUTION; we expose the IPM multipliers, negated from the
        MadNLP internal convention c + A'y - zl + zu = 0)."""
        st = self._require_solved()
        d = -st.multipliers[ref.rows]
        return float(d[0]) if d.size == 1 else d

    def reduced_costs(self) -> np.ndarray:
        """zl - zu for every variable (bound duals)."""
        st = self._require_solved()
        return st.multipliers_L - st.multipliers_U

    def termination_status(self) -> Status:
        return self._require_solved().status

    @property
    def is_solved(self) -> bool:
        return self._stats is not None and self._stats.success

    def solve_time(self) -> float:
        """MOI SolveTimeSec (MOI_wrapper.jl:177-179)."""
        return self._require_solved().total_time
