"""Problem data model.

Host half: copy of ``madipm_tpu/models/qp.py`` (``QuadraticModel``,
``from_dense``, ``standard_form``, ``slack_form``), numpy and scipy only.

Device half: :class:`TorchQP`, the counterpart of ``DeviceQP``.  It holds
the padded dense standard-form problem as tensors with a leading batch
dimension (one lane per instance, where the JAX package used ``vmap``),
with the same fields and the same masks, so that both packages compute on
the same padded data.  With a column group (``parallel/schur.shard_columns``)
a TorchQP is one rank's part of a problem split over a mesh axis: its
products end in the collectives of ``utils/comm.py``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import ozaki
from ..utils import comm
from ..utils.logging import spanned

INF = float("inf")

#: bytes of the dense operand read by the products of :class:`TorchQP`
#: (``matvec``, ``rmatvec``: A; ``qmatvec``: Q), each in its stored dtype
#: and, on a mesh, this rank's block, by whatever route the product takes
#: (an Ozaki product counts A's bytes, not its slices')
product_bytes = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _as_csr(a, m, n) -> sp.csr_matrix:
    if a is None:
        return sp.csr_matrix((m, n))
    if sp.issparse(a):
        return a.tocsr().astype(np.float64)
    return sp.csr_matrix(np.asarray(a, dtype=np.float64).reshape(m, n))


@dataclasses.dataclass
class QuadraticModel:
    """General-form convex QP (host side, float64, scipy.sparse).

    min  c0 + c'x + 1/2 x' Q x
    s.t. lcon <= A x <= ucon
         lvar <= x <= uvar
    """

    c: np.ndarray
    A: sp.csr_matrix
    lcon: np.ndarray
    ucon: np.ndarray
    lvar: np.ndarray
    uvar: np.ndarray
    Q: Optional[sp.csr_matrix] = None
    c0: float = 0.0
    x0: Optional[np.ndarray] = None
    y0: Optional[np.ndarray] = None
    name: str = "qp"
    minimize: bool = True

    def __post_init__(self):
        self.c = np.asarray(self.c, dtype=np.float64).ravel()
        n = self.c.shape[0]
        self.lvar = np.asarray(self.lvar, dtype=np.float64).ravel()
        self.uvar = np.asarray(self.uvar, dtype=np.float64).ravel()
        self.lcon = np.asarray(self.lcon, dtype=np.float64).ravel()
        self.ucon = np.asarray(self.ucon, dtype=np.float64).ravel()
        m = self.lcon.shape[0]
        self.A = _as_csr(self.A, m, n)
        if self.A.shape != (m, n):
            raise ValueError(f"A has shape {self.A.shape}, expected {(m, n)}")
        if self.Q is not None and self.Q.nnz == 0:
            self.Q = None
        if self.Q is not None:
            Q = _as_csr(self.Q, n, n)
            # Symmetrize: accept lower-triangular or full input.
            QT = Q.T.tocsr()
            D = sp.diags(Q.diagonal())
            if abs(Q - QT).sum() > 1e-12 * max(1.0, abs(Q).sum()):
                Q = Q + QT - D
            self.Q = Q.tocsr()
        if self.x0 is None:
            self.x0 = np.zeros(n)
        else:
            self.x0 = np.asarray(self.x0, dtype=np.float64).ravel()
        if self.y0 is None:
            self.y0 = np.zeros(m)
        else:
            self.y0 = np.asarray(self.y0, dtype=np.float64).ravel()

    @property
    def nvar(self) -> int:
        return self.c.shape[0]

    @property
    def ncon(self) -> int:
        return self.lcon.shape[0]

    @property
    def nnzj(self) -> int:
        return self.A.nnz

    @property
    def nnzh(self) -> int:
        return 0 if self.Q is None else sp.tril(self.Q).nnz

    @property
    def is_qp(self) -> bool:
        return self.Q is not None

    def obj(self, x: np.ndarray) -> float:
        v = self.c0 + self.c @ x
        if self.Q is not None:
            v += 0.5 * x @ (self.Q @ x)
        return float(v)

    def cons(self, x: np.ndarray) -> np.ndarray:
        return self.A @ x

    def grad(self, x: np.ndarray) -> np.ndarray:
        g = self.c.copy()
        if self.Q is not None:
            g = g + self.Q @ x
        return g


def from_dense(c, A, lcon, ucon, lvar, uvar, Q=None, **kw) -> QuadraticModel:
    """Convenience constructor from dense arrays."""
    A = sp.csr_matrix(np.atleast_2d(np.asarray(A, dtype=np.float64)))
    if Q is not None:
        Q = sp.csr_matrix(np.asarray(Q, dtype=np.float64))
    return QuadraticModel(c=c, A=A, lcon=lcon, ucon=ucon, lvar=lvar, uvar=uvar, Q=Q, **kw)


@dataclasses.dataclass
class StandardFormMap:
    """Undo record for :func:`standard_form` (primal and dual maps)."""

    n: int  # original variable count
    m: int  # original row count
    ind_ineq: np.ndarray  # inequality rows that got slacks
    ind_rng: np.ndarray  # range-bounded entries of [x; s] with moved ub

    def duals(self, y_std, zl_std, zu_std):
        y = np.asarray(y_std)[: self.m].copy()
        zl = np.asarray(zl_std)[: self.n].copy()
        zu = np.asarray(zu_std)[: self.n].copy()
        for k, idx in enumerate(self.ind_rng):
            if idx < self.n:  # variable (not slack) upper bound moved
                zu[idx] = max(float(np.asarray(y_std)[self.m + k]), 0.0)
        return y, zl, zu

    def x(self, x_std):
        return np.asarray(x_std)[: self.n]


def standard_form(qp: QuadraticModel, return_map: bool = False):
    """Slacks for inequality rows; every range-bounded variable or slack
    gets its upper bound moved into an extra equality row ``x + w = xu``."""
    n, m = qp.nvar, qp.ncon
    lvar, uvar, lcon, ucon = qp.lvar, qp.uvar, qp.lcon, qp.ucon

    ind_ineq = np.flatnonzero(lcon < ucon)
    ns = ind_ineq.size

    ind_rng: list[int] = []
    xu_vals: list[float] = []
    for i in range(n):
        if lvar[i] == uvar[i]:
            continue  # fixed variable: keep as-is
        if -INF < lvar[i] < uvar[i] < INF:
            ind_rng.append(i)
            xu_vals.append(uvar[i])
    for k, i in enumerate(ind_ineq):
        if -INF < lcon[i] < ucon[i] < INF:
            ind_rng.append(n + k)
            xu_vals.append(ucon[i])
    ind_rng = np.asarray(ind_rng, dtype=np.int64)
    xu_vals = np.asarray(xu_vals, dtype=np.float64)
    nw = ind_rng.size

    nvar = n + ns + nw
    ncon = m + nw

    coo = qp.A.tocoo()
    Bi = np.concatenate([ind_ineq, np.repeat(np.arange(m, m + nw), 2)])
    Bj_rng = np.empty(2 * nw, dtype=np.int64)
    Bj_rng[0::2] = ind_rng
    Bj_rng[1::2] = n + ns + np.arange(nw)
    Bj = np.concatenate([n + np.arange(ns), Bj_rng])
    Bx = np.concatenate([-np.ones(ns), np.ones(2 * nw)])
    A_new = sp.csr_matrix(
        (
            np.concatenate([coo.data, Bx]),
            (np.concatenate([coo.row, Bi]), np.concatenate([coo.col, Bj])),
        ),
        shape=(ncon, nvar),
    )

    lcon_new = np.zeros(ncon)
    ucon_new = np.zeros(ncon)
    eq_mask = lcon == ucon
    lcon_new[:m] = np.where(eq_mask, lcon, 0.0)
    ucon_new[:m] = np.where(eq_mask, ucon, 0.0)
    lcon_new[m:] = xu_vals
    ucon_new[m:] = xu_vals

    lvar_new = np.concatenate([lvar, lcon[ind_ineq], np.zeros(nw)])
    uvar_new = np.concatenate([uvar, ucon[ind_ineq], np.full(nw, INF)])
    uvar_new[ind_rng] = INF
    fixed = np.flatnonzero(lvar == uvar)
    uvar_new[fixed] = uvar[fixed]

    Q_new = None
    if qp.Q is not None:
        Q_new = sp.bmat(
            [[qp.Q, None], [None, sp.csr_matrix((ns + nw, ns + nw))]], format="csr"
        )

    out = QuadraticModel(
        c=np.concatenate([qp.c, np.zeros(ns + nw)]),
        A=A_new,
        lcon=lcon_new,
        ucon=ucon_new,
        lvar=lvar_new,
        uvar=uvar_new,
        Q=Q_new,
        c0=qp.c0,
        x0=np.concatenate([qp.x0, np.zeros(ns + nw)]),
        y0=np.concatenate([qp.y0, np.zeros(nw)]),
        name=qp.name,
        minimize=qp.minimize,
    )
    if return_map:
        return out, StandardFormMap(n=n, m=m, ind_ineq=ind_ineq, ind_rng=ind_rng)
    return out


def slack_form(qp: QuadraticModel) -> QuadraticModel:
    """Add slacks so every constraint is an equality: ``A x - s = 0``
    (range bounds stay two-sided)."""
    m, n = qp.ncon, qp.nvar
    ind_ineq = np.flatnonzero(qp.lcon < qp.ucon)
    ns = ind_ineq.size
    if ns == 0:
        return qp
    S = sp.csr_matrix(
        (-np.ones(ns), (ind_ineq, np.arange(ns))),
        shape=(m, ns),
    )
    A_new = sp.hstack([qp.A, S], format="csr")
    eq = qp.lcon == qp.ucon
    b = np.where(eq, qp.lcon, 0.0)
    Q_new = None
    if qp.Q is not None:
        Q_new = sp.bmat([[qp.Q, None], [None, sp.csr_matrix((ns, ns))]], format="csr")
    s0 = np.clip(qp.A @ qp.x0, qp.lcon, qp.ucon)[ind_ineq]
    return QuadraticModel(
        c=np.concatenate([qp.c, np.zeros(ns)]),
        A=A_new,
        lcon=b,
        ucon=b,
        lvar=np.concatenate([qp.lvar, qp.lcon[ind_ineq]]),
        uvar=np.concatenate([qp.uvar, qp.ucon[ind_ineq]]),
        Q=Q_new,
        c0=qp.c0,
        x0=np.concatenate([qp.x0, s0]),
        y0=qp.y0,
        name=qp.name,
        minimize=qp.minimize,
    )


def _round_up(x: int, mult: int) -> int:
    return max(mult, ((x + mult - 1) // mult) * mult)


#: TorchQP fields that hold masks (bool); every other tensor is floating.
_MASK_FIELDS = ("row_mask", "col_mask")
#: TorchQP fields that the numpy form lacks: the column-sharded layout and
#: the Ozaki slices
_LAYOUT_FIELDS = ("group", "A_rows", "A_sl", "At_sl", "Q_sl")


@dataclasses.dataclass(frozen=True, eq=False)
class TorchQP:
    """Padded, dense, standard-form problems, one per lane of the batch.

    Shapes: ``A`` (B, m, n); ``c``, ``lb``, ``ub``, ``x0``, ``col_mask``
    (B, n); ``b``, ``y0``, ``row_mask`` (B, m); ``c0`` (B, 1).  All
    constraints are equalities ``A x = b``; absent bounds are +-inf.
    Fixed (lb == ub) and padded columns are pinned out of the KKT system;
    padded rows are masked out of every reduction.  Instances are
    immutable: bound and scaling updates return a new object
    (``dataclasses.replace``), so the derived masks are cached per object.

    With ``group`` (a process group of P ranks, this rank p) ``A`` is
    this rank's column block (B, m, n/P), columns [p n/P, (p+1) n/P), ``Q``
    its row strip (B, n/P, n) and ``A_rows``, when kept, its row block of A
    (B, m/P, n); every vector stays whole and the same on every rank.  The
    products then reduce over the group: A x is summed, A' y and Q x are
    gathered, so their results are replicated too.
    """

    c: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    Q: Optional[torch.Tensor]  # (B, n, n) or None for LP
    c0: torch.Tensor
    row_mask: torch.Tensor
    col_mask: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor
    #: the column group (None: this process holds the whole problem)
    group: Optional[object] = None
    #: this rank's row block of A, for the distributed K1 assembly
    A_rows: Optional[torch.Tensor] = None
    #: Ozaki slices of A, A' and Q (ops/ozaki.py), present only when the
    #: solver runs its fp64 products through them; built after the row and
    #: objective scaling (driver.initialize), since they snapshot the values
    A_sl: Optional[object] = None
    At_sl: Optional[object] = None
    Q_sl: Optional[object] = None

    @classmethod
    def from_numpy(cls, fields: dict, device=None, dtype=torch.float64) -> "TorchQP":
        """Build from numpy arrays named as the ``DeviceQP`` fields, either
        one instance (``A`` of shape (m, n)) or a stack ((B, m, n))."""
        batched = np.ndim(fields["A"]) == 3
        kw = {}
        for f in dataclasses.fields(cls):
            v = fields.get(f.name)
            if v is None or f.name in _LAYOUT_FIELDS:
                kw[f.name] = None
                continue
            v = np.array(v)  # a writable copy
            if not batched:
                v = v[None]
            if f.name == "c0":
                v = v.reshape(-1, 1)
            dt = torch.bool if f.name in _MASK_FIELDS else dtype
            kw[f.name] = torch.as_tensor(v, dtype=dt, device=device)
        return cls(**kw)

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def m(self) -> int:
        return self.b.shape[-1]

    @property
    def batch(self) -> int:
        return self.c.shape[0]

    @property
    def is_qp(self) -> bool:
        return self.Q is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    @property
    def device(self) -> torch.device:
        return self.c.device

    @property
    def dense_A(self) -> torch.Tensor:
        """The dense Jacobian (B, m, n), which the AUGMENTED systems need."""
        if self.group is not None:
            raise NotImplementedError("a column-sharded problem holds no whole A")
        return self.A

    @cached_property
    def free_mask(self) -> torch.Tensor:
        """Live, non-fixed variables: the columns the KKT system sees."""
        return self.col_mask & (self.lb < self.ub)

    @cached_property
    def has_lb(self) -> torch.Tensor:
        return self.free_mask & torch.isfinite(self.lb)

    @cached_property
    def has_ub(self) -> torch.Tensor:
        return self.free_mask & torch.isfinite(self.ub)

    def cols(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's block of an n-vector (the whole vector without a group)."""
        if self.group is None:
            return v
        nb = self.A.shape[-1]
        p = comm.rank(self.group)
        return v[..., p * nb:(p + 1) * nb]

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's block of an m-vector, the rows of ``A_rows``."""
        mb = self.A_rows.shape[-2]
        p = comm.rank(self.group)
        return v[..., p * mb:(p + 1) * mb]

    @spanned("madipm.qp.matvec")
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x per lane: (B, n) -> (B, m); through the Ozaki slices when
        they are present and x is fp64."""
        global product_bytes
        product_bytes += _nbytes(self.A)
        if self.A_sl is not None and x.dtype == torch.float64:
            ax = ozaki.apply(self.A_sl, self.cols(x))
        else:
            ax = torch.bmm(self.A, self.cols(x).unsqueeze(-1)).squeeze(-1)
        return ax if self.group is None else comm.all_sum(ax, self.group)

    @spanned("madipm.qp.rmatvec")
    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A' @ y per lane: (B, m) -> (B, n).  In fp64 it takes the stored
        transposed slices, or with shared slices (``At_sl`` None, ``A_sl``
        present) the transposed contraction of the forward ones."""
        global product_bytes
        product_bytes += _nbytes(self.A)
        if y.dtype == torch.float64 and self.At_sl is not None:
            aty = ozaki.apply(self.At_sl, y)
        elif y.dtype == torch.float64 and self.A_sl is not None:
            aty = ozaki.apply_t(self.A_sl, y)
        else:
            aty = torch.bmm(y.unsqueeze(-2), self.A).squeeze(-2)
        return aty if self.group is None else comm.gather_last(aty, self.group)

    def with_ozaki(self, variant: str = "bf16", share_slices: bool = False,
                   n_slices: Optional[int] = None) -> "TorchQP":
        """Copy carrying Ozaki slices of A, of A' (unless ``share_slices``:
        A' products then contract the forward slices) and of Q.

        ``variant`` "bf16" (``n_slices`` slices, default ozaki.N_SLICES) or
        "i8" (ozaki.N8_SLICES int8 slices).  Call it after any scaling of A
        or Q.  The shapes must be multiples of ozaki.CHUNK (the padding
        gives it); otherwise self is returned unchanged.  With a group each
        rank slices its own column block of A and row strip of Q."""
        m, n = self.A.shape[-2:]
        if m % ozaki.CHUNK or n % ozaki.CHUNK:
            return self
        return dataclasses.replace(
            self,
            A_sl=ozaki.slice_any(self.A, variant, n_slices),
            At_sl=None if share_slices else ozaki.slice_any(self.A.mT, variant, n_slices),
            Q_sl=None if self.Q is None else ozaki.slice_any(self.Q, variant, n_slices),
        )

    def row_inf_norm(self) -> torch.Tensor:
        """max_j |A_ij| per row."""
        amax = torch.amax(torch.abs(self.A), dim=-1)
        return amax if self.group is None else comm.all_max(amax, self.group)

    def scale_rows(self, con_scale: torch.Tensor) -> "TorchQP":
        """Copy with the rows of A scaled (b is scaled by the caller); any
        Ozaki slices of A are dropped (driver.initialize rebuilds them)."""
        A_rows = self.A_rows
        if A_rows is not None:
            A_rows = A_rows * self.rows(con_scale).unsqueeze(-1)
        return dataclasses.replace(self, A=self.A * con_scale.unsqueeze(-1), A_rows=A_rows,
                                   A_sl=None, At_sl=None)

    def scale_quad(self, obj_scale: torch.Tensor) -> "TorchQP":
        """Copy with Q scaled by the objective scaling (identity for an LP);
        any Ozaki slices of Q are dropped."""
        if self.Q is None:
            return self
        return dataclasses.replace(self, Q=self.Q * obj_scale.unsqueeze(-1), Q_sl=None)

    def assemble_normal_matrix(self, dinv: torch.Tensor, factor_dtype: torch.dtype) -> torch.Tensor:
        """S = A diag(dinv) A' per lane, in the factor dtype (no
        regularization or pinning; ops/kkt applies those)."""
        Af = self.A.to(factor_dtype)
        df = self.cols(dinv).to(factor_dtype)
        S = torch.matmul(Af * df.unsqueeze(-2), Af.mT)
        return S if self.group is None else comm.all_sum(S, self.group)

    def live_rows(self) -> torch.Tensor:
        """Rows that touch at least one free column."""
        A_eff = self.A * self.cols(self.free_mask).unsqueeze(-2)
        sq = torch.sum(A_eff * A_eff, dim=-1)
        if self.group is not None:
            sq = comm.all_sum(sq, self.group)
        return self.row_mask & (sq > 0)

    @spanned("madipm.qp.qmatvec")
    def qmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """Q @ x per lane (zeros for an LP); through the Ozaki slices when
        they are present and x is fp64."""
        global product_bytes
        if self.Q is None:
            return torch.zeros_like(x)
        product_bytes += _nbytes(self.Q)
        if self.Q_sl is not None and x.dtype == torch.float64:
            qx = ozaki.apply(self.Q_sl, x)
        else:
            qx = torch.bmm(self.Q, x.unsqueeze(-1)).squeeze(-1)
        return qx if self.group is None else comm.gather_last(qx, self.group)

    def assemble_ata(self, w: torch.Tensor, factor_dtype: torch.dtype) -> torch.Tensor:
        """A' diag(w) A over free columns per lane, in the factor dtype
        (the K1 condensed assembly; ``w`` (B, m) is the live-row indicator).
        With a group: a sum over the ranks of their row blocks' products."""
        if self.group is None:
            A, wr = self.A, w
        else:
            A, wr = self.A_rows, self.rows(w)
        Af = (A * self.free_mask.unsqueeze(-2)).to(factor_dtype)
        Aw = Af * wr.to(factor_dtype).unsqueeze(-1)
        C = torch.matmul(Aw.mT, Af)
        return C if self.group is None else comm.all_sum(C, self.group)

    def quad_strip(self, factor_dtype: torch.dtype) -> Optional[torch.Tensor]:
        """Q masked to free rows and columns, in the factor dtype: this
        rank's row strip with a group, else the whole; None for an LP."""
        if self.Q is None:
            return None
        free = self.free_mask
        return (self.Q * self.cols(free).unsqueeze(-1) * free.unsqueeze(-2)).to(factor_dtype)

    def add_quad(self, C: torch.Tensor, factor_dtype: torch.dtype) -> torch.Tensor:
        """C + Q masked to free rows and columns (C itself for an LP)."""
        Qf = self.quad_strip(factor_dtype)
        if Qf is None:
            return C
        if self.group is not None:
            Qf = comm.gather_rows(Qf, self.group)
        return C + Qf


def pad_to_device(
    qp: QuadraticModel,
    dtype: torch.dtype = torch.float64,
    pad_multiple: int = 128,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    device=None,
) -> TorchQP:
    """Pack a host equality-form model into a one-lane padded TorchQP.

    Padded columns are pinned (lb = ub = 0, masked out); padded rows get
    ``0 x = 0`` and are masked out of every reduction.
    """
    if np.any(qp.lcon != qp.ucon):
        raise ValueError("pad_to_device requires equality-only constraints; run slack_form first")
    m, n = qp.ncon, qp.nvar
    mp = m_pad if m_pad is not None else _round_up(m, pad_multiple)
    np_ = n_pad if n_pad is not None else _round_up(n, pad_multiple)
    if mp < m or np_ < n:
        raise ValueError("padded shape smaller than problem")

    A = np.zeros((mp, np_), dtype=np.float64)
    A[:m, :n] = qp.A.toarray()
    c = np.zeros(np_)
    c[:n] = qp.c
    b = np.zeros(mp)
    b[:m] = qp.lcon
    lb = np.zeros(np_)
    ub = np.zeros(np_)
    lb[:n] = qp.lvar
    ub[:n] = qp.uvar
    x0 = np.zeros(np_)
    x0[:n] = qp.x0
    y0 = np.zeros(mp)
    y0[:m] = qp.y0
    row_mask = np.zeros(mp, dtype=bool)
    row_mask[:m] = True
    col_mask = np.zeros(np_, dtype=bool)
    col_mask[:n] = True
    Q = None
    if qp.Q is not None:
        Q = np.zeros((np_, np_), dtype=np.float64)
        Q[:n, :n] = qp.Q.toarray()
    fields = dict(
        c=c, A=A, b=b, lb=lb, ub=ub, Q=Q, c0=np.float64(qp.c0),
        row_mask=row_mask, col_mask=col_mask, x0=x0, y0=y0,
    )
    return TorchQP.from_numpy(fields, device=device, dtype=dtype)
