"""Sparse problems: the port of ``madipm_tpu/models/sparse.py``.

The Jacobian is kept in ELL form (row-padded values and column indices,
and the same for its transpose), so that ``A x`` and ``A' y`` are one
gather and one reduction along the padded width, and the dense ``A`` is
never formed.  The normal matrix ``S = A diag(dinv) A'`` is assembled from
a pair list built once on the host (:func:`build_normal_pattern`): every
pair of nonzeros that share a column adds ``A_aj A_bj dinv_j`` to one
entry of S.  The pairs are sorted by destination, so the device work is
two gathers, a product, a segmented sum and one scatter into the dense
padded S, which the SPD factor (``ops/chol_inv``) then takes as the dense
path's.  Sparse QPs go through the K1 CONDENSED system: the pattern of
``A'A`` is the normal pattern of ``A'``, and Q is held in ELL.

:class:`SparseTorchQP` is the counterpart of ``SparseDeviceQP`` with a
leading lane dimension, as :class:`TorchQP` is of ``DeviceQP``.  Two things
differ from the JAX package on the device, neither in what is computed:

- indices are int64, converted once when the problem is packed
  (``torch.gather`` and ``scatter`` take no other index type);
- the segmented sum is ``torch.segment_reduce`` over lengths computed on
  the host (``seg_len``, ``cseg_len``), which sums each segment in a fixed
  order, so an assembly gives the same bits from run to run (a
  ``scatter_add_`` on CUDA would not).  Where the JAX package drops padded
  slots (``segment_sum`` of an out-of-range id, ``mode="drop"``), each
  lane here has one extra sink segment and one extra sink entry of S that
  are sliced off.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import torch

from . import native
from .qp import QuadraticModel, _round_up

#: SparseTorchQP fields that hold indices (int64 on the device)
_INDEX_FIELDS = (
    "A_col", "AT_row", "Q_col",
    "pair_a", "pair_b", "pair_col", "seg_id", "s_low", "s_up", "seg_len",
    "cpair_a", "cpair_b", "cpair_col", "cseg_id", "c_low", "c_up", "cseg_len",
)
_MASK_FIELDS = ("row_mask", "col_mask")

#: raised wherever a KKT system needs the dense Jacobian (AUGMENTED, K2.5)
DENSE_A_MESSAGE = (
    "the sparse path supports the NORMAL (LP) and CONDENSED (K1) "
    "KKT systems; use the dense representation for AUGMENTED/K2 "
    "solves (those materialize the full [Sigma+Q, A'; A, del_c] "
    "block matrix)"
)


class NormalPattern(NamedTuple):
    """Host-precomputed symbolic structure of S = A D A' (lower triangle).

    All arrays are int32.  ``pair_*`` have length P = sum_j k_j (k_j + 1)/2
    (k_j = nnz of column j); ``s_low``/``s_up`` have length nnzS (unique
    lower-triangle entries of S, as flat indices into the padded m*m)."""

    pair_a: np.ndarray  # flat ELL index of the first factor A[r_a, j]
    pair_b: np.ndarray  # flat ELL index of the second factor A[r_b, j]
    pair_col: np.ndarray  # j (gathers dinv)
    seg_id: np.ndarray  # sorted segment id into the unique entries
    s_low: np.ndarray  # destination r_a * m_pad + r_b  (r_a >= r_b)
    s_up: np.ndarray  # mirror r_b * m_pad + r_a (== s_low on the diagonal)


def segment_lengths(seg_id: np.ndarray, n_segments: int) -> np.ndarray:
    """Lengths of the ``n_segments`` segments of a lane's sorted ``seg_id``
    plus one sink segment for the padded slots (whose id is
    ``n_segments``): an int64 array of ``n_segments + 1``."""
    seg_id = np.asarray(seg_id)
    if seg_id.size and np.any(np.diff(seg_id) < 0):
        raise ValueError("segment ids must be sorted within each lane")
    if seg_id.size and (seg_id.min() < 0 or seg_id.max() > n_segments):
        raise ValueError("segment id out of range")
    return np.bincount(seg_id, minlength=n_segments + 1).astype(np.int64)


def _segment_sum(contrib: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-lane sums of sorted segments, sink segment dropped: (B, P)
    values and (B, nnz+1) lengths -> (B, nnz).  Each segment is summed in
    one fixed order."""
    B, nseg = lengths.shape
    if contrib.shape[-1] == 0:
        return contrib.new_zeros((B, nseg - 1))
    sums = torch.segment_reduce(contrib.reshape(-1), "sum", lengths=lengths.reshape(-1))
    return sums.reshape(B, nseg)[:, :-1]


def _scatter_square(vals: torch.Tensor, low: torch.Tensor, up: torch.Tensor, size: int) -> torch.Tensor:
    """Dense (B, size, size) matrix with ``vals`` at the flat positions
    ``low`` and ``up`` of each lane; a position ``size*size`` (a padded
    slot) lands in a sink entry that is sliced off."""
    B = vals.shape[0]
    flat = vals.new_zeros((B, size * size + 1))
    # up == low on the diagonal: the second scatter writes the same value.
    flat.scatter_(1, low, vals)
    flat.scatter_(1, up, vals)
    return flat[:, : size * size].reshape(B, size, size)


def _gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``v[b, idx[b, ...]]`` per lane: v (B, L), idx (B, r, k) -> (B, r, k)."""
    return v.gather(1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseTorchQP:
    """Padded ELL-sparse standard-form problems, one per lane of the batch.

    The same fields as ``SparseDeviceQP`` with a leading lane dimension
    (``c`` (B, n), ``A_val`` (B, m, K), ``pair_a`` (B, P), ``c0`` (B, 1)
    ...), plus the segment lengths ``seg_len`` (B, nnzS+1) and
    ``cseg_len`` (B, nnzC+1) of the two patterns.  It has the operator
    interface of :class:`TorchQP`, which is all that ``solver/`` and
    ``ops/kkt.py`` use; the dense Jacobian does not exist
    (:attr:`dense_A` raises)."""

    c: torch.Tensor
    b: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    c0: torch.Tensor
    row_mask: torch.Tensor
    col_mask: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor

    # ELL Jacobian, row-major and transposed (padded slots: index 0, value 0)
    A_val: torch.Tensor  # (B, m, K)
    A_col: torch.Tensor  # (B, m, K)
    AT_val: torch.Tensor  # (B, n, Kc)
    AT_row: torch.Tensor  # (B, n, Kc)

    # Normal-equation pattern (zero length when only the condensed one was built)
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    pair_col: torch.Tensor
    seg_id: torch.Tensor
    s_low: torch.Tensor
    s_up: torch.Tensor
    seg_len: torch.Tensor

    Q: Optional[torch.Tensor] = None  # never a dense matrix on this path

    # ELL quadratic term (full symmetric), None for an LP
    Q_val: Optional[torch.Tensor] = None  # (B, n, Kq)
    Q_col: Optional[torch.Tensor] = None

    # Condensed (K1) pattern of A'A = normal pattern of A'
    cpair_a: Optional[torch.Tensor] = None
    cpair_b: Optional[torch.Tensor] = None
    cpair_col: Optional[torch.Tensor] = None  # constraint row r (gathers w)
    cseg_id: Optional[torch.Tensor] = None
    c_low: Optional[torch.Tensor] = None  # flat n_pad*n_pad destinations
    c_up: Optional[torch.Tensor] = None
    cseg_len: Optional[torch.Tensor] = None

    @classmethod
    def from_numpy(cls, fields: dict, device=None, dtype=torch.float64) -> "SparseTorchQP":
        """Build from numpy arrays named as the ``SparseDeviceQP`` fields,
        one instance (``A_val`` of shape (m, K)) or a stack ((B, m, K)).
        Indices become int64 and the segment lengths are computed here."""
        batched = np.ndim(fields["A_val"]) == 3
        arrays = {}
        for f in dataclasses.fields(cls):
            v = fields.get(f.name)
            if v is None or f.name == "Q":
                continue
            v = np.array(v)  # a writable copy
            arrays[f.name] = v if batched else v[None]
        for ids, low, lens in (("seg_id", "s_low", "seg_len"), ("cseg_id", "c_low", "cseg_len")):
            if ids in arrays and lens not in arrays:
                nnz = arrays[low].shape[-1]
                arrays[lens] = np.stack([segment_lengths(s, nnz) for s in arrays[ids]])
        kw = {}
        for name, v in arrays.items():
            if name == "c0":
                v = v.reshape(-1, 1)
            if name in _INDEX_FIELDS:
                dt = torch.int64
            elif name in _MASK_FIELDS:
                dt = torch.bool
            else:
                dt = dtype
            kw[name] = torch.as_tensor(v, dtype=dt, device=device)
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
        return self.Q_val is not None

    @property
    def dtype(self) -> torch.dtype:
        return self.c.dtype

    @property
    def device(self) -> torch.device:
        return self.c.device

    @property
    def dense_A(self) -> torch.Tensor:
        raise NotImplementedError(DENSE_A_MESSAGE)

    @cached_property
    def free_mask(self) -> torch.Tensor:
        return self.col_mask & (self.lb < self.ub)

    @cached_property
    def has_lb(self) -> torch.Tensor:
        return self.free_mask & torch.isfinite(self.lb)

    @cached_property
    def has_ub(self) -> torch.Tensor:
        return self.free_mask & torch.isfinite(self.ub)

    # Jacobian operator interface ---------------------------------------

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x per lane: one gather along the ELL width and a sum."""
        return torch.sum(self.A_val * _gather_rows(x, self.A_col), dim=-1)

    def rmatvec(self, y: torch.Tensor) -> torch.Tensor:
        """A' @ y per lane through the transposed ELL (no scatter)."""
        return torch.sum(self.AT_val * _gather_rows(y, self.AT_row), dim=-1)

    def row_inf_norm(self) -> torch.Tensor:
        return torch.amax(torch.abs(self.A_val), dim=-1)

    def scale_rows(self, con_scale: torch.Tensor) -> "SparseTorchQP":
        return dataclasses.replace(
            self,
            A_val=self.A_val * con_scale.unsqueeze(-1),
            AT_val=self.AT_val * _gather_rows(con_scale, self.AT_row),
        )

    def assemble_normal_matrix(self, dinv: torch.Tensor, factor_dtype: torch.dtype) -> torch.Tensor:
        """S = A diag(dinv) A' per lane into a dense padded (B, m, m):
        gather, multiply, segmented sum, scatter (and its mirror)."""
        B = self.batch
        flatA = self.A_val.to(factor_dtype).reshape(B, -1)
        contrib = (
            flatA.gather(1, self.pair_a)
            * flatA.gather(1, self.pair_b)
            * dinv.to(factor_dtype).gather(1, self.pair_col)
        )
        snz = _segment_sum(contrib, self.seg_len)
        return _scatter_square(snz, self.s_low, self.s_up, self.m)

    # Quadratic-term operator interface (consumed by K1) -----------------

    def qmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """Q @ x through the full-symmetric ELL (zeros for an LP)."""
        if self.Q_val is None:
            return torch.zeros_like(x)
        return torch.sum(self.Q_val * _gather_rows(x, self.Q_col), dim=-1)

    def scale_quad(self, obj_scale: torch.Tensor) -> "SparseTorchQP":
        if self.Q_val is None:
            return self
        return dataclasses.replace(self, Q_val=self.Q_val * obj_scale.unsqueeze(-1))

    def live_rows(self) -> torch.Tensor:
        free = torch.where(_gather_rows(self.free_mask, self.A_col), 1.0, 0.0)
        contrib = self.A_val * self.A_val * free
        return self.row_mask & (torch.sum(contrib, dim=-1) > 0)

    def assemble_ata(self, w: torch.Tensor, factor_dtype: torch.dtype) -> torch.Tensor:
        """A' diag(w) A over free columns per lane into a dense padded
        (B, n, n), by the pair list of the transposed pattern."""
        if self.cpair_a is None or self.cpair_a.shape[-1] == 0:
            raise NotImplementedError(
                "this SparseTorchQP was packed without the condensed "
                "pattern; rebuild with pad_sparse_to_device(kkt='condensed')"
            )
        B = self.batch
        free = torch.where(self.free_mask, 1.0, 0.0).to(self.AT_val.dtype)
        flatAT = (self.AT_val * free.unsqueeze(-1)).to(factor_dtype).reshape(B, -1)
        contrib = (
            flatAT.gather(1, self.cpair_a)
            * flatAT.gather(1, self.cpair_b)
            * w.to(factor_dtype).gather(1, self.cpair_col)
        )
        cnz = _segment_sum(contrib, self.cseg_len)
        return _scatter_square(cnz, self.c_low, self.c_up, self.n)

    def add_quad(self, C: torch.Tensor, factor_dtype: torch.dtype) -> torch.Tensor:
        """C + Q masked to free columns by one scatter-add (padded ELL slots
        add 0 at column 0, and a real entry's destination is unique)."""
        if self.Q_val is None:
            return C
        B, n = self.batch, self.n
        free = self.free_mask
        rows = torch.arange(n, device=C.device).unsqueeze(-1)
        dst = (rows * n + self.Q_col).reshape(B, -1)
        mask = _gather_rows(free, self.Q_col) & free.unsqueeze(-1)
        vals = torch.where(mask, self.Q_val, 0.0).to(factor_dtype).reshape(B, -1)
        return C.reshape(B, -1).scatter_add(1, dst, vals).reshape(B, n, n)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------


def _clean_csr(M) -> sp.csr_matrix:
    """CSR with sorted indices, duplicates summed and explicit zeros gone."""
    M = M.tocsr()
    M.sort_indices()
    M.sum_duplicates()
    M.eliminate_zeros()
    return M


def ell_width(counts: np.ndarray, k_pad_mult: int = 8) -> int:
    """The padded ELL width of rows holding ``counts`` nonzeros."""
    K = int(counts.max()) if counts.size and counts.max() > 0 else 1
    return _round_up(K, k_pad_mult)


def _to_ell(A: sp.csr_matrix, rows_pad: int, cols_pad: int, k_pad_mult: int = 8,
            k_width: Optional[int] = None):
    """CSR -> padded ELL ([rows_pad, K] values/indices) plus, for each CSR
    nonzero in order, its flat ELL position (rows * K + slot).  ``k_width``
    forces the padded lane width (batched buckets need one shared K)."""
    m = A.shape[0]
    counts = np.diff(A.indptr)
    K = ell_width(counts, k_pad_mult)
    if k_width is not None:
        if k_width < K:
            raise ValueError(f"k_width {k_width} < required {K}")
        K = k_width
    val = np.zeros((rows_pad, K), dtype=np.float64)
    idx = np.zeros((rows_pad, K), dtype=np.int32)
    rows = np.repeat(np.arange(m), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    val[rows, slots] = A.data
    idx[rows, slots] = A.indices
    ell_pos = (rows * K + slots).astype(np.int64)
    return val, idx, ell_pos


def build_normal_pattern(A: sp.csr_matrix, ell_pos: np.ndarray, m_pad: int) -> NormalPattern:
    """Symbolic analysis of S = A D A': for every column, all ordered pairs
    of its nonzero rows (r_a >= r_b), sorted by destination, given the
    CSR->ELL position map from :func:`_to_ell`.

    Cost: P = sum_j k_j (k_j + 1) / 2 pairs; a dense column makes P grow
    with the square of its count."""
    tag = sp.csr_matrix(
        (np.arange(A.nnz, dtype=np.int64), A.indices, A.indptr), shape=A.shape
    )
    csc = tag.tocsc()
    csc.sort_indices()
    col_counts = np.diff(csc.indptr)

    pair_a_parts, pair_b_parts, pair_col_parts = [], [], []
    out_i_parts, out_j_parts = [], []
    # Columns grouped by nonzero count: the tril template is built once per k.
    for k in np.unique(col_counts):
        if k == 0:
            continue
        cols = np.flatnonzero(col_counts == k)
        starts = csc.indptr[cols]
        take = starts[:, None] + np.arange(k)[None, :]
        pos_k = csc.data[take]  # CSR positions
        row_k = csc.indices[take]  # row ids, ascending per column
        ii, bb = np.tril_indices(int(k))  # ii >= bb -> r_a >= r_b
        pair_a_parts.append(ell_pos[pos_k[:, ii]].ravel())
        pair_b_parts.append(ell_pos[pos_k[:, bb]].ravel())
        pair_col_parts.append(np.repeat(cols, ii.size))
        out_i_parts.append(row_k[:, ii].ravel())
        out_j_parts.append(row_k[:, bb].ravel())

    if not pair_a_parts:
        z = np.zeros(0, dtype=np.int32)
        return NormalPattern(z, z, z, z, z, z)

    pair_a = np.concatenate(pair_a_parts)
    pair_b = np.concatenate(pair_b_parts)
    pair_col = np.concatenate(pair_col_parts)
    out_i = np.concatenate(out_i_parts)
    out_j = np.concatenate(out_j_parts)

    key = out_i.astype(np.int64) * m_pad + out_j
    order = np.argsort(key, kind="stable")
    key = key[order]
    uniq, seg_id = np.unique(key, return_inverse=True)
    ui = uniq // m_pad
    uj = uniq % m_pad
    return NormalPattern(
        pair_a=pair_a[order].astype(np.int32),
        pair_b=pair_b[order].astype(np.int32),
        pair_col=pair_col[order].astype(np.int32),
        seg_id=seg_id.astype(np.int32),
        s_low=uniq.astype(np.int32),
        s_up=(uj * m_pad + ui).astype(np.int32),
    )


def _pad_pattern(pattern: NormalPattern, p_size, s_size, dst_oob: int) -> NormalPattern:
    """Pad a pattern to ``p_size`` pairs and ``s_size`` destinations:
    padded pairs carry ``seg_id == s_size`` and padded destinations
    ``dst_oob`` (the padded m*m or n*n); both are dropped on the device."""
    if p_size is None and s_size is None:
        return pattern
    P0, S0 = pattern.pair_a.size, pattern.s_low.size
    Pp = p_size if p_size is not None else P0
    Sp = s_size if s_size is not None else S0
    if Pp < P0 or Sp < S0:
        raise ValueError("pattern pad sizes smaller than actual pattern")

    def padi(a, size, fill):
        out = np.full(size, fill, dtype=np.int32)
        out[: a.size] = a
        return out

    return NormalPattern(
        pair_a=padi(pattern.pair_a, Pp, 0),
        pair_b=padi(pattern.pair_b, Pp, 0),
        pair_col=padi(pattern.pair_col, Pp, 0),
        seg_id=padi(pattern.seg_id, Pp, Sp),
        s_low=padi(pattern.s_low, Sp, dst_oob),
        s_up=padi(pattern.s_up, Sp, dst_oob),
    )


_EMPTY = NormalPattern(*(np.zeros(0, dtype=np.int32),) * 6)

#: the packed fields of each pattern, in NormalPattern's order
PATTERN_FIELDS = {
    "normal": ("pair_a", "pair_b", "pair_col", "seg_id", "s_low", "s_up"),
    "condensed": ("cpair_a", "cpair_b", "cpair_col", "cseg_id", "c_low", "c_up"),
}


def pack_sparse(
    qp: QuadraticModel,
    pad_multiple: int = 128,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    ell_k: Optional[int] = None,
    ell_kt: Optional[int] = None,
    ell_kq: Optional[int] = None,
    pattern_p: Optional[int] = None,
    pattern_nnzs: Optional[int] = None,
    cpattern_p: Optional[int] = None,
    cpattern_nnzs: Optional[int] = None,
    kkt: Optional[str] = None,
) -> dict:
    """The host half of :func:`pad_sparse_to_device`: numpy arrays named
    as the ``SparseDeviceQP`` fields (values float64, indices int32), for
    one equality-form model.

    ``kkt`` picks the pattern(s): ``"normal"`` (S = A D A', LPs only),
    ``"condensed"`` (C = A' w A, K1) or ``"both"``; default condensed for a
    QP, normal otherwise.  The size overrides (ELL widths ``ell_k``,
    ``ell_kt``, ``ell_kq``; pattern lengths ``pattern_p``,
    ``pattern_nnzs``, ``cpattern_*``) let the lanes of a bucket share one
    shape; padded slots carry the out-of-range indices of
    :func:`_pad_pattern`."""
    if kkt is None:
        kkt = "condensed" if qp.Q is not None else "normal"
    if kkt not in ("normal", "condensed", "both"):
        raise ValueError(f"kkt must be 'normal', 'condensed' or 'both', got {kkt!r}")
    if qp.Q is not None and kkt == "normal":
        raise ValueError(
            "the NORMAL pattern is LP-only; pack sparse QPs with "
            "kkt='condensed' (K1)"
        )
    if np.any(qp.lcon != qp.ucon):
        raise ValueError(
            "pad_sparse_to_device requires equality-only constraints; run slack_form first"
        )
    m, n = qp.ncon, qp.nvar
    mp = m_pad if m_pad is not None else _round_up(m, pad_multiple)
    np_ = n_pad if n_pad is not None else _round_up(n, pad_multiple)
    if mp < m or np_ < n:
        raise ValueError("padded shape smaller than problem")

    A = _clean_csr(qp.A)
    val, idx, ell_pos = _to_ell(A, mp, np_, k_width=ell_k)
    AT = A.T.tocsr()
    AT.sort_indices()
    tval, tidx, t_ell_pos = _to_ell(AT, np_, mp, k_width=ell_kt)

    # The C++ pattern code when the native library loads, the Python one
    # otherwise: the same pattern up to the order of pairs within a segment.
    def pattern_for(mat, pos, rows, cols, width, row_pad):
        if native.available():
            return NormalPattern(*native.native_normal_pattern(
                mat.indptr, mat.indices, rows, cols, width, row_pad
            ))
        return build_normal_pattern(mat, pos, row_pad)

    pattern = _EMPTY
    if kkt in ("normal", "both"):
        pattern = pattern_for(A, ell_pos, m, n, val.shape[1], mp)
        pattern = _pad_pattern(pattern, pattern_p, pattern_nnzs, mp * mp)
    cpattern = _EMPTY
    if kkt in ("condensed", "both"):
        # pair positions index the flat AT ELL; pair_col is the constraint row
        cpattern = pattern_for(AT, t_ell_pos, n, m, tval.shape[1], np_)
        cpattern = _pad_pattern(cpattern, cpattern_p, cpattern_nnzs, np_ * np_)

    qval = qidx = None
    if qp.Q is not None:
        qval, qidx, _ = _to_ell(_clean_csr(qp.Q), np_, np_, k_width=ell_kq)
    elif ell_kq is not None:
        # an explicit zero Q lets an LP share a bucket with QPs
        qval = np.zeros((np_, ell_kq), dtype=np.float64)
        qidx = np.zeros((np_, ell_kq), dtype=np.int32)

    def vecpad(v, size):
        out = np.zeros(size, dtype=np.float64)
        out[: v.shape[0]] = v
        return out

    row_mask = np.zeros(mp, dtype=bool)
    row_mask[:m] = True
    col_mask = np.zeros(np_, dtype=bool)
    col_mask[:n] = True
    return dict(
        c=vecpad(qp.c, np_), b=vecpad(qp.lcon, mp), lb=vecpad(qp.lvar, np_),
        ub=vecpad(qp.uvar, np_), c0=np.float64(qp.c0), row_mask=row_mask,
        col_mask=col_mask, x0=vecpad(qp.x0, np_), y0=vecpad(qp.y0, mp),
        A_val=val, A_col=idx, AT_val=tval, AT_row=tidx,
        pair_a=pattern.pair_a, pair_b=pattern.pair_b, pair_col=pattern.pair_col,
        seg_id=pattern.seg_id, s_low=pattern.s_low, s_up=pattern.s_up,
        Q=None, Q_val=qval, Q_col=qidx,
        cpair_a=cpattern.pair_a, cpair_b=cpattern.pair_b, cpair_col=cpattern.pair_col,
        cseg_id=cpattern.seg_id, c_low=cpattern.s_low, c_up=cpattern.s_up,
    )


def pad_sparse_to_device(
    qp: QuadraticModel,
    dtype: torch.dtype = torch.float64,
    pad_multiple: int = 128,
    device=None,
    **sizes,
) -> SparseTorchQP:
    """Pack a host equality-form LP/QP into a one-lane SparseTorchQP (the
    sparse counterpart of ``pad_to_device``); ``sizes`` are the options of
    :func:`pack_sparse` (``m_pad``, ``n_pad``, ELL widths, pattern lengths,
    ``kkt``)."""
    fields = pack_sparse(qp, pad_multiple=pad_multiple, **sizes)
    return SparseTorchQP.from_numpy(fields, device=device, dtype=dtype)
