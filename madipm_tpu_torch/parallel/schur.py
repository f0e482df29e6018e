"""Distributed single-instance KKT: the port of
``madipm_tpu/parallel/schur.py``.

One instance's variable dimension is split over a mesh axis.  The normal
matrix is a sum of per-rank outer products,

    S = A Sigma^-1 A' = sum_k A_k D_k A_k'        (k = rank on the axis),

reduced over the axis: a sum of the whole matrix for a replicated factor,
a reduce-scatter into row strips for the distributed one
(parallel/dist_chol.py).

- :func:`shard_columns` + :func:`solve_sharded`: the solver program
  unchanged on a column-sharded problem, whose products carry the
  collectives (``models/qp.TorchQP`` with a group).
- :func:`schur_normal_solve`: the explicit building block, the partial
  Schur products summed over the axis and a replicated Cholesky.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.qp import TorchQP
from ..solver import driver
from ..utils import comm
from ..utils.options import KKTSystem


def shard_columns(prob: TorchQP, mesh, axis: str = "cols", keep_rows: bool = False) -> TorchQP:
    """This rank's part of ``prob`` (which every rank holds whole) with the
    variable dimension split over ``axis``.

    The layout differs from the JAX package's in one deliberate way.  A
    rank keeps A's column block (B, m, n/P) and, for the distributed K1
    system (``keep_rows``), A's row block (B, m/P, n) too, cut once here:
    A never changes, so this does once what GSPMD did by resharding A on
    every K1 factor.  Q is split into row strips (B, n/P, n).  Every
    m-vector and every n-vector stays **replicated**: JAX shards the
    n-vectors and lets GSPMD put a collective into every reduction over n;
    torch has no GSPMD, and with whole n-vectors the one-device solver
    code runs unchanged, each reduction over n local and bit-equal on every
    rank, for O(n) work per rank against the O(m n / P) of the products.
    The collectives are then those of the products (A x summed, A' y and
    Q x gathered), of the assembly and of the distributed factor.

    n, and with ``keep_rows`` m, must divide by the axis size: a padding
    multiple of 128 times the mesh size (``MPCSolver(mesh=...)``) does it.
    """
    if prob.group is not None:
        raise ValueError("the problem is already sharded")
    group = mesh.get_group(axis)
    P, p = comm.size(group), comm.rank(group)
    m, n = prob.m, prob.n
    if n % P or (keep_rows and m % P):
        raise ValueError(f"(m, n) = ({m}, {n}) must divide by the {axis!r} axis size {P}")
    nb, mb = n // P, m // P
    cols = slice(p * nb, (p + 1) * nb)
    return dataclasses.replace(
        prob,
        A=prob.A[..., cols].contiguous(),
        Q=None if prob.Q is None else prob.Q[..., cols, :].contiguous(),
        A_rows=prob.A[..., p * mb:(p + 1) * mb, :].contiguous() if keep_rows else None,
        group=group,
    )


def solve_sharded(cfg: driver.SolverConfig, prob: TorchQP, mesh, axis: str = "cols",
                  distribute_factor: bool = True):
    """The standard solve (``driver.solve_device``) on the column-sharded
    ``prob``; returns (prob_scaled, scale, state), the state replicated.

    ``distribute_factor=True`` routes a NORMAL factor through the
    distributed strip Cholesky (``parallel/dist_chol.dist_factor_normal``):
    the m x m matrix and its factor are split over the axis instead of
    summed and factored on every rank (m must divide by the axis size).
    Any other factor is replicated, on the summed matrix.
    """
    if distribute_factor and cfg.kkt.kind == KKTSystem.NORMAL:
        cfg = dataclasses.replace(
            cfg, kkt=dataclasses.replace(cfg.kkt, dist_mesh=mesh, dist_axis=axis))
    dist_k1 = cfg.kkt.kind == KKTSystem.CONDENSED
    return driver.solve_device(cfg, shard_columns(prob, mesh, axis, keep_rows=dist_k1))


def schur_normal_solve(mesh, A_k, dinv_k, rx_k, rp, row_mask, del_c, axis: str = "cols"):
    """Solve (A Sigma^-1 A' - del_c) dy = A Sigma^-1 rx - rp and
    back-substitute dx, with the columns of A split over ``axis``.

    ``A_k`` (B, m, n/P), ``dinv_k`` and ``rx_k`` (B, n/P) are this rank's;
    ``rp``, ``row_mask`` (B, m) and ``del_c`` replicated.  The partial
    Schur product and rhs are summed over the axis (the one m x m
    all-reduce of a solve) and every rank factors the whole matrix; padded
    rows are pinned to the identity, as ``ops/kkt`` does.  Returns
    (dx_k, dy), dx this rank's block.
    """
    group = mesh.get_group(axis)
    S = comm.all_sum(torch.matmul(A_k * dinv_k.unsqueeze(-2), A_k.mT), group)
    r = comm.all_sum((A_k @ (dinv_k * rx_k).unsqueeze(-1)).squeeze(-1), group)
    dS = torch.diagonal(S, dim1=-2, dim2=-1)
    S = S + torch.diag_embed(torch.where(row_mask, -del_c, 1.0 - dS))
    r2 = torch.where(row_mask, r - rp, 0.0)
    L = torch.linalg.cholesky(S)
    z = torch.linalg.solve_triangular(L, r2.unsqueeze(-1), upper=False)
    dy = torch.linalg.solve_triangular(L.mT, z, upper=True).squeeze(-1)
    dy = torch.where(row_mask, dy, 0.0)
    dx_k = dinv_k * (rx_k - (A_k.mT @ dy.unsqueeze(-1)).squeeze(-1))
    return dx_k, dy
