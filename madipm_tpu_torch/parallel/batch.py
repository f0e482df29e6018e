"""Batched solves: the port of ``madipm_tpu/parallel/batch.py``.

Instances padded to a common bucket shape are stacked on the leading lane
dimension of one TorchQP (dense) or SparseTorchQP (ELL, ``sparse=True``)
and solved together (``solver.driver.solve_device`` runs every lane; a
lane that has stopped keeps its state).  The mesh-sharded path is ROADMAP
item A11.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Union

import numpy as np
import torch

from ..api import _ensure_fp32_matmul, _synchronize, default_device
from ..models.qp import QuadraticModel, TorchQP, _round_up, pad_to_device, slack_form
from ..models.sparse import (
    PATTERN_FIELDS,
    NormalPattern,
    SparseTorchQP,
    _clean_csr,
    _pad_pattern,
    ell_width,
    pack_sparse,
)
from ..solver import driver
from ..solver.state import IPMState
from ..utils.options import KKTSystem, load_options
from ..utils.stats import IPMStats
from ..utils.status import Status


Problem = Union[TorchQP, SparseTorchQP]


def stack_problems(probs: Sequence[Problem]) -> Problem:
    """Concatenate problems of one class and one padded shape (every
    field's, for the sparse class) along the lane dimension."""
    cls = type(probs[0])
    shapes = {
        (type(p),) + tuple(None if getattr(p, f.name) is None else tuple(getattr(p, f.name).shape[1:])
                           for f in dataclasses.fields(cls))
        for p in probs
    }
    if len(shapes) != 1:
        raise ValueError(
            f"all problems must share a padded shape, got {sorted({(p.m, p.n, p.is_qp) for p in probs})}"
        )
    fields = {}
    for f in dataclasses.fields(cls):
        parts = [getattr(p, f.name) for p in probs]
        fields[f.name] = None if parts[0] is None else torch.cat(parts)
    return cls(**fields)


def bucket_pad(models: Sequence[QuadraticModel], pad_multiple: int = 128,
               dtype: torch.dtype = torch.float64, device=None):
    """Slack-form + pad a set of models to one common bucket shape."""
    slacked = [slack_form(m) for m in models]
    m_pad = max(_round_up(s.ncon, pad_multiple) for s in slacked)
    n_pad = max(_round_up(s.nvar, pad_multiple) for s in slacked)
    probs = [
        pad_to_device(s, dtype=dtype, m_pad=m_pad, n_pad=n_pad, device=device) for s in slacked
    ]
    return stack_problems(probs), slacked


def bucket_pad_sparse(models: Sequence[QuadraticModel], pad_multiple: int = 128,
                      dtype: torch.dtype = torch.float64, device=None):
    """Slack-form + pack a set of sparse LPs/QPs into one SparseTorchQP
    bucket.

    The lanes share the padded m and n, the ELL widths and the pattern
    lengths; padded pattern slots carry the out-of-range indices that the
    assembly drops (``models/sparse._pad_pattern``).  A bucket holding any
    QP is packed for K1 (CONDENSED), with an explicit zero Q for its LPs.
    The shared widths come from the nonzero counts, so each lane's pattern
    is built once."""
    slacked = [slack_form(m) for m in models]
    kkt = "condensed" if any(s.is_qp for s in slacked) else "normal"
    m_pad = max(_round_up(s.ncon, pad_multiple) for s in slacked)
    n_pad = max(_round_up(s.nvar, pad_multiple) for s in slacked)
    clean = [_clean_csr(s.A) for s in slacked]
    widths = dict(
        ell_k=max(ell_width(np.diff(A.indptr)) for A in clean),
        ell_kt=max(ell_width(np.bincount(A.indices, minlength=A.shape[1])) for A in clean),
    )
    if kkt == "condensed":
        widths["ell_kq"] = max(
            (ell_width(np.diff(_clean_csr(s.Q).indptr)) for s in slacked if s.is_qp), default=8
        )
    packed = [pack_sparse(s, m_pad=m_pad, n_pad=n_pad, kkt=kkt, **widths) for s in slacked]
    names = PATTERN_FIELDS[kkt]
    dst_oob = m_pad * m_pad if kkt == "normal" else n_pad * n_pad
    p_size = max(f[names[0]].size for f in packed)
    s_size = max(f[names[4]].size for f in packed)
    for f in packed:
        padded = _pad_pattern(NormalPattern(*(f[k] for k in names)), p_size, s_size, dst_oob)
        f.update(zip(names, padded))
    stacked = {k: None if packed[0][k] is None else np.stack([f[k] for f in packed])
               for k in packed[0]}
    return SparseTorchQP.from_numpy(stacked, device=device, dtype=dtype), slacked


def solve_batched(cfg: driver.SolverConfig, probs: TorchQP):
    """Solve a stacked batch; returns (prob_scaled, scale, state) with a
    leading lane dimension."""
    return driver.solve_device(cfg, probs)


def batched_stats(models: Sequence[QuadraticModel], scale, state: IPMState,
                  solver_time: float) -> List[IPMStats]:
    """Unpack a batched solve into per-instance IPMStats."""
    s = state.to_numpy()
    obj_scale = scale.obj_scale[:, 0].cpu().numpy()
    con_scale = scale.con_scale.cpu().numpy()
    out = []
    for i, model in enumerate(models):
        osc = float(obj_scale[i])
        m0, n0 = model.ncon, model.nvar
        x = s["x"][i][:n0]
        out.append(
            IPMStats(
                status=Status(int(s["status"][i])),
                objective=float(s["obj_val"][i]) / osc,
                solution=x,
                constraints=model.cons(x),
                multipliers=s["y"][i][:m0] * con_scale[i][:m0] / osc,
                multipliers_L=s["zl"][i][:n0] / osc,
                multipliers_U=s["zu"][i][:n0] / osc,
                iter=int(s["k"][i]),
                primal_feas=float(s["inf_pr"][i]),
                dual_feas=float(s["inf_du"][i]),
                complementarity=float(s["inf_compl"][i]),
                total_time=solver_time,
                solver_time=solver_time,
            )
        )
    return out


def madipm_batch(models: Sequence[QuadraticModel], pad_multiple: int = 128,
                 dtype: torch.dtype = torch.float64, device=None, sparse: bool = False,
                 **options) -> List[IPMStats]:
    """Solve many instances as the lanes of one batched solve: all LPs or
    all QPs on the dense route, any mix on the ELL route (``sparse=True``),
    where a bucket with a QP is solved on K1 (CONDENSED).  ``device``
    defaults to the first CUDA device; without one, ``device="cpu"`` must
    be given.  ``solver_time`` covers the solve only, not packing and
    upload."""
    _ensure_fp32_matmul()
    opt = load_options(**options)
    device = torch.device(device) if device is not None else default_device()
    if sparse:
        probs, _ = bucket_pad_sparse(models, pad_multiple=pad_multiple, dtype=dtype, device=device)
        if probs.is_qp:
            if opt.kkt_system is None:
                opt = dataclasses.replace(opt, kkt_system=KKTSystem.CONDENSED)
            elif opt.kkt_system != KKTSystem.CONDENSED:
                raise ValueError(
                    f"sparse QP buckets require kkt_system=CONDENSED, got {opt.kkt_system}"
                )
    else:
        probs, _ = bucket_pad(models, pad_multiple=pad_multiple, dtype=dtype, device=device)
    cfg = driver.make_config(opt, is_qp=probs.is_qp, dtype=dtype)
    _synchronize(device)
    t0 = time.time()
    _, scale, state = solve_batched(cfg, probs)
    _synchronize(device)
    wall = time.time() - t0
    return batched_stats(models, scale, state, wall)
