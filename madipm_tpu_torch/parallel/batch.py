"""Batched solves: the port of ``madipm_tpu/parallel/batch.py``.

Instances padded to a common bucket shape are stacked on the leading lane
dimension of one TorchQP (dense) or SparseTorchQP (ELL, ``sparse=True``)
and solved together (``solver.driver.solve_device`` runs every lane; a
lane that has stopped keeps its state).  With a mesh the lanes are split
over its ``batch`` axis: each rank solves its block of lanes, with no
communication inside the solve, and the results are gathered so that every
rank returns all of them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence, Union

import numpy as np
import torch

from ..api import _ensure_fp32_matmul, _synchronize, default_device
from ..models import native
from ..models import sparse as sparse_model
from ..models.qp import QuadraticModel, TorchQP, _round_up, pack_lanes, slack_form
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
from ..utils import comm
from ..utils.logging import span, spanned
from ..utils.options import KKTSystem, load_options
from ..utils.stats import IPMStats
from ..utils.status import Status


Problem = Union[TorchQP, SparseTorchQP]

#: host nanoseconds spent packing and uploading the instances
#: (``madipm.batch.pack``), added once per :func:`madipm_batch` call
pack_ns = 0
#: bytes of the host buffers that :func:`bucket_pad` hands to the device,
#: and the number of host-to-device copies it makes (the dense route)
upload_bytes = 0
uploads = 0


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
    """Slack-form + pad a set of models to one common bucket shape, packed
    from their nonzeros in one piece (``models.qp.pack_lanes``: two
    host-to-device copies, whatever the number of lanes, which
    :data:`upload_bytes` and :data:`uploads` count)."""
    global upload_bytes, uploads
    slacked = [slack_form(m) for m in models]
    m_pad = max(_round_up(s.ncon, pad_multiple) for s in slacked)
    n_pad = max(_round_up(s.nvar, pad_multiple) for s in slacked)
    probs, staged = pack_lanes(slacked, m_pad, n_pad, dtype=dtype, device=device)
    upload_bytes += sum(staged)
    uploads += len(staged)
    return probs, slacked


def bucket_pad_sparse(models: Sequence[QuadraticModel], pad_multiple: int = 128,
                      dtype: torch.dtype = torch.float64, device=None):
    """Slack-form + pack a set of sparse LPs/QPs into one SparseTorchQP
    bucket.

    The lanes share the padded m and n, the ELL widths and the pattern
    lengths; padded pattern slots carry the out-of-range indices that the
    assembly drops (``models/sparse._pad_pattern``).  A bucket holding any
    QP is packed for K1 (CONDENSED), with an explicit zero Q for its LPs.
    The shared widths come from the nonzero counts, so each lane's pattern
    is built once.  The host build, from the slack forms to the stacked
    arrays, runs inside ``madipm.sparse.pattern`` and adds its time to
    ``models.sparse.pattern_ns``; the upload does not."""
    slacked = [slack_form(m) for m in models]
    native.available()  # the library's one-off load or build is not packing
    t0 = time.perf_counter_ns()
    with span("madipm.sparse.pattern"):
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
    sparse_model.pattern_ns += time.perf_counter_ns() - t0
    return SparseTorchQP.from_numpy(stacked, device=device, dtype=dtype), slacked


def select_lanes(probs: Problem, lanes: Sequence[int], device=None) -> Problem:
    """The problem of the given lanes (in that order, repeats allowed),
    moved to ``device`` (default: where it is)."""
    idx = torch.as_tensor(list(lanes), dtype=torch.long, device=probs.c.device)
    device = probs.c.device if device is None else device
    fields = {}
    for f in dataclasses.fields(probs):
        v = getattr(probs, f.name)
        fields[f.name] = v.index_select(0, idx).to(device) if isinstance(v, torch.Tensor) else v
    return type(probs)(**fields)


def lane_block(k: int, mesh, axis: str = "batch") -> List[int]:
    """The lanes this rank solves out of ``k``: its block of the batch
    padded to a multiple of the axis size, the pad lanes repeating lane 0
    (a solved duplicate costs nothing: every lane runs the same loop)."""
    group = mesh.get_group(axis)
    P, r = comm.size(group), comm.rank(group)
    block = -(-k // P)
    return [i if i < k else 0 for i in range(r * block, (r + 1) * block)]


def _gather_lanes(t: torch.Tensor, group, k: int) -> torch.Tensor:
    """Every rank's lane block of ``t``, in rank order, the pad lanes dropped."""
    out = comm.gather_blocks(t, group)
    return out.reshape((-1,) + tuple(t.shape[1:]))[:k]


def solve_batched(cfg: driver.SolverConfig, probs: Problem, mesh=None, axis: str = "batch"):
    """Solve a stacked batch; returns (prob_scaled, scale, state) with a
    leading lane dimension.

    With ``mesh`` each rank of the ``axis`` solves :func:`lane_block` of
    ``probs`` (which every rank holds whole, on any device), moved to this
    rank's device of the mesh (``rank_device``), and the scale and
    state of every lane are gathered, so that each rank returns all of
    them; prob_scaled is then None (the scaled lanes stay on their ranks).
    """
    if mesh is None:
        return driver.solve_device(cfg, probs)
    from .mesh import rank_device

    k, group = probs.batch, mesh.get_group(axis)
    local = select_lanes(probs, lane_block(k, mesh, axis), rank_device(mesh))
    _, scale, state = driver.solve_device(cfg, local)
    gather = lambda t: _gather_lanes(t, group, k)
    scale = type(scale)(*map(gather, scale))
    state = IPMState(**{f.name: gather(getattr(state, f.name)) for f in dataclasses.fields(state)})
    return None, scale, state


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


@spanned("madipm.batch")
def madipm_batch(models: Sequence[QuadraticModel], pad_multiple: int = 128,
                 dtype: torch.dtype = torch.float64, device=None, sparse: bool = False,
                 mesh=None, **options) -> List[IPMStats]:
    """Solve many instances as the lanes of one batched solve: all LPs or
    all QPs on the dense route, any mix on the ELL route (``sparse=True``),
    where a bucket with a QP is solved on K1 (CONDENSED).  ``device``
    defaults to the first CUDA device; without one, ``device="cpu"`` must
    be given.  ``solver_time`` covers the solve only, not packing and
    upload (with a mesh it covers the upload of the rank's lanes).

    ``mesh`` (a DeviceMesh with a ``batch`` axis) splits the lanes over the
    ranks of that axis (:func:`solve_batched`), every rank calling with the
    same models; each returns the stats of all of them, with the longest
    rank's solve time.  The device is the rank's (``mesh_device``)."""
    global pack_ns
    _ensure_fp32_matmul()
    opt = load_options(**options)
    if mesh is not None:
        from .mesh import mesh_device

        device = mesh_device(mesh, device)
    else:
        device = torch.device(device) if device is not None else default_device()
    # With a mesh the bucket is packed on the host and only this rank's
    # lanes are uploaded.
    pack_device = None if mesh is not None else device
    t_pack = time.perf_counter_ns()
    with span("madipm.batch.pack"):
        if sparse:
            probs, _ = bucket_pad_sparse(models, pad_multiple=pad_multiple, dtype=dtype,
                                         device=pack_device)
            if probs.is_qp:
                if opt.kkt_system is None:
                    opt = dataclasses.replace(opt, kkt_system=KKTSystem.CONDENSED)
                elif opt.kkt_system != KKTSystem.CONDENSED:
                    raise ValueError(
                        f"sparse QP buckets require kkt_system=CONDENSED, got {opt.kkt_system}"
                    )
        else:
            probs, _ = bucket_pad(models, pad_multiple=pad_multiple, dtype=dtype, device=pack_device)
    pack_ns += time.perf_counter_ns() - t_pack
    cfg = driver.make_config(opt, is_qp=probs.is_qp, dtype=dtype)
    _synchronize(device)
    t0 = time.time()
    with span("madipm.batch.solve"):
        _, scale, state = solve_batched(cfg, probs, mesh=mesh)
        _synchronize(device)
    wall = time.time() - t0
    if mesh is not None:
        t = torch.tensor([wall], dtype=torch.float64, device=device)
        wall = float(comm.all_max(t, mesh.get_group("batch"))[0])
    with span("madipm.batch.unpack"):
        return batched_stats(models, scale, state, wall)
