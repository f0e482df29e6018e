"""Batched solves: the dense part of ``madipm_tpu/parallel/batch.py``.

Instances padded to a common bucket shape are stacked on the leading lane
dimension of one TorchQP and solved together (``solver.driver.solve_device``
runs every lane; a lane that has stopped keeps its state).  The mesh-
sharded path is ROADMAP item A11, the sparse bucket A8.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import torch

from ..api import _ensure_fp32_matmul, _synchronize, default_device
from ..models.qp import QuadraticModel, TorchQP, _round_up, pad_to_device, slack_form
from ..solver import driver
from ..solver.state import IPMState
from ..utils.options import load_options
from ..utils.stats import IPMStats
from ..utils.status import Status


def stack_problems(probs: Sequence[TorchQP]) -> TorchQP:
    """Concatenate same-shape TorchQPs along the lane dimension."""
    shapes = {(p.m, p.n, p.is_qp) for p in probs}
    if len(shapes) != 1:
        raise ValueError(f"all problems must share a padded shape, got {shapes}")
    fields = {}
    for f in dataclasses.fields(TorchQP):
        parts = [getattr(p, f.name) for p in probs]
        fields[f.name] = None if parts[0] is None else torch.cat(parts)
    return TorchQP(**fields)


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
                 dtype: torch.dtype = torch.float64, device=None, **options) -> List[IPMStats]:
    """Solve many instances, all LPs or all QPs, as the lanes of one
    batched solve.  ``device`` defaults to the first CUDA device; without
    one, ``device="cpu"`` must be given.  ``solver_time`` covers the solve
    only, not padding and upload."""
    _ensure_fp32_matmul()
    opt = load_options(**options)
    device = torch.device(device) if device is not None else default_device()
    probs, _ = bucket_pad(models, pad_multiple=pad_multiple, dtype=dtype, device=device)
    cfg = driver.make_config(opt, is_qp=probs.is_qp, dtype=dtype)
    _synchronize(device)
    t0 = time.time()
    _, scale, state = solve_batched(cfg, probs)
    _synchronize(device)
    wall = time.time() - t0
    return batched_stats(models, scale, state, wall)
