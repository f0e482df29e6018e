"""Solver-state checkpoint and warm start: the port of
``madipm_tpu/utils/checkpoint.py``.

A checkpoint is the JAX package's ``.npz``: one array per ``IPMState``
field under the field's name, one instance without a lane dimension
(vectors 1-d, scalars 0-d; int32 counters and status, a bool ``ls_cert``,
the rest float64).  A checkpoint written by either package therefore
resumes in the other, against the same padded problem.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..solver import driver
from ..solver import kernels as K
from ..solver.state import _INTS, IPMState
from .stats import IPMStats
from .status import Status


def save_state(path: str, state: IPMState) -> None:
    """Write a one-lane IPMState to an ``.npz`` file in the JAX package's
    format (the lane dimension dropped)."""
    if state.x.shape[0] != 1:
        raise ValueError(f"save_state writes one instance, got a batch of {state.x.shape[0]}")
    arrays = {name: np.asarray(v[0]) for name, v in state.to_numpy().items()}
    np.savez_compressed(path, **arrays)


def load_state(path: str, dtype: torch.dtype = torch.float64, device=None) -> IPMState:
    """Read a checkpoint of :func:`save_state` (or of the JAX package) as a
    one-lane IPMState on ``device`` (default: the first CUDA device; the
    CPU only when asked for).  A field the file lacks (added after it was
    written) starts afresh: counters 0, ``best_pr`` at "no best yet" so the
    stall detector cannot misfire, ``ls_cert`` False, other scalars 0."""
    if device is None:
        from ..api import default_device

        device = default_device()
    with np.load(path) as data:
        fields = {}
        for f in dataclasses.fields(IPMState):
            name = f.name
            if name in data:
                fields[name] = data[name]
            elif name in _INTS:
                fields[name] = np.int32(0)
            elif name == "best_pr":
                fields[name] = np.float64(torch.finfo(dtype).max)
            elif name == "ls_cert":
                fields[name] = np.bool_(False)
            else:
                fields[name] = np.float64(0.0)
    return IPMState.from_numpy(fields, device=device, dtype=dtype)


def resume(solver, state: IPMState) -> IPMStats:
    """Continue a solve of ``solver`` (an :class:`~madipm_tpu_torch.api.MPCSolver`)
    from ``state``, which must come from the same padded problem and lie on
    the solver's device.  The status is set back to REGULAR and ``ls_cert``
    to False (a certificate holds only at the iterate it was measured on);
    then the fused loop nest (``driver.run_loop``) runs to the end."""
    cfg = solver.cfg
    t0 = time.time()
    prob_s, scale, _ = driver.initialize(cfg, solver.prob)
    state = state.replace(
        status=torch.full_like(state.status, int(Status.REGULAR)),
        ls_cert=torch.zeros_like(state.ls_cert),
    )
    state = driver.run_loop(cfg, prob_s, state)
    if state.x.is_cuda:
        torch.cuda.synchronize(state.x.device)
    return solver._build_stats(scale, state, time.time() - t0)


def warm_start_state(solver, x0=None, y0=None, bound_push: float = 1e-4) -> IPMState:
    """A starting state of ``solver``'s problem at a primal/dual guess: the
    initialized state with x at ``x0`` (pushed ``bound_push`` inside its
    bounds) and y at ``y0``, the bound multipliers at mu_init / slack."""
    cfg, prob = solver.cfg, solver.prob
    prob_s, _, st = driver.initialize(cfg, prob)
    if x0 is not None:
        x = torch.zeros_like(st.x)
        x[0, : len(x0)] = torch.as_tensor(np.asarray(x0), dtype=x.dtype)
        x = torch.where(prob.has_lb, torch.maximum(x, st.lb + bound_push), x)
        x = torch.where(prob.has_ub, torch.minimum(x, st.ub - bound_push), x)
        st = st.replace(x=torch.where(prob.free_mask, x, st.x))
    if y0 is not None:
        y = torch.zeros_like(st.y)
        y[0, : len(y0)] = torch.as_tensor(np.asarray(y0), dtype=y.dtype)
        st = st.replace(y=y)
    sl, su = K.slacks(dataclasses.replace(prob_s, lb=st.lb, ub=st.ub), st.x)
    mu = cfg.mu_init
    return st.replace(
        zl=torch.where(prob.has_lb, mu / torch.clamp(sl, min=bound_push), 0.0),
        zu=torch.where(prob.has_ub, mu / torch.clamp(su, min=bound_push), 0.0),
        status=torch.full_like(st.status, int(Status.REGULAR)),
    )
