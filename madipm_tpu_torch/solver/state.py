"""Solver state: the counterpart of ``madipm_tpu/solver/state.py``.

One dataclass of tensors holds the iterate of every lane of the batch.
Vectors are (B, n) or (B, m); each per-lane scalar is a (B, 1) column, so
it broadcasts against the lane's vectors without reshaping.  Counters and
the status are int32, ``ls_cert`` is bool.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.status import Status

_VECTORS = ("x", "y", "zl", "zu", "lb", "ub", "dx", "dy", "dzl", "dzu")
_INTS = ("k", "status", "n_acceptable", "n_stall")


@dataclasses.dataclass(eq=False)
class IPMState:
    # Primal-dual iterate (masked invariants: zl=0 off has_lb, zu=0 off
    # has_ub, x pinned on fixed/padded columns)
    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    # Working bounds, nudged outward by adjust_boundary
    lb: torch.Tensor
    ub: torch.Tensor
    # Last search direction
    dx: torch.Tensor
    dy: torch.Tensor
    dzl: torch.Tensor
    dzu: torch.Tensor
    # Barrier / step / regularization scalars
    mu: torch.Tensor
    mu_curr: torch.Tensor
    alpha_p: torch.Tensor
    alpha_d: torch.Tensor
    del_w: torch.Tensor
    del_c: torch.Tensor
    reg_p: torch.Tensor
    reg_d: torch.Tensor
    # Convergence diagnostics
    obj_val: torch.Tensor
    inf_pr: torch.Tensor
    inf_du: torch.Tensor
    inf_compl: torch.Tensor
    best_compl: torch.Tensor
    norm_b: torch.Tensor
    norm_c: torch.Tensor
    # Counters / status
    k: torch.Tensor
    status: torch.Tensor
    lin_resid: torch.Tensor
    n_acceptable: torch.Tensor
    best_pr: torch.Tensor
    n_stall: torch.Tensor
    ls_cert: torch.Tensor

    def replace(self, **changes) -> "IPMState":
        return dataclasses.replace(self, **changes)

    def where(self, mask: torch.Tensor, other: "IPMState") -> "IPMState":
        """Lane-wise select: this state where ``mask`` (B, 1), else ``other``."""
        return IPMState(**{
            f.name: torch.where(mask, getattr(self, f.name), getattr(other, f.name))
            for f in dataclasses.fields(self)
        })

    def to_numpy(self) -> dict:
        """Fields as numpy arrays: vectors (B, len), scalars (B,)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name).detach().cpu().numpy()
            out[f.name] = v if f.name in _VECTORS else v[:, 0]
        return out

    @classmethod
    def from_numpy(cls, fields: dict, device=None, dtype=torch.float64) -> "IPMState":
        """Build from numpy arrays named as the fields, one lane (``x`` of
        shape (n,)) or a batch ((B, n))."""
        batched = np.ndim(fields["x"]) == 2
        kw = {}
        for f in dataclasses.fields(cls):
            v = np.array(fields[f.name])  # a writable copy
            if not batched:
                v = v[None]
            if f.name not in _VECTORS:
                v = v.reshape(-1, 1)
            if f.name in _INTS:
                dt = torch.int32
            elif f.name == "ls_cert":
                dt = torch.bool
            else:
                dt = dtype
            kw[f.name] = torch.as_tensor(v, dtype=dt, device=device)
        return cls(**kw)


def init_state(batch: int, n: int, m: int, dtype=torch.float64, device=None) -> IPMState:
    z = lambda d: torch.zeros(batch, d, dtype=dtype, device=device)
    sc = lambda v=0.0: torch.full((batch, 1), v, dtype=dtype, device=device)
    iz = lambda v=0: torch.full((batch, 1), v, dtype=torch.int32, device=device)
    big = torch.finfo(dtype).max
    return IPMState(
        x=z(n), y=z(m), zl=z(n), zu=z(n),
        lb=z(n), ub=z(n),
        dx=z(n), dy=z(m), dzl=z(n), dzu=z(n),
        mu=sc(1e-1), mu_curr=sc(),
        alpha_p=sc(), alpha_d=sc(),
        del_w=sc(), del_c=sc(), reg_p=sc(), reg_d=sc(),
        obj_val=sc(), inf_pr=sc(float("inf")), inf_du=sc(float("inf")),
        inf_compl=sc(float("inf")), best_compl=sc(big),
        norm_b=sc(), norm_c=sc(),
        k=iz(),
        status=iz(int(Status.INITIAL)),
        lin_resid=sc(),
        n_acceptable=iz(),
        best_pr=sc(big),
        n_stall=iz(),
        ls_cert=torch.zeros(batch, 1, dtype=torch.bool, device=device),
    )
