"""The plain reference: a dense Mehrotra predictor-corrector for a batch
of convex QPs (LPs when Q is absent) in plain PyTorch.

    min  c'x + 1/2 x'Qx   s.t.  A x = b,  l <= x <= u   (l finite, u may be inf)

It reads the instances the benchmark generated, as they are: no slack
form, no scaling, no padding.  Each Newton step eliminates the bound
multipliers and solves the normal equations A H^-1 A' dy = r with
H = Q + Z_l S_l^-1 + Z_u S_u^-1, through ``torch.linalg.cholesky``.  The
multipliers follow the program's sign convention, the stationarity being
c + Qx + A'y - zl + zu = 0.

It imports nothing of the program and runs on any device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class Batch:
    """A batch of instances as dense tensors; ``Q`` is None for LPs."""

    c: torch.Tensor     # (k, n)
    A: torch.Tensor     # (k, m, n)
    b: torch.Tensor     # (k, m)
    l: torch.Tensor     # (k, n), finite
    u: torch.Tensor     # (k, n), inf where unbounded
    Q: Optional[torch.Tensor] = None  # (k, n, n)

    @classmethod
    def from_instances(cls, instances: Sequence[dict], rhs_scale: Sequence[float],
                       device, dtype=torch.float64) -> "Batch":
        """Stack raw instances (``generators``' dicts, equality rows only),
        each with its right-hand side times ``rhs_scale[i]``."""
        for q in instances:
            if not np.array_equal(q["lcon"], q["ucon"]):
                raise ValueError("the reference takes equality rows only (lcon == ucon)")
            if not np.all(np.isfinite(q["lvar"])):
                raise ValueError("the reference takes finite lower bounds only")

        def stack(key, scale=None):
            arr = np.stack([q[key] * (1.0 if scale is None else scale[i])
                            for i, q in enumerate(instances)])
            return torch.as_tensor(arr, dtype=dtype, device=device)

        Q = None
        if instances[0]["Q"] is not None:
            Q = stack("Q")
        return cls(c=stack("c"), A=stack("A"), b=stack("lcon", rhs_scale), l=stack("lvar"),
                   u=stack("uvar"), Q=Q)

    def objective(self, x: torch.Tensor) -> torch.Tensor:
        obj = (self.c * x).sum(-1)
        if self.Q is not None:
            obj = obj + 0.5 * (x * (self.Q @ x.unsqueeze(-1)).squeeze(-1)).sum(-1)
        return obj


@dataclasses.dataclass
class Solution:
    x: torch.Tensor
    y: torch.Tensor
    zl: torch.Tensor
    zu: torch.Tensor
    objective: torch.Tensor
    solved: torch.Tensor      # (k,) bool: every measure under tol
    iterations: torch.Tensor  # (k,)


def _matvec(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _rmatvec(M, v):
    return (M.mT @ v.unsqueeze(-1)).squeeze(-1)


def _max_step(v, dv):
    """Largest alpha in (0, 1] with v + alpha dv >= 0 for every entry
    (v > 0); entries with dv >= 0 do not bound it."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return ratio.amin(-1).clamp(max=1.0)


def _cholesky(M: torch.Tensor):
    """(L, ok): the Cholesky factor of each SPD matrix of ``M``, shifted
    by a multiple of its mean diagonal that starts near the type's round-off
    and grows a hundredfold for a lane whose factor broke down, up to a
    million times that; a lane still broken is ``ok`` False (and gets the
    identity)."""
    eps = torch.finfo(M.dtype).eps
    scale = M.diagonal(dim1=-2, dim2=-1).mean(-1)[:, None, None]
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    shift = 100 * eps * eps if M.dtype == torch.float64 else 10 * eps
    L, info = torch.linalg.cholesky_ex(M + shift * scale * eye)
    for _ in range(3):
        if not bool((info != 0).any()):
            break
        shift *= 100
        L2, info2 = torch.linalg.cholesky_ex(M + shift * scale * eye)
        bad = (info != 0)[:, None, None]
        L, info = torch.where(bad, L2, L), torch.where(info != 0, info2, info)
    ok = info == 0
    return torch.where(ok[:, None, None], L, eye), ok


def residuals(p: Batch, x, y, zl, zu):
    """(primal, dual, gap) relative measures of each lane: ||Ax - b||,
    bound violation; ||c + Qx + A'y - zl + zu||, negative multipliers;
    the duality gap (zl'(x - l) + zu'(u - x)) over 1 + |objective|."""
    hasu = torch.isfinite(p.u)
    u = torch.where(hasu, p.u, x)
    grad = p.c - zl + zu + _rmatvec(p.A, y)
    if p.Q is not None:
        grad = grad + _matvec(p.Q, x)
    viol = torch.maximum((p.l - x).clamp(min=0), (x - u).clamp(min=0)).amax(-1)
    pr = torch.maximum((_matvec(p.A, x) - p.b).abs().amax(-1), viol)
    neg = torch.maximum((-zl).clamp(min=0), (-zu).clamp(min=0)).amax(-1)
    du = torch.maximum(grad.abs().amax(-1), neg)
    gap = (zl * (x - p.l)).sum(-1) + torch.where(hasu, zu * (u - x), torch.zeros_like(x)).sum(-1)
    pr = pr / (1 + p.b.abs().amax(-1))
    du = du / (1 + p.c.abs().amax(-1))
    gap = gap.abs() / (1 + p.objective(x).abs())
    return pr, du, gap


def solve(p: Batch, tol: float = 1e-9, max_iter: int = 120, eta: float = 0.995) -> Solution:
    """Solve every lane of ``p`` by Mehrotra's predictor-corrector with a
    common primal-dual step.  A lane stops moving once its three measures
    are under ``tol`` (ten times under the program's 1e-8), or once its
    duality gap is under ``1e-4 tol``, where more steps only lose digits;
    it is solved if its three measures are then under ``tol``."""
    k, m, n = p.A.shape
    dt, dev = p.A.dtype, p.A.device
    hasu = torch.isfinite(p.u)
    fu = hasu.to(dt)
    width = torch.where(hasu, p.u - p.l, torch.full_like(p.u, 2.0))
    x = p.l + torch.minimum(torch.ones_like(p.l), 0.5 * width)
    y = torch.zeros(k, m, dtype=dt, device=dev)
    zl = torch.ones_like(x)
    zu = fu.clone()
    n_pairs = n + fu.sum(-1)
    eye_m = torch.eye(m, dtype=dt, device=dev)
    done = torch.zeros(k, dtype=torch.bool, device=dev)
    iters = torch.zeros(k, dtype=torch.long, device=dev)

    for _ in range(max_iter):
        pr, du, gap = residuals(p, x, y, zl, zu)
        done = done | ((pr <= tol) & (du <= tol) & (gap <= tol)) | (gap <= 1e-4 * tol)
        if bool(done.all()):
            break
        sl = x - p.l
        su = torch.where(hasu, p.u - x, torch.ones_like(x))
        mu = ((sl * zl).sum(-1) + (su * zu * fu).sum(-1)) / n_pairs
        rp = p.b - _matvec(p.A, x)
        rd = p.c + _rmatvec(p.A, y) - zl + zu
        if p.Q is not None:
            rd = rd + _matvec(p.Q, x)
        D = zl / sl + fu * zu / su

        # the normal matrix of this iteration and a solve with it
        if p.Q is None:
            Hinv_At = p.A.mT / D.unsqueeze(-1)                        # (k, n, m)
            M = p.A @ Hinv_At
            apply_Hinv = lambda v: v / D
        else:
            H = torch.where(done[:, None, None], torch.eye(n, dtype=dt, device=dev),
                            p.Q + torch.diag_embed(D))
            LH, ok_h = _cholesky(H)
            W = torch.linalg.solve_triangular(LH, p.A.mT, upper=False)  # L^-1 A'
            M = W.mT @ W
            apply_Hinv = lambda v: torch.cholesky_solve(v.unsqueeze(-1), LH).squeeze(-1)
        # a lane that has stopped is not solved for: its matrix may have lost
        # definiteness to the last digits
        LM, ok_m = _cholesky(torch.where(done[:, None, None], eye_m, M))
        done = done | ~ok_m if p.Q is None else done | ~ok_m | ~ok_h

        def reduced(g, r):
            """(dx, dy) with H dx + A' dy = g and A dx = r, by the normal
            equations."""
            dy = torch.cholesky_solve((_matvec(p.A, apply_Hinv(g)) - r).unsqueeze(-1), LM).squeeze(-1)
            return apply_Hinv(g - _rmatvec(p.A, dy)), dy

        def newton(rl, ru):
            """(dx, dy, dzl, dzu) for the complementarity targets
            sl dzl + zl dx = rl and su dzu - zu dx = ru.  Two steps of
            iterative refinement on the reduced system keep the dual
            residual at round-off where H spans many orders."""
            g = -rd + rl / sl - fu * ru / su
            dx, dy = reduced(g, rp)
            for _ in range(2):
                Hdx = D * dx if p.Q is None else _matvec(p.Q, dx) + D * dx
                ex, ey = reduced(g - Hdx - _rmatvec(p.A, dy), rp - _matvec(p.A, dx))
                dx, dy = dx + ex, dy + ey
            dzl = (rl - zl * dx) / sl
            dzu = fu * (ru + zu * dx) / su
            return dx, dy, dzl, dzu

        def step(dx, dzl, dzu):
            big = torch.full_like(x, float("inf"))
            a = torch.stack([
                _max_step(sl, dx),
                _max_step(torch.where(hasu, su, big), torch.where(hasu, -dx, big)),
                _max_step(zl, dzl),
                _max_step(torch.where(hasu, zu, big), torch.where(hasu, dzu, big)),
            ]).amin(0)
            return a

        # predictor
        dx_a, _, dzl_a, dzu_a = newton(-sl * zl, -fu * su * zu)
        a_aff = step(dx_a, dzl_a, dzu_a)
        al = a_aff.unsqueeze(-1)
        mu_aff = (((sl + al * dx_a) * (zl + al * dzl_a)).sum(-1)
                  + (fu * (su - al * dx_a) * (zu + al * dzu_a)).sum(-1)) / n_pairs
        sigma = (mu_aff / mu).clamp(min=0, max=1) ** 3
        sm = (sigma * mu).unsqueeze(-1)
        # corrector
        dx, dy, dzl, dzu = newton(sm - sl * zl - dx_a * dzl_a,
                                  fu * (sm - su * zu + dx_a * dzu_a))
        a = (eta * step(dx, dzl, dzu)).clamp(max=1.0)
        # a lane whose step is not finite stops where it is
        finite = torch.stack([t.isfinite().all(-1) for t in (dx, dy, dzl, dzu)]).all(0) & a.isfinite()
        done = done | ~finite
        ac = torch.where(done, torch.zeros_like(a), a).unsqueeze(-1)
        step_of = lambda d: torch.where(done.unsqueeze(-1), torch.zeros_like(d), ac * d)
        x = x + step_of(dx)
        y = y + step_of(dy)
        zl = zl + step_of(dzl)
        zu = zu + step_of(dzu)
        iters = iters + (~done).long()

    pr, du, gap = residuals(p, x, y, zl, zu)
    solved = (pr <= tol) & (du <= tol) & (gap <= tol)
    return Solution(x=x, y=y, zl=zl, zu=zu, objective=p.objective(x), solved=solved,
                    iterations=iters)
