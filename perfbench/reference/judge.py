"""The comparison that decides ``correct``.

The program's answers for a sample of instances (status, objective, x, y,
zl, zu, as ``madipm_batch`` returned them) are held against the plain
reference (``reference/ipm.py``) solved on the same instances, with the
same right-hand sides, and each number read here is compared with its
limit from ``perfbench/limits/<cell>.json``:

- ``unsolved``: instances whose status is not SOLVE_SUCCEEDED, where the
  reference solved every one (limit 0);
- ``nonfinite``: instances whose answer holds a NaN or an infinity
  (limit 0);
- ``ref_unsolved``: instances the reference did not solve to its own tol
  (limit 0; the comparison cannot judge them);
- ``kkt_res``: the worst relative residual of the program's own point on
  the generated instance (primal, dual, duality gap; ``ipm.residuals``);
- ``obj_gap``: the worst |objective - reference objective| / (1 + |reference|).

``x_gap``, the worst max|x - x_ref| / (1 + max|x_ref|), is read and
printed but not compared: near a degenerate vertex x is fixed far less
tightly than the residuals, and sound runs spread over three orders.

``kkt_res``, ``obj_gap`` and ``x_gap`` are taken over the instances whose
answers are finite (``nonfinite`` counts the others), so that a run with a
NaN in one answer still reads a number for the rest; with no finite
answer they read inf.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import ipm

#: the status code of a solve that met its tolerance (the program's
#: ``Status.SOLVE_SUCCEEDED``; the reference does not import the program)
SOLVE_SUCCEEDED = 2

#: the numbers compared, in the order they are printed
NUMBERS = ("unsolved", "nonfinite", "ref_unsolved", "kkt_res", "obj_gap")


def readings(instances: Sequence[dict], rhs_scale: Sequence[float], answers: Sequence[dict],
             device) -> Dict[str, float]:
    """The numbers compared, and ``x_gap``, for ``answers[i]`` (a dict
    with ``status``, ``objective``, ``x``, ``y``, ``zl``, ``zu``) on
    ``instances[i]`` with its right-hand side times ``rhs_scale[i]``."""
    p = ipm.Batch.from_instances(instances, rhs_scale, device)
    ref = ipm.solve(p)
    as_t = lambda key: torch.as_tensor(np.stack([np.asarray(a[key], dtype=np.float64) for a in answers]),
                                       dtype=torch.float64, device=device)
    x, y, zl, zu = (as_t(key) for key in ("x", "y", "zl", "zu"))
    pr, du, gap = ipm.residuals(p, x, y, zl, zu)
    obj = torch.as_tensor([float(a["objective"]) for a in answers], dtype=torch.float64, device=device)
    finite = torch.stack([t.isfinite().all(-1) for t in (x, y, zl, zu)]).all(0) & obj.isfinite()
    obj_gap = (obj - ref.objective).abs() / (1 + ref.objective.abs())
    x_gap = (x - ref.x).abs().amax(-1) / (1 + ref.x.abs().amax(-1))
    worst = lambda t: float(t[finite].max()) if bool(finite.any()) else float("inf")
    return dict(
        unsolved=float(sum(int(a["status"]) != SOLVE_SUCCEEDED for a in answers)),
        nonfinite=float((~finite).sum()),
        ref_unsolved=float((~ref.solved).sum()),
        kkt_res=worst(torch.stack([pr, du, gap]).amax(0)),
        obj_gap=worst(obj_gap),
        x_gap=worst(x_gap),
    )


def verdict(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True where every number is at or under its limit."""
    missing = set(NUMBERS) - set(limits)
    if missing:
        raise ValueError(f"no limit for {sorted(missing)}")
    return all(values[name] <= limits[name] for name in NUMBERS)
