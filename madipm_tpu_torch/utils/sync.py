"""Host syncs of the batched solve.

Every data-dependent exit of the solve (the outer and inner loop tests,
the factor-retry loop, each PCG trip) reads one flag from the device.  On
a GPU that read waits for the queued work; :func:`any_true` is the only
place the solver does it, and ``count`` counts the calls.
"""

from __future__ import annotations

import torch

#: number of device-to-host flag reads made by :func:`any_true`
count = 0


def any_true(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted."""
    global count
    count += 1
    return bool(mask.any())
