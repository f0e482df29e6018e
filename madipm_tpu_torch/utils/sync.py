"""Host syncs of the batched solve.

Every data-dependent exit of the solve (the outer and inner loop tests,
the factor-retry loop, each PCG trip) reads one flag from the device, and
the logged and timed drivers read a few values per iteration.  On a GPU
such a read waits for the queued work; :func:`any_true` and
:func:`to_host` are the only places the solver does it, and ``count``
counts the calls.
"""

from __future__ import annotations

import torch

#: number of device-to-host reads made by :func:`any_true` and :func:`to_host`
count = 0


def any_true(mask: torch.Tensor) -> bool:
    """``bool(mask.any())``, counted."""
    global count
    count += 1
    return bool(mask.any())


def to_host(t: torch.Tensor):
    """``t`` copied to the host as a numpy array, counted."""
    global count
    count += 1
    return t.detach().cpu().numpy()
