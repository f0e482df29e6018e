"""Instance generators of the benchmark, one file each, found by the name
that a configuration's ``generator.name`` gives:
``perfbench/generators/<name>.py`` defines ``generate(k, seed0, **sizes)``.

A generator returns a list of ``k`` raw instances: dicts of numpy arrays
with the keys of ``madipm_tpu_torch.from_dense`` (``c``, ``A``, ``lcon``,
``ucon``, ``lvar``, ``uvar``, ``Q``, ``name``), dense and in float64.  The
harness hands them to the program through ``from_dense``; the reference
reads them as they are.
"""

from __future__ import annotations

import numpy as np


def raw_instance(c, A, b, uvar, Q, name) -> dict:
    """An equality-constrained instance ``A x = b``, ``0 <= x <= uvar``."""
    n = A.shape[1]
    return dict(c=c, A=A, lcon=b, ucon=b.copy(), lvar=np.zeros(n), uvar=uvar, Q=Q, name=name)
