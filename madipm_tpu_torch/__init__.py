"""madipm_tpu_torch — the Mehrotra predictor-corrector LP and convex-QP
solver of ``madipm_tpu``, ported to PyTorch and CUDA.

It runs the batched dense path, ``madipm(model)`` and
``madipm_batch(models)``, on every dense KKT system: NORMAL (LPs),
CONDENSED (K1) and AUGMENTED / SCALED_AUGMENTED (K2 / K2.5); the sparse
ELL route (``sparse=True``, or chosen for a large sparse LP) on NORMAL and
K1; the file front end ``from_mps`` (MPS/QPS, presolve, Ruiz scaling,
postsolve) with ``solve_linprog`` and ``solve_qp``; the algebraic
``Model``; and, as in the JAX package, the checkpoint functions in
``utils/checkpoint.py`` and the generators in ``models/generators.py``;
and the multi-GPU layer in ``parallel/`` on torch.distributed
(``MPCSolver(mesh=...)``, ``madipm_batch(mesh=...)``).
``MPCSolver.solve`` picks the JAX package's driver: the per-iteration
table at print_level <= INFO, the timed driver, a wall-clock guard for a
finite ``max_wall_time``, or the fused loop.  The factor
of an SPD system comes from ``torch.linalg`` (CHOLESKY) or from the
hand-written CUDA kernels of ``csrc/chol_inv.cu``: (L, L^-1) for
CHOLESKY_INV and L alone for CHOLESKY with ``use_pallas=True``, the ports
of the JAX package's Pallas ``pallas_chol_inv`` and ``pallas_cholesky``.
The package imports torch and never jax.
"""

from .api import MPCSolver, madipm
from .frontends import LinprogResult, from_mps, solve_linprog, solve_qp
from .modeling import Model
from .models.qp import QuadraticModel, TorchQP, from_dense, pad_to_device, slack_form, standard_form
from .models.sparse import SparseTorchQP, pad_sparse_to_device
from .parallel.batch import madipm_batch
from .utils.options import (
    AdaptiveRegularization,
    AdaptiveStep,
    ConservativeStep,
    FixedRegularization,
    IPMOptions,
    KKTSystem,
    LinearSolver,
    Mehrotra,
    MehrotraAdaptiveStep,
    NoRegularization,
    PrintLevel,
    load_options,
)
from .utils.stats import IPMStats
from .utils.status import Status

__all__ = [
    "MPCSolver",
    "madipm",
    "Model",
    "madipm_batch",
    "solve_linprog",
    "solve_qp",
    "from_mps",
    "LinprogResult",
    "QuadraticModel",
    "TorchQP",
    "SparseTorchQP",
    "pad_sparse_to_device",
    "from_dense",
    "slack_form",
    "standard_form",
    "pad_to_device",
    "IPMOptions",
    "load_options",
    "KKTSystem",
    "LinearSolver",
    "PrintLevel",
    "Status",
    "IPMStats",
    "Mehrotra",
    "ConservativeStep",
    "AdaptiveStep",
    "MehrotraAdaptiveStep",
    "NoRegularization",
    "FixedRegularization",
    "AdaptiveRegularization",
]
