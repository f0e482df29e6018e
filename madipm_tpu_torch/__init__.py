"""madipm_tpu_torch — the Mehrotra predictor-corrector LP solver of
``madipm_tpu``, ported to PyTorch and CUDA.

This first slice runs the batched dense-LP path on the NORMAL KKT system:
``madipm(lp)`` and ``madipm_batch(models)``, with the factor of the
normal matrix either from ``torch.linalg`` (CHOLESKY) or, for
CHOLESKY_INV, from a hand-written CUDA kernel (``csrc/chol_inv.cu``,
the port of the JAX package's Pallas ``pallas_chol_inv``).  The package
imports torch and never jax.
"""

from .api import MPCSolver, madipm
from .models.qp import QuadraticModel, TorchQP, from_dense, pad_to_device, slack_form, standard_form
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
    "madipm_batch",
    "QuadraticModel",
    "TorchQP",
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
