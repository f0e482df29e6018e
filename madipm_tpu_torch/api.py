"""Top-level solver API: the counterpart of ``madipm_tpu/api.py``.

    QuadraticModel (host) -> slack_form
      -> pad_to_device (one-lane TorchQP) or, on the sparse route,
         pad_sparse_to_device (one-lane SparseTorchQP)
      -> solver.driver.solve_device -> IPMStats (unscaled, input variables)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .models.qp import QuadraticModel, pad_to_device, slack_form
from .models.sparse import pad_sparse_to_device
from .solver import driver
from .utils.logging import Logger
from .utils.options import KKTSystem, load_options
from .utils.stats import IPMStats
from .utils.status import Status


def default_device() -> torch.device:
    """The first CUDA device.  Without one this raises: the CPU is taken
    only when the caller asks for it with ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device found; pass device="cpu" to solve on the CPU'
        )
    return torch.device("cuda")


def _ensure_fp32_matmul():
    """Keep float32 products in full float32: a TF32 factor breaks the
    convergence of the fp32-factor + fp64-PCG configuration."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def use_sparse(slack_model: QuadraticModel) -> bool:
    """The automatic choice of the sparse route (the JAX package's rule):
    an LP whose Jacobian has more than 64e6 entries and a
    density under 2%, judged after ``slack_form``."""
    dense_entries = slack_model.ncon * slack_model.nvar
    density = slack_model.A.nnz / max(1, dense_entries)
    return (not slack_model.is_qp) and dense_entries > 64_000_000 and density < 0.02


#: the pattern the sparse route packs for each KKT system it supports
SPARSE_PATTERNS = {KKTSystem.NORMAL: "normal", KKTSystem.CONDENSED: "condensed"}


class MPCSolver:
    """Holds the transformed device problem and its configuration."""

    def __init__(
        self,
        model: QuadraticModel,
        dtype: torch.dtype = torch.float64,
        pad_multiple: int = 128,
        device=None,
        sparse: Optional[bool] = None,
        **options,
    ):
        """``sparse=None`` takes the ELL route of ``models/sparse.py`` by
        :func:`use_sparse`; a sparse QP is solved on K1 (CONDENSED), which
        is chosen for it when no ``kkt_system`` is given."""
        _ensure_fp32_matmul()
        self.model = model
        self.opt = options.pop("options", None) or load_options(**options)
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else default_device()
        t0 = time.time()
        self.slack_model = slack_form(model)
        if sparse is None:
            sparse = use_sparse(self.slack_model)
        if sparse:
            kkt = self.opt.resolved_kkt(self.slack_model.is_qp)
            if self.slack_model.is_qp and kkt != KKTSystem.CONDENSED:
                if self.opt.kkt_system is not None:
                    raise ValueError(f"sparse QPs require kkt_system=CONDENSED, got {kkt}")
                kkt = KKTSystem.CONDENSED
                self.opt = dataclasses.replace(self.opt, kkt_system=kkt)
            if kkt not in SPARSE_PATTERNS:
                raise ValueError(
                    f"the sparse path supports NORMAL and CONDENSED KKT systems, got {kkt}"
                )
            self.prob = pad_sparse_to_device(
                self.slack_model, dtype=self.dtype, pad_multiple=pad_multiple,
                device=self.device, kkt=SPARSE_PATTERNS[kkt],
            )
        else:
            self.prob = pad_to_device(
                self.slack_model, dtype=self.dtype, pad_multiple=pad_multiple, device=self.device
            )
        self.cfg = driver.make_config(self.opt, is_qp=self.prob.is_qp, dtype=self.dtype)
        self.init_time = time.time() - t0

    def solve(self, logged: bool = None, timed: bool = False) -> IPMStats:
        """Run the MPC loop (the fused driver).  The per-iteration table,
        the phase-timed driver and a finite ``max_wall_time`` are ROADMAP
        item A10: ``logged=True``, ``timed=True`` and ``max_wall_time`` below
        1e6 raise NotImplementedError; ``logged=None`` runs unlogged."""
        if logged or timed:
            raise NotImplementedError("the logged and timed drivers are ROADMAP item A10")
        if self.opt.max_wall_time < 1e6:
            raise NotImplementedError("a finite max_wall_time is ROADMAP item A10")
        logger = Logger(
            print_level=self.opt.print_level,
            file_print_level=self.opt.file_print_level,
            output_file=self.opt.output_file,
        )
        t0 = time.time()
        # Host-side exceptions map to a status unless rethrow_error, as in
        # the JAX package; NaNs inside the loop map to
        # ERROR_IN_STEP_COMPUTATION there.
        try:
            _, scale, state = driver.solve_device(self.cfg, self.prob)
            _synchronize(self.device)
        except KeyboardInterrupt:
            if self.opt.rethrow_error:
                raise
            return self._exit(logger, self._error_stats(Status.USER_REQUESTED_STOP, time.time() - t0))
        except Exception as e:  # noqa: BLE001 - status-mapping boundary
            if self.opt.rethrow_error:
                raise
            logger.error(f"solve failed: {type(e).__name__}: {e}")
            return self._exit(logger, self._error_stats(Status.INTERNAL_ERROR, time.time() - t0))
        stats = self._build_stats(scale, state, time.time() - t0)
        logger.notice(
            f"EXIT: {stats.message()}  (iter={stats.iter}, "
            f"obj={stats.objective:.8e}, time={stats.total_time:.3f}s)"
        )
        logger.close()
        return stats

    def _exit(self, logger: Logger, stats: IPMStats) -> IPMStats:
        logger.notice(f"EXIT: {stats.message()}")
        logger.close()
        return stats

    def _error_stats(self, status: Status, solver_time: float) -> IPMStats:
        """Stats shell for a solve that died host-side (no iterate)."""
        m0, n0 = self.model.ncon, self.model.nvar
        return IPMStats(
            status=status,
            objective=float("nan"),
            solution=np.full(n0, np.nan),
            constraints=np.full(m0, np.nan),
            multipliers=np.full(m0, np.nan),
            multipliers_L=np.full(n0, np.nan),
            multipliers_U=np.full(n0, np.nan),
            iter=0,
            primal_feas=float("inf"),
            dual_feas=float("inf"),
            complementarity=float("inf"),
            total_time=solver_time + self.init_time,
            init_time=self.init_time,
            solver_time=solver_time,
        )

    def _build_stats(self, scale, state, solver_time) -> IPMStats:
        m0, n0 = self.model.ncon, self.model.nvar
        s = state.to_numpy()
        osc = float(scale.obj_scale[0, 0])
        csc = scale.con_scale[0].cpu().numpy()[:m0]
        x = s["x"][0][:n0]
        sign = 1.0 if self.model.minimize else -1.0
        return IPMStats(
            status=Status(int(s["status"][0])),
            objective=sign * float(s["obj_val"][0]) / osc,
            solution=x,
            constraints=self.model.cons(x),
            multipliers=s["y"][0][:m0] * csc / osc,
            multipliers_L=s["zl"][0][:n0] / osc,
            multipliers_U=s["zu"][0][:n0] / osc,
            iter=int(s["k"][0]),
            primal_feas=float(s["inf_pr"][0]),
            dual_feas=float(s["inf_du"][0]),
            complementarity=float(s["inf_compl"][0]),
            total_time=solver_time + self.init_time,
            init_time=self.init_time,
            solver_time=solver_time,
        )


def madipm(model: QuadraticModel, **options) -> IPMStats:
    """Solve an LP or a convex QP with the Mehrotra predictor-corrector
    interior-point method.  ``device`` (default: the first CUDA device;
    without one, ``device="cpu"`` must be given) and ``dtype`` go to
    :class:`MPCSolver`, and so does ``sparse`` (None: the automatic
    choice of the ELL route); the rest are IPMOptions.  A maximization model
    (concave Q) is negated on entry and its objective flipped back."""
    if not model.minimize:
        model = QuadraticModel(
            c=-model.c,
            A=model.A,
            lcon=model.lcon,
            ucon=model.ucon,
            lvar=model.lvar,
            uvar=model.uvar,
            Q=None if model.Q is None else -model.Q,
            c0=-model.c0,
            x0=model.x0,
            y0=model.y0,
            name=model.name,
            minimize=False,  # remembered so the stats flip the sign back
        )
    return MPCSolver(model, **options).solve()
