"""One run of one cell: set-up, the measured window, the traced calls and
the comparison with the reference.

The traffic is a closed-loop parametric sweep with one caller: the next
call starts when the last one has returned.  At set-up the
configuration's generator builds its ``k`` instances (the traffic file's
one parameter), the same problems in every run (from the configuration's
``seed0``, so that the seed does not change the work); the seed gives
each run its own layout of them: their order, a permutation of each
instance's rows and of its columns, and the sign of each row.  Every
call hands ``madipm_tpu_torch.madipm_batch`` those ``k`` instances with
the right-hand side scaled by ``1 + RHS_JITTER * u``, a fresh ``u`` in
[0, 1) drawn from the seed for each call.  The program sees only the
instances and the options of the configuration's file.

Time is read from the host's clock (``time.perf_counter``); every call
ends with the program's own synchronisation and its statistics on the
host.  The run's records (:class:`Run`) are what the metric readers of
``perfbench/metrics/`` take.
"""

from __future__ import annotations

import copy
import dataclasses
import resource
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import spec
from . import trace as trace_mod
from .reference import judge

#: top-level module names that must not be loaded in a run's process
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "madipm_tpu"})
#: the right-hand side of a call is scaled by 1 + RHS_JITTER * u (bench.py's sweep)
RHS_JITTER = 1e-4


@dataclasses.dataclass
class Call:
    """One ``madipm_batch`` call of the window."""

    start: float            # host clock before the call
    end: float              # host clock after it returned
    solver_time: float      # the program's own solve time (stats[0].solver_time)
    iters: List[int]        # IPMStats.iter of each instance
    statuses: List[int]     # IPMStats.status of each instance
    scale: float            # the right-hand side's factor
    traced: bool            # inside the profiled range


@dataclasses.dataclass
class Run:
    """What a run recorded; the metric readers take it."""

    cell: spec.Cell
    k: int
    setup_s: float
    calls: List[Call]
    syncs: int                  # the program's host syncs over every call
    chol_launches_traced: int   # chol_inv launches during the profiled calls
    trace: Optional[trace_mod.Summary]
    checks: dict                # compared number -> (value, limit)
    correct: bool
    memory_peak_bytes: int

    @property
    def timed_calls(self) -> List[Call]:
        """The calls of the window; with --trace 1 the profiled call follows them."""
        return [c for c in self.calls if not c.traced]

    @property
    def traced_calls(self) -> List[Call]:
        return [c for c in self.calls if c.traced]


def loaded_forbidden() -> List[str]:
    """The forbidden top-level modules this process has loaded, by whole
    top-level name (``madipm_tpu_torch`` is not ``madipm_tpu``)."""
    return sorted({name.partition(".")[0] for name in sys.modules} & FORBIDDEN_MODULES)


def _value(v, mtt):
    """An option's value from its JSON: ``{"enum": E, "member": M}`` is
    ``mtt.E[M]``, ``{"class": C, "args": [...]}`` is ``mtt.C(*args)``."""
    if isinstance(v, dict) and set(v) == {"enum", "member"}:
        return getattr(mtt, v["enum"])[v["member"]]
    if isinstance(v, dict) and set(v) == {"class", "args"}:
        return getattr(mtt, v["class"])(*v["args"])
    return v


def call_arguments(config: dict, mtt, control: bool = False) -> dict:
    """The keyword arguments of ``madipm_batch`` that the configuration
    fixes: its ``call`` group (dtype, padding) and its ``options``; with
    ``control``, the ``control`` group's changes on top."""
    import torch

    call = dict(config["call"])
    options = dict(config["options"])
    if control:
        call.update(config["control"].get("call", {}))
        options.update(config["control"].get("options", {}))
    args = {key: _value(v, mtt) for key, v in options.items()}
    args["dtype"] = getattr(torch, call.pop("dtype"))
    args.update(call)
    return args


def _scaled(models: Sequence, f: float) -> list:
    """The models with their right-hand side times ``f`` (shallow copies:
    the matrices are shared, not rebuilt)."""
    out = []
    for q in models:
        q2 = copy.copy(q)
        q2.lcon = q.lcon * f
        q2.ucon = q.ucon * f
        out.append(q2)
    return out


def laid_out(inst: dict, rng: np.random.Generator) -> dict:
    """The same problem in a layout drawn from ``rng``: its rows and its
    columns permuted, and each row's sign flipped or not."""
    A = inst["A"]
    rows, cols = rng.permutation(A.shape[0]), rng.permutation(A.shape[1])
    sign = np.where(rng.random(A.shape[0]) < 0.5, -1.0, 1.0)
    lo, hi = sign * inst["lcon"][rows], sign * inst["ucon"][rows]
    Q = inst["Q"]
    return dict(inst, A=sign[:, None] * A[np.ix_(rows, cols)], lcon=np.minimum(lo, hi),
                ucon=np.maximum(lo, hi), c=inst["c"][cols], lvar=inst["lvar"][cols],
                uvar=inst["uvar"][cols], Q=None if Q is None else Q[np.ix_(cols, cols)])


def _host_usage() -> np.ndarray:
    """This process's CPU seconds so far, user and system."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return np.array([r.ru_utime, r.ru_stime])


def _answer(s) -> dict:
    return dict(status=int(s.status), objective=float(s.objective), x=s.solution,
                y=s.multipliers, zl=s.multipliers_L, zu=s.multipliers_U)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, control: bool = False,
        solve: Optional[Callable[[list], list]] = None, log=print) -> Run:
    """Set up, measure for ``seconds``, compare, and return the records.

    ``solve`` replaces the program's call (``madipm_batch`` with the
    configuration's arguments), where a test breaks it on purpose or a
    control takes its place; ``control`` runs the configuration's own
    lower-precision path instead of the configuration as stated."""
    import torch

    import madipm_tpu_torch as mtt
    from madipm_tpu_torch.ops import chol_inv
    from madipm_tpu_torch.utils import sync

    cfg = cell.config
    k = int(cell.traffic["k"])
    gen = dict(cfg["generator"])
    made = spec.generator(gen.pop("name")).generate(k=k, **gen)
    layout = np.random.default_rng([seed, 0])
    instances = [laid_out(made[int(i)], layout) for i in layout.permutation(k)]
    models = [mtt.from_dense(**inst) for inst in instances]
    if solve is None:
        args = call_arguments(cfg, mtt, control)
        solve = lambda ms: mtt.madipm_batch(ms, device=device, **args)
    on_cuda = device.startswith("cuda")
    solve(_scaled(models, 1.0))  # the warm call: kernel build, library handles, the cell's shapes
    setup_s = time.perf_counter() - t_start

    draws = np.random.default_rng([seed, 1])
    calls: List[Call] = []
    answers: List[list] = []

    def one_call(profiled: bool) -> None:
        f = 1.0 + RHS_JITTER * float(draws.random())
        ms = _scaled(models, f)
        t0 = time.perf_counter()
        stats = solve(ms)
        t1 = time.perf_counter()
        calls.append(Call(start=t0, end=t1, solver_time=float(stats[0].solver_time),
                          iters=[int(s.iter) for s in stats], statuses=[int(s.status) for s in stats],
                          scale=f, traced=profiled))
        answers.append([_answer(s) for s in stats])

    sync.count = 0
    usage0 = _host_usage()
    deadline = time.perf_counter() + seconds
    while time.perf_counter() < deadline:
        one_call(profiled=False)
    usage = _host_usage() - usage0
    window = calls[-1].end - calls[0].start
    summary, chol_traced = None, 0
    if traced:
        # after the window, so that the profiler's hooks slow no timed call
        launches0 = chol_inv.launches
        with trace_mod.Capture() as cap:
            one_call(profiled=True)
        summary, chol_traced = cap.summary, chol_inv.launches - launches0
    syncs = sync.count
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_cuda else 0
    log(f"perfbench: {cell.name} seed {seed}{' control' if control else ''}: {len(calls)} calls, "
        f"{len(calls) * k} instances, {sum(s == judge.SOLVE_SUCCEEDED for c in calls for s in c.statuses)} "
        f"solved, window {window:.4f} s, setup {setup_s:.4f} s, "
        f"batch iterations {sorted(set(max(c.iters) for c in calls))}")
    log(f"perfbench: host CPU over the window: user {usage[0]:.4f} s, system {usage[1]:.4f} s")

    # the comparison: lane i of a call drawn from the seed, for every lane
    pick = np.random.default_rng([seed, 2]).integers(len(calls), size=k)
    sample = [answers[int(c)][i] for i, c in enumerate(pick)]
    scales = [calls[int(c)].scale for c in pick]
    del answers, models
    if on_cuda:
        torch.cuda.empty_cache()
    values = judge.readings(instances, scales, sample, device)
    log(f"perfbench: not compared: x_gap {values['x_gap']!r}")
    checks = {name: (values[name], float(cell.limits[name])) for name in judge.NUMBERS}
    return Run(cell=cell, k=k, setup_s=setup_s, calls=calls, syncs=syncs,
               chol_launches_traced=chol_traced, trace=summary, checks=checks,
               correct=judge.verdict(values, cell.limits), memory_peak_bytes=memory_peak)
