"""Run a function on P CPU ranks of a gloo process group, with a deadline.

    results = run_ranks(fn, world=4, args=(...), workdir=path, deadline=120)
    run = start_ranks(...); ...; results = run.wait()   # work meanwhile

Each rank is a spawned process that takes one thread, joins the group
through a file store under ``workdir`` (no TCP port, so that several runs
can share a host), calls ``fn(rank, world, *args)`` and saves what it
returns; ``run_ranks`` returns the ranks' results in rank order.  ``fn``
must be a module-level function (the children import its module), and the
module should import no more than torch and this package at its top.

A rank that raises fails the run with its traceback.  A run that has not
ended by the deadline is killed, every rank, and raises TimeoutError with
each rank's last line of :func:`log`: a collective that waits forever
becomes a failure, never a wait.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Callable, List, Sequence

import torch

_log_path = None


def log(msg: str):
    """Append a line to this rank's log (what a timeout reports)."""
    if _log_path is not None:
        with open(_log_path, "a") as f:
            f.write(msg + "\n")


def _entry(rank: int, fn: Callable, world: int, args: Sequence, workdir: str):
    global _log_path
    import torch.distributed as dist

    torch.set_num_threads(1)
    _log_path = os.path.join(workdir, f"rank{rank}.log")
    log("start")
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        log("done")
    finally:
        dist.destroy_process_group()


def _last_line(path: Path) -> str:
    lines = path.read_text().splitlines() if path.exists() else []
    return lines[-1] if lines else "(no log)"


class RankRun:
    """A started run of gloo ranks; :meth:`wait` collects their results."""

    def __init__(self, fn: Callable, world: int, workdir, args: Sequence, deadline: float):
        import torch.multiprocessing as mp

        self.world = world
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.t_end = time.time() + deadline
        self.deadline = deadline
        self.ctx = mp.start_processes(_entry, args=(fn, world, tuple(args), str(self.workdir)),
                                      nprocs=world, join=False, start_method="spawn")

    def wait(self) -> List:
        """The ranks' results in rank order, once every rank has ended; a
        rank's exception is raised here, and at the deadline every rank is
        killed and TimeoutError raised."""
        while not self.ctx.join(timeout=0.5):
            if time.time() > self.t_end:
                for p in self.ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in self.ctx.processes:
                    p.join()
                last = {r: _last_line(self.workdir / f"rank{r}.log") for r in range(self.world)}
                raise TimeoutError(f"{self.world} gloo ranks did not finish in {self.deadline:g} s; "
                                   f"last log line of each: {last}")
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False) for r in range(self.world)]


def start_ranks(fn: Callable, world: int, workdir, args: Sequence = (),
                deadline: float = 120.0) -> RankRun:
    """Start ``fn(rank, world, *args)`` on ``world`` gloo ranks and return
    at once; the deadline counts from now."""
    return RankRun(fn, world, workdir, args, deadline)


def run_ranks(fn: Callable, world: int, workdir, args: Sequence = (),
              deadline: float = 120.0) -> List:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; their results."""
    return start_ranks(fn, world, workdir, args, deadline).wait()
