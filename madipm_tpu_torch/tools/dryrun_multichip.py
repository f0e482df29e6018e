"""Multi-GPU dry run of the mesh path.

    torchrun --nproc_per_node N -m madipm_tpu_torch.tools.dryrun_multichip
    python -m madipm_tpu_torch.tools.dryrun_multichip --cpu-ranks 4

Three checks, each of which must solve or advance, on every rank:

1. :func:`mpc_step`: one MPC iteration on a (batch, cols) mesh, each rank
   of the ``batch`` axis on its block of instances, the variable dimension
   of each split over ``cols`` (a replicated factor of the summed normal
   matrix);
2. :func:`dist_lp`: a whole LP solve with the normal matrix and its factor
   in row strips over a ``cols`` mesh (``parallel/schur.solve_sharded``,
   ``parallel/dist_chol.dist_factor_normal``);
3. :func:`dist_qp`: a whole convex-QP solve on K1 through
   ``MPCSolver(mesh=...)`` (``dist_chol.dist_factor_condensed``).

Under torchrun each rank takes ``cuda:{LOCAL_RANK}`` and the group is NCCL;
``--cpu-ranks N`` runs the same on N gloo ranks of the CPU
(``tools/gloo_ranks.py``).  ``chip_smoke.py`` calls these functions on a
one-rank NCCL group, so that the code a multi-GPU run takes is the code the
single card runs.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

import madipm_tpu_torch as mtt
from madipm_tpu_torch.models.qp import QuadraticModel, pad_to_device, slack_form
from madipm_tpu_torch.parallel.batch import bucket_pad, lane_block, select_lanes
from madipm_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_device
from madipm_tpu_torch.parallel.schur import shard_columns, solve_sharded
from madipm_tpu_torch.solver import driver
from madipm_tpu_torch.utils.options import load_options
from madipm_tpu_torch.utils.status import Status

SOLVED = (Status.SOLVE_SUCCEEDED, Status.SOLVED_TO_ACCEPTABLE_LEVEL)


def random_lp(n_vars: int, m_cons: int, seed: int) -> QuadraticModel:
    """A feasible LP with x >= 0 (``__graft_entry__._make_problem``'s)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m_cons, n_vars))
    b = A @ (rng.random(n_vars) + 0.5)
    return mtt.from_dense(c=rng.random(n_vars) + 0.1, A=A, lcon=b, ucon=b,
                          lvar=np.zeros(n_vars), uvar=np.full(n_vars, np.inf))


def random_qp(n: int, m: int, seed: int) -> QuadraticModel:
    """A strictly convex equality-constrained QP with x >= 0."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    B = rng.standard_normal((n // 2, n)) / np.sqrt(n)
    return QuadraticModel(c=rng.standard_normal(n), A=sp.csr_matrix(A), lcon=b, ucon=b,
                          lvar=np.zeros(n), uvar=np.full(n, np.inf),
                          Q=sp.csr_matrix(B.T @ B + 0.3 * np.eye(n)))


def mpc_step(mesh, device, n_vars: int = 48, m_cons: int = 16) -> int:
    """One MPC iteration on this rank's instances of a (batch, cols) mesh;
    returns the iteration counter it reached (1)."""
    n_inst = mesh.size(0)
    models = [random_lp(n_vars, m_cons, seed) for seed in range(n_inst)]
    probs, _ = bucket_pad(models, pad_multiple=128)
    local = select_lanes(probs, lane_block(n_inst, mesh, "batch"), device)
    prob = shard_columns(local, mesh, "cols")
    cfg = driver.make_config(load_options(), is_qp=False)
    prob_s, _, state = driver.initialize(cfg, prob)
    state = driver.iteration(cfg, prob_s, state)
    k = int(state.k.min())
    if k != 1 or not bool(torch.isfinite(state.x).all()):
        raise RuntimeError(f"mpc_step: the iteration did not advance (k={k})")
    return k


def dist_lp(mesh, device, n_vars: int = 220, m_cons: int = 110):
    """A whole LP solve with the factor in row strips over ``cols``;
    returns (status, iterations, objective)."""
    lp = random_lp(n_vars, m_cons, seed=7)
    prob = pad_to_device(slack_form(lp), pad_multiple=128, device=device)
    cfg = driver.make_config(load_options(), is_qp=False)
    _, scale, state = solve_sharded(cfg, prob, mesh, "cols", distribute_factor=True)
    status = Status(int(state.status[0, 0]))
    obj = float(state.obj_val[0, 0] / scale.obj_scale[0, 0])
    if status not in SOLVED:
        raise RuntimeError(f"dist_lp: ended {status.name} after {int(state.k[0, 0])} iterations")
    return status, int(state.k[0, 0]), obj


def dist_qp(mesh, device, n: int = 40, m: int = 12):
    """A whole convex-QP solve on K1 with the size-n factor in row strips;
    returns its IPMStats."""
    stats = mtt.MPCSolver(random_qp(n, m, seed=11), mesh=mesh, device=device,
                          kkt_system=mtt.KKTSystem.CONDENSED,
                          print_level=mtt.PrintLevel.ERROR).solve(logged=False)
    if not stats.success:
        raise RuntimeError(f"dist_qp: ended {stats.status.name}")
    return stats


def run(log=print) -> None:
    """The three checks on the initialized group (every rank calls it)."""
    world = dist.get_world_size()
    cols = 2 if world % 2 == 0 else 1
    mesh2 = make_mesh(world, ("batch", "cols"), shape=(world // cols, cols))
    device = rank_device(mesh2)
    log(f"dryrun_multichip OK: one MPC step on mesh(batch={world // cols}, cols={cols}), "
        f"iteration {mpc_step(mesh2, device)}")
    mesh1 = make_mesh(world, ("cols",))
    status, iters, obj = dist_lp(mesh1, device)
    log(f"dryrun_multichip OK: distributed-factor LP ({status.name}, {iters} iterations, "
        f"obj {obj:.6e}) strip-factored over {world} ranks")
    st = dist_qp(mesh1, device)
    log(f"dryrun_multichip OK: distributed K1 QP ({st.iter} iterations, obj {st.objective:.6e}) "
        f"strip-factored over {world} ranks")


def _cpu_rank(rank: int, world: int):
    lines = []
    run(log=lines.append)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-ranks", type=int, default=0,
                    help="run on this many gloo ranks of the CPU instead of under torchrun")
    args = ap.parse_args(argv)
    if args.cpu_ranks:
        from madipm_tpu_torch.tools.gloo_ranks import run_ranks

        with tempfile.TemporaryDirectory() as tmp:
            lines = run_ranks(_cpu_rank, args.cpu_ranks, tmp, deadline=300.0)
        print("\n".join(lines[0]))
        return 0
    rank = init_distributed()
    if not dist.is_initialized():
        print("dryrun_multichip: no process group; run under torchrun or pass --cpu-ranks",
              file=sys.stderr)
        return 1
    try:
        run(log=print if rank == 0 else (lambda msg: None))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
