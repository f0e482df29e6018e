"""The mesh path of madipm_tpu_torch/parallel at world size 2 on the CPU,
and its pieces that need no ranks.

Two gloo ranks (``tools/gloo_ranks.py``, 120 s deadline) run the
distributed-factor LP of test_torch_parallel.py at P = 2 and
``madipm_batch(mesh=...)`` on 5 instances, dense and ELL, which pads the
batch to 6 by repeating lane 0, and ``solve_batched(mesh=...)`` on the
same dense bucket; they are held against the port's
one-process solves and the JAX package's one-device solves with
test_torch_parallel.py's rules (same status and iterations as the port,
+-1 of JAX, objectives to 1e-8 relative, every lane bit-equal to the
mesh-free batch, the results bit-identical on both ranks).  Then, in this
process: ``shard_columns``' layout, ``init_distributed`` without a group,
and a hung collective failing at the deadline.  This module imports no
JAX at its top: the ranks import it to find their function.
"""

import pytest
import torch

import madipm_tpu_torch as mtt
from test_torch_parallel import (
    _model,
    _qp_data,
    _solves,
    agrees,
    check_batch,
    jax_refs_of,
    replicated,
    run_with_refs,
)


def _world2(rank, world):
    return _solves(rank, world, ["lp64", "batch", "batch_sparse", "solve_batched"])


@pytest.fixture(scope="module")
def jax_refs():
    return jax_refs_of(["lp64", "batch"])


@pytest.fixture(scope="module")
def world2(request):
    return run_with_refs(request, _world2, 2, ["lp64", "batch", "batch_sparse"])


def test_distributed_factor_lp_world_size_2(world2, jax_refs):
    ranks, port = world2
    agrees(replicated(ranks, "lp64"), port["lp64"], jax_refs["lp64"], 1e-8)


def test_madipm_batch_mesh_padded(world2, jax_refs):
    """5 instances on 2 ranks: the batch is padded to 6 by repeating lane 0."""
    check_batch(*world2, jax_refs, "batch")


def test_madipm_batch_mesh_sparse(world2, jax_refs):
    """The same on the ELL route: lanes of a SparseTorchQP bucket."""
    check_batch(*world2, jax_refs, "batch_sparse", ref="batch_sparse")


def test_solve_batched_mesh(world2, jax_refs):
    """solve_batched(mesh=...) itself, on a bucket packed on the host."""
    check_batch(*world2, jax_refs, "solve_batched")


def _hang(rank, world):
    """A rank that waits on a collective its peer never joins."""
    import torch.distributed as dist

    from madipm_tpu_torch.tools.gloo_ranks import log

    log(f"rank {rank} waiting")
    if rank == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        import time

        time.sleep(600)


def test_rank_deadline(tmp_path):
    """A collective that waits forever is a failure at the deadline."""
    from madipm_tpu_torch.tools.gloo_ranks import run_ranks

    with pytest.raises(TimeoutError, match="rank 0 waiting"):
        run_ranks(_hang, 2, tmp_path, deadline=8.0)


def test_init_distributed_noop(monkeypatch):
    import torch.distributed as dist

    from madipm_tpu_torch.parallel import init_distributed

    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == 0
    assert not dist.is_initialized()


def test_shard_columns_layout():
    """One rank's part of a problem: A's column block, Q's row strip and
    A's row block, cut as shard_columns' docstring states (a fake group of
    4 with this process as rank 1)."""
    from madipm_tpu_torch.models.qp import pad_to_device, slack_form
    from madipm_tpu_torch.parallel.schur import shard_columns
    from madipm_tpu_torch.utils import comm

    class Mesh:
        def get_group(self, axis):
            return "g"

    prob = pad_to_device(slack_form(_model(mtt, _qp_data(31))), pad_multiple=32, device="cpu")
    orig = comm.rank, comm.size
    comm.rank, comm.size = (lambda g: 1), (lambda g: 4)
    try:
        part = shard_columns(prob, Mesh(), keep_rows=True)
    finally:
        comm.rank, comm.size = orig
    nb, mb = prob.n // 4, prob.m // 4
    assert torch.equal(part.A, prob.A[..., nb:2 * nb])
    assert torch.equal(part.Q, prob.Q[..., nb:2 * nb, :])
    assert torch.equal(part.A_rows, prob.A[..., mb:2 * mb, :])
    assert part.group == "g" and torch.equal(part.c, prob.c) and torch.equal(part.b, prob.b)
    with pytest.raises(ValueError, match="already sharded"):
        shard_columns(part, Mesh())
