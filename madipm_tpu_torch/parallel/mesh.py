"""Device meshes: the port of ``madipm_tpu/parallel/mesh.py``.

A JAX ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh``
with the same axis names, over the ranks of the default process group,
one device per rank.  Execution is SPMD: every rank makes the same call
with the same model (the global-data contract) and gets the same
replicated result.  Two axes, as in the JAX package:

- ``batch``: independent instances split across ranks (parallel/batch.py),
  no communication inside the solve;
- ``cols``: the variable dimension of one instance split across ranks
  (parallel/schur.py, parallel/dist_chol.py), its collectives on
  ``mesh.get_group("cols")``.

A rank's device is ``cuda:{LOCAL_RANK}`` on an NCCL group, the CPU on a
gloo group; :func:`mesh_device` refuses a solve device of another type.
"""

from __future__ import annotations

import math
import os
from typing import TYPE_CHECKING, Optional, Sequence

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh


def _require_group():
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: call init_distributed() first "
            "(or run under torchrun)"
        )


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("batch",),
    shape: Optional[Sequence[int]] = None,
) -> DeviceMesh:
    """A mesh over the ``n_devices`` ranks of the process group (default:
    all of them; the mesh must cover the group), 1D or reshaped to
    ``shape``: of CUDA devices on an NCCL group, of the CPU on gloo."""
    _require_group()
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"a mesh covers every rank: n_devices={n_devices}, world size {world}")
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n_devices:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {n_devices} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def batch_sharding(mesh: DeviceMesh, axis: str = "batch"):
    """Placements that split the leading (instance) dimension over
    ``axis`` and replicate it over the other axes."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def local_rank() -> int:
    """``LOCAL_RANK`` as torchrun sets it, else the global rank modulo the
    devices of this host."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    rank = dist.get_rank() if dist.is_initialized() else 0
    return rank % max(1, torch.cuda.device_count())


def mesh_device(mesh: DeviceMesh, device=None) -> torch.device:
    """The device a solve on ``mesh`` runs on: ``device`` if its type is the
    mesh's (else ValueError); without one, ``cuda:{LOCAL_RANK}`` on a CUDA
    mesh, and on a CPU mesh what ``api.default_device`` says (which raises
    unless ``device="cpu"`` is given)."""
    if device is None:
        if mesh.device_type == "cuda":
            return torch.device("cuda", local_rank())
        from ..api import default_device

        device = default_device()
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r} devices but the solve was asked to run on {device}"
        )
    return device


def rank_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: ``cuda:{LOCAL_RANK}`` on a CUDA
    mesh, the CPU on a CPU mesh."""
    return mesh_device(mesh, "cpu" if mesh.device_type == "cpu" else None)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join a process group; a no-op when neither the caller nor the
    environment names one.  Returns this process's rank.

    The counterpart of ``jax.distributed.initialize``.  The group is
    configured by the arguments (``coordinator_address`` "host:port" or an
    init-method URL such as "file:///path"; ``num_processes``;
    ``process_id``) or, when they are absent, by ``MASTER_ADDR``, ``RANK``
    and ``WORLD_SIZE`` as torchrun sets them.  The ranks' devices are CUDA
    devices where CUDA is available, each rank on ``cuda:{LOCAL_RANK}``,
    and the backend NCCL; gloo only where there is no CUDA device.  An
    initialized group is kept as it is.
    """
    if dist.is_initialized():
        return dist.get_rank()
    env = all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if not (coordinator_address or num_processes or env):
        return 0
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    if coordinator_address:
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    else:
        kw = {}
        if num_processes is not None:
            kw["world_size"] = num_processes
        if process_id is not None:
            kw["rank"] = process_id
        dist.init_process_group(backend, init_method="env://", **kw)
    return dist.get_rank()


def make_multihost_mesh(axis_names: Sequence[str] = ("batch", "cols"), cols: int = 1) -> DeviceMesh:
    """A (batch, cols) mesh over every rank: ``batch`` outer, across hosts;
    ``cols`` inner, within a host, so that the column collectives never
    leave it.  ``cols`` must divide the ranks of one host
    (``LOCAL_WORLD_SIZE``, else the world size)."""
    _require_group()
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if per_host % cols != 0:
        raise ValueError(
            f"cols={cols} must divide the per-host device count {per_host} "
            "(the Schur collectives must stay within a host)"
        )
    return make_mesh(world, axis_names, shape=(world // cols, cols))
