"""The collectives of the mesh path, on ``torch.distributed``.

The counterparts of the JAX package's ``lax.psum``, ``psum_scatter`` and
``all_gather`` inside ``shard_map``: every function takes tensors with a
leading lane dimension and a process group (one mesh axis,
``DeviceMesh.get_group``), and every rank of the group must call it in the
same order.  The group's backend is NCCL for CUDA tensors and gloo for CPU
tensors; the tensors are enqueued on the current stream, so they stay
ordered with the kernels around them.

A result that every rank gets (``all_sum``, ``all_max``, ``all_min``,
``gather_last``, ``gather_rows``, ``broadcast_from``) holds the same bits on
every rank: the host may branch on it without the ranks parting ways.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def rank(group) -> int:
    """This process's position in ``group``."""
    return dist.get_rank(group)


def size(group) -> int:
    return dist.get_world_size(group)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks (``lax.psum``); ``t`` is reduced in place."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_max(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_min(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def broadcast_from(t: torch.Tensor, owner: int, group) -> torch.Tensor:
    """The owner's ``t`` on every rank (the JAX package's psum of a value
    masked to its owner, which gives the same bits); in place."""
    dist.broadcast(t, src=dist.get_global_rank(group, owner), group=group)
    return t


def reduce_to(t: torch.Tensor, owner: int, group) -> torch.Tensor:
    """Sum over the ranks, on the owner only (the other ranks' ``t`` is
    left undefined); in place."""
    dist.reduce(t, dst=dist.get_global_rank(group, owner), op=dist.ReduceOp.SUM, group=group)
    return t


def gather_blocks(t: torch.Tensor, group) -> torch.Tensor:
    """(P, *t.shape): rank r's ``t`` at index r (the same on every rank)."""
    P = size(group)
    shape = tuple(t.shape)
    out = torch.empty((P * shape[0],) + shape[1:], dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out.reshape((P,) + shape)


def gather_last(t: torch.Tensor, group) -> torch.Tensor:
    """(B, k) blocks -> (B, P*k), rank r's block at [r*k, (r+1)*k)
    (``all_gather(..., tiled=True)`` of a sharded vector)."""
    out = gather_blocks(t, group)  # (P, B, k)
    return out.transpose(0, 1).reshape(t.shape[0], -1)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """(B, r, c) row strips -> (B, P*r, c), rank p's strip at rows
    [p*r, (p+1)*r)."""
    out = gather_blocks(t, group)  # (P, B, r, c)
    B, r, c = t.shape
    return out.transpose(0, 1).reshape(B, -1, c)


def scatter_rows_sum(t: torch.Tensor, group) -> torch.Tensor:
    """(B, P*r, c) partial sums -> this rank's row strip (B, r, c) of their
    sum over the ranks (``psum_scatter(..., scatter_dimension=0,
    tiled=True)``)."""
    P = size(group)
    B, m, c = t.shape
    r = m // P
    blocks = t.reshape(B, P, r, c).transpose(0, 1).reshape(P * B, r, c).contiguous()
    out = torch.empty((B, r, c), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, blocks, op=dist.ReduceOp.SUM, group=group)
    return out
