"""Tensor parallelism's collectives: the gather of a width shard, and the
sum of the ranks' parts of NeuS's normal.

Counterpart of ``neddf_tpu/fields/base.py::tp_gather``. Under tensor
parallelism (``mesh.model`` = n > 1, ``parallel/mesh.py``) every trunk
layer's weight is column-sharded over the ranks of a model group, so a
rank computes a ``[..., W/n]`` slice of each activation; ``tp_gather``
all-gathers the slices back to the full ``[..., W]`` in rank order, so
the next layer and the replicated heads see the whole width.

Its backward is the transpose that JAX's ``shard_map`` takes for
``all_gather(tiled=True)``: the sum reduce-scatter. Every rank's
cotangent of the full activation is summed over the group and each rank
keeps its own columns. Where every rank computes the same loss, that sum
is n times one rank's cotangent, which ``make_sharded_grads`` undoes on
the sharded leaves, as the JAX package does.

The collectives run outside the kernels (``torch.distributed``):
``all_gather_into_tensor`` / ``reduce_scatter_tensor`` on NCCL; gloo
gathers CPU tensors only, so for CUDA tensors it takes a zero-padded
``all_reduce`` (each rank's slice in place, -0.0 elsewhere: adding -0.0
leaves every value, +0.0 too, bitwise as it is) and its reduce-scatter
is an ``all_reduce`` and a slice. Sums are taken in f32.

``all_reduce_sum`` sums a tensor over the group (the per-layer sdf
route's normal, each rank's part over its columns; its adjoint is the
same sum), and ``holds_column0`` tells the rank whose shard holds a
layer's column 0 (channel 0 of NeuS's sweep).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

Tensor = torch.Tensor


def group_size(group: Optional[Any]) -> int:
    """The ranks of a model group (1 for None: one shard)."""
    return 1 if group is None else dist.get_world_size(group)


def _nccl(group: Any) -> bool:
    return dist.get_backend(group) == "nccl"


def all_gather_last(x: Tensor, group: Optional[Any]) -> Tensor:
    """``[..., N]`` on each of the n ranks of ``group`` -> ``[..., n N]``,
    the ranks' slices in rank order (a new tensor; ``x`` itself for one
    rank)."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    width = x.shape[-1]
    if _nccl(group):
        parts = torch.empty((n, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(parts, x, group=group)
        return parts.movedim(0, -2).reshape(*x.shape[:-1], n * width)
    if x.device.type == "cpu":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)
    return gather_by_all_reduce(x, group)


def gather_by_all_reduce(x: Tensor, group: Any) -> Tensor:
    """``all_gather_last`` as a sum: this rank's slice in place in a
    full-width tensor of -0.0, all-reduced over ``group`` (gloo's gather
    for CUDA tensors; bitwise the gather, -0.0 being the identity of
    addition)."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    width = x.shape[-1]
    full = torch.full((*x.shape[:-1], n * width), -0.0, dtype=x.dtype, device=x.device)
    full[..., rank * width : (rank + 1) * width] = x
    dist.all_reduce(full, group=group)
    return full


def reduce_scatter_last(g: Tensor, group: Optional[Any]) -> Tensor:
    """``[..., n N]`` on each rank -> this rank's ``[..., N]`` columns of
    the sum over the ranks of ``group``, in f32 (``g`` as f32 for one
    rank)."""
    g = g.float()
    n = group_size(group)
    if n == 1:
        return g
    width = g.shape[-1] // n
    rank = dist.get_rank(group)
    if _nccl(group):
        parts = g.reshape(*g.shape[:-1], n, width).movedim(-2, 0).contiguous()
        out = torch.empty((*g.shape[:-1], width), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, parts, group=group)
        return out
    total = g.clone(memory_format=torch.contiguous_format)  # the caller's g stays
    dist.all_reduce(total, group=group)
    return total[..., rank * width : (rank + 1) * width].contiguous()


def all_reduce_sum(x: Tensor, group: Optional[Any]) -> Tensor:
    """The sum over the ranks of ``group`` of each rank's ``x``, in f32 (a
    new tensor; ``x`` as f32 for one rank): the per-layer sdf route's
    normals, each rank's part over its columns, and their adjoint."""
    x = x.float()
    if group_size(group) == 1:
        return x
    total = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(total, group=group)
    return total


def holds_column0(group: Optional[Any]) -> bool:
    """Whether this rank's column shard holds a layer's column 0 (its rank
    in the model group is 0; one shard holds every column)."""
    return group_size(group) == 1 or dist.get_rank(group) == 0


class TPGather(torch.autograd.Function):
    """``all_gather_last`` with the sum reduce-scatter as its backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.dtype = x.dtype
        return all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_last(g, ctx.group).to(ctx.dtype), None


def tp_gather(x: Tensor, group: Optional[Any]) -> Tensor:
    """The full-width activation of a width shard ``x`` over the model
    group ``group`` (differentiable); ``x`` itself where ``group`` is None
    or of one rank, the JAX package's no-op outside tensor parallelism."""
    if group_size(group) == 1:
        return x
    return TPGather.apply(x, group)
