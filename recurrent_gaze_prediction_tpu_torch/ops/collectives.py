"""Collectives of the multi-rank path and the model-parallel weight slices.

Ranks are processes under `torch.distributed`; `parallel/mesh.py` builds
their process groups. Each helper takes a group, or None for an axis of
size 1: it then returns its input and launches nothing.

A gather is an `all_reduce` of a zero-filled [n, *shape] buffer in which
each rank fills its own slot. Adding zeros is exact, and the one route
runs under both backends: gloo takes CUDA tensors only in `broadcast` and
`all_reduce`, and two ranks that share one card must use gloo (NCCL
refuses two ranks on one device).

A weight split over the "model" axis keeps the columns of its last dim
that belong to this rank and carries a `ModelShard` (its group, this
rank's place and the whole width) as the attribute `model_shard`, as do
the optimizer moments that follow it (`parallel.place_state`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

SHARD_ATTR = "model_shard"


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """Where a column slice sits: `group` is the model-axis group (None
    at size 1), `rank` this rank's place in it, `size` its ranks, `full`
    the whole last dim."""

    group: Optional[dist.ProcessGroup]
    rank: int
    size: int
    full: int

    def columns(self) -> slice:
        k = self.full // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def shard_of(t) -> Optional[ModelShard]:
    """The `ModelShard` of a sliced weight or moment, else None."""
    return getattr(t, SHARD_ATTR, None)


def mark_shard(t: torch.Tensor, shard: Optional[ModelShard]) -> torch.Tensor:
    setattr(t, SHARD_ATTR, shard)
    return t


def local_columns(full: torch.Tensor, like) -> torch.Tensor:
    """This rank's columns of the whole tensor `full` when `like` is a
    column slice, else `full` (a checkpoint's tensors are whole)."""
    shard = shard_of(like)
    return full if shard is None else full[..., shard.columns()]


def all_reduce_(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over `group`; returns `x`."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


def all_gather_cat(x: torch.Tensor, group: Optional[dist.ProcessGroup],
                   dim: int = 0) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along `dim` in rank
    order, on every rank of `group`."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    # gloo's reduction of half types is not assured on every build: they
    # widen to f32 and back, which is exact
    wide = torch.float32 if x.dtype in (torch.bfloat16,
                                        torch.float16) else x.dtype
    out = x.new_zeros((n,) + tuple(x.shape), dtype=wide)
    out[r] = x
    dist.all_reduce(out, group=group)
    out = out.to(x.dtype)
    return torch.cat(out.unbind(0), dim=dim)


class _GatherColumns(torch.autograd.Function):
    """Forward: the model group's column slices gathered along the last
    dim. Backward: this rank's columns of the cotangent. Everything after
    the gather is computed alike on every rank of the group, so each
    already holds the whole cotangent; a summing backward (reduce-scatter,
    as `torch.distributed.nn.functional.all_gather` has) would scale the
    sliced weights' gradients by the group's size."""

    @staticmethod
    def forward(ctx, x, group, rank, width):
        ctx.cols = slice(rank * width, (rank + 1) * width)
        return all_gather_cat(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols].contiguous(), None, None, None


class _SumCotangent(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group. It sits on the input of a column-parallel product: each rank's
    columns give only their share of d(input), and the layers before it
    are replicated and need the whole of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


def gather_columns(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The whole [..., full] tensor from this rank's [..., full/size]
    columns, differentiable (the backward slices)."""
    if shard.group is None:
        return x
    return _GatherColumns.apply(x, shard.group, shard.rank, x.shape[-1])


def sum_cotangent(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    if shard.group is None or not x.requires_grad:
        return x
    return _SumCotangent.apply(x, shard.group)


def whole_weight(w: torch.Tensor) -> torch.Tensor:
    """`w` whole: gathered when it is a column slice (differentiable),
    else itself. For a weight used other than as a column-parallel
    product's right operand (gaze_pupil_gru2's tied transpose)."""
    shard = shard_of(w)
    return w if shard is None else gather_columns(w, shard)


@torch.no_grad()
def whole_tensor(t: torch.Tensor) -> torch.Tensor:
    """A weight or moment whole, for a checkpoint; a collective over the
    model group when `t` is a column slice (every rank of the group calls
    it)."""
    shard = shard_of(t)
    if shard is None or shard.group is None:
        return t
    return all_gather_cat(t.detach(), shard.group, dim=-1)
