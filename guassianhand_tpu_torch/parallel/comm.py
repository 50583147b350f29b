"""The communication layer of the sharded path: collectives over a process
group, the ones the render's gradient passes through written as autograd
Functions, each call counted.

- ``all_to_all``: rows of a tensor split unevenly over the group's ranks;
  its backward is the transposed exchange (the gradient rows go back to
  the rank they came from);
- ``all_gather``: one tensor from each rank, stacked; its backward returns
  this rank's slice of the incoming gradient and does not sum it, because
  every rank of the group computes the same loss from the gathered tensor;
- ``all_reduce``: in place, no gradient (the step's gradient and loss
  reductions, checksums);
- ``average_gradient``: the identity, whose backward averages the
  gradient over the group (the features' boundary in the sharded render);
- ``ring_shift``: each rank's tensor to the next rank of the group, the
  ring attention's rotation (an ``all_to_all`` with one live bucket).

``stats`` counts the calls of each kind and the bytes this rank sends to
the other ranks in them (an all_reduce counts its buffer once): the port's
evidence that the exchange ran, as "all-to-all in the compiled HLO" is the
JAX package's.
"""
from __future__ import annotations

import collections
from typing import List, Sequence

import torch
import torch.distributed as dist


class CommStats:
    """Calls and bytes sent, by kind of collective."""

    def __init__(self):
        self.calls = collections.Counter()
        self.bytes = collections.Counter()

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def add(self, kind: str, n_bytes: int) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += int(n_bytes)

    def snapshot(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k]}
                for k in sorted(self.calls)}


stats = CommStats()


def _all_to_all(x: torch.Tensor, in_splits: List[int],
                out_splits: List[int], group) -> torch.Tensor:
    x = x.contiguous()
    row = x[0].numel() * x.element_size() if x.shape[0] else 0
    me = dist.get_rank(group)
    stats.add("all_to_all", row * (sum(in_splits) - in_splits[me]))
    out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, out_splits, in_splits, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, in_splits, out_splits, group):
        ctx.splits = (in_splits, out_splits)
        ctx.group = group
        return _all_to_all(x, in_splits, out_splits, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        in_splits, out_splits = ctx.splits
        return (_all_to_all(grad, out_splits, in_splits, ctx.group), None,
                None, None)


def all_to_all(x: torch.Tensor, in_splits: Sequence[int],
               out_splits: Sequence[int], group) -> torch.Tensor:
    """Rows ``x[sum(in_splits[:j]):][:in_splits[j]]`` go to rank j of
    ``group``; the result holds the rows from rank 0, then rank 1, ...
    (``out_splits[j]`` from rank j), each block in its sender's order."""
    return _AllToAll.apply(x, [int(s) for s in in_splits],
                           [int(s) for s in out_splits], group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.me = dist.get_rank(group)
        x = x.contiguous()
        n = dist.get_world_size(group)
        stats.add("all_gather", x.numel() * x.element_size() * (n - 1))
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return grad[ctx.me], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): rank j's ``x`` at [j]."""
    return _AllGather.apply(x, group)


class _AverageGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.group)
        return grad / dist.get_world_size(ctx.group), None


def average_gradient(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself; in the backward its gradient becomes the mean of the
    group's ranks' gradients. Where every rank of the group computes ``x``
    whole but each backpropagates only its part of the gradient, every
    rank then runs the backward upstream of ``x`` on the same (whole,
    scaled) gradient."""
    return _AverageGradient.apply(x, group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced in place over ``group`` (op sum, max or min);
    returns it."""
    stats.add("all_reduce", x.numel() * x.element_size())
    dist.all_reduce(x, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return x


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank j's ``x`` on rank j + 1 (mod the group size); every rank's
    ``x`` has the same shape."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    rows = x.shape[0]
    send = [0] * n
    recv = [0] * n
    send[(me + 1) % n] = rows
    recv[(me - 1) % n] = rows
    return all_to_all(x, send, recv, group)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` from global rank ``src`` in place on every rank of ``group``."""
    n = dist.get_world_size(group)
    stats.add("broadcast", x.numel() * x.element_size() * (n - 1)
              if dist.get_rank() == src else 0)
    dist.broadcast(x, src, group=group)
    return x


def exchange_counts(counts: torch.Tensor, group) -> torch.Tensor:
    """(group size,) int64: ``counts[j]`` is what this rank sends rank j;
    returns what each rank sends this one."""
    n = dist.get_world_size(group)
    return _all_to_all(counts.to(torch.int64), [1] * n, [1] * n, group)
