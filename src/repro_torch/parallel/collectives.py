"""Collectives over one axis of a :class:`~repro_torch.launch.mesh.Mesh`.

The counterparts of the named-axis collectives the reference takes from
``jax.lax`` inside ``shard_map`` (``all_to_all``, ``all_gather``,
``psum``, ``ppermute``, ``axis_index``), over a ``torch.distributed``
process group.  Each takes an :class:`AxisGroup` (``mesh.group(axis)``):
the group's process group, this rank's index on the axis and the
transport the caller named when it set up the process group:

* ``nccl``: every rank has its own card and CUDA tensors move as they are;
* ``gloo``: gloo moves only CPU tensors for ``all_to_all`` and send/recv,
  so a CUDA tensor is copied to the host, exchanged and copied back (the
  compute stays on the card).

An axis of one rank has no process group and every collective on it is
the identity (``ppermute`` gives zeros to a rank that receives nothing).
``all_to_all`` and ``all_gather`` are forward-only (the port runs them in
serving and in gradient exchange); ``ppermute`` and ``psum`` carry
gradients, for training through the pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class AxisGroup:
    """One mesh axis (or axis tuple) as this rank sees it."""
    name: Any                   # the axis name, or a tuple of names
    size: int                   # ranks on the axis
    index: int                  # this rank's index on the axis
    ranks: tuple[int, ...]      # the axis's global ranks, in index order
    pg: Optional[Any]           # its process group (None for one rank)
    staged: bool                # CUDA tensors go through the host (gloo)


def axis_index(group: AxisGroup) -> int:
    """This rank's index on the axis (``jax.lax.axis_index``)."""
    return group.index


def _out(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``x`` as the transport takes it: on the host for a staged group."""
    return x.cpu().contiguous() if group.staged else x.contiguous()


def all_to_all(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)``: ``x`` is
    ``[n, ...]`` with row ``i`` bound for rank ``i``; row ``i`` of the
    result came from rank ``i``."""
    if x.shape[0] != group.size:
        raise ValueError(f"all_to_all over {group.size} ranks needs a "
                         f"leading dim of {group.size}, not {x.shape[0]}")
    if group.pg is None:
        return x
    src = _out(x, group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group.pg)
    return out.to(x.device)


def all_gather(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis)``: ``[n, *x.shape]``, row ``i`` from
    rank ``i``."""
    if group.pg is None:
        return x.unsqueeze(0)
    src = _out(x, group)
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.stack(parts).to(x.device)


def _all_reduce(x: torch.Tensor, group: AxisGroup, op) -> torch.Tensor:
    if group.pg is None:
        return x
    buf = x.cpu() if group.staged else x.clone()
    dist.all_reduce(buf, op=op, group=group.pg)
    return buf.to(x.device)


class _Psum(torch.autograd.Function):
    """Sum over the axis.  The backward passes the cotangent through: the
    sum is replicated on every rank and every rank computes the same loss
    on it, so each rank's cotangent is already the whole of it (summing
    them, as an all-reduce's usual backward does, would count it
    ``n`` times)."""

    @staticmethod
    def forward(ctx, x, group):
        if group.pg is None:
            return x.clone()
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``jax.lax.psum(x, axis)``, differentiable as above."""
    return _Psum.apply(x, group)


def pmax(x: torch.Tensor, group: AxisGroup) -> torch.Tensor:
    """``jax.lax.pmax(x, axis)`` (forward only)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def _permute(x: torch.Tensor, group: AxisGroup,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` to each ``dst`` of ``(me, dst)`` in ``perm`` and receive
    from the ``src`` of ``(src, me)``; zeros where nothing arrives."""
    me = group.index
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if group.pg is None:
        return x.clone() if srcs else torch.zeros_like(x)
    src = _out(x, group)
    recv = torch.zeros_like(src)
    ops = [dist.P2POp(dist.isend, src, group.ranks[d], group.pg)
           for d in dsts]
    ops += [dist.P2POp(dist.irecv, recv, group.ranks[s], group.pg)
            for s in srcs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return _permute(g.contiguous(), ctx.group, back), None, None


def ppermute(x: torch.Tensor, group: AxisGroup,
             perm: Sequence[tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, perm)``: ``perm`` holds ``(src, dst)``
    axis indices, each source and each destination at most once; a rank
    that receives nothing gets zeros.  The backward is the reverse
    permutation.  Every rank of the axis must call it (and, when
    training, reach its backward) at the same point of the program."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    for side in zip(*perm) if perm else ():
        if len(set(side)) != len(side):
            raise ValueError(f"ppermute: {perm} is not a permutation")
    return _Ppermute.apply(x, group, perm)
