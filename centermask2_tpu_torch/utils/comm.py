"""Tensor collectives over a ``torch.distributed`` process group, the
counterparts of the ``psum``/``pmean`` that the JAX package calls over its
``data`` mesh axis (``lax.psum`` in ``models/fcos/losses.py``, flax's
SyncBN, ``lax.pmean`` in ``train/trainer.py``).

A ``group`` of None means no mapped axis: every function here is then the
identity, as a JAX collective outside ``shard_map`` does not engage. The
process group itself is set up by ``parallel/distributed.py``.

On a gloo group a CUDA tensor is reduced through a host copy (gloo reduces
host memory); on NCCL the tensor is reduced where it lies, which a CUDA
graph can capture.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def world_group() -> Group:
    """The default process group, or None when none was set up."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def is_gloo(group: Group) -> bool:
    return group is not None and dist.get_backend(group) == "gloo"


def all_reduce_sum_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    if group is None:
        return t
    if is_gloo(group) and t.is_cuda:
        host = t.cpu()
        dist.all_reduce(host, group=group)
        return t.copy_(host)
    dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The group's tensors concatenated along dim 0, in rank order (every
    rank's ``t`` has the same shape). bool goes through uint8."""
    if group is None:
        return t
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    if is_gloo(group) and src.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts).to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


class _AllReduceSum(torch.autograd.Function):
    """``psum`` with its transpose: the sum over the group forward, and
    the sum of the cotangents over the group backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce_sum_(g.clone(), ctx.group), None


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable sum over the group (``lax.psum``)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Differentiable mean over the group (``lax.pmean``: the sum divided
    by the group's size)."""
    if group is None:
        return x
    return psum(x, group) / world_size(group)


def mean_reduce(group: Group
                ) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The ``reduce`` of ``models/fcos/losses.py::fcos_losses`` over
    ``group`` (a cross-replica mean, no gradient), or None."""
    if group is None:
        return None
    n = world_size(group)

    def reduce(x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum_(x.detach().clone(), group) / n

    return reduce
