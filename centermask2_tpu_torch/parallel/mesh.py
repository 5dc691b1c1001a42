"""The data mesh as a process group (the port of
``centermask2_tpu/parallel/mesh.py`` and of ``shard_host_batch`` /
``replicate_from_host`` in ``parallel/distributed.py``).

JAX lays a 1-D ``data`` mesh over the devices, places parameters
replicated and a global batch sharded over it. With one process per
device the mesh is the process group, and:

- "replicate" is a broadcast of the parameters and buffers from rank 0,
  in place (``replicate``);
- "shard" is this rank's rows ``[r * B/W, (r + 1) * B/W)`` of a global
  batch of B (``shard_batch``): the JAX global device order is
  process-major, so rank r holds the same rows that process r's devices
  hold there.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch import nn

from ..utils.comm import Group, is_gloo, rank, world_group, world_size


def local_rows(batch: int, group: Group = None) -> slice:
    """This rank's rows of a global batch of ``batch``, which the group's
    size must divide."""
    group = world_group() if group is None else group
    w, r = world_size(group), rank(group)
    if batch % w:
        raise ValueError(f"a global batch of {batch} does not split over "
                         f"{w} ranks")
    n = batch // w
    return slice(r * n, (r + 1) * n)


def shard_batch(batch: Any, group: Group = None) -> Any:
    """This rank's rows of every leaf of ``batch`` (tensors or arrays with
    the global batch leading; tuples, named tuples, lists and dicts of
    them; None passes through)."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(v, group) for k, v in batch.items()}
    if isinstance(batch, tuple) and hasattr(batch, "_fields"):
        return type(batch)(*(shard_batch(v, group) for v in batch))
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, group) for v in batch)
    return batch[local_rows(batch.shape[0], group)]


@torch.no_grad()
def replicate(module: nn.Module, group: Group = None) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 into
    every rank's, in place (the tensors keep their addresses); returns
    ``module``."""
    group = world_group() if group is None else group
    if world_size(group) == 1:
        return module
    for t in list(module.parameters()) + list(module.buffers()):
        if is_gloo(group) and t.is_cuda:
            host = t.cpu()
            dist.broadcast(host, 0, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t.data, 0, group=group)
    return module
