"""Multi-process data parallelism over ``torch.distributed`` (the port of
``centermask2_tpu/parallel/distributed.py``).

One process drives one device, which the caller names (``--device
cuda:N`` in the CLIs); the processes join one process group, NCCL for
CUDA devices and gloo for the CPU. The JAX package joins a cluster with
``jax.distributed.initialize`` and lays one mesh over every process's
devices; here the process group is that mesh (``parallel/mesh.py``), and
the collectives of the train step and of SyncBN are ``utils/comm.py``'s.

``init_distributed`` reads the JAX package's environment variables,
``CM2_COORDINATOR`` (``host:port`` of rank 0), ``CM2_NUM_PROCESSES`` and
``CM2_PROCESS_ID``, and is a no-op without them. Call it first, before any
model is built or any CUDA work is done. The group's timeout is long (30
minutes, as the JAX CLI's first-step barrier allows), so that ranks whose
evaluation shares or first steps take minutes longer than another's meet
at the next collective instead of failing there.

``all_gather_objects`` is ``all_gather_object``: every process receives
the list of every process's object, which the evaluation loop merges
before rank 0 scores (the reference's ``comm.gather``,
coco_evaluation.py:154-160).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

TIMEOUT = datetime.timedelta(minutes=30)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: DeviceLike = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group that the arguments, or else the ``CM2_*``
    environment variables, describe; returns whether one was joined (or
    had been). ``device``: the one device this process drives (``cuda``
    unless ``cpu`` is asked for, as every entry point); with more than one
    process a CUDA device needs its index. ``backend``: NCCL for a CUDA
    device and gloo for the CPU unless given (gloo also reduces CUDA
    tensors, through the host: the step then runs eagerly)."""
    coordinator = coordinator or os.environ.get("CM2_COORDINATOR")
    if num_processes is None and os.environ.get("CM2_NUM_PROCESSES"):
        num_processes = int(os.environ["CM2_NUM_PROCESSES"])
    if process_id is None and os.environ.get("CM2_PROCESS_ID"):
        process_id = int(os.environ["CM2_PROCESS_ID"])
    if coordinator is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator, the number "
                         "of processes and this process's id "
                         "(CM2_COORDINATOR, CM2_NUM_PROCESSES, "
                         "CM2_PROCESS_ID)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None and num_processes > 1:
            raise ValueError(f"process {process_id} of {num_processes} was "
                             "given device 'cuda': name its card (cuda:N)")
        torch.cuda.set_device(dev.index or 0)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)
    return True


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Every process waits here for the others (no-op in one process),
    within the group's timeout."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def process_subset(seq: Sequence) -> Sequence:
    """This process's strided share of a global work list (the analog of
    detectron2's InferenceSampler split)."""
    return seq[process_index()::process_count()]


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object per process; every process receives the full
    ``[obj_0, ..., obj_{P-1}]``. One process: ``[obj]``."""
    if process_count() == 1:
        return [obj]
    out: List[Any] = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out
