"""Data parallelism over ``torch.distributed`` (the port of
``centermask2_tpu/parallel``): the process group, the batch split and
the parameter broadcast that stand for the JAX mesh, and data-parallel
serving. The train step's collectives are in ``train/trainer.py`` and
``utils/comm.py``."""

from .distributed import (
    all_gather_objects,
    barrier,
    init_distributed,
    is_main_process,
    process_count,
    process_index,
    process_subset,
    shutdown,
)
from .mesh import local_rows, replicate, shard_batch
from .serve import default_image_sizes, make_dp_inference

__all__ = [
    "all_gather_objects",
    "barrier",
    "default_image_sizes",
    "init_distributed",
    "is_main_process",
    "local_rows",
    "make_dp_inference",
    "process_count",
    "process_index",
    "process_subset",
    "replicate",
    "shard_batch",
    "shutdown",
]
