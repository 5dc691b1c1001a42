from .optimizer import (
    ClippedSGD,
    freeze_prefixes,
    make_optimizer,
    make_optimizer_from_cfg,
    warmup_multistep_schedule,
)
from .trainer import batch_to_device, make_train_step, train_loop

__all__ = ["ClippedSGD", "freeze_prefixes", "make_optimizer",
           "make_optimizer_from_cfg", "warmup_multistep_schedule",
           "batch_to_device", "make_train_step", "train_loop"]
