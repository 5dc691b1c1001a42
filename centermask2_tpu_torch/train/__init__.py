from .optimizer import (
    ClippedSGD,
    WarmupMultiStepLR,
    freeze_prefixes,
    frozen_leaves,
    make_optimizer,
    make_optimizer_from_cfg,
)
from .trainer import (CapturedTrainStep, StaticBatch, batch_to_device,
                      make_train_step, train_loop)

__all__ = ["ClippedSGD", "WarmupMultiStepLR", "freeze_prefixes",
           "frozen_leaves", "make_optimizer",
           "make_optimizer_from_cfg",
           "CapturedTrainStep", "StaticBatch", "batch_to_device",
           "make_train_step", "train_loop"]
