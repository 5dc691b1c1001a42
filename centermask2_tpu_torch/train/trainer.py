"""The training step and loop (the port of
``centermask2_tpu/train/trainer.py`` and of the loop body of the
repository's ``tools/train_net.py``), for one process on one device.

``make_train_step`` returns the step: the losses of ``CenterMask.loss``,
their sum's backward, the clipped SGD update and the schedule's step,
with no host sync; the metrics come back as device tensors. ``train_loop``
feeds it host batches (``data/coco.py::train_batches``) and is the loop
both ``tools/train_net.py`` and ``chip_smoke.py`` run. Data parallelism
(the JAX shard_map step) waits for ROADMAP queue 1, item 14.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models.meta import CenterMask, GroundTruth

Metrics = Dict[str, torch.Tensor]
StepFn = Callable[..., Metrics]


def make_train_step(model: CenterMask, optimizer: torch.optim.Optimizer,
                    scheduler) -> StepFn:
    """Returns ``step(images, gt, draws=None, generator=None) -> metrics``:
    the five losses and ``total_loss``, detached device scalars."""

    def step(images: torch.Tensor, gt: GroundTruth,
             draws: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Metrics:
        optimizer.zero_grad(set_to_none=True)
        losses = model.loss(images, gt, draws=draws, generator=generator)
        total = sum(losses.values())
        total.backward()
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":  # pinned, so the copy does not block the host
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def batch_to_device(batch: Dict[str, np.ndarray], dev: torch.device,
                    s2d_input: bool = False
                    ) -> Tuple[torch.Tensor, GroundTruth]:
    """A ``train_batches`` batch -> (images, GroundTruth) on ``dev``. The
    images are the f32 normalized canvases, put in the s2d layout on the
    host for an s2d-input model (as the JAX ``input_transform_for``)."""
    dev = torch.device(dev)
    images = batch["image"]
    if s2d_input:
        from ..data.preprocess import stem_space_to_depth

        images = stem_space_to_depth(images)
    gt = GroundTruth(
        boxes=_to_device(batch["gt_boxes"], dev),
        classes=_to_device(batch["gt_classes"], dev),
        valid=_to_device(batch["gt_valid"], dev),
        mask_patches=_to_device(batch["gt_mask_patches"], dev),
        image_sizes=_to_device(batch["image_size"].astype(np.float32), dev))
    return _to_device(images, dev), gt


def train_loop(step: StepFn, batches: Iterable[Dict[str, np.ndarray]], *,
               device: torch.device, start_iter: int, max_iter: int,
               s2d_input: bool = False,
               generator: Optional[torch.Generator] = None,
               storage=None, log_every: int = 20,
               after_step: Optional[Callable[[int, Metrics], None]] = None,
               log: Callable[[str], None] = print) -> Optional[Metrics]:
    """Runs iterations ``start_iter .. max_iter - 1`` over ``batches``.
    Every ``log_every`` iterations the metrics come to the host, into
    ``storage`` (an ``EventStorage``) with the seconds per iteration, and
    into ``log``. ``after_step(iteration_done, metrics)`` runs after each
    step (checkpoints, evaluation, measurements), then ``storage.step()``.
    Returns the last step's metrics (device tensors)."""
    metrics = None
    t0 = time.perf_counter()
    for it, batch in zip(range(start_iter, max_iter), batches):
        images, gt = batch_to_device(batch, device, s2d_input)
        metrics = step(images, gt, generator=generator)
        if (it + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / log_every
            t0 = time.perf_counter()
            if storage is not None:
                storage.put_scalars(**m)
                storage.put_scalar("s_per_iter", dt)
            log(f"iter {it + 1}/{max_iter} " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(m.items()))
                + f" ({dt:.3f} s/it)")
        if after_step is not None:
            after_step(it + 1, metrics)
        if storage is not None:
            storage.step()
    return metrics
