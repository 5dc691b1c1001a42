"""SGD and its learning-rate schedule, the detectron2 training recipe
(the port of ``centermask2_tpu/train/optimizer.py``).

detectron2's default solver as the reference configs use it (reference
configs/centermask/Base-CenterMask-VoVNet.yaml:29-33 + detectron2
defaults): SGD momentum 0.9, weight decay 1e-4 (none on the FCOS scales
and norm layers, which get WEIGHT_DECAY_NORM), linear warm-up (factor
1/1000, 1000 iterations), multistep decay by gamma 0.1 at STEPS.

It matches the JAX package's optax chain ``clip -> add_decayed_weights
(masked) -> sgd(momentum, nesterov)`` update for update:
- the clip comes first, by value (each element to +-clip_value) or by
  global L2 norm with optax's rule, written by hand: the gradients are
  scaled by ``clip_value / norm`` only when ``norm >= clip_value``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm);
- weight decay adds ``wd * p`` to the clipped gradient, then momentum
  (the first step's buffer is the gradient itself, as optax's zero trace
  plus the gradient), then ``p -= lr * update``;
- ``LambdaLR`` stepped after each ``optimizer.step()`` gives update k the
  schedule at k, as optax evaluates it at the count of earlier updates.

Frozen parameters (``MODEL.BACKBONE.FREEZE_AT``) get
``requires_grad=False`` and stay out of the optimizer; FrozenBN's scale
and bias are buffers of the port. The JAX package holds both as
parameters whose updates it zeroes, so its global norm also counts their
gradients; the port's counts the gradients of what trains (as
detectron2's clipping does, where they have no gradient).
"""

from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn


def warmup_multistep_schedule(
    base_lr: float,
    steps: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 1000,
    warmup_iters: int = 1000,
    warmup_method: str = "linear",
) -> Callable[[int], float]:
    """WarmupMultiStepLR (detectron2 solver): the learning rate of update
    ``count`` (0 for the first)."""
    if warmup_method not in ("linear", "constant"):
        raise ValueError(f"unknown warmup method {warmup_method!r}")
    milestones = sorted(steps)

    def schedule(count: int) -> float:
        if warmup_method == "linear":
            alpha = min(max(count / max(warmup_iters, 1), 0.0), 1.0)
            warm = warmup_factor * (1 - alpha) + alpha
        else:
            warm = warmup_factor if count < warmup_iters else 1.0
        return base_lr * warm * gamma ** bisect.bisect_right(milestones,
                                                             count)

    return schedule


def freeze_prefixes(freeze_at: int) -> Tuple[str, ...]:
    """MODEL.BACKBONE.FREEZE_AT -> backbone module-name patterns to freeze
    (JAX ``optimizer.py:47-71``): stage 0 is the VoVNet stem (``stem_*``),
    stage i > 0 is ``OSA{i+1}_*``; the ResNet (``res{i}_``) and MobileNet
    (``features{i}``) names are kept for when those backbones are ported.
    A trailing ``$`` marks an exact module-name match; anything else is a
    prefix."""
    names = []
    if freeze_at >= 1:
        names.append("stem")
        names.append("features0_")
    for s in range(2, freeze_at + 1):
        names.append(f"OSA{s}_")
        names.append(f"res{s}_")
    for i in range(1, freeze_at):
        names.append(f"features{i}$")
    return tuple(names)


def _match(key: str, pattern: str) -> bool:
    if pattern.endswith("$"):
        return key == pattern[:-1]
    return key.startswith(pattern)


def _is_frozen(keys: Sequence[str], prefixes: Sequence[str]) -> bool:
    if any(k.startswith("frozen_") for k in keys):
        return True
    if prefixes and "backbone" in keys:
        return any(_match(k, p) for k in keys for p in prefixes)
    return False


def _is_norm_module(keys: Sequence[str]) -> bool:
    """A parameter of a norm layer (GN, FrozenBN), bias included:
    detectron2 gives every parameter of a norm module WEIGHT_DECAY_NORM."""
    if any(k.startswith("frozen_") for k in keys):
        return True
    return any(k in ("gn", "norm") or k.endswith("_norm") for k in keys)


def param_groups(model: nn.Module, weight_decay: float,
                 weight_decay_norm: float, freeze_at: int
                 ) -> List[Dict]:
    """The JAX decay masks by the port's parameter names (which mirror the
    JAX paths): norm-module parameters decay by ``weight_decay_norm``, the
    FCOS ``scale`` parameters not at all, the rest by ``weight_decay``.
    Parameters under the FREEZE_AT prefixes get ``requires_grad=False``
    and no group."""
    prefixes = freeze_prefixes(freeze_at)
    groups = {"decay": [], "norm": [], "none": []}
    for name, p in model.named_parameters():
        keys = name.split(".")
        if _is_frozen(keys, prefixes):
            p.requires_grad_(False)
            continue
        if _is_norm_module(keys):
            groups["norm"].append(p)
        elif keys[-1] == "scale":
            groups["none"].append(p)
        else:
            groups["decay"].append(p)
    decay = {"decay": weight_decay, "norm": weight_decay_norm, "none": 0.0}
    return [{"params": ps, "weight_decay": decay[k], "name": k}
            for k, ps in groups.items() if ps]


class ClippedSGD(torch.optim.SGD):
    """``torch.optim.SGD`` that clips the gradients first, by optax's
    rules (the module docstring). ``clip_type``: "value" or "norm";
    ``clip_value`` <= 0 turns clipping off. The clip runs on the device,
    with no host sync."""

    def __init__(self, params, lr: float, momentum: float = 0.0,
                 nesterov: bool = False, clip_value: float = 0.0,
                 clip_type: str = "value"):
        if clip_type not in ("value", "norm"):
            raise ValueError(f"unsupported clip_type: {clip_type!r}")
        super().__init__(params, lr=lr, momentum=momentum,
                         nesterov=nesterov)
        self.clip_value = float(clip_value)
        self.clip_type = clip_type

    @torch.no_grad()
    def clip_(self) -> None:
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if self.clip_value <= 0 or not grads:
            return
        v = self.clip_value
        if self.clip_type == "value":
            for g in grads:
                g.clamp_(-v, v)
            return
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        keep = norm < v
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * v))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ClippedSGD takes no closure")
        self.clip_()
        return super().step()


def make_optimizer(
    model: nn.Module,
    base_lr: float,
    steps: Sequence[int],
    *,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    weight_decay_norm: float = 0.0,
    nesterov: bool = False,
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 1000,
    warmup_iters: int = 1000,
    warmup_method: str = "linear",
    clip_value: float = 0.0,
    clip_type: str = "value",
    freeze_at: int = 0,
) -> Tuple[ClippedSGD, torch.optim.lr_scheduler.LambdaLR]:
    """The optimizer over ``model``'s trainable parameters and its
    schedule; call ``scheduler.step()`` after each ``optimizer.step()``."""
    schedule = warmup_multistep_schedule(base_lr, steps, gamma, warmup_factor,
                                         warmup_iters, warmup_method)
    opt = ClippedSGD(param_groups(model, weight_decay, weight_decay_norm,
                                  freeze_at),
                     lr=base_lr, momentum=momentum, nesterov=nesterov,
                     clip_value=clip_value, clip_type=clip_type)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: schedule(count) / base_lr)
    return opt, sched


def make_optimizer_from_cfg(model: nn.Module, cfg
                            ) -> Tuple[ClippedSGD,
                                       torch.optim.lr_scheduler.LambdaLR]:
    """``make_optimizer`` with the SOLVER and FREEZE_AT settings of a
    config, as ``tools/train_net.py`` builds it."""
    clip = cfg.SOLVER.CLIP_GRADIENTS
    if clip.ENABLED and clip.CLIP_TYPE == "norm" and \
            float(clip.NORM_TYPE) != 2.0:
        raise ValueError("only NORM_TYPE 2.0 (global L2) is supported")
    return make_optimizer(
        model, cfg.SOLVER.BASE_LR, tuple(cfg.SOLVER.STEPS),
        momentum=cfg.SOLVER.MOMENTUM, weight_decay=cfg.SOLVER.WEIGHT_DECAY,
        weight_decay_norm=cfg.SOLVER.WEIGHT_DECAY_NORM,
        nesterov=cfg.SOLVER.NESTEROV, gamma=cfg.SOLVER.GAMMA,
        warmup_factor=cfg.SOLVER.WARMUP_FACTOR,
        warmup_iters=cfg.SOLVER.WARMUP_ITERS,
        warmup_method=cfg.SOLVER.WARMUP_METHOD,
        clip_value=clip.CLIP_VALUE if clip.ENABLED else 0.0,
        clip_type=clip.CLIP_TYPE, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT)
