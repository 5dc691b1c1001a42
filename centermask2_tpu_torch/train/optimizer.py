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
- the learning rate of update k is the schedule at k, as optax evaluates
  it at the count of earlier updates.

The schedule lives on the device (``WarmupMultiStepLR``): a step-count
tensor, advanced in place after each update, from which the update
computes the rate in f32 with JAX's formula. The update itself is
foreach ops that read that rate as a tensor, so nothing in a step
crosses to the host and a captured train step (``train/trainer.py``)
replays the schedule. ``torch.optim.SGD`` would not capture with a tensor
rate outside ``torch.compile``: its foreach path passes the rate as the
``alpha`` of ``_foreach_add_``, a host number (``torch/optim/sgd.py``).
Checkpoints keep the schema of ``torch.optim.SGD`` and ``LambdaLR``.

Frozen parameters (``MODEL.BACKBONE.FREEZE_AT``) get
``requires_grad=False`` and stay out of the update; FrozenBN's scale and
bias are buffers of the port. The JAX package holds both as parameters
whose updates it zeroes, so its global norm also counts their gradients.
With clipping by norm the port counts them too: ``frozen_leaves`` lists
them, the train step gives them gradients, and ``ClippedSGD`` adds those
to the norm and updates nothing of them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn


class WarmupMultiStepLR:
    """WarmupMultiStepLR (detectron2 solver) on the device. ``count`` is an
    int64 scalar tensor on ``device``, the number of updates so far;
    ``lr()`` evaluates the rate of the next update from it in f32 with
    the JAX package's formula (``optimizer.py:34-42``): linear (or
    constant) warm-up from ``warmup_factor`` over ``warmup_iters``, then
    ``gamma`` at each of ``steps``. ``step()`` adds one in place, so a
    captured step advances it at every replay. ``state_dict`` holds
    ``last_epoch``, LambdaLR's key, and ``load_state_dict`` takes a
    LambdaLR state too, written into ``count`` in place."""

    def __init__(self, base_lr: float, steps: Sequence[int],
                 gamma: float = 0.1, warmup_factor: float = 1.0 / 1000,
                 warmup_iters: int = 1000, warmup_method: str = "linear",
                 device=None):
        if warmup_method not in ("linear", "constant"):
            raise ValueError(f"unknown warmup method {warmup_method!r}")
        self.base_lr = float(base_lr)
        self.gamma = float(gamma)
        self.warmup_factor = float(warmup_factor)
        self.warmup_iters = int(warmup_iters)
        self.warmup_method = warmup_method
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.milestones = torch.tensor(sorted(steps), dtype=torch.float32,
                                       device=device)

    def lr(self) -> torch.Tensor:
        it = self.count.float()
        if self.warmup_method == "linear":
            alpha = torch.clamp(it / max(self.warmup_iters, 1), 0.0, 1.0)
            warm = self.warmup_factor * (1 - alpha) + alpha
        else:
            warm = torch.where(it < self.warmup_iters,
                               self.warmup_factor, 1.0)
        decay = torch.pow(torch.full_like(it, self.gamma),
                          (it >= self.milestones).sum().float())
        return self.base_lr * warm * decay

    def step(self) -> None:
        self.count.add_(1)

    @property
    def last_epoch(self) -> int:
        return int(self.count)

    def state_dict(self) -> Dict:
        return {"last_epoch": int(self.count)}

    def load_state_dict(self, state: Dict) -> None:
        self.count.fill_(int(state["last_epoch"]))


def freeze_prefixes(freeze_at: int) -> Tuple[str, ...]:
    """MODEL.BACKBONE.FREEZE_AT -> backbone module-name patterns to freeze
    (JAX ``optimizer.py:47-71``). Stage 1 is the stem: VoVNet's
    ``stem_{1,2,3}``, ResNet's ``stem_conv1`` and MobileNet's
    ``features0_*``. Stage s >= 2 adds VoVNet's ``OSA{s}_*``, ResNet's
    ``res{s}_*`` and MobileNet's block ``features{s-1}``. A trailing
    ``$`` marks an exact module-name match; anything else is a prefix."""
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


def frozen_leaves(model: nn.Module, freeze_at: int) -> List[torch.Tensor]:
    """The tensors the JAX package holds as parameters with zeroed
    updates: the FREEZE_AT parameters and FrozenBN's ``frozen_*``
    buffers. Its global norm counts their gradients."""
    prefixes = freeze_prefixes(freeze_at)
    out = [p for n, p in model.named_parameters()
           if _is_frozen(n.split("."), prefixes)]
    return out + [b for n, b in model.named_buffers()
                  if n.split(".")[-1].startswith("frozen_")]


class ClippedSGD(torch.optim.SGD):
    """SGD that clips the gradients first, by optax's rules (the module
    docstring). ``clip_type``: "value" or "norm"; ``clip_value`` <= 0
    turns clipping off. ``schedule`` gives the rate as a device tensor
    (each group's ``lr`` stays the base rate, for the checkpoint's
    schema). ``counted``:
    tensors whose gradients the global norm counts but which no update
    touches (``frozen_leaves``); ``zero_grad`` clears their gradients
    too. Everything runs on the device, with no host sync."""

    def __init__(self, params, lr: float, schedule: WarmupMultiStepLR,
                 momentum: float = 0.0, nesterov: bool = False,
                 clip_value: float = 0.0, clip_type: str = "value",
                 counted: Sequence[torch.Tensor] = ()):
        if clip_type not in ("value", "norm"):
            raise ValueError(f"unsupported clip_type: {clip_type!r}")
        super().__init__(params, lr=lr, momentum=momentum,
                         nesterov=nesterov)
        self.clip_value = float(clip_value)
        self.clip_type = clip_type
        self.schedule = schedule
        self.counted = list(counted)

    def zero_grad(self, set_to_none: bool = True) -> None:
        super().zero_grad(set_to_none)
        for t in self.counted:
            t.grad = None

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
        counted = grads + [t.grad for t in self.counted if t.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in counted))
        keep = norm < v
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * v))

    @torch.no_grad()
    def step(self, closure=None):
        """Clip, then per group: weight decay, momentum (nesterov), and
        ``p -= lr * update`` with the rate as a tensor, in foreach ops."""
        if closure is not None:
            raise ValueError("ClippedSGD takes no closure")
        self.clip_()
        lr = self.schedule.lr()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            m = group["momentum"]
            if m:
                bufs = [self.state[p].get("momentum_buffer") for p in params]
                if all(b is not None for b in bufs):
                    torch._foreach_mul_(bufs, m)
                    torch._foreach_add_(bufs, grads)
                else:
                    for p, g, b in zip(params, grads, bufs):
                        if b is None:
                            self.state[p]["momentum_buffer"] = g.clone()
                        else:
                            b.mul_(m).add_(g)
                    bufs = [self.state[p]["momentum_buffer"] for p in params]
                grads = torch._foreach_add(grads, bufs, alpha=m) \
                    if group["nesterov"] else bufs
            torch._foreach_sub_(params, torch._foreach_mul(grads, lr))

    def load_state_dict(self, state_dict) -> None:
        """``torch.optim.SGD``'s, with the loaded momentum written into the
        buffers that already exist (a captured step keeps reading them),
        or into new ones: ``torch.optim`` keeps the given tensors where
        they already have the parameters' device and dtype, and the next
        update would write into the caller's state."""
        live = {p: st["momentum_buffer"] for p, st in self.state.items()
                if torch.is_tensor(st.get("momentum_buffer"))}
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            new = st.get("momentum_buffer")
            if torch.is_tensor(new):
                st["momentum_buffer"] = live[p].copy_(new) if p in live \
                    else new.clone()


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
) -> Tuple[ClippedSGD, WarmupMultiStepLR]:
    """The optimizer over ``model``'s trainable parameters and its
    schedule on the parameters' device; call ``scheduler.step()`` after
    each ``optimizer.step()``. With clipping by norm the optimizer counts
    ``frozen_leaves`` in the norm."""
    sched = WarmupMultiStepLR(base_lr, steps, gamma, warmup_factor,
                              warmup_iters, warmup_method,
                              device=next(model.parameters()).device)
    counted = frozen_leaves(model, freeze_at) \
        if clip_type == "norm" and clip_value > 0 else ()
    opt = ClippedSGD(param_groups(model, weight_decay, weight_decay_norm,
                                  freeze_at),
                     lr=base_lr, schedule=sched, momentum=momentum,
                     nesterov=nesterov, clip_value=clip_value,
                     clip_type=clip_type, counted=counted)
    return opt, sched


def make_optimizer_from_cfg(model: nn.Module, cfg
                            ) -> Tuple[ClippedSGD, WarmupMultiStepLR]:
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
