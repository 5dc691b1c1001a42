"""Loss primitives: sigmoid focal loss, IoU-family box loss, masked BCE
(the port of ``centermask2_tpu/ops/losses.py``).

Replacements for fvcore sigmoid_focal_loss_jit (reference
fcos_outputs.py:99-105) and the reference IOULoss (layers/iou_loss.py:
5-54), in masked form: rows with weight zero contribute exactly zero.

Every ``jnp.maximum``/``jnp.minimum``/``jnp.clip`` of the JAX functions is
``torch.maximum``/``torch.minimum`` here: at a tie both split the
gradient in half between the two arguments, where ``torch.clamp`` would
pass all of it and ``F.relu`` none. ``jnp.abs`` passes the full gradient
at 0 and ``torch.abs`` none, so ``_abs`` selects as JAX's rule does.
"""

from __future__ import annotations

from typing import Optional

import torch


def _max0(x: torch.Tensor, floor: float = 0.0) -> torch.Tensor:
    """``jnp.maximum(x, floor)`` with its tie gradient (half to x)."""
    return torch.maximum(x, torch.full_like(x, floor))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` with its gradient at 0 (+1, the x >= 0 branch)."""
    return torch.where(x >= 0, x, -x)


def optax_sigmoid_bce(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE with logits, elementwise (==
    F.binary_cross_entropy_with_logits, reduction='none', in JAX's
    formula)."""
    return _max0(logits) - logits * targets + \
        torch.log1p(torch.exp(-_abs(logits)))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise focal loss (fvcore semantics). No reduction."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_bce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def iou_loss(pred: torch.Tensor, target: torch.Tensor,
             weight: Optional[torch.Tensor] = None,
             loss_type: str = "giou") -> torch.Tensor:
    """IoU / linear-IoU / GIoU loss on (l, t, r, b) distance vectors,
    summed over rows (weighted): reference layers/iou_loss.py:14-54, with
    its +1 smoothing of the IoU ratio."""
    pred_l, pred_t, pred_r, pred_b = pred.unbind(-1)
    tgt_l, tgt_t, tgt_r, tgt_b = target.unbind(-1)

    target_area = (tgt_l + tgt_r) * (tgt_t + tgt_b)
    pred_area = (pred_l + pred_r) * (pred_t + pred_b)

    w_intersect = torch.minimum(pred_l, tgt_l) + torch.minimum(pred_r, tgt_r)
    h_intersect = torch.minimum(pred_b, tgt_b) + torch.minimum(pred_t, tgt_t)
    g_w = torch.maximum(pred_l, tgt_l) + torch.maximum(pred_r, tgt_r)
    g_h = torch.maximum(pred_b, tgt_b) + torch.maximum(pred_t, tgt_t)
    ac_union = g_w * g_h

    area_intersect = w_intersect * h_intersect
    area_union = target_area + pred_area - area_intersect

    ious = (area_intersect + 1.0) / (area_union + 1.0)
    gious = ious - (ac_union - area_union) / torch.where(
        ac_union == 0, torch.ones_like(ac_union), ac_union)

    if loss_type == "iou":
        losses = -torch.log(_max0(ious, 1e-8))
    elif loss_type == "linear_iou":
        losses = 1 - ious
    elif loss_type == "giou":
        losses = 1 - gious
    else:
        raise NotImplementedError(loss_type)
    if weight is not None:
        return torch.sum(losses * weight)
    return torch.sum(losses)
