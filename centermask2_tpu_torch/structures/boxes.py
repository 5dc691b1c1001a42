"""Functional box ops on (..., 4) XYXY tensors (the port of
``centermask2_tpu/structures/boxes.py``).

The float32 operations run in the JAX package's order, so that IoU
comparisons against a threshold decide identically (the NMS keep set
depends on it).
"""

from __future__ import annotations

import torch


def area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (...,) areas."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_intersection(boxes1: torch.Tensor,
                          boxes2: torch.Tensor) -> torch.Tensor:
    """(..., M, 4), (..., N, 4) -> (..., M, N) intersection areas."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(..., M, 4), (..., N, 4) -> (..., M, N) IoU. Zero where union is zero."""
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[..., :, None]
    a2 = area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0), 0.0)
