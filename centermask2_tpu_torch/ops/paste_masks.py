"""Paste ROI masks into full-resolution images by separable interpolation
(the port of ``centermask2_tpu/ops/paste_masks.py``).

Bilinear resampling of an (M, M) mask into its box footprint is
separable: out[r] = Wy[r] @ mask[r] @ Wx[r]^T with interpolation
matrices Wy (H, M) and Wx (W, M), two batched matmuls with static shapes
(R, H, W) and no gathers. It matches torch grid_sample
(align_corners=False, zero padding) restricted to the box's integer
footprint, which is what detectron2's _do_paste_mask computes
(reference deploy_utils.py:153-156).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _interp_matrix(starts: torch.Tensor, ends: torch.Tensor, size: int,
                   mask_size: int) -> torch.Tensor:
    """(R,) box starts/ends along one axis -> (R, size, mask_size)."""
    dev = starts.device
    coords = torch.arange(size, dtype=torch.float32, device=dev) + 0.5
    # mask-space coordinate of each image pixel (align_corners=False)
    span = torch.clamp(ends - starts, min=1e-6)
    m = (coords[None, :] - starts[:, None]) / span[:, None] * mask_size - 0.5
    taps = torch.arange(mask_size, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - (m[:, :, None] - taps[None, None, :]).abs(),
                    min=0.0)
    # restrict to the box's integer footprint [floor(start), ceil(end))
    inside = (coords[None, :] >= torch.floor(starts)[:, None]) & (
        coords[None, :] < torch.ceil(ends)[:, None] + 0.5)
    return w * inside[:, :, None]


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor,
                image_size: Tuple[int, int],
                threshold: float = 0.5) -> torch.Tensor:
    """Paste each (M, M) soft mask (R, M, M) into its xyxy box (R, 4);
    returns (R, H, W) bool, or the float paste if ``threshold`` < 0."""
    H, W = image_size
    M = masks.shape[-1]
    boxes = boxes.float()
    wy = _interp_matrix(boxes[:, 1], boxes[:, 3], H, M)  # (R, H, M)
    wx = _interp_matrix(boxes[:, 0], boxes[:, 2], W, M)  # (R, W, M)
    out = torch.einsum("rhm,rmn,rwn->rhw", wy, masks.float(), wx)
    if threshold >= 0:
        return out > threshold
    return out
