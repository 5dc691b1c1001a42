"""CenterROIHeads, inference (the port of
``centermask2_tpu/models/roi/heads.py``): assign each ROI its FPN level
by area ratio, pool it with the multilevel ROIAlign, run the SAG-Mask
head, select each ROI's class mask, and rescore with MaskIoU.

All per-ROI tensors are padded buffers with validity masks; the images of
a batch share one ROI axis (batch_indices select the image). Training
(proposal matching and sampling) and the keypoint branch are not ported
yet (ROADMAP queue 1, items 12 and 13).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
from torch import nn

from ...ops import (assign_boxes_by_area, assign_boxes_by_ratio,
                    multilevel_roi_align)
from ...structures import boxes as box_ops
from .mask_head import SpatialAttentionMaskHead, mask_rcnn_inference
from .maskiou_head import MaskIoUHead, mask_iou_inference


class CenterROIHeads(nn.Module):
    """Branch heads with parameters; pooling and assignment are ops."""

    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 in_strides: Sequence[int] = (8, 16, 32),
                 mask_on: bool = True, maskiou_on: bool = True,
                 assign_criterion: str = "ratio", pooler_resolution: int = 14,
                 sampling_ratio: int = 2, mask_conv_dims: int = 256,
                 mask_num_conv: int = 4, mask_norm: str = "",
                 cls_agnostic_mask: bool = False,
                 maskiou_conv_dims: int = 256, maskiou_num_conv: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if sampling_ratio == 0:
            raise NotImplementedError(
                "TPU.POOLER_SAMPLING_RATIO=0 (adaptive buckets) is not "
                "ported yet (ROADMAP queue 1, item 12)")
        self.in_strides = tuple(in_strides)
        self.mask_on = mask_on
        self.maskiou_on = maskiou_on
        self.assign_criterion = assign_criterion
        self.pooler_resolution = pooler_resolution
        self.sampling_ratio = sampling_ratio
        if mask_on:
            self.mask_head = SpatialAttentionMaskHead(
                in_channels, num_classes, mask_conv_dims, mask_num_conv,
                mask_norm, cls_agnostic_mask, dtype=dtype)
        if maskiou_on:
            self.maskiou_head = MaskIoUHead(
                in_channels, num_classes, maskiou_conv_dims,
                maskiou_num_conv, pooler_resolution, dtype=dtype)

    def _assign_levels(self, flat_boxes: torch.Tensor,
                       img_areas: torch.Tensor) -> torch.Tensor:
        min_level = 3
        max_level = min_level + len(self.in_strides) - 1
        box_areas = box_ops.area(flat_boxes)
        if self.assign_criterion == "ratio":
            return assign_boxes_by_ratio(box_areas, img_areas, min_level,
                                         max_level)
        return assign_boxes_by_area(box_areas, min_level, max_level)

    def pool(self, features: List[torch.Tensor], flat_boxes: torch.Tensor,
             batch_indices: torch.Tensor, img_areas: torch.Tensor
             ) -> torch.Tensor:
        levels = self._assign_levels(flat_boxes, img_areas)
        scales = [1.0 / s for s in self.in_strides]
        return multilevel_roi_align(
            features, flat_boxes, batch_indices, levels, scales,
            self.pooler_resolution, self.sampling_ratio, aligned=True)

    def forward(self, features: List[torch.Tensor], boxes: torch.Tensor,
                classes: torch.Tensor, valid: torch.Tensor,
                batch_indices: torch.Tensor, img_areas: torch.Tensor,
                scores: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Inference path (forward_with_given_boxes). features: [p3, p4,
        p5] NCHW; boxes/classes/valid/scores: flattened (R,) ROI buffers;
        batch_indices: image of each ROI; img_areas: (R,). Returns
        pred_masks (R, 2M, 2M) f32 probabilities and mask_scores (R,)."""
        out: Dict[str, torch.Tensor] = {}
        if not self.mask_on:
            return out
        pooled = self.pool(features, boxes, batch_indices, img_areas)
        mask_probs = mask_rcnn_inference(self.mask_head(pooled), classes)
        out["pred_masks"] = mask_probs
        zero = torch.zeros_like(scores)
        if self.maskiou_on:
            pred_maskiou = self.maskiou_head(pooled, mask_probs[:, None])
            out["mask_scores"] = torch.where(
                valid, mask_iou_inference(pred_maskiou, classes, scores), zero)
        else:
            out["mask_scores"] = torch.where(valid, scores, zero)
        return out
