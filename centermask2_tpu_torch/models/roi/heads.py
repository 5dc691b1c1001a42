"""CenterROIHeads (the port of ``centermask2_tpu/models/roi/heads.py``).

- Inference (reference center_heads.py:413-444): assign each ROI its FPN
  level by area ratio, pool it with the multilevel ROIAlign, run the
  SAG-Mask head, select each ROI's class mask, and rescore with MaskIoU.
  The keypoint head (``keypoint_forward``) pools with the same pooler:
  ROI_HEADS.IN_FEATURES (p3-p5), POOLER_RESOLUTION and
  TPU.POOLER_SAMPLING_RATIO, as the JAX heads do; detectron2 would take
  ROI_KEYPOINT_HEAD.IN_FEATURES (p2-p5), but the FPN here has no p2.
- Training (reference center_heads.py:173-260): append the gt boxes to
  the proposals, match them by IoU (detectron2 Matcher, no low-quality
  matches) and subsample ``batch_size_per_image`` rows at most
  ``positive_fraction`` foreground by random priority, for the whole
  batch at once (the JAX package vmaps over images). The uniform draws
  are an argument, so a test can hand both packages the same numbers.

All per-ROI tensors are padded buffers with validity masks; the images of
a batch share one ROI axis (batch_indices select the image). Orders among
equal keys are the JAX ones: stable sorts, first maxima.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn

from ...ops import (assign_boxes_by_area, assign_boxes_by_ratio,
                    multilevel_roi_align)
from ...structures import boxes as box_ops
from .keypoint_head import KRCNNConvDeconvUpsampleHead
from .mask_head import SpatialAttentionMaskHead, mask_rcnn_inference
from .maskiou_head import MaskIoUHead, mask_iou_inference


class SampledProposals(NamedTuple):
    """Fixed-capacity training proposals, (B, S, ...)."""

    boxes: torch.Tensor  # (B, S, 4)
    gt_classes: torch.Tensor  # (B, S) in [0, C] (C = background)
    gt_indices: torch.Tensor  # (B, S) matched gt row
    valid: torch.Tensor  # (B, S) bool


def match_proposals(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                    proposal_boxes: torch.Tensor,
                    iou_thresholds: Sequence[float] = (0.5,),
                    iou_labels: Sequence[int] = (0, 1)
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Matcher(MODEL.ROI_HEADS.IOU_THRESHOLDS, IOU_LABELS, no
    low-quality matches) over gt (B, G, 4) and proposals (B, P, 4):
    returns (matched_idx (B, P), matched_label (B, P)). A label is
    ``iou_labels[i]`` for a matched IoU in [thr[i-1], thr[i]); 1 = fg,
    0 = bg, -1 = ignore. The first of equal IoUs wins, as in JAX."""
    if len(iou_labels) != len(iou_thresholds) + 1:
        raise ValueError("need one more IoU label than thresholds")
    iou = box_ops.pairwise_iou(gt_boxes, proposal_boxes)  # (B, G, P)
    iou = torch.where(gt_valid[:, :, None], iou, torch.full_like(iou, -1.0))
    matched_vals, matched_idx = iou.max(dim=1)
    interval = sum((matched_vals >= thr).long() for thr in iou_thresholds)
    # iou_labels[interval], built on the device (no host table copy)
    label = torch.full_like(interval, iou_labels[0], dtype=torch.int32)
    for i in range(1, len(iou_labels)):
        label = torch.where(interval == i, iou_labels[i], label)
    return matched_idx, label


def _stable_rank(x: torch.Tensor) -> torch.Tensor:
    """``argsort(argsort(x))`` along the last axis with stable sorts, as
    ``jnp.argsort`` sorts."""
    order = torch.sort(x, dim=-1, stable=True).indices
    return torch.sort(order, dim=-1, stable=True).indices


def subsample_proposals(draws: torch.Tensor, fg_mask: torch.Tensor,
                        bg_mask: torch.Tensor, batch_size: int,
                        positive_fraction: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random subsample to ``batch_size`` slots with at most
    ``positive_fraction`` positives (detectron2 subsample_labels).
    ``draws``: (B, P) uniform [0, 1) numbers, one per proposal row.

    Returns (indices, is_fg, valid), each (B, batch_size). Ranks and the
    final pick take ties lowest index first (``jnp.argsort`` is stable,
    ``lax.top_k`` takes the lower index): ``3 + r`` rounds distinct draws
    to equal f32 values often enough for that to matter."""
    B, P = fg_mask.shape
    max_fg = int(batch_size * positive_fraction)
    r = draws.float()
    two = torch.full_like(r, 2.0)
    keep_fg = fg_mask & (_stable_rank(torch.where(fg_mask, r, two)) < max_fg)
    num_fg = keep_fg.sum(dim=1, keepdim=True)
    keep_bg = bg_mask & (_stable_rank(torch.where(bg_mask, r, two))
                         < batch_size - num_fg)
    # priority: positives first (3 + r), then negatives (1 + r)
    pri = torch.where(keep_fg, 3.0 + r,
                      torch.where(keep_bg, 1.0 + r, torch.full_like(r, -1.0)))
    if P < batch_size:  # fewer proposals than sample slots: dead rows
        pri = torch.cat([pri, pri.new_full((B, batch_size - P), -1.0)], dim=1)
    top, idx = torch.sort(pri, dim=1, descending=True, stable=True)
    top, idx = top[:, :batch_size], idx[:, :batch_size]
    idx = torch.clamp_max(idx, P - 1)
    valid = top > 0.0
    return idx, torch.gather(keep_fg, 1, idx) & valid, valid


def label_and_sample_proposals(
    draws: torch.Tensor,  # (B, P) uniform draws, P = K (+ G with append_gt)
    proposal_boxes: torch.Tensor,  # (B, K, 4) from FCOS
    proposal_valid: torch.Tensor,  # (B, K)
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_classes: torch.Tensor,  # (B, G)
    gt_valid: torch.Tensor,  # (B, G)
    num_classes: int,
    batch_size_per_image: int = 512,
    positive_fraction: float = 0.25,
    iou_thresholds: Sequence[float] = (0.5,),
    iou_labels: Sequence[int] = (0, 1),
    append_gt: bool = True,
) -> SampledProposals:
    """Proposal labeling and sampling (center_heads.py:173-260) for a
    batch of images."""
    if append_gt:
        boxes = torch.cat([proposal_boxes, gt_boxes], dim=1)
        valid = torch.cat([proposal_valid, gt_valid], dim=1)
    else:
        boxes, valid = proposal_boxes, proposal_valid
    if draws.shape != valid.shape:
        raise ValueError(f"draws {tuple(draws.shape)}: one per proposal row "
                         f"{tuple(valid.shape)} needed")
    matched_idx, matched_label = match_proposals(
        gt_boxes, gt_valid, boxes, iou_thresholds, iou_labels)
    any_gt = gt_valid.any(dim=1, keepdim=True)
    cls = torch.gather(gt_classes.long(), 1, matched_idx)
    cls = torch.where((matched_label == 1) & any_gt, cls, num_classes)

    fg = valid & (matched_label == 1) & any_gt
    bg = valid & (matched_label == 0)
    idx, _, sel_valid = subsample_proposals(
        draws, fg, bg, batch_size_per_image, positive_fraction)
    return SampledProposals(
        boxes=torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
        gt_classes=torch.where(sel_valid, torch.gather(cls, 1, idx),
                               num_classes),
        gt_indices=torch.gather(matched_idx, 1, idx),
        valid=sel_valid)


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
                 keypoint_on: bool = False, num_keypoints: int = 17,
                 keypoint_conv_dims: Sequence[int] = (512,) * 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_strides = tuple(in_strides)
        self.mask_on = mask_on
        self.maskiou_on = maskiou_on
        self.keypoint_on = keypoint_on
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
        if keypoint_on:
            self.keypoint_head = KRCNNConvDeconvUpsampleHead(
                in_channels, num_keypoints, keypoint_conv_dims, dtype=dtype)

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

    def mask_forward_train(self, features: List[torch.Tensor],
                           boxes: torch.Tensor, batch_indices: torch.Tensor,
                           img_areas: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pool and mask head on the (padded) foreground proposals: returns
        (pooled (R, C, 14, 14), mask_logits (R, classes, 28, 28)); the pool
        carries the ROIAlign gradient to the features."""
        pooled = self.pool(features, boxes, batch_indices, img_areas)
        return pooled, self.mask_head(pooled)

    def maskiou_forward(self, pooled: torch.Tensor,
                        selected_mask: torch.Tensor) -> torch.Tensor:
        return self.maskiou_head(pooled, selected_mask)

    def keypoint_forward(self, features: List[torch.Tensor],
                         boxes: torch.Tensor, batch_indices: torch.Tensor,
                         img_areas: torch.Tensor) -> torch.Tensor:
        """Pool and keypoint head: (R, K, 56, 56) logits (JAX
        ``heads.py:230-232``); the pool carries the ROIAlign gradient to
        the features."""
        return self.keypoint_head(
            self.pool(features, boxes, batch_indices, img_areas))
