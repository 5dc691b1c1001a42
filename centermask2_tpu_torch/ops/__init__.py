from .group_norm import group_norm_relu_op
from .nms import batched_nms, nms_keep_mask, nms_select
from .paste_masks import paste_masks
from .roi_align import (
    assign_boxes_by_area,
    assign_boxes_by_ratio,
    multilevel_roi_align,
)
from .select import masked_topk

__all__ = [
    "batched_nms", "group_norm_relu_op", "nms_keep_mask", "nms_select",
    "paste_masks",
    "assign_boxes_by_area", "assign_boxes_by_ratio", "multilevel_roi_align",
    "masked_topk",
]
