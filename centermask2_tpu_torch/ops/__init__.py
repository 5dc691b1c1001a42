from .nms import batched_nms, nms_keep_mask, nms_select
from .roi_align import (
    assign_boxes_by_area,
    assign_boxes_by_ratio,
    multilevel_roi_align,
)
from .select import masked_topk

__all__ = [
    "batched_nms", "nms_keep_mask", "nms_select", "assign_boxes_by_area",
    "assign_boxes_by_ratio", "multilevel_roi_align", "masked_topk",
]
