from .heads import CenterROIHeads
from .mask_head import SpatialAttentionMaskHead, mask_rcnn_inference
from .maskiou_head import MaskIoUHead, mask_iou_inference

__all__ = ["CenterROIHeads", "SpatialAttentionMaskHead",
           "mask_rcnn_inference", "MaskIoUHead", "mask_iou_inference"]
