from .heads import (
    CenterROIHeads,
    SampledProposals,
    label_and_sample_proposals,
    match_proposals,
    subsample_proposals,
)
from .keypoint_head import (
    KRCNNConvDeconvUpsampleHead,
    heatmaps_to_keypoints,
    keypoint_rcnn_inference,
    keypoint_rcnn_loss,
    keypoints_to_heatmap,
)
from .mask_head import SpatialAttentionMaskHead, mask_rcnn_inference
from .maskiou_head import MaskIoUHead, mask_iou_inference, mask_iou_loss

__all__ = ["CenterROIHeads", "SampledProposals", "label_and_sample_proposals",
           "match_proposals", "subsample_proposals",
           "SpatialAttentionMaskHead", "mask_rcnn_inference", "MaskIoUHead",
           "mask_iou_inference", "mask_iou_loss",
           "KRCNNConvDeconvUpsampleHead", "heatmaps_to_keypoints",
           "keypoint_rcnn_inference", "keypoint_rcnn_loss",
           "keypoints_to_heatmap"]
