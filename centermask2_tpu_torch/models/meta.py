"""CenterMask meta-architecture, inference: backbone -> FPN -> FCOS ->
ROI heads (the port of ``centermask2_tpu/models/meta.py``).

``CenterMask.inference`` takes the JAX model's input, a normalized padded
NHWC batch (B, H, W, 3), and returns the same fixed-capacity
``InferenceOutputs``: the six tensors of the reference's export contract
(deploy_utils.py:117-126) plus an explicit validity mask. Inside, the
activations are NCHW.

Not ported yet, each raising ``NotImplementedError``: training (ROADMAP
queue 1, item 13), keypoints and DCN (item 12), the ResNet and MobileNet
backbones (item 11), and the serving input modes: s2d input, uint8 input
and the tight-canvas pad (item 9).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..config import CfgNode
from ..layers import reset_parameters
from ..utils.device import DeviceLike, resolve_device
from .backbones import FPN, VoVNet, feature_channels
from .backbones.vovnet import FEATURE_STRIDES
from .fcos import FCOSHead, compute_locations, decode_batch
from .roi import CenterROIHeads


class InferenceOutputs(NamedTuple):
    """Batched fixed-capacity outputs; the first six fields mirror
    single_flatten_to_tuple (deploy_utils.py:117-126).

    ``pred_classes`` is int32, as in the JAX package: class ids are below
    2^31 and every index op of the port takes int32. The reference's bin
    contract names int64 (BASELINE.md); a caller that writes that format
    widens at its own boundary. Invalid slots carry unmasked
    ``pred_classes`` and ``locations``: read them through ``valid``."""

    locations: torch.Tensor  # (B, K, 2)
    mask_scores: torch.Tensor  # (B, K)
    pred_boxes: torch.Tensor  # (B, K, 4)
    pred_classes: torch.Tensor  # (B, K) int32
    pred_masks: torch.Tensor  # (B, K, 1, 2M, 2M)
    scores: torch.Tensor  # (B, K)
    valid: torch.Tensor  # (B, K) bool


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class CenterMask(nn.Module):
    def __init__(
        self,
        conv_body: str = "V-39-eSE",
        backbone_norm: str = "FrozenBN",
        fpn_in_features: Sequence[str] = ("stage3", "stage4", "stage5"),
        fpn_out_channels: int = 256,
        fpn_norm: str = "",
        fpn_fuse_type: str = "sum",
        top_levels: int = 2,
        num_classes: int = 80,
        fcos_in_features: Sequence[str] = ("p3", "p4", "p5", "p6", "p7"),
        fpn_strides: Sequence[int] = (8, 16, 32, 64, 128),
        fcos_norm: str = "GN",
        num_cls_convs: int = 4,
        num_box_convs: int = 4,
        num_share_convs: int = 0,
        use_scale: bool = True,
        prior_prob: float = 0.01,
        thresh_with_ctr: bool = False,
        pre_nms_thresh_test: float = 0.05,
        pre_nms_topk_test: int = 1000,
        post_nms_topk_test: int = 50,
        nms_thresh: float = 0.6,
        nms_candidates: int = 1000,
        mask_on: bool = True,
        maskiou_on: bool = True,
        roi_in_features: Sequence[str] = ("p3", "p4", "p5"),
        roi_in_strides: Sequence[int] = (8, 16, 32),
        assign_criterion: str = "ratio",
        pooler_resolution: int = 14,
        pooler_sampling_ratio: int = 2,
        mask_norm: str = "",
        cls_agnostic_mask: bool = False,
        mask_conv_dim: int = 256,
        mask_num_conv: int = 4,
        maskiou_conv_dim: int = 256,
        maskiou_num_conv: int = 4,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        if top_levels != 2:
            raise NotImplementedError(
                "only the P6P7 top block is ported (ROADMAP queue 1, item 11)")
        self.fpn_in_features = tuple(fpn_in_features)
        self.fcos_in_features = tuple(fcos_in_features)
        self.fpn_strides = tuple(fpn_strides)
        self.roi_in_features = tuple(roi_in_features)
        self.mask_on = mask_on
        self.pooler_resolution = pooler_resolution
        self.decode_kwargs = dict(
            pre_nms_thresh=pre_nms_thresh_test,
            pre_nms_topk=pre_nms_topk_test, nms_thresh=nms_thresh,
            post_nms_topk=post_nms_topk_test, nms_candidates=nms_candidates,
            thresh_with_ctr=thresh_with_ctr)
        self.dtype = dtype

        self.backbone = VoVNet(conv_body, out_features=self.fpn_in_features,
                               norm=backbone_norm, dtype=dtype)
        chans = feature_channels(conv_body)
        self.fpn = FPN([chans[f] for f in self.fpn_in_features],
                       [FEATURE_STRIDES[f] for f in self.fpn_in_features],
                       fpn_out_channels, fpn_norm, fpn_fuse_type,
                       top_block="p6p7", dtype=dtype)
        self.fcos_head = FCOSHead(
            num_classes, fpn_out_channels, num_cls_convs, num_box_convs,
            num_share_convs, fcos_norm, len(self.fcos_in_features),
            use_scale, prior_prob, dtype=dtype)
        self.roi_heads = CenterROIHeads(
            fpn_out_channels, num_classes, roi_in_strides, mask_on,
            maskiou_on, assign_criterion, pooler_resolution,
            pooler_sampling_ratio, mask_conv_dim, mask_num_conv, mask_norm,
            cls_agnostic_mask, maskiou_conv_dim, maskiou_num_conv,
            dtype=dtype)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) normalized and padded (BGR - mean)."""
        H, W = images.shape[1], images.shape[2]
        if H % 32 or W % 32:
            raise ValueError(
                f"canvas {H}x{W} must be divisible by 32 (detectron2 "
                "size_divisibility): the FPN top-down 2x upsample "
                "misaligns against ceil-divided lateral shapes otherwise")
        x = images.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        bottom_up = self.backbone(x)
        return self.fpn([bottom_up[f] for f in self.fpn_in_features])

    def _fcos_raw(self, feats: Dict[str, torch.Tensor]):
        fcos_feats = [feats[f] for f in self.fcos_in_features]
        logits, reg, ctr = self.fcos_head(fcos_feats)
        shapes = [(f.shape[2], f.shape[3]) for f in fcos_feats]
        locations = compute_locations(shapes, self.fpn_strides,
                                      fcos_feats[0].device)
        return locations, logits, reg, ctr

    def _decode(self, locations, logits, reg, ctr):
        return decode_batch(locations, logits, reg, ctr, self.fpn_strides,
                            **self.decode_kwargs)

    def forward(self, images: torch.Tensor,
                image_sizes: Optional[torch.Tensor] = None
                ) -> InferenceOutputs:
        return self.inference(images, image_sizes)

    @torch.no_grad()
    def inference(self, images: torch.Tensor,
                  image_sizes: Optional[torch.Tensor] = None
                  ) -> InferenceOutputs:
        """Full inference to the output contract. ``image_sizes``: (B, 2)
        true (h, w) per image (defaults to the padded size, the reference's
        FakeImageList deployment contract)."""
        if not torch.is_floating_point(images):
            raise NotImplementedError(
                "uint8 (s2d-packed) input is not ported yet "
                "(ROADMAP queue 1, item 9)")
        B, H, W = images.shape[:3]
        feats = self.features(images)
        locations, logits, reg, ctr = self._fcos_raw(feats)
        proposals = self._decode(locations, logits, reg, ctr)

        K = proposals.pred_boxes.shape[1]
        flat_boxes = proposals.pred_boxes.reshape(B * K, 4)
        flat_classes = proposals.pred_classes.reshape(B * K)
        flat_valid = proposals.valid.reshape(B * K)
        flat_scores = proposals.scores.reshape(B * K)
        batch_idx = torch.arange(B, dtype=torch.int32,
                                 device=images.device).repeat_interleave(K)
        if image_sizes is None:  # filled on the device: no host copy
            img_areas = torch.full((B * K,), float(H * W),
                                   device=images.device)
        else:
            img_areas = (image_sizes[:, 0] * image_sizes[:, 1]).float() \
                .repeat_interleave(K)

        if self.mask_on:
            roi_out = self.roi_heads(
                [feats[f] for f in self.roi_in_features], flat_boxes,
                flat_classes, flat_valid, batch_idx, img_areas, flat_scores)
            masks = roi_out["pred_masks"]
            m = masks.shape[-1]
            pred_masks = masks.reshape(B, K, 1, m, m)
            mask_scores = roi_out["mask_scores"].reshape(B, K)
        else:
            m = 2 * self.pooler_resolution
            pred_masks = torch.zeros((B, K, 1, m, m), dtype=torch.float32,
                                     device=images.device)
            mask_scores = proposals.scores

        boxes_out = torch.where(proposals.valid[..., None],
                                proposals.pred_boxes,
                                torch.zeros_like(proposals.pred_boxes))
        return InferenceOutputs(
            locations=proposals.locations,
            mask_scores=mask_scores,
            pred_boxes=boxes_out,
            pred_classes=proposals.pred_classes,
            pred_masks=pred_masks,
            scores=proposals.scores,
            valid=proposals.valid,
        )


def build_centermask(cfg: CfgNode, device: DeviceLike = None,
                     seed: int = 0) -> CenterMask:
    """Construct the model from a config on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; raises with no GPU and no explicit request),
    in eval mode, with parameters drawn from ``seed`` by the JAX
    package's initializers. Load real weights afterwards with
    ``checkpoint.from_jax.load_jax_params``."""
    dev = resolve_device(device)
    backbone_name = cfg.MODEL.BACKBONE.NAME
    if "mobilenet" in backbone_name or "resnet" in backbone_name or \
            cfg.MODEL.MOBILENET:
        raise NotImplementedError(
            f"backbone {backbone_name!r} is not ported yet (ROADMAP queue 1, "
            "item 11)")
    if cfg.TPU.S2D_STEM_INPUT:
        raise NotImplementedError(
            "TPU.S2D_STEM_INPUT is not ported yet (ROADMAP queue 1, item 9)")
    if cfg.MODEL.KEYPOINT_ON:
        raise NotImplementedError(
            "keypoints are not ported yet (ROADMAP queue 1, item 12)")
    if cfg.MODEL.FCOS.USE_DEFORMABLE or any(cfg.MODEL.VOVNET.STAGE_WITH_DCN):
        raise NotImplementedError(
            "deformable convs are not ported yet (ROADMAP queue 1, item 12)")
    if cfg.TPU.APPROX_TOPK:
        raise NotImplementedError("TPU.APPROX_TOPK has no port")
    fpn_in = tuple(cfg.MODEL.FPN.IN_FEATURES) or ("stage3", "stage4", "stage5")
    model = CenterMask(
        conv_body=cfg.MODEL.VOVNET.CONV_BODY,
        backbone_norm=cfg.MODEL.VOVNET.NORM,
        fpn_in_features=fpn_in,
        fpn_out_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        fpn_norm=cfg.MODEL.FPN.NORM,
        fpn_fuse_type=cfg.MODEL.FPN.FUSE_TYPE,
        top_levels=cfg.MODEL.FCOS.TOP_LEVELS,
        num_classes=cfg.MODEL.FCOS.NUM_CLASSES,
        fcos_in_features=tuple(cfg.MODEL.FCOS.IN_FEATURES),
        fpn_strides=tuple(cfg.MODEL.FCOS.FPN_STRIDES),
        fcos_norm=cfg.MODEL.FCOS.NORM,
        num_cls_convs=cfg.MODEL.FCOS.NUM_CLS_CONVS,
        num_box_convs=cfg.MODEL.FCOS.NUM_BOX_CONVS,
        num_share_convs=cfg.MODEL.FCOS.NUM_SHARE_CONVS,
        use_scale=cfg.MODEL.FCOS.USE_SCALE,
        prior_prob=cfg.MODEL.FCOS.PRIOR_PROB,
        thresh_with_ctr=cfg.MODEL.FCOS.THRESH_WITH_CTR,
        pre_nms_thresh_test=cfg.MODEL.FCOS.INFERENCE_TH_TEST,
        pre_nms_topk_test=cfg.MODEL.FCOS.PRE_NMS_TOPK_TEST,
        # TEST.DETECTIONS_PER_IMAGE is detectron2's detection cap; it
        # binds here when tighter than the FCOS post-NMS top-k
        post_nms_topk_test=min(cfg.MODEL.FCOS.POST_NMS_TOPK_TEST,
                               cfg.TEST.DETECTIONS_PER_IMAGE),
        nms_thresh=cfg.MODEL.FCOS.NMS_TH,
        nms_candidates=cfg.TPU.NMS_CANDIDATES,
        mask_on=cfg.MODEL.MASK_ON,
        maskiou_on=cfg.MODEL.MASKIOU_ON,
        roi_in_features=tuple(cfg.MODEL.ROI_HEADS.IN_FEATURES),
        roi_in_strides=tuple(
            {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}[f]
            for f in cfg.MODEL.ROI_HEADS.IN_FEATURES),
        assign_criterion=cfg.MODEL.ROI_MASK_HEAD.ASSIGN_CRITERION,
        pooler_resolution=cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION,
        pooler_sampling_ratio=cfg.TPU.POOLER_SAMPLING_RATIO,
        mask_norm=cfg.MODEL.ROI_MASK_HEAD.NORM,
        cls_agnostic_mask=cfg.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK,
        mask_conv_dim=cfg.MODEL.ROI_MASK_HEAD.CONV_DIM,
        mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
        maskiou_conv_dim=cfg.MODEL.ROI_MASKIOU_HEAD.CONV_DIM,
        maskiou_num_conv=cfg.MODEL.ROI_MASKIOU_HEAD.NUM_CONV,
        dtype=_DTYPES[cfg.TPU.COMPUTE_DTYPE],
    )
    reset_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
