"""CenterMask meta-architecture: backbone -> FPN -> FCOS -> ROI heads
(the port of ``centermask2_tpu/models/meta.py``).

``CenterMask.inference`` takes the JAX model's inputs and returns the
same fixed-capacity ``InferenceOutputs``: the six tensors of the
reference's export contract (deploy_utils.py:117-126) plus an explicit
validity mask. Inside, the activations are NCHW. The inputs are
- a normalized padded NHWC batch (B, H, W, 3), or, with ``s2d_input``
  (TPU.S2D_STEM_INPUT), its factor-4 s2d layout (B, H/4+1, W/4+1, 48);
- the serving form of the latter: the RAW uint8 s2d pack, normalized on
  the device (``_normalize_u8_s2d``), possibly over a tight canvas that
  the device zero-pads back to the deployment canvas (``_pad_to_canvas``)
  or that the program runs at as it is (tight compute).

``CenterMask.loss`` is the training branch (JAX ``meta.py:437-629``):
FCOS target assignment and losses, the train-mode decode (detached),
proposal matching and sampling, the foreground pick, the mask and
MaskIoU losses on the multilevel ROIAlign of the picked boxes. Its
inputs are the f32 canvas (or its s2d layout) and a ``GroundTruth``.

The backbone is a VoVNet (standard or depthwise body), a ResNet or a
MobileNetV2, resolved from the config as the JAX ``build_centermask``
does; the s2d stem input applies to the VoVNet only. With
MODEL.KEYPOINT_ON the ROI heads carry the keypoint head: ``inference``
adds ``pred_keypoints`` and ``loss`` adds ``loss_keypoint``. The
deformable convs (MODEL.VOVNET.STAGE_WITH_DCN, MODEL.FCOS.USE_DEFORMABLE)
and the adaptive ROIAlign buckets (TPU.POOLER_SAMPLING_RATIO 0) are
ported, and so are BN and SyncBN (``layers/blocks.py::BatchNorm``; ``loss``
trains them in the module's train mode) and ``TPU.REMAT_BACKBONE`` (the
backbone recomputed in the backward, ``torch.utils.checkpoint``).
``loss(group=...)`` is the JAX ``loss(axis_name=...)``: the FCOS
normalizers and SyncBN's moments are averaged over the process group.
``TPU.APPROX_TOPK`` has no port: it selects the TPU's approximate top-k.
More than one deformable group is refused: the JAX reference cannot run
it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import CfgNode
from ..layers import BatchNorm, no_stat_updates, reset_parameters
from ..utils import tracing
from ..utils.comm import Group, mean_reduce
from ..utils.device import DeviceLike, resolve_device
from ..ops import masked_topk
from ..ops.losses import optax_sigmoid_bce
from .backbones import (FPN, MOBILENET_FEATURE_CHANNELS,
                        RESNET_FEATURE_STRIDES, MobileNetV2, ResNet, VoVNet,
                        feature_channels, resnet_feature_channels)
from .backbones.vovnet import FEATURE_STRIDES
from .fcos import (FCOSHead, assign_targets_single_image, compute_locations,
                   decode_batch, fcos_losses, level_metadata)
from .roi import (CenterROIHeads, keypoint_rcnn_inference,
                  keypoint_rcnn_loss, keypoints_to_heatmap,
                  label_and_sample_proposals, mask_iou_loss)


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
    # (B, K, 17, 3) x, y, prob with the keypoint head, else None
    pred_keypoints: Optional[torch.Tensor] = None


class GroundTruth(NamedTuple):
    """Padded per-batch training targets (the host pipeline's output,
    ``data/coco.py::train_batches``)."""

    boxes: torch.Tensor  # (B, G, 4) xyxy in network input coords
    classes: torch.Tensor  # (B, G) int
    valid: torch.Tensor  # (B, G) bool
    mask_patches: torch.Tensor  # (B, G, P, P) float {0,1} over each gt box
    keypoints: Optional[torch.Tensor] = None  # (B, G, 17, 3) x, y, vis
    image_sizes: Optional[torch.Tensor] = None  # (B, 2) true (h, w)


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


BACKBONE_TYPES = ("vovnet", "resnet", "mobilenet")
TOP_LEVEL_BLOCKS = {2: "p6p7", 1: "p6", 0: None}  # FCOS.TOP_LEVELS


def _remat_contexts():
    """``torch.utils.checkpoint``'s (forward, recomputation) contexts."""
    return contextlib.nullcontext(), no_stat_updates()


class CenterMask(nn.Module):
    def __init__(
        self,
        backbone_type: str = "vovnet",
        conv_body: str = "V-39-eSE",
        resnet_depth: int = 50,
        resnet_norm: str = "FrozenBN",
        resnet_num_groups: int = 1,
        resnet_width_per_group: int = 64,
        resnet_stride_in_1x1: bool = True,
        resnet_res5_dilation: int = 1,
        resnet_res2_out_channels: int = 256,
        resnet_stem_out_channels: int = 64,
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
        pre_nms_thresh_train: float = 0.05,
        pre_nms_topk_train: int = 1000,
        post_nms_topk_train: int = 100,
        nms_thresh: float = 0.6,
        nms_candidates: int = 1000,
        sizes_of_interest: Sequence[int] = (64, 128, 256, 512),
        center_sample: bool = True,
        pos_radius: float = 1.5,
        loc_loss_type: str = "giou",
        focal_alpha: float = 0.25,
        focal_gamma: float = 2.0,
        mask_on: bool = True,
        maskiou_on: bool = True,
        maskiou_loss_weight: float = 1.0,
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
        keypoint_on: bool = False,
        num_keypoints: int = 17,
        keypoint_conv_dims: Sequence[int] = (512,) * 8,
        keypoint_loss_weight: float = 1.0,
        keypoint_normalize_by_visible: bool = True,
        use_deformable: bool = False,
        stage_with_dcn: Sequence[bool] = (False,) * 4,
        with_modulated_dcn: bool = False,
        deformable_groups: int = 1,
        batch_size_per_image: int = 512,
        positive_fraction: float = 0.25,
        max_fg_proposals: int = 128,
        roi_iou_thresholds: Sequence[float] = (0.5,),
        roi_iou_labels: Sequence[int] = (0, 1),
        proposal_append_gt: bool = True,
        s2d_input: bool = False,
        pixel_mean: Sequence[float] = (103.53, 116.28, 123.675),
        remat_backbone: bool = False,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__()
        if backbone_type not in BACKBONE_TYPES:
            raise ValueError(f"backbone type {backbone_type!r}: one of "
                             f"{BACKBONE_TYPES}")
        if s2d_input and backbone_type != "vovnet":
            raise ValueError("the s2d stem input (TPU.S2D_STEM_INPUT) "
                             f"applies to the VoVNet only, not {backbone_type}")
        self.backbone_type = backbone_type
        self.fpn_in_features = tuple(fpn_in_features)
        self.fcos_in_features = tuple(fcos_in_features)
        self.fpn_strides = tuple(fpn_strides)
        self.roi_in_features = tuple(roi_in_features)
        self.mask_on = mask_on
        self.maskiou_on = maskiou_on
        self.keypoint_on = keypoint_on
        self.num_keypoints = num_keypoints
        self.keypoint_loss_weight = keypoint_loss_weight
        self.keypoint_normalize_by_visible = keypoint_normalize_by_visible
        self.pooler_resolution = pooler_resolution
        self.num_classes = num_classes
        self.decode_kwargs = dict(
            pre_nms_thresh=pre_nms_thresh_test,
            pre_nms_topk=pre_nms_topk_test, nms_thresh=nms_thresh,
            post_nms_topk=post_nms_topk_test, nms_candidates=nms_candidates,
            thresh_with_ctr=thresh_with_ctr)
        self.train_decode_kwargs = dict(
            self.decode_kwargs, pre_nms_thresh=pre_nms_thresh_train,
            pre_nms_topk=pre_nms_topk_train,
            post_nms_topk=post_nms_topk_train)
        self.sizes_of_interest = tuple(sizes_of_interest)
        self.center_sample = center_sample
        self.pos_radius = pos_radius
        self.loc_loss_type = loc_loss_type
        self.focal_alpha = focal_alpha
        self.focal_gamma = focal_gamma
        self.maskiou_loss_weight = maskiou_loss_weight
        self.batch_size_per_image = batch_size_per_image
        self.positive_fraction = positive_fraction
        self.max_fg_proposals = max_fg_proposals
        self.roi_iou_thresholds = tuple(roi_iou_thresholds)
        self.roi_iou_labels = tuple(roi_iou_labels)
        self.proposal_append_gt = proposal_append_gt
        self.dtype = dtype
        self.s2d_input = s2d_input
        self.remat_backbone = remat_backbone
        # BGR mean of the on-device normalization of uint8 inputs
        # (MODEL.PIXEL_MEAN); not a parameter, so not in the state_dict
        self.register_buffer("pixel_mean",
                             torch.tensor(pixel_mean, dtype=torch.float32),
                             persistent=False)

        if backbone_type == "mobilenet":
            # computes in f32 whatever ``dtype`` (backbones/mobilenet.py)
            self.backbone = MobileNetV2(out_features=self.fpn_in_features)
            chans, strides = MOBILENET_FEATURE_CHANNELS, RESNET_FEATURE_STRIDES
        elif backbone_type == "resnet":
            # reference build_fcos_resnet_fpn_backbone (fpn.py:56-87)
            self.backbone = ResNet(
                resnet_depth, out_features=self.fpn_in_features,
                norm=resnet_norm, stem_out_channels=resnet_stem_out_channels,
                res2_out_channels=resnet_res2_out_channels,
                num_groups=resnet_num_groups,
                width_per_group=resnet_width_per_group,
                stride_in_1x1=resnet_stride_in_1x1,
                res5_dilation=resnet_res5_dilation, dtype=dtype)
            chans = resnet_feature_channels(resnet_res2_out_channels)
            strides = RESNET_FEATURE_STRIDES
        else:
            self.backbone = VoVNet(
                conv_body, out_features=self.fpn_in_features,
                norm=backbone_norm, s2d_input=s2d_input,
                stage_with_dcn=stage_with_dcn,
                with_modulated_dcn=with_modulated_dcn,
                deformable_groups=deformable_groups, dtype=dtype)
            chans, strides = feature_channels(conv_body), FEATURE_STRIDES
        self.fpn = FPN([chans[f] for f in self.fpn_in_features],
                       [strides[f] for f in self.fpn_in_features],
                       fpn_out_channels, fpn_norm, fpn_fuse_type,
                       top_block=TOP_LEVEL_BLOCKS[top_levels], dtype=dtype)
        self.fcos_head = FCOSHead(
            num_classes, fpn_out_channels, num_cls_convs, num_box_convs,
            num_share_convs, fcos_norm, len(self.fcos_in_features),
            use_scale, prior_prob, use_deformable, dtype=dtype)
        self.roi_heads = CenterROIHeads(
            fpn_out_channels, num_classes, roi_in_strides, mask_on,
            maskiou_on, assign_criterion, pooler_resolution,
            pooler_sampling_ratio, mask_conv_dim, mask_num_conv, mask_norm,
            cls_agnostic_mask, maskiou_conv_dim, maskiou_num_conv,
            keypoint_on, num_keypoints, keypoint_conv_dims, dtype=dtype)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images: (B, H, W, 3) normalized and padded (BGR - mean), or its
        s2d layout (B, H/4+1, W/4+1, 48) with ``s2d_input``."""
        H, W = self.canvas_hw(images)
        if H % 32 or W % 32:
            raise ValueError(
                f"canvas {H}x{W} must be divisible by 32 (detectron2 "
                "size_divisibility): the FPN top-down 2x upsample "
                "misaligns against ceil-divided lateral shapes otherwise "
                "(check TPU.FIXED_EDGE_SIZE or the tight-compute serving "
                "canvas)")
        x = images.permute(0, 3, 1, 2).to(self.dtype).contiguous()
        if self.remat_backbone and torch.is_grad_enabled():
            # JAX nn.remat: the backward recomputes the backbone from its
            # input; the recomputation leaves BN's running statistics alone
            bottom_up = checkpoint(self.backbone, x, use_reentrant=False,
                                   context_fn=_remat_contexts)
        else:
            bottom_up = self.backbone(x)
        tracing.mark("backbone")
        return self.fpn([bottom_up[f] for f in self.fpn_in_features])

    def _fcos_raw(self, feats: Dict[str, torch.Tensor]):
        fcos_feats = [feats[f] for f in self.fcos_in_features]
        logits, reg, ctr = self.fcos_head(fcos_feats)
        shapes = [(f.shape[2], f.shape[3]) for f in fcos_feats]
        locations = compute_locations(shapes, self.fpn_strides,
                                      fcos_feats[0].device)
        tracing.mark("fpn_head")
        return locations, logits, reg, ctr

    def _decode(self, locations, logits, reg, ctr, training: bool = False):
        out = decode_batch(locations, logits, reg, ctr, self.fpn_strides,
                           **(self.train_decode_kwargs if training
                              else self.decode_kwargs))
        tracing.mark("decode")
        return out

    def forward(self, images: torch.Tensor,
                image_sizes: Optional[torch.Tensor] = None,
                valid_hw: Optional[torch.Tensor] = None,
                canvas_hw: Optional[Tuple[int, int]] = None
                ) -> InferenceOutputs:
        return self.inference(images, image_sizes, valid_hw, canvas_hw)

    def _pad_to_canvas(self, images: torch.Tensor,
                       canvas_hw: Optional[Tuple[int, int]]) -> torch.Tensor:
        """Zero-pad a TIGHT s2d pack (``data/preprocess.py::
        s2d_pack_u8_tight``) back to the deployment canvas on the device
        (JAX ``meta.py:275-291``). Exact: a tight-canvas s2d pack equals
        the top-left block of the full-canvas pack, and every full-pack
        cell outside it reads only zero canvas padding. ``canvas_hw``:
        python (H, W) of the deployment canvas."""
        if canvas_hw is None or not self.s2d_input:
            return images
        Ho, Wo = canvas_hw[0] // 4 + 1, canvas_hw[1] // 4 + 1
        dh, dw = Ho - images.shape[1], Wo - images.shape[2]
        if dh == 0 and dw == 0:
            return images
        if dh < 0 or dw < 0:
            raise ValueError(f"s2d pack {tuple(images.shape)} exceeds the "
                             f"canvas {canvas_hw}")
        return F.pad(images, (0, 0, 0, dw, 0, dh))

    def _normalize_u8_s2d(self, images: torch.Tensor,
                          valid_hw: Optional[torch.Tensor]) -> torch.Tensor:
        """On-device normalization of a RAW uint8 s2d input (JAX
        ``meta.py:293-322``): cast to f32, subtract the BGR mean, and zero
        everything outside the true resized image (the reference
        zero-pads the normalized canvas; the u8 padding bytes would read
        as -mean after the subtraction). Equal to the host f32 path: the
        u8 -> f32 cast is exact and the subtraction the same f32 op.
        ``valid_hw``: (B, 2) int true resized (h, w); defaults to the
        full canvas. Other dtypes pass through."""
        if images.dtype != torch.uint8:
            return images
        if not self.s2d_input:
            raise ValueError("uint8 input requires the s2d layout "
                             "(TPU.S2D_STEM_INPUT)")
        B, Ho, Wo, C16 = images.shape
        C = C16 // 16
        dev = images.device
        # channel rho*4C + kap*C + c holds pixel (4i + rho - 2, 4j + kap - 2)
        phase = torch.arange(4, device=dev)[None, :] - 2
        rows = 4 * torch.arange(Ho, device=dev)[:, None] + phase  # (Ho, 4)
        cols = 4 * torch.arange(Wo, device=dev)[:, None] + phase
        if valid_hw is None:
            H, W = self.canvas_hw(images)
            rvalid = ((rows >= 0) & (rows < H))[None].expand(B, -1, -1)
            cvalid = ((cols >= 0) & (cols < W))[None].expand(B, -1, -1)
        else:
            vh = valid_hw.to(dev)
            rvalid = (rows[None] >= 0) & (rows[None] < vh[:, :1, None])
            cvalid = (cols[None] >= 0) & (cols[None] < vh[:, 1:, None])
        x = images.float().reshape(B, Ho, Wo, 4, 4, C)
        mask = (rvalid[:, :, None, :, None, None]
                & cvalid[:, None, :, None, :, None])
        x = torch.where(mask, x - self.pixel_mean, 0.0)
        return x.reshape(B, Ho, Wo, C16)

    def canvas_hw(self, images: torch.Tensor) -> Tuple[int, int]:
        """Padded-canvas (H, W) of an input batch, undoing the s2d layout
        ((H/4+1, W/4+1) grid) when ``s2d_input`` is set."""
        H, W = images.shape[1], images.shape[2]
        if self.s2d_input:
            H, W = (H - 1) * 4, (W - 1) * 4
        return H, W

    @torch.no_grad()
    def inference(self, images: torch.Tensor,
                  image_sizes: Optional[torch.Tensor] = None,
                  valid_hw: Optional[torch.Tensor] = None,
                  canvas_hw: Optional[Tuple[int, int]] = None
                  ) -> InferenceOutputs:
        """Full inference to the output contract (JAX ``meta.py:332-398``).

        ``image_sizes``: (B, 2) true (h, w) per image, which sets the
        image area of ROI level assignment; defaults to the padded canvas
        (the reference's FakeImageList deployment contract): after the
        pad-back, or the tight canvas itself in tight compute.
        ``valid_hw``: (B, 2) true resized sizes, used only to normalize a
        uint8 s2d input on the device. ``canvas_hw``: the deployment
        canvas (H, W) a TIGHT s2d pack is zero-padded back to; without it
        the program runs at the pack's own canvas. A uint8 input takes
        the on-device normalization, chosen by its dtype. A captured call
        records the section stamps (``utils/tracing.py``)."""
        tracing.mark("start")
        images = self._pad_to_canvas(images, canvas_hw)
        B = images.shape[0]
        H, W = self.canvas_hw(images)
        images = self._normalize_u8_s2d(images, valid_hw)
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

        roi_features = [feats[f] for f in self.roi_in_features]
        if self.mask_on:
            roi_out = self.roi_heads(
                roi_features, flat_boxes, flat_classes, flat_valid,
                batch_idx, img_areas, flat_scores)
            masks = roi_out["pred_masks"]
            m = masks.shape[-1]
            pred_masks = masks.reshape(B, K, 1, m, m)
            mask_scores = roi_out["mask_scores"].reshape(B, K)
        else:
            m = 2 * self.pooler_resolution
            pred_masks = torch.zeros((B, K, 1, m, m), dtype=torch.float32,
                                     device=images.device)
            mask_scores = proposals.scores

        pred_keypoints = None
        if self.keypoint_on:  # JAX meta.py:378-386
            kp_logits = self.roi_heads.keypoint_forward(
                roi_features, flat_boxes, batch_idx, img_areas)
            pred_keypoints = keypoint_rcnn_inference(
                kp_logits, flat_boxes).reshape(B, K, -1, 3)

        boxes_out = torch.where(proposals.valid[..., None],
                                proposals.pred_boxes,
                                torch.zeros_like(proposals.pred_boxes))
        out = InferenceOutputs(
            locations=proposals.locations,
            mask_scores=mask_scores,
            pred_boxes=boxes_out,
            pred_classes=proposals.pred_classes,
            pred_masks=pred_masks,
            scores=proposals.scores,
            valid=proposals.valid,
            pred_keypoints=pred_keypoints,
        )
        tracing.mark("roi")
        return out

    @torch.no_grad()
    def inference_batched(self, images: torch.Tensor,
                          image_sizes: Optional[torch.Tensor] = None,
                          valid_hw: Optional[torch.Tensor] = None
                          ) -> InferenceOutputs:
        """Batched serving as one B = 1 program per image, in order (JAX
        ``meta.py:400-434`` maps the single-image program over the batch
        with ``lax.map``), outputs stacked. Defaults as ``inference``."""
        def part(t, i):
            return None if t is None else t[i:i + 1]

        outs = [self.inference(images[i:i + 1], part(image_sizes, i),
                               part(valid_hw, i))
                for i in range(images.shape[0])]
        return InferenceOutputs(*(None if f[0] is None else torch.cat(f)
                                  for f in zip(*outs)))


    # ------------------------------------------------------------------
    @property
    def roi_training(self) -> bool:
        """Whether ``loss`` trains an ROI branch (mask or keypoint), which
        samples proposals (JAX ``meta.py:476``)."""
        return self.mask_on or self.keypoint_on

    def draws_shape(self, gt: GroundTruth) -> Tuple[int, int]:
        """(B, K + G) of the proposal sampler's uniforms: K post-NMS train
        proposals (the decode pads to K) and the G gt slots appended with
        PROPOSAL_APPEND_GT; ``loss`` draws this shape when not given it."""
        B, G = gt.valid.shape
        K = self.train_decode_kwargs["post_nms_topk"]
        return B, K + (G if self.proposal_append_gt else 0)

    def loss(self, images: torch.Tensor, gt: GroundTruth,
             draws: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             group: Group = None) -> Dict[str, torch.Tensor]:
        """Training losses (FCOS + mask + MaskIoU, and keypoints with
        ``keypoint_on`` and ``gt.keypoints``), f32 scalars on the device,
        with no host sync (JAX ``meta.py:437-629``).

        ``images``: the f32 normalized canvas (B, H, W, 3), or its s2d
        layout with ``s2d_input``. ``draws``: the proposal sampler's
        uniform numbers, (B, K + G) with K = the post-NMS train proposals
        and G = the gt capacity when PROPOSAL_APPEND_GT is on (else
        (B, K)); drawn from ``generator`` (on the images' device) when
        not given. ``group``: the data-parallel process group (JAX
        ``axis_name``), over which the FCOS normalizers and SyncBN's
        moments are averaged; it stays SyncBN's group for the backward
        (a recomputed backbone reduces again). BN and SyncBN train as
        the model's mode says: the train step puts it in train mode."""
        for m in self.modules():
            if isinstance(m, BatchNorm) and m.sync:
                m.group = group
        B = images.shape[0]
        H, W = self.canvas_hw(images)
        dev = images.device
        feats = self.features(images)
        locations, logits, reg, ctr = self._fcos_raw(feats)

        # ---- FCOS losses: level-first flattening like the reference
        strides_per_loc, ranges = level_metadata(
            [loc.shape[0] for loc in locations], self.fpn_strides,
            self.sizes_of_interest, dev)
        labels, reg_targets = assign_targets_single_image(
            torch.cat(locations), strides_per_loc, ranges, gt.boxes,
            gt.classes, gt.valid, self.num_classes, self.center_sample,
            self.pos_radius)
        # normalize reg targets by per-location stride (fcos_outputs.py:229)
        reg_targets = reg_targets / strides_per_loc[None, :, None]

        def flat(xs, n):  # per-level (B, n, H, W) -> (B * L, n)
            return torch.cat([x.permute(0, 2, 3, 1).reshape(B, -1, n)
                              for x in xs], dim=1).reshape(-1, n)

        losses = fcos_losses(
            labels.reshape(-1), reg_targets.reshape(-1, 4),
            flat(logits, self.num_classes), flat(reg, 4), flat(ctr, 1)[:, 0],
            self.num_classes, self.focal_alpha, self.focal_gamma,
            self.loc_loss_type, reduce=mean_reduce(group))
        if not self.roi_training:
            return losses

        # ---- proposals for ROI training, detached (the reference labels
        # and samples them under no_grad, center_heads.py:178)
        with torch.no_grad():
            proposals = self._decode(locations, logits, reg, ctr,
                                     training=True)
        if draws is None:
            draws = torch.rand(self.draws_shape(gt), generator=generator,
                               device=dev)
        sampled = label_and_sample_proposals(
            draws, proposals.pred_boxes, proposals.valid, gt.boxes,
            gt.classes, gt.valid, self.num_classes,
            self.batch_size_per_image, self.positive_fraction,
            self.roi_iou_thresholds, self.roi_iou_labels,
            self.proposal_append_gt)

        # ---- foreground pick, at most max_fg_proposals an image: 0/1
        # keys, ties taken lowest index first (masked_topk)
        Fg = self.max_fg_proposals
        fg_mask = sampled.valid & (sampled.gt_classes != self.num_classes)
        fg_idx, fg_valid, _ = masked_topk(fg_mask.float(), fg_mask, Fg)
        R = B * Fg
        flat_fg_boxes = torch.gather(
            sampled.boxes, 1, fg_idx[..., None].expand(-1, -1, 4)).reshape(R, 4)
        flat_fg_valid = fg_valid.reshape(R)
        flat_fg_classes = torch.clamp(
            torch.gather(sampled.gt_classes, 1, fg_idx).reshape(R), 0,
            self.num_classes - 1)
        fg_gt_idx = torch.gather(sampled.gt_indices, 1, fg_idx)
        batch_idx = torch.arange(B, dtype=torch.int32,
                                 device=dev).repeat_interleave(Fg)
        # ratio-criterion level assignment on the true image areas
        if gt.image_sizes is not None:
            img_areas = (gt.image_sizes[:, 0] * gt.image_sizes[:, 1]) \
                .float().repeat_interleave(Fg)
        else:
            img_areas = torch.full((R,), float(H * W), device=dev)

        roi_features = [feats[f] for f in self.roi_in_features]
        if self.mask_on:
            self._mask_losses(losses, gt, roi_features, flat_fg_boxes,
                              flat_fg_valid, flat_fg_classes, fg_gt_idx,
                              batch_idx, img_areas)
        if self.keypoint_on and gt.keypoints is not None:
            # JAX meta.py:603-629: the foreground's gt keypoints by
            # fg_gt_idx, normalized by the visible keypoints or by
            # B * K * BATCH_SIZE_PER_IMAGE * POSITIVE_FRACTION
            K = gt.keypoints.shape[2]
            G = gt.keypoints.shape[1]
            kp_of_fg = torch.gather(
                gt.keypoints.float(), 1,
                torch.clamp(fg_gt_idx, 0, G - 1).long()[..., None, None]
                .expand(-1, -1, K, 3)).reshape(R, K, 3)
            kp_logits = self.roi_heads.keypoint_forward(
                roi_features, flat_fg_boxes, batch_idx, img_areas)
            heat_idx, kp_valid = keypoints_to_heatmap(
                kp_of_fg, flat_fg_boxes, kp_logits.shape[-1])
            kp_valid = kp_valid & flat_fg_valid[:, None]
            normalizer = None
            if not self.keypoint_normalize_by_visible:
                normalizer = float(B * self.num_keypoints
                                   * self.batch_size_per_image
                                   * self.positive_fraction)
            losses["loss_keypoint"] = self.keypoint_loss_weight * \
                keypoint_rcnn_loss(kp_logits, heat_idx, kp_valid, normalizer)
        return losses

    def _mask_losses(self, losses: Dict[str, torch.Tensor], gt: GroundTruth,
                     roi_features, flat_fg_boxes: torch.Tensor,
                     flat_fg_valid: torch.Tensor,
                     flat_fg_classes: torch.Tensor, fg_gt_idx: torch.Tensor,
                     batch_idx: torch.Tensor,
                     img_areas: torch.Tensor) -> None:
        """The mask and MaskIoU losses on the foreground proposals, into
        ``losses`` (JAX ``meta.py:528-601``)."""
        B = fg_gt_idx.shape[0]
        R = flat_fg_boxes.shape[0]
        dev = flat_fg_boxes.device
        pooled, mask_logits = self.roi_heads.mask_forward_train(
            roi_features, flat_fg_boxes, batch_idx, img_areas)

        # ---- mask targets from the rasterized gt patches
        G = gt.mask_patches.shape[1]
        gt_boxes_of_fg = torch.gather(
            gt.boxes, 1, fg_gt_idx[..., None].expand(-1, -1, 4)).reshape(R, 4)
        patches_of_fg = gt.mask_patches.flatten(0, 1)[
            (torch.clamp(fg_gt_idx, 0, G - 1)
             + torch.arange(B, device=dev)[:, None] * G).reshape(R)].float()
        m_side = 2 * self.pooler_resolution
        gt_mask = crop_and_resize_patches(
            patches_of_fg, gt_boxes_of_fg, flat_fg_boxes, m_side) >= 0.5

        # per-class logit selection as a one-hot contraction (JAX
        # meta.py:564-567); logits (R, classes, 28, 28)
        n_out = mask_logits.shape[1]
        one_hot = (flat_fg_classes[:, None]
                   == torch.arange(n_out, device=dev)).float()
        sel_logits = torch.einsum("rchw,rc->rhw", mask_logits.float(),
                                  one_hot)
        vmaskf = flat_fg_valid.float()[:, None, None]
        n_el = torch.clamp_min(vmaskf.sum() * (m_side * m_side), 1.0)
        losses["loss_mask"] = (optax_sigmoid_bce(sel_logits, gt_mask.float())
                               * vmaskf).sum() / n_el

        if self.maskiou_on:
            # maskiou targets (mask_head.py:150-165): the ratio-corrected
            # IoU of the binarized prediction and the full gt mask
            with torch.no_grad():
                pred_bin = sel_logits > 0.0
                inter = (pred_bin & gt_mask).float().sum(dim=(1, 2))
                full_area = patches_of_fg.sum(dim=(1, 2))
                inside = _patch_fraction_inside(
                    patches_of_fg, gt_boxes_of_fg, flat_fg_boxes)
                ratio = torch.clamp(inside / torch.clamp_min(full_area, 1e-6),
                                    0.0, 1.0)
                ratio = torch.clamp_min(ratio, 1e-10)
                full_area_28 = gt_mask.float().sum(dim=(1, 2)) / ratio
                union = pred_bin.float().sum(dim=(1, 2)) + full_area_28 - inter
                maskiou_targets = inter / torch.clamp_min(union, 1.0)
            pred_maskiou = self.roi_heads.maskiou_forward(
                pooled, torch.sigmoid(sel_logits)[:, None])
            losses["loss_maskiou"] = mask_iou_loss(
                flat_fg_classes, pred_maskiou.float(), maskiou_targets,
                flat_fg_valid, self.maskiou_loss_weight)


def _resample_matrix(coords: torch.Tensor, size: int, s: int) -> torch.Tensor:
    """(R, out*s) 1-D ROIAlign sample coords -> (R, out, size) weight
    matrix folding the bilinear taps and the s-subsample mean, with
    ``ops/roi_align.py``'s border semantics (zero outside [-1, size],
    taps clamped to [0, size-1])."""
    in_r = (coords >= -1.0) & (coords <= size)
    c = torch.clamp(coords, 0.0, size - 1.0)
    low = torch.clamp_max(torch.floor(c), size - 1.0)
    frac = c - low
    high = torch.clamp_max(low + 1.0, size - 1.0)
    j = torch.arange(size, dtype=torch.float32, device=coords.device)
    w = (1.0 - frac)[..., None] * (j == low[..., None]) \
        + frac[..., None] * (j == high[..., None])
    w = w * in_r[..., None]
    R, n = coords.shape
    return w.reshape(R, n // s, s, size).mean(dim=2)


def crop_and_resize_patches(patches: torch.Tensor, gt_boxes: torch.Tensor,
                            proposal_boxes: torch.Tensor,
                            out_size: int) -> torch.Tensor:
    """Sample each gt patch (R, P, P), rasterized over its gt box
    (R, 4), at its proposal box (R, 4) -> (R, out, out) floats (JAX
    ``meta.py:650-689``; detectron2's crop_and_resize as separable
    bilinear resampling: out = Ay @ patch @ Ax^T per ROI)."""
    P = patches.shape[-1]
    gx0, gy0, gx1, gy1 = gt_boxes.unbind(1)
    sx = P / torch.clamp_min(gx1 - gx0, 1e-6)
    sy = P / torch.clamp_min(gy1 - gy0, 1e-6)
    # proposal box in patch coords, then aligned sample coords per axis
    bx0 = (proposal_boxes[:, 0] - gx0) * sx - 0.5
    by0 = (proposal_boxes[:, 1] - gy0) * sy - 0.5
    bx1 = (proposal_boxes[:, 2] - gx0) * sx - 0.5
    by1 = (proposal_boxes[:, 3] - gy0) * sy - 0.5
    s = 2
    grid = (torch.arange(out_size * s, dtype=torch.float32,
                         device=patches.device) + 0.5) * (1.0 / s)
    step = 1.0 / out_size
    ys = by0[:, None] + grid[None, :] * ((by1 - by0) * step)[:, None]
    xs = bx0[:, None] + grid[None, :] * ((bx1 - bx0) * step)[:, None]
    ay = _resample_matrix(ys, P, s)  # (R, out, P)
    ax = _resample_matrix(xs, P, s)
    t = torch.einsum("rij,rjk->rik", ay, patches.float())
    return torch.einsum("rik,rlk->ril", t, ax)


def _patch_fraction_inside(patches: torch.Tensor, gt_boxes: torch.Tensor,
                           proposal_boxes: torch.Tensor) -> torch.Tensor:
    """Sum of patch mass whose cell centers fall inside the proposal box
    (JAX ``meta.py:692-703``)."""
    P = patches.shape[1]
    gx0, gy0, gx1, gy1 = gt_boxes.unbind(1)
    cells = (torch.arange(P, dtype=torch.float32, device=patches.device)
             + 0.5) / P
    cell_y = gy0[:, None] + cells[None, :] * (gy1 - gy0)[:, None]  # (R, P)
    cell_x = gx0[:, None] + cells[None, :] * (gx1 - gx0)[:, None]
    in_y = (cell_y >= proposal_boxes[:, 1:2]) & \
        (cell_y <= proposal_boxes[:, 3:4])
    in_x = (cell_x >= proposal_boxes[:, 0:1]) & \
        (cell_x <= proposal_boxes[:, 2:3])
    inside = in_y[:, :, None] & in_x[:, None, :]
    return (patches * inside).sum(dim=(1, 2))


def backbone_type(cfg: CfgNode) -> str:
    """"mobilenet", "resnet" or "vovnet", from MODEL.BACKBONE.NAME and
    MODEL.MOBILENET as the JAX ``build_centermask`` resolves them
    (``meta.py:706-717``)."""
    name = cfg.MODEL.BACKBONE.NAME
    if "mobilenet" in name or cfg.MODEL.MOBILENET:
        return "mobilenet"
    return "resnet" if "resnet" in name else "vovnet"


def build_centermask(cfg: CfgNode, device: DeviceLike = None,
                     seed: int = 0) -> CenterMask:
    """Construct the model from a config on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; raises with no GPU and no explicit request),
    in eval mode, with parameters drawn from ``seed`` by the JAX
    package's initializers. Load real weights afterwards with
    ``checkpoint.from_jax.load_jax_params``. Training takes the same
    model; only BN and SyncBN behave differently in train mode. Its
    seconds add to the ``tracing`` counter ``model_build_s``."""
    t0 = time.perf_counter()
    dev = resolve_device(device)
    kind = backbone_type(cfg)
    if cfg.TPU.APPROX_TOPK:
        raise NotImplementedError(
            "TPU.APPROX_TOPK selects the TPU's approximate top-k, which has "
            "no CUDA counterpart; the port decodes with the exact top-k")
    fpn_in = tuple(cfg.MODEL.FPN.IN_FEATURES) or {
        "vovnet": ("stage3", "stage4", "stage5"),
        "resnet": tuple(cfg.MODEL.RESNETS.OUT_FEATURES)}.get(kind, ())
    model = CenterMask(
        backbone_type=kind,
        conv_body=cfg.MODEL.VOVNET.CONV_BODY,
        resnet_depth=cfg.MODEL.RESNETS.DEPTH,
        resnet_norm=cfg.MODEL.RESNETS.NORM,
        resnet_num_groups=cfg.MODEL.RESNETS.NUM_GROUPS,
        resnet_width_per_group=cfg.MODEL.RESNETS.WIDTH_PER_GROUP,
        resnet_stride_in_1x1=cfg.MODEL.RESNETS.STRIDE_IN_1X1,
        resnet_res5_dilation=cfg.MODEL.RESNETS.RES5_DILATION,
        resnet_res2_out_channels=cfg.MODEL.RESNETS.RES2_OUT_CHANNELS,
        resnet_stem_out_channels=cfg.MODEL.RESNETS.STEM_OUT_CHANNELS,
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
        pre_nms_thresh_train=cfg.MODEL.FCOS.INFERENCE_TH_TRAIN,
        pre_nms_topk_train=cfg.MODEL.FCOS.PRE_NMS_TOPK_TRAIN,
        post_nms_topk_train=cfg.MODEL.FCOS.POST_NMS_TOPK_TRAIN,
        nms_thresh=cfg.MODEL.FCOS.NMS_TH,
        nms_candidates=cfg.TPU.NMS_CANDIDATES,
        sizes_of_interest=tuple(cfg.MODEL.FCOS.SIZES_OF_INTEREST),
        center_sample=cfg.MODEL.FCOS.CENTER_SAMPLE,
        pos_radius=cfg.MODEL.FCOS.POS_RADIUS,
        loc_loss_type=cfg.MODEL.FCOS.LOC_LOSS_TYPE,
        focal_alpha=cfg.MODEL.FCOS.LOSS_ALPHA,
        focal_gamma=cfg.MODEL.FCOS.LOSS_GAMMA,
        mask_on=cfg.MODEL.MASK_ON,
        maskiou_on=cfg.MODEL.MASKIOU_ON,
        maskiou_loss_weight=cfg.MODEL.MASKIOU_LOSS_WEIGHT,
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
        keypoint_on=cfg.MODEL.KEYPOINT_ON,
        num_keypoints=cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS,
        keypoint_conv_dims=tuple(cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS),
        keypoint_loss_weight=cfg.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT,
        keypoint_normalize_by_visible=(
            cfg.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS),
        use_deformable=cfg.MODEL.FCOS.USE_DEFORMABLE,
        stage_with_dcn=tuple(cfg.MODEL.VOVNET.STAGE_WITH_DCN),
        with_modulated_dcn=cfg.MODEL.VOVNET.WITH_MODULATED_DCN,
        deformable_groups=cfg.MODEL.VOVNET.DEFORMABLE_GROUPS,
        batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        max_fg_proposals=cfg.TPU.MAX_FG_PROPOSALS,
        roi_iou_thresholds=tuple(cfg.MODEL.ROI_HEADS.IOU_THRESHOLDS),
        roi_iou_labels=tuple(cfg.MODEL.ROI_HEADS.IOU_LABELS),
        proposal_append_gt=cfg.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT,
        # the s2d stem is VoVNet's (JAX meta.py:799)
        s2d_input=cfg.TPU.S2D_STEM_INPUT and kind == "vovnet",
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        remat_backbone=cfg.TPU.REMAT_BACKBONE,
        dtype=_DTYPES[cfg.TPU.COMPUTE_DTYPE],
    )
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).eval()
    tracing.count("model_build_s", time.perf_counter() - t0)
    return model
