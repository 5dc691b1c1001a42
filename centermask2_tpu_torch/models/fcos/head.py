"""FCOS head (the port of ``centermask2_tpu/models/fcos/head.py``):
shared cls/bbox towers of conv3x3 -> GN -> relu (no norm unless the norm
is "GN", as in the JAX head), 3x3 predictors for
class logits (prior-prob bias), box regression (per-level Scale, then
relu, reference fcos.py:237-238) and centerness. Tower weights are
shared across FPN levels. With ``use_deformable``
(MODEL.FCOS.USE_DEFORMABLE) the share and bbox towers' convs are
deformable (``DeformConvBlock`` with a bias, no norm or relu of its own,
then the tower's GN and relu); the cls tower stays regular, as in JAX.

Each tower is called once over the list of levels and runs layer by
layer, each layer over every level. Maps are (N, C, H, W). On CUDA with
autograd off (inference and its captures,
``ops/group_norm.py::fused_path``) the head moves each level to
channels-last memory once (the captured serving program's FPN levels
come channels-last already): the regular towers' convs then read and
write NHWC with no cuDNN transposes, each layer's GN and ReLU is one call of
``cm2::group_norm_relu`` (kernel 3) over the levels, and the predictors'
outputs come out channels-last, whose NHWC flattening in the decode is a
view. A deformable conv writes NCHW: its output moves to channels-last
before the kernel. Training and the CPU keep NCHW maps and the chain of
``GroupNorm`` and ReLU.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, DeformConvBlock, GroupNorm, Scale
from ...ops import group_norm as gn_ops


class Tower(nn.Module):
    """num_convs x [conv3x3(bias) -> GN -> relu]; GroupNorm only when
    ``norm`` is "GN", any other value meaning none (JAX ``head.py:47``);
    deformable convs with ``use_deformable`` (JAX ``head.py:30-47``)."""

    def __init__(self, num_convs: int, channels: int, norm: str = "GN",
                 use_deformable: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", DeformConvBlock(
                channels, channels, norm="", use_act=False, use_bias=True,
                dtype=dtype) if use_deformable else
                Conv2d(channels, channels, init=0.01, dtype=dtype))
            if norm == "GN":
                self.add_module(f"norm{i}", GroupNorm(channels, 32))

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """xs: every level's map; each layer runs over all of them before
        the next."""
        fused = gn_ops.fused_path(xs[0])
        for i in range(self.num_convs):
            conv = getattr(self, f"conv{i}")
            xs = [conv(x) for x in xs]
            if fused:  # channels-last already, but for a deformable conv's
                xs = [x.contiguous(memory_format=torch.channels_last)
                      for x in xs]
            norm = getattr(self, f"norm{i}", None)
            if norm is None:
                xs = [F.relu(x) for x in xs]
            elif fused:
                gn = norm.gn
                xs = gn_ops.group_norm_relu_op(xs, gn.weight, gn.bias,
                                               gn.num_groups, gn.eps)
            else:
                xs = [F.relu(norm(x)) for x in xs]
        return xs


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 num_cls_convs: int = 4, num_box_convs: int = 4,
                 num_share_convs: int = 0, norm: str = "GN",
                 num_levels: int = 5, use_scale: bool = True,
                 prior_prob: float = 0.01, use_deformable: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.share_tower = Tower(num_share_convs, in_channels, norm,
                                 use_deformable, dtype)
        self.cls_tower = Tower(num_cls_convs, in_channels, norm, dtype=dtype)
        self.bbox_tower = Tower(num_box_convs, in_channels, norm,
                                use_deformable, dtype)
        bias_value = -math.log((1 - prior_prob) / prior_prob)
        self.cls_logits = Conv2d(in_channels, num_classes, init=0.01,
                                 bias_value=bias_value, dtype=dtype)
        self.bbox_pred = Conv2d(in_channels, 4, init=0.01, dtype=dtype)
        self.ctrness = Conv2d(in_channels, 1, init=0.01, dtype=dtype)
        self.use_scale = use_scale
        if use_scale:
            for lvl in range(num_levels):
                self.add_module(f"scale{lvl}", Scale())

    def forward(self, features: List[torch.Tensor]
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                           List[torch.Tensor]]:
        """features: per-level (N, C, Hl, Wl). Returns per-level lists
        (logits, bbox_reg, ctrness), (N, C, Hl, Wl) with C = num_classes /
        4 / 1, channels-last on CUDA with autograd off."""
        if gn_ops.fused_path(features[0]):
            features = [x.contiguous(memory_format=torch.channels_last)
                        for x in features]
        f = self.share_tower(list(features))
        cls_f = self.cls_tower(f)
        box_f = self.bbox_tower(f)
        logits = [self.cls_logits(x) for x in cls_f]
        ctr = [self.ctrness(x) for x in box_f]
        bbox_reg = []
        for lvl, x in enumerate(box_f):
            reg = self.bbox_pred(x)
            if self.use_scale:
                reg = getattr(self, f"scale{lvl}")(reg)
            bbox_reg.append(F.relu(reg))
        return logits, bbox_reg, ctr
