"""FCOS head, NCHW (the port of ``centermask2_tpu/models/fcos/head.py``):
shared cls/bbox towers of conv3x3 -> GN -> relu (no norm unless the norm
is "GN", as in the JAX head), 3x3 predictors for
class logits (prior-prob bias), box regression (per-level Scale, then
relu, reference fcos.py:237-238) and centerness. Tower weights are
shared across FPN levels.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, GroupNorm, Scale


class Tower(nn.Module):
    """num_convs x [conv3x3(bias) -> GN -> relu]; GroupNorm only when
    ``norm`` is "GN", any other value meaning none (JAX ``head.py:47``)."""

    def __init__(self, num_convs: int, channels: int, norm: str = "GN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_convs = num_convs
        for i in range(num_convs):
            self.add_module(f"conv{i}", Conv2d(channels, channels, init=0.01,
                                               dtype=dtype))
            if norm == "GN":
                self.add_module(f"norm{i}", GroupNorm(channels, 32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_convs):
            x = getattr(self, f"conv{i}")(x)
            norm = getattr(self, f"norm{i}", None)
            if norm is not None:
                x = norm(x)
            x = F.relu(x)
        return x


class FCOSHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 num_cls_convs: int = 4, num_box_convs: int = 4,
                 num_share_convs: int = 0, norm: str = "GN",
                 num_levels: int = 5, use_scale: bool = True,
                 prior_prob: float = 0.01, use_deformable: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_deformable:
            raise NotImplementedError(
                "deformable FCOS towers are not ported yet (ROADMAP queue "
                "1, 'Deformable conv, keypoints, adaptive ROIAlign')")
        self.share_tower = Tower(num_share_convs, in_channels, norm, dtype)
        self.cls_tower = Tower(num_cls_convs, in_channels, norm, dtype)
        self.bbox_tower = Tower(num_box_convs, in_channels, norm, dtype)
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
        (logits, bbox_reg, ctrness) in NCHW with C = num_classes / 4 / 1."""
        logits, bbox_reg, ctr = [], [], []
        for lvl, feature in enumerate(features):
            f = self.share_tower(feature)
            cls_f = self.cls_tower(f)
            box_f = self.bbox_tower(f)
            logits.append(self.cls_logits(cls_f))
            ctr.append(self.ctrness(box_f))
            reg = self.bbox_pred(box_f)
            if self.use_scale:
                reg = getattr(self, f"scale{lvl}")(reg)
            bbox_reg.append(F.relu(reg))
        return logits, bbox_reg, ctr
