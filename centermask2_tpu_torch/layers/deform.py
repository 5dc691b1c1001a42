"""Deformable conv block (the port of ``centermask2_tpu/layers/deform.py``):
the DFConv3x3 of the VoVNet's DCN stages (reference vovnet.py:132-201)
and the DFConv2d of the deformable FCOS towers (reference
layers/deform_conv.py:19-112).

A regular 3x3 conv, zero-initialized and in f32, predicts the offsets
(and with ``modulated`` the DCN v2 mask), so an untrained block equals a
plain conv; then ``ops/deform_conv.py::deform_conv2d``, the norm and the
relu. The modulated prediction splits as (off_x, off_y, mask), as the
reference's DFConv3x3 chunks it, and the offsets are re-stacked as
(dy, dx) pairs; the mask goes through a sigmoid.

``deformable_groups`` > 1 is refused: the JAX block reshapes the
2 * 9 * G offset channels into (..., 9, 2), which fails for G > 1, so
the reference computes nothing to hold such a port against.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.deform_conv import deform_conv2d
from .blocks import Conv2d, get_norm, init_weight_


class DeformConvBlock(nn.Module):
    """3x3 deformable conv (DCN v1, or v2 with ``modulated``), norm, relu.
    Parameters as the JAX block's: ``conv_offset`` (f32, zeros),
    ``weight`` (the JAX ``kernel``), ``bias`` with ``use_bias``, and
    ``norm``. Undilated: no caller of the JAX block dilates it."""

    def __init__(self, in_channels: int, features: int,
                 modulated: bool = False, deformable_groups: int = 1,
                 norm: str = "FrozenBN", use_act: bool = True,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if deformable_groups != 1:
            raise NotImplementedError(
                f"MODEL.VOVNET.DEFORMABLE_GROUPS={deformable_groups}: the JAX "
                "reference cannot run more than one deformable group (its "
                "offsets reshape fails), so the port refuses it")
        K = 9
        self.modulated = modulated
        self.use_act = use_act
        self.dtype = dtype
        self.conv_offset = Conv2d(in_channels, (3 if modulated else 2) * K,
                                  init="zeros")
        self.weight = nn.Parameter(torch.empty(features, in_channels, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.norm = get_norm(norm, features)
        self.reset_parameters(None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_weight_(self.weight, "kaiming_fan_out", generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raw = self.conv_offset(x.float())
        mask = None
        if self.modulated:
            off_x, off_y, m = torch.chunk(raw, 3, dim=1)
            n, k, h, w = off_x.shape
            offsets = torch.stack([off_y, off_x], dim=2).reshape(
                n, 2 * k, h, w)
            mask = torch.sigmoid(m)
        else:
            offsets = raw
        y = deform_conv2d(x.to(self.dtype), offsets, self.weight, mask,
                          self.bias)
        if self.norm is not None:
            y = self.norm(y)
        if self.use_act:
            y = F.relu(y)
        return y
