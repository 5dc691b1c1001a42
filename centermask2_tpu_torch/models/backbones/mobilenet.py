"""MobileNetV2 backbone, NCHW (the port of
``centermask2_tpu/models/backbones/mobilenet.py``): a conv-bn stem, 17
inverted-residual blocks with relu6 and FrozenBN, feature taps after
blocks 3/6/13/17 as res2..res5 (strides 4/8/16/32, channels
24/32/96/320).

The body computes in float32 whatever the model's dtype. The JAX module
builds its convs with no ``dtype``, so flax promotes the bf16 image and
the f32 parameters to f32, and res2..res5 leave it in f32 (the FPN's
convs cast them back to the model's dtype). The port casts the image to
f32 at the entry and keeps every conv in f32, as that promotion does.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ...layers import Conv2d, FrozenBatchNorm
from ...utils import tracing

# (expand_ratio t, out_channels c, repeats n, stride s), JAX mobilenet.py:20-28
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
RETURN_FEATURES_INDICES = (3, 6, 13, 17)
MOBILENET_FEATURE_CHANNELS = {"res2": 24, "res3": 32, "res4": 96,
                              "res5": 320}


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _conv(in_channels: int, features: int, k: int, s: int,
          groups: int = 1) -> Conv2d:
    """flax ``nn.Conv`` with its defaults (lecun init) and no bias, in f32."""
    p = (k - 1) // 2
    return Conv2d(in_channels, features, (k, k), (s, s), (p, p), groups,
                  use_bias=False, init="lecun", dtype=torch.float32)


class InvertedResidual(nn.Module):
    """Optional 1x1 expand, 3x3 depthwise (``groups = hidden``), 1x1
    project, FrozenBN after each, relu6 after the first two; a residual
    when the stride is 1 and the channels match. Modules ``conv{i}`` and
    ``bn{i}``, numbered from 0 over the convs present."""

    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        specs = [] if expand_ratio == 1 else [(inp, hidden, 1, 1, 1)]
        specs += [(hidden, hidden, 3, stride, hidden), (hidden, oup, 1, 1, 1)]
        self.n = len(specs)
        for i, (ci, co, k, s, g) in enumerate(specs):
            self.add_module(f"conv{i}", _conv(ci, co, k, s, g))
            self.add_module(f"bn{i}", FrozenBatchNorm(co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n):
            y = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(y))
            if i < self.n - 1:
                y = relu6(y)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """MobileNetV2 trunk on a 3-channel image (a 32-channel stem and
    ``INVERTED_RESIDUAL_SETTING``); returns a dict of the requested
    ``out_features`` ("res2".."res5"), in float32."""

    def __init__(self, out_features: Sequence[str] = ("res2", "res3", "res4",
                                                      "res5")):
        super().__init__()
        self.out_features = tuple(out_features)
        ch = 32
        self.features0_conv = _conv(3, ch, 3, 2)
        self.features0_bn = FrozenBatchNorm(ch)
        self.n_blocks = 0
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for i in range(n):
                self.n_blocks += 1
                self.add_module(f"features{self.n_blocks}", InvertedResidual(
                    ch, c, s if i == 0 else 1, t))
                ch = c

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = relu6(self.features0_bn(self.features0_conv(x.float())))
        tracing.mark("stem")
        outputs: Dict[str, torch.Tensor] = {}
        for idx in range(1, self.n_blocks + 1):
            x = getattr(self, f"features{idx}")(x)
            if idx in RETURN_FEATURES_INDICES:
                name = f"res{RETURN_FEATURES_INDICES.index(idx) + 2}"
                if name in self.out_features:
                    outputs[name] = x
        return outputs
