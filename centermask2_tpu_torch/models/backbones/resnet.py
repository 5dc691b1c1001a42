"""ResNet bottom-up of ``build_fcos_resnet_fpn_backbone``, NCHW (the port of
``centermask2_tpu/models/backbones/resnet.py``): detectron2's semantics
for the configs the reference can name.

- BasicStem: conv7x7/s2/p3 + norm + relu, then max-pool 3x3/s2/p1 (floor
  mode, -inf padding: ``F.max_pool2d(x, 3, 2, 1)``, not VoVNet's
  ceil-mode pool);
- BottleneckBlock: 1x1 -> 3x3 (``groups``) -> 1x1, the stride in the
  first 1x1 when ``stride_in_1x1`` (detectron2's default), else in the
  3x3; a projection shortcut where the channels or the stride change;
- depths 50 / 101 / 152.

Module names mirror the JAX tree (``stem_conv1``, ``res{s}_{b}`` with
``conv1..3`` and ``shortcut``, each a conv and its ``norm``), so that
``checkpoint/from_jax.py`` maps every leaf one to one and the FREEZE_AT
prefixes of ``train/optimizer.py`` (``stem``, ``res{s}_``) reach them.

``res5_dilation`` other than 1 raises: the JAX module pads conv2 by the
dilation without dilating its kernel, so every stride-1 block of res5
grows its output by two pixels and cannot add its shortcut; no shipped
config sets it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import ConvNormAct
from ...utils import tracing

RESNET_STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                       152: (3, 8, 36, 3)}
RESNET_FEATURE_STRIDES = {"stem": 4, "res2": 4, "res3": 8, "res4": 16,
                          "res5": 32}


def resnet_feature_channels(res2_out: int = 256) -> Dict[str, int]:
    return {f"res{i + 2}": res2_out * (2 ** i) for i in range(4)}


class BottleneckBlock(nn.Module):
    """detectron2 BottleneckBlock: 1x1 -> 3x3 -> 1x1, relu(out + shortcut)."""

    def __init__(self, in_channels: int, out_channels: int,
                 bottleneck_channels: int, stride: int = 1,
                 stride_in_1x1: bool = True, num_groups: int = 1,
                 norm: str = "FrozenBN", dtype: torch.dtype = torch.float32):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNormAct(in_channels, bottleneck_channels, (1, 1),
                                 (s1, s1), (0, 0), norm=norm, dtype=dtype)
        self.conv2 = ConvNormAct(bottleneck_channels, bottleneck_channels,
                                 (3, 3), (s3, s3), (1, 1), groups=num_groups,
                                 norm=norm, dtype=dtype)
        self.conv3 = ConvNormAct(bottleneck_channels, out_channels, (1, 1),
                                 padding=(0, 0), norm=norm, use_act=False,
                                 dtype=dtype)
        self.shortcut = None
        if in_channels != out_channels or stride != 1:
            self.shortcut = ConvNormAct(in_channels, out_channels, (1, 1),
                                        (stride, stride), (0, 0), norm=norm,
                                        use_act=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv3(self.conv2(self.conv1(x)))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + shortcut)


class ResNet(nn.Module):
    """detectron2-semantics ResNet trunk on a 3-channel image; returns a
    dict of the requested ``out_features`` ("stem", "res2".."res5")."""

    def __init__(self, depth: int = 50,
                 out_features: Sequence[str] = ("res3", "res4", "res5"),
                 norm: str = "FrozenBN", stem_out_channels: int = 64, res2_out_channels: int = 256,
                 num_groups: int = 1, width_per_group: int = 64,
                 stride_in_1x1: bool = True, res5_dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if res5_dilation != 1:
            raise NotImplementedError(
                f"RES5_DILATION {res5_dilation}: the JAX ResNet pads res5's "
                "3x3 by the dilation without dilating it, so its blocks "
                "cannot add their shortcuts; the port refuses it")
        if depth not in RESNET_STAGE_BLOCKS:
            raise ValueError(f"ResNet depth {depth}: one of "
                             f"{sorted(RESNET_STAGE_BLOCKS)}")
        self.out_features = tuple(out_features)
        self.stem_conv1 = ConvNormAct(3, stem_out_channels, (7, 7),
                                      (2, 2), (3, 3), norm=norm, dtype=dtype)
        self.stages = []
        ch = stem_out_channels
        bottleneck = num_groups * width_per_group
        out_ch = res2_out_channels
        for i, n_blocks in enumerate(RESNET_STAGE_BLOCKS[depth]):
            stage = i + 2
            names = []
            for b in range(n_blocks):
                name = f"res{stage}_{b}"
                stride = 2 if b == 0 and stage != 2 else 1
                self.add_module(name, BottleneckBlock(
                    ch, out_ch, bottleneck, stride, stride_in_1x1,
                    num_groups, norm, dtype))
                ch = out_ch
                names.append(name)
            self.stages.append(names)
            bottleneck *= 2
            out_ch *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(self.stem_conv1(x), 3, 2, 1)
        tracing.mark("stem")
        outputs: Dict[str, torch.Tensor] = {}
        if "stem" in self.out_features:
            outputs["stem"] = x
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if f"res{i + 2}" in self.out_features:
                outputs[f"res{i + 2}"] = x
        return outputs
