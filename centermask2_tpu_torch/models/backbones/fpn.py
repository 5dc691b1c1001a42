"""Feature Pyramid Network, NCHW (the port of
``centermask2_tpu/models/backbones/fpn.py``): 1x1 laterals, nearest-2x
top-down fusion cropped to the ceil-divided lateral shape, 3x3 output
convs, each conv followed by ``get_norm(norm)`` (``fpn_lateral{s}_norm``,
``fpn_output{s}_norm``; the convs have a bias only with no norm), and
one of the top blocks: FCOS's LastLevelP6P7 or LastLevelP6 (reference
modeling/backbone/fpn.py:17-53), detectron2's LastLevelMaxPool (P5
subsampled by 2), or none. The captured serving program on CUDA gives
it channels-last maps, which it keeps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, get_norm

TOP_BLOCKS = ("p6p7", "p6", "maxpool", None)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W) exact nearest (== F.interpolate x2)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class FPN(nn.Module):
    """Top-down FPN over bottom-up features ordered low -> high stride.
    Output dict maps "p{log2(stride)}" to maps, plus the top block's
    levels. ``in_channels``: each input's width, from the backbone's
    feature-channel table."""

    def __init__(self, in_channels: Sequence[int], in_strides: Sequence[int],
                 out_channels: int = 256, norm: str = "",
                 fuse_type: str = "sum", top_block: Optional[str] = "p6p7",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if top_block not in TOP_BLOCKS:
            raise ValueError(f"FPN top block {top_block!r}: one of "
                             f"{TOP_BLOCKS}")
        self.stages = [int(math.log2(s)) for s in in_strides]
        self.fuse_type = fuse_type
        self.top_block = top_block
        use_bias = norm == ""
        for c, stage in zip(in_channels, self.stages):
            self.add_module(f"fpn_lateral{stage}", Conv2d(
                c, out_channels, (1, 1), padding=(0, 0), use_bias=use_bias,
                init="xavier", dtype=dtype))
            self.add_module(f"fpn_lateral{stage}_norm",
                            get_norm(norm, out_channels))
            self.add_module(f"fpn_output{stage}", Conv2d(
                out_channels, out_channels, use_bias=use_bias, init="xavier",
                dtype=dtype))
            self.add_module(f"fpn_output{stage}_norm",
                            get_norm(norm, out_channels))
        if top_block in ("p6p7", "p6"):
            self.top_block_p6 = Conv2d(out_channels, out_channels,
                                       strides=(2, 2), init="xavier",
                                       dtype=dtype)
        if top_block == "p6p7":
            self.top_block_p7 = Conv2d(out_channels, out_channels,
                                       strides=(2, 2), init="xavier",
                                       dtype=dtype)

    def _conv_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = getattr(self, name)(x)
        norm = getattr(self, f"{name}_norm")
        return x if norm is None else norm(x)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        stages = self.stages
        results: Dict[str, torch.Tensor] = {}
        prev = self._conv_norm(f"fpn_lateral{stages[-1]}", feats[-1])
        results[f"p{stages[-1]}"] = self._conv_norm(
            f"fpn_output{stages[-1]}", prev)
        for idx in range(len(feats) - 2, -1, -1):
            stage = stages[idx]
            lat = self._conv_norm(f"fpn_lateral{stage}", feats[idx])
            td = upsample_nearest_2x(prev)[:, :, :lat.shape[2], :lat.shape[3]]
            prev = lat + td
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[f"p{stage}"] = self._conv_norm(f"fpn_output{stage}", prev)
        top = stages[-1]
        p_top = results[f"p{top}"]
        if self.top_block in ("p6p7", "p6"):
            p6 = self.top_block_p6(p_top)
            results[f"p{top + 1}"] = p6
            if self.top_block == "p6p7":
                results[f"p{top + 2}"] = self.top_block_p7(F.relu(p6))
        elif self.top_block == "maxpool":
            # LastLevelMaxPool: a 1x1 window at stride 2
            results[f"p{top + 1}"] = p_top[:, :, ::2, ::2]
        return results
