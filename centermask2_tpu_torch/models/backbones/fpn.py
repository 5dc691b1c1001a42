"""Feature Pyramid Network, NCHW (the port of
``centermask2_tpu/models/backbones/fpn.py``): 1x1 laterals, nearest-2x
top-down fusion cropped to the ceil-divided lateral shape, 3x3 output
convs, and the FCOS LastLevelP6P7 top block (reference
modeling/backbone/fpn.py:17-35). The other top blocks and FPN norms are
not ported yet (ROADMAP queue 1, 'The other backbones and norms').
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W) exact nearest (== F.interpolate x2)."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


class FPN(nn.Module):
    """Top-down FPN over bottom-up features ordered low -> high stride.
    Output dict maps "p{log2(stride)}" to maps, plus p6/p7."""

    def __init__(self, in_channels: Sequence[int], in_strides: Sequence[int],
                 out_channels: int = 256, norm: str = "",
                 fuse_type: str = "sum", top_block: Optional[str] = "p6p7",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm or top_block != "p6p7":
            raise NotImplementedError(
                f"FPN norm {norm!r} / top block {top_block!r}: only the "
                "plain FPN with P6P7 is ported (ROADMAP queue 1, "
                "'The other backbones and norms')")
        self.stages = [int(math.log2(s)) for s in in_strides]
        self.fuse_type = fuse_type
        for c, stage in zip(in_channels, self.stages):
            self.add_module(f"fpn_lateral{stage}", Conv2d(
                c, out_channels, (1, 1), padding=(0, 0), init="xavier",
                dtype=dtype))
            self.add_module(f"fpn_output{stage}", Conv2d(
                out_channels, out_channels, init="xavier", dtype=dtype))
        self.top_block_p6 = Conv2d(out_channels, out_channels, strides=(2, 2),
                                   init="xavier", dtype=dtype)
        self.top_block_p7 = Conv2d(out_channels, out_channels, strides=(2, 2),
                                   init="xavier", dtype=dtype)

    def forward(self, feats: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        stages = self.stages
        results: Dict[str, torch.Tensor] = {}
        prev = getattr(self, f"fpn_lateral{stages[-1]}")(feats[-1])
        results[f"p{stages[-1]}"] = getattr(
            self, f"fpn_output{stages[-1]}")(prev)
        for idx in range(len(feats) - 2, -1, -1):
            stage = stages[idx]
            lat = getattr(self, f"fpn_lateral{stage}")(feats[idx])
            td = upsample_nearest_2x(prev)[:, :, :lat.shape[2], :lat.shape[3]]
            prev = lat + td
            if self.fuse_type == "avg":
                prev = prev / 2.0
            results[f"p{stage}"] = getattr(self, f"fpn_output{stage}")(prev)
        top = stages[-1]
        p6 = self.top_block_p6(results[f"p{top}"])
        results[f"p{top + 1}"] = p6
        results[f"p{top + 2}"] = self.top_block_p7(F.relu(p6))
        return results
