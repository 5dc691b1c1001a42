"""MaskIoU rescoring head, NCHW (the port of
``centermask2_tpu/models/roi/maskiou_head.py``): concat(mask features
(R, C, 14, 14), maxpool2x2(pred mask 28x28)), 4 conv3x3 (last stride 2 ->
7x7), 3 FC (1024, 1024, num_classes). ``maskiou_fc1`` reads the (C, 7, 7)
activation flattened C-major, the torch order; ``checkpoint/from_jax.py``
permutes the JAX (7, 7, C) columns into it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, Linear


class MaskIoUHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 conv_dims: int = 256, num_conv: int = 4,
                 input_resolution: int = 14,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conv = num_conv
        ch = in_channels + 1
        for k in range(num_conv):
            s = 2 if (k + 1) == num_conv else 1
            self.add_module(f"maskiou_fcn{k + 1}", Conv2d(
                ch, conv_dims, strides=(s, s), init="kaiming_fan_out",
                dtype=dtype))
            ch = conv_dims
        side = input_resolution // 2
        self.maskiou_fc1 = Linear(conv_dims * side * side, 1024,
                                  init="kaiming_fan_out", dtype=dtype)
        self.maskiou_fc2 = Linear(1024, 1024, init="kaiming_fan_out",
                                  dtype=dtype)
        self.maskiou = Linear(1024, num_classes, init=0.01, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x: (R, C, 14, 14) pooled features; mask: (R, 1, 28, 28) soft
        mask. Returns (R, num_classes) predicted IoUs."""
        mask_pool = F.max_pool2d(mask, 2, 2)
        x = torch.cat([x, mask_pool.to(x.dtype)], dim=1)
        for k in range(self.num_conv):
            x = F.relu(getattr(self, f"maskiou_fcn{k + 1}")(x))
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.maskiou_fc1(x))
        x = F.relu(self.maskiou_fc2(x))
        return self.maskiou(x)


def mask_iou_inference(pred_maskiou: torch.Tensor, pred_classes: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """mask_scores = scores * maskiou[class] (reference
    maskiou_head.py:50-60)."""
    sel = torch.gather(pred_maskiou, 1, pred_classes.long()[:, None])[:, 0]
    return scores * sel.to(scores.dtype)
