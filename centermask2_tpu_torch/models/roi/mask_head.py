"""SAG-Mask head, NCHW (the port of
``centermask2_tpu/models/roi/mask_head.py``): 4x conv3x3 + relu ->
spatial attention -> 2x2/s2 deconv + relu -> 1x1 predictor with
num_classes channels, on (R, C, 14, 14) pooled features to
(R, num_classes, 28, 28) logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvTranspose2d, SpatialAttention


class SpatialAttentionMaskHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 conv_dims: int = 256, num_conv: int = 4, norm: str = "",
                 cls_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm:
            raise NotImplementedError(
                f"mask head norm {norm!r} is not ported (shipped configs "
                "use none; ROADMAP queue 1, 'The other backbones and norms')")
        self.num_conv = num_conv
        ch = in_channels
        for k in range(num_conv):
            self.add_module(f"mask_fcn{k + 1}", Conv2d(
                ch, conv_dims, init="kaiming_fan_out", dtype=dtype))
            ch = conv_dims
        self.spatialAtt = SpatialAttention(dtype=dtype)
        self.deconv = ConvTranspose2d(conv_dims, conv_dims,
                                      init="kaiming_fan_out", dtype=dtype)
        self.predictor = Conv2d(conv_dims, 1 if cls_agnostic else num_classes,
                                (1, 1), padding=(0, 0), init=0.001,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{k + 1}")(x))
        x = self.spatialAtt(x)
        x = F.relu(self.deconv(x))
        return self.predictor(x)


def mask_rcnn_inference(mask_logits: torch.Tensor,
                        pred_classes: torch.Tensor) -> torch.Tensor:
    """Per-class mask selection + sigmoid (reference mask_head.py:174-216):
    (R, C, M, M) logits -> (R, M, M) f32 probabilities."""
    if mask_logits.shape[1] == 1:
        sel = mask_logits[:, 0]
    else:
        rows = torch.arange(mask_logits.shape[0], device=mask_logits.device)
        sel = mask_logits[rows, pred_classes.long()]
    return torch.sigmoid(sel.float())
