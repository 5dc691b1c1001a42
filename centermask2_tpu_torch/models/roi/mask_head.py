"""SAG-Mask head, NCHW (the port of
``centermask2_tpu/models/roi/mask_head.py``): 4x conv3x3 (+ norm) + relu ->
spatial attention -> 2x2/s2 deconv + relu -> 1x1 predictor with
num_classes channels, on (R, C, 14, 14) pooled features to
(R, num_classes, 28, 28) logits. With a norm (ROI_MASK_HEAD.NORM, GN or
FrozenBN) each conv loses its bias and is followed by ``mask_fcn{k}_norm``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvTranspose2d, SpatialAttention, get_norm


class SpatialAttentionMaskHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 80,
                 conv_dims: int = 256, num_conv: int = 4, norm: str = "",
                 cls_agnostic: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conv = num_conv
        ch = in_channels
        for k in range(num_conv):
            self.add_module(f"mask_fcn{k + 1}", Conv2d(
                ch, conv_dims, use_bias=not norm, init="kaiming_fan_out",
                dtype=dtype))
            self.add_module(f"mask_fcn{k + 1}_norm", get_norm(norm, conv_dims))
            ch = conv_dims
        self.spatialAtt = SpatialAttention(dtype=dtype)
        self.deconv = ConvTranspose2d(conv_dims, conv_dims,
                                      init="kaiming_fan_out", dtype=dtype)
        self.predictor = Conv2d(conv_dims, 1 if cls_agnostic else num_classes,
                                (1, 1), padding=(0, 0), init=0.001,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(self.num_conv):
            x = getattr(self, f"mask_fcn{k + 1}")(x)
            norm = getattr(self, f"mask_fcn{k + 1}_norm")
            if norm is not None:
                x = norm(x)
            x = F.relu(x)
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
