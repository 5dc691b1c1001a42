"""A conv with its epilogue in one call: ``relu(conv(x, w) + b [+ z])``.

The captured serving program (``layers/prepared.py``) folds each
FrozenBN into its conv, so every folded conv has a bias. On the plain
chain ATen adds that bias as a broadcast pass after the GEMM, then the
ReLU runs as another pass, and a ResNet bottleneck's shortcut add as a
third. ``conv_bias_act`` does the whole epilogue in the convolution:

- on CUDA maps, cuDNN's fused conv-bias-add-activation op
  (``torch.cudnn_convolution_relu``, ``torch.cudnn_convolution_add_relu``
  with alpha 1): the sum ``conv + b + z`` is kept in float32 and rounded
  once to the output's dtype. The trunk feeds it channels-last maps and
  weights, cuDNN's NHWC layout, so no transpose runs around it;
- on every other device, ``conv_bias_act_plain``, the chain it stands
  for and its oracle: ``F.conv2d(x, w, b)``, then ``+ z``, then ReLU, each
  rounded to the dtype, in the memory format ``F.conv2d`` gives.

Only the served path calls it (``ConvNormAct`` and the VoVNet's s2d stem
on their prepared weights); training, eager inference, ``torch.export``
and the FLOP count run the plain chain, which never reaches it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def conv_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        z: Optional[torch.Tensor], stride: Sequence[int],
                        padding: Sequence[int], groups: int) -> torch.Tensor:
    """``relu(F.conv2d(x, w, b) + z)`` (``z`` None: no add), each step
    rounded to ``x``'s dtype."""
    y = F.conv2d(x, w, b, stride, padding, 1, groups)
    if z is not None:
        y = y + z
    return F.relu(y)


def conv_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  z: Optional[torch.Tensor] = None,
                  stride: Sequence[int] = (1, 1),
                  padding: Sequence[int] = (0, 0),
                  groups: int = 1) -> torch.Tensor:
    """``relu(conv(x, w) + b + z)`` of an (N, C, H, W) map ``x``, an
    (O, C / groups, kh, kw) weight ``w``, an (O,) bias ``b`` and an
    optional (N, O, Ho, Wo) ``z``, all of one dtype: one cuDNN call on
    CUDA, the plain chain elsewhere (the module docstring)."""
    if not x.is_cuda:
        return conv_bias_act_plain(x, w, b, z, stride, padding, groups)
    stride, padding = list(stride), list(padding)
    if z is None:
        return torch.cudnn_convolution_relu(x, w, b, stride, padding, [1, 1],
                                            groups)
    return torch.cudnn_convolution_add_relu(x, w, z, 1.0, b, stride, padding,
                                            [1, 1], groups)
