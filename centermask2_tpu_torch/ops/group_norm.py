"""GroupNorm, and GroupNorm followed by ReLU over the levels of an FCOS
tower layer (kernel 3).

``group_norm_f32`` is the port of JAX ``layers/blocks.py:138-157``
(``layers/blocks.py::GroupNorm`` runs it): float32 moments and affine,
cast back to the activation's dtype. A group of one value (C/G x H x W
== 1, e.g. FPN width 32 on a 1x1 P7) equals its mean, so JAX returns
the bias exactly; F.group_norm refuses such groups at batch 1 and leaves
~1e-5 above it. That case is decided from the static shape and returns
the bias broadcast.

The registered operator ``cm2::group_norm_relu`` takes every level of
one tower layer (the layer's weights are shared across levels) and
dispatches by device:
- on CUDA tensors, kernel 3 (``csrc/group_norm.cu`` via ``_kernels``),
  over channels-last maps;
- on CPU tensors, its plain version ``group_norm_relu_plain``, the chain
  the tower runs on every other path: ``group_norm_f32``, then ReLU.
Its fake implementation states the outputs (each level's shape and
strides), so ``torch.export`` traces through it.

``fused_path`` (a CUDA map, autograd off, both observed on the tensor
and the thread) is the FCOS head's rule for running its towers
channels-last, each GN layer through the operator. The rule reads no strides: ``torch.export`` traces with fake
tensors whose strides may differ from the run's, and a rule on them
would export another path than the eager one. Training (autograd on)
and the CPU keep the plain chain and its backward.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from . import _kernels


def group_norm_f32(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                   bias: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm with float32 moments and affine, in ``x``'s dtype."""
    if math.prod(x.shape[1:]) == num_groups:
        return bias.to(x.dtype).reshape(
            1, -1, *([1] * (x.dim() - 2))).expand_as(x)
    return F.group_norm(x.float(), num_groups, weight, bias,
                        eps).to(x.dtype)


def group_norm_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, num_groups: int,
                          eps: float) -> torch.Tensor:
    """Plain PyTorch version of kernel 3 for one level: ``relu`` of
    ``group_norm_f32``, laid out as ``x`` is."""
    y = F.relu(group_norm_f32(x, num_groups, weight, bias, eps))
    if y.stride() != x.stride():
        y = torch.empty_like(x).copy_(y)
    return y


@torch.library.custom_op("cm2::group_norm_relu", mutates_args=(),
                         device_types="cpu")
def group_norm_relu_op(xs: List[torch.Tensor], weight: torch.Tensor,
                       bias: torch.Tensor, num_groups: int,
                       eps: float) -> List[torch.Tensor]:
    """``relu(group_norm(x))`` of each (N, C, H, W) level of ``xs`` with
    (C,) f32 ``weight`` and ``bias``: the plain version on the CPU."""
    return [group_norm_relu_plain(x, weight, bias, num_groups, eps)
            for x in xs]


group_norm_relu_op.register_kernel("cuda")(_kernels.group_norm_relu)


@group_norm_relu_op.register_fake
def _(xs, weight, bias, num_groups, eps):
    return [torch.empty_like(x) for x in xs]


def fused_path(x: torch.Tensor) -> bool:
    """Whether the FCOS head runs its towers channels-last with kernel 3:
    a CUDA map with autograd off."""
    return x.is_cuda and not torch.is_grad_enabled()
