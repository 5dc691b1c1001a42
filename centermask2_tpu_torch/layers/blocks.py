"""Core NN building blocks (NCHW, torch.nn).

The port of ``centermask2_tpu/layers/blocks.py``. Activations are NCHW;
parameters stay float32 and every conv runs in the module's compute
dtype (``dtype``: torch.bfloat16 or torch.float32), as the JAX modules
do with their ``dtype`` field.

Parameter names follow the JAX tree so that ``checkpoint/from_jax.py``
maps every leaf by name: a JAX ``kernel`` is the port's ``weight`` (in
torch layout), ``bias`` stays ``bias``, the GroupNorm ``gn/scale`` is
``gn.weight``, and FrozenBN keeps ``frozen_scale``/``frozen_bias``.
Each parameterised block has ``reset_parameters(generator)`` drawing the
JAX initializer's distribution from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-5

# Initializer names (the JAX package's flax initializers):
# "kaiming_fan_out" = variance_scaling(2, fan_out, normal) (c2_msra_fill),
# "lecun" = lecun_normal (truncated normal, fan_in), "xavier" =
# variance_scaling(1/3, fan_in, uniform) (c2_xavier_fill), and a float
# = normal(stddev).
Init = Union[str, float]


def _fans(weight: torch.Tensor) -> Tuple[int, int]:
    """(fan_in, fan_out) as flax counts them for the equivalent kernel.
    Also right for a deconv: its (I, O, kh, kw) weight is the flax
    (kh, kw, O, I) kernel, whose fan_in flax takes from O."""
    rf = weight.shape[2] * weight.shape[3] if weight.dim() == 4 else 1
    return weight.shape[1] * rf, weight.shape[0] * rf


def init_weight_(weight: torch.Tensor, init: Init,
                 generator: Optional[torch.Generator]) -> None:
    fan_in, fan_out = _fans(weight)
    with torch.no_grad():
        if init == "kaiming_fan_out":
            weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
        elif init == "lecun":
            # truncated to +-2 std, with flax's 0.8796 std correction
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        elif init == "xavier":
            lim = math.sqrt(1.0 / fan_in)
            weight.uniform_(-lim, lim, generator=generator)
        elif isinstance(init, float):
            weight.normal_(0.0, init, generator=generator)
        else:
            raise ValueError(f"unknown initializer {init!r}")


class Conv2d(nn.Module):
    """Conv with torch-style symmetric integer padding in the compute
    dtype (JAX ``layers/blocks.py:45-80``; also stands for every bare
    ``nn.Conv`` of the JAX modules). ``weight`` is (O, I/groups, kh, kw)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (1, 1),
                 groups: int = 1, use_bias: bool = True,
                 init: Init = "lecun", bias_value: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = tuple(strides)
        self.padding = tuple(padding)
        self.groups = groups
        self.init = init
        self.bias_value = bias_value
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_channels // groups, *kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters(None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_weight_(self.weight, self.init, generator)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, 1, self.groups)


class ConvTranspose2d(nn.Module):
    """torch ConvTranspose2d(k=2, s=2, p=0) in the compute dtype (JAX
    ``blocks.py:82-117``, the mask-head upsampler). ``weight`` is
    (I, O, kh, kw)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (2, 2),
                 strides: Tuple[int, int] = (2, 2), use_bias: bool = True,
                 init: Init = "lecun", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = tuple(strides)
        self.init = init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            in_channels, features, *kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self.reset_parameters(None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_weight_(self.weight, self.init, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), b,
                                  self.stride)


class Linear(nn.Module):
    """Dense layer in the compute dtype (flax ``nn.Dense``); ``weight``
    is (O, I)."""

    def __init__(self, in_features: int, features: int, init: Init = "lecun",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.init = init
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))
        self.reset_parameters(None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        init_weight_(self.weight, self.init, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class FrozenBatchNorm(nn.Module):
    """Inference BN folded to a per-channel affine (JAX
    ``blocks.py:120-135``): ``x * frozen_scale + frozen_bias`` in the
    activation's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("frozen_scale", torch.ones(features))
        self.register_buffer("frozen_bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.frozen_scale.to(x.dtype)[None, :, None, None]
        b = self.frozen_bias.to(x.dtype)[None, :, None, None]
        return x * s + b


class GroupNorm(nn.Module):
    """GroupNorm(32) with float32 moments and affine, cast back to the
    activation's dtype (JAX ``blocks.py:138-157``; flax upcasts the same
    way).

    A group of one value (C/G x H x W == 1, e.g. FPN width 32 on a 1x1
    P7) equals its mean, so JAX returns the bias exactly; F.group_norm
    refuses such groups at batch 1 and leaves ~1e-5 above it. That case
    is decided from the static shape and returns the bias broadcast."""

    def __init__(self, features: int, num_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(num_groups, features, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if math.prod(x.shape[1:]) == self.gn.num_groups:
            bias = self.gn.bias.to(x.dtype)
            return bias.reshape(1, -1, *([1] * (x.dim() - 2))).expand_as(x)
        return F.group_norm(x.float(), self.gn.num_groups, self.gn.weight,
                            self.gn.bias, self.gn.eps).to(x.dtype)


def get_norm(norm: str, features: int) -> Optional[nn.Module]:
    """Norm factory mirroring detectron2 get_norm as the reference uses it."""
    if not norm or norm == "none":
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(features)
    if norm == "GN":
        return GroupNorm(features)
    if norm in ("BN", "SyncBN"):
        raise NotImplementedError(
            f"norm {norm!r} is not ported yet (ROADMAP queue 1, item 14, "
            "with data parallelism)")
    raise ValueError(f"Unknown norm: {norm}")


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6 (reference Hsigmoid, vovnet.py:238-244)."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class eSEModule(nn.Module):
    """Effective Squeeze-Excitation: x * hsigmoid(fc(global_avg_pool(x))),
    with the gate as an f32 matmul on the pooled vector (JAX
    ``blocks.py:227-250``). ``fc`` keeps the conv-shaped (C, C, 1, 1)
    weight of the checkpoint layout."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, (1, 1), padding=(0, 0),
                         init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = x.mean(dim=(2, 3), dtype=torch.float32)  # (N, C)
        w = self.fc.weight.reshape(self.fc.weight.shape[0], -1)
        gate = pooled @ w.t() + self.fc.bias
        return x * hsigmoid(gate)[:, :, None, None].to(x.dtype)


class SpatialAttention(nn.Module):
    """SAG-Mask spatial attention gate (reference sam.py:12-28):
    x * sigmoid(conv3x3(concat[mean_c(x), max_c(x)]))."""

    def __init__(self, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        p = kernel_size // 2
        self.conv = Conv2d(2, 1, (kernel_size, kernel_size), padding=(p, p),
                           use_bias=False, init="kaiming_fan_out", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg_out = x.mean(dim=1, keepdim=True)
        max_out = x.amax(dim=1, keepdim=True)
        scale = self.conv(torch.cat([avg_out, max_out], dim=1))
        return x * torch.sigmoid(scale.float()).to(x.dtype)


class Scale(nn.Module):
    """Single learnable scalar multiplier (reference fcos.py:19-25)."""

    def __init__(self, init_value: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), float(init_value)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


def max_pool2d_ceil(x: torch.Tensor, kernel: int = 3,
                    stride: int = 2) -> torch.Tensor:
    """torch MaxPool2d(kernel, stride, ceil_mode=True) on NCHW: the OSA
    stage downsampler (vovnet.py:345). Output side ceil((h-k)/s)+1, as
    JAX ``blocks.py:294`` computes it with -inf padding."""
    return F.max_pool2d(x, kernel, stride, ceil_mode=True)


class ConvNormAct(nn.Module):
    """conv -> norm -> relu unit (JAX ``blocks.py:331-369``)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Tuple[int, int] = (1, 1), groups: int = 1,
                 norm: str = "FrozenBN", use_act: bool = True,
                 use_bias: Optional[bool] = None,
                 init: Init = "kaiming_fan_out",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if use_bias is None:
            use_bias = not norm
        self.conv = Conv2d(in_channels, features, kernel_size, strides,
                           padding, groups, use_bias, init, dtype=dtype)
        self.norm = get_norm(norm, features)
        self.use_act = use_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.use_act:
            x = F.relu(x)
        return x


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Re-draw every conv and linear weight from ``generator`` in module
    order (norms and scales keep their constant initial values)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.reset_parameters(generator)
