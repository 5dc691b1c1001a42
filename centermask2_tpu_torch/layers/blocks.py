"""Core NN building blocks (NCHW, torch.nn).

The port of ``centermask2_tpu/layers/blocks.py``. Activations are NCHW
maps; the captured serving program on CUDA runs the trunk's and the
FPN's maps channels-last (``prepared.channels_last``), which the blocks
take as they come, each conv reading a weight in its input's format.
Parameters stay float32 and every conv runs in the module's compute
dtype (``dtype``: torch.bfloat16 or torch.float32), as the JAX modules
do with their ``dtype`` field.

Parameter names follow the JAX tree so that ``checkpoint/from_jax.py``
maps every leaf by name: a JAX ``kernel`` is the port's ``weight`` (in
torch layout), ``bias`` stays ``bias``, the GroupNorm ``gn/scale`` is
``gn.weight``, a BatchNorm's ``bn/scale`` is ``bn.weight`` (its
``batch_stats`` ``bn/mean`` and ``bn/var`` are the buffers ``bn.mean`` and
``bn.var``), and FrozenBN keeps ``frozen_scale``/``frozen_bias``.
The convs and linears take their cast weights from
``prepared.weights``: computed on each call, or inside the captured
serving program (``layers/prepared.py``) prepared once per set of
weights, where a FrozenBN ``ConvNormAct`` also reads its norm folded
into the conv and, with a ReLU after it, runs the conv, bias and ReLU
in one call (``ops/conv_bias_act.py``).
Each parameterised block has ``reset_parameters(generator)`` drawing the
JAX initializer's distribution from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_bias_act import conv_bias_act
from ..ops.group_norm import group_norm_f32
from . import prepared

GN_EPS = 1e-5
BN_EPS = 1e-5

# Initializer names (the JAX package's flax initializers):
# "kaiming_fan_out" = variance_scaling(2, fan_out, normal) (c2_msra_fill),
# "lecun" = lecun_normal (truncated normal, fan_in), "xavier" =
# variance_scaling(1/3, fan_in, uniform) (c2_xavier_fill), "zeros", and a
# float = normal(stddev).
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
        elif init == "zeros":
            weight.zero_()
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

    prepared_counts = (1, 0)  # (convs, folded norms) of its entry

    def prepared_sources(self):
        return [self.weight] + ([] if self.bias is None else [self.bias])

    def prepare_weights(self, nhwc: bool):
        """(weight, bias) in the compute dtype, the weight channels-last
        for a channels-last input (``layers/prepared.py``)."""
        fmt = torch.channels_last if nhwc else torch.preserve_format
        return (self.weight.to(self.dtype, memory_format=fmt),
                None if self.bias is None else self.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a channels-last input (the FCOS towers on the card) takes its
        # weight channels-last, as cuDNN's NHWC kernels read it
        w, b = prepared.weights(self, prepared.is_channels_last(x))
        return F.conv2d(x.to(w.dtype), w, b, self.stride, self.padding, 1,
                        self.groups)


class ConvTranspose2d(nn.Module):
    """torch ConvTranspose2d in the compute dtype: k=2, s=2, p=0 is the
    mask-head upsampler (JAX ``blocks.py:82-117``), k=4, s=2, p=1 the
    keypoint head's (JAX ``keypoint_head.py:45-60``). ``weight`` is
    (I, O, kh, kw)."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Tuple[int, int] = (2, 2),
                 strides: Tuple[int, int] = (2, 2),
                 padding: Tuple[int, int] = (0, 0), use_bias: bool = True,
                 init: Init = "lecun", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = tuple(strides)
        self.padding = tuple(padding)
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

    prepared_counts = (1, 0)

    def prepared_sources(self):
        return [self.weight] + ([] if self.bias is None else [self.bias])

    def prepare_weights(self, fmt=None):
        return (self.weight.to(self.dtype),
                None if self.bias is None else self.bias.to(self.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = prepared.weights(self)
        return F.conv_transpose2d(x.to(w.dtype), w, b, self.stride,
                                  self.padding)


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

    prepared_counts = (1, 0)

    def prepared_sources(self):
        return [self.weight, self.bias]

    def prepare_weights(self, fmt=None):
        return self.weight.to(self.dtype), self.bias.to(self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = prepared.weights(self)
        return F.linear(x.to(w.dtype), w, b)


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
    way): ``ops/group_norm.py::group_norm_f32``, which also keeps JAX's
    exact bias for a group of one value."""

    def __init__(self, features: int, num_groups: int = 32):
        super().__init__()
        self.gn = nn.GroupNorm(num_groups, features, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_f32(x, self.gn.num_groups, self.gn.weight,
                              self.gn.bias, self.gn.eps)


class _BNState(nn.Module):
    """flax ``nn.BatchNorm``'s leaves under the JAX module name ``bn``:
    the parameters ``weight`` (flax ``scale``) and ``bias``, and the
    ``batch_stats`` buffers ``mean`` and ``var``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))


_STAT_UPDATES = [True]


@contextlib.contextmanager
def no_stat_updates():
    """Train-mode BatchNorm inside leaves its running statistics alone:
    a recomputed forward (``TPU.REMAT_BACKBONE``) must not move them a
    second time, as JAX's functional remat moves them once."""
    _STAT_UPDATES.append(False)
    try:
        yield
    finally:
        _STAT_UPDATES.pop()


class BatchNorm(nn.Module):
    """Train-capable BatchNorm with flax ``nn.BatchNorm``'s semantics (JAX
    ``blocks.py:159-184``), written out rather than taken from
    ``nn.BatchNorm2d``, whose running statistics differ:

    - in training (the module's ``training`` flag; JAX keys it off the
      mutability of ``batch_stats``) the moments are float32 means of x
      and x^2 over (N, H, W), the variance ``max(E[x^2] - E[x]^2, 0)``
      (biased, and the running variance keeps that same biased value),
      and the running values move by ``0.9 * run + 0.1 * batch``;
    - in eval the running values normalize;
    - the output is ``(x - mean) * rsqrt(var + eps) * scale + bias`` with
      float32 statistics and parameters, so it is float32 whatever the
      activation's dtype (flax's ``dtype=None`` promotes a bf16 input).

    ``sync`` (SyncBN): the two moments are averaged over ``group``
    inside the forward (flax ``axis_name``, one ``pmean`` of the stacked
    moments), with the gradient flowing through that mean. ``group`` is
    set by ``CenterMask.loss`` for its call; None (no mapped axis) keeps
    the statistics local, as JAX does outside ``shard_map``."""

    def __init__(self, features: int, sync: bool = False,
                 momentum: float = 0.9):
        super().__init__()
        self.bn = _BNState(features)
        self.sync = sync
        self.momentum = momentum
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        st = self.bn
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            moments = torch.stack([xf.mean(dim=axes),
                                   (xf * xf).mean(dim=axes)])
            if self.sync:
                from ..utils.comm import pmean

                moments = pmean(moments, self.group)
            mean, mean2 = moments[0], moments[1]
            var = torch.clamp_min(mean2 - mean * mean, 0.0)
            if _STAT_UPDATES[-1]:
                m = self.momentum
                with torch.no_grad():
                    st.mean.copy_(m * st.mean + (1 - m) * mean)
                    st.var.copy_(m * st.var + (1 - m) * var)
        else:
            mean, var = st.mean, st.var
        mul = torch.rsqrt(var + BN_EPS) * st.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + st.bias.reshape(shape)


def get_norm(norm: str, features: int) -> Optional[nn.Module]:
    """Norm factory mirroring detectron2 get_norm as the reference uses it."""
    if not norm or norm == "none":
        return None
    if norm == "FrozenBN":
        return FrozenBatchNorm(features)
    if norm == "GN":
        return GroupNorm(features)
    if norm == "BN":
        return BatchNorm(features)
    if norm == "SyncBN":
        return BatchNorm(features, sync=True)
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

    prepared_counts = (1, 1)  # the conv, with its FrozenBN folded

    def prepared_sources(self):
        if not isinstance(self.norm, FrozenBatchNorm):
            return []
        return self.conv.prepared_sources() + [self.norm.frozen_scale,
                                               self.norm.frozen_bias]

    def prepare_weights(self, nhwc: bool):
        """The FrozenBN folded into the conv (``layers/prepared.py``):
        (weight, bias) computed in float32, rounded once to the compute
        dtype."""
        c, n = self.conv, self.norm
        w, b = prepared.fold_frozen_bn(c.weight.detach(), None if c.bias is
                                       None else c.bias.detach(),
                                       n.frozen_scale, n.frozen_bias)
        fmt = torch.channels_last if nhwc else torch.contiguous_format
        return w.to(c.dtype, memory_format=fmt), b.to(c.dtype)

    def forward(self, x: torch.Tensor,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``norm(conv(x))``, plus ``z`` if given (a ResNet bottleneck's
        shortcut), then the ReLU where ``use_act`` or ``z``. Inside the
        captured serving program a FrozenBN conv runs on its folded
        weights, and with a ReLU after it takes its bias, ``z`` and the
        ReLU into the conv's call (``ops/conv_bias_act.py``)."""
        act = self.use_act or z is not None
        store = prepared.active()
        if store is not None and isinstance(self.norm, FrozenBatchNorm):
            c = self.conv
            w, b = store.get(self, prepared.is_channels_last(x),
                             fused=int(act))
            x = x.to(w.dtype)
            if act:
                return conv_bias_act(x, w, b, z, c.stride, c.padding,
                                     c.groups)
            return F.conv2d(x, w, b, c.stride, c.padding, 1, c.groups)
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if z is not None:
            x = x + z
        return F.relu(x) if act else x


def reset_parameters(module: nn.Module,
                     generator: Optional[torch.Generator]) -> None:
    """Re-draw every conv, deformable conv and linear weight from
    ``generator`` in module order (norms and scales keep their constant
    initial values)."""
    from .deform import DeformConvBlock

    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear, DeformConvBlock)):
            m.reset_parameters(generator)
