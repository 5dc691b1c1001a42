"""VoVNetV2 backbone (One-Shot Aggregation + eSE), NCHW (the port of
``centermask2_tpu/models/backbones/vovnet.py``).

Stem of 3 convs at strides 2/1/2, either on the image or, with
``s2d_input``, evaluated in space-to-depth coordinates on the host's
factor-4 s2d input (``s2d_stem_forward``); OSA modules (input + k
sequential 3x3 convs concatenated, 1x1 aggregate, eSE gate, identity
residual on non-first blocks), and a ceil-mode 3x3/s2 max-pool opening
stages 3-5. The depthwise bodies (``V-19-*dw-eSE``) take depthwise
blocks (3x3 depthwise, 1x1 pointwise, the norm after the pointwise conv)
for stem_2, stem_3 and every OSA layer, with a 1x1 reduction where an
OSA module's input width differs from its stage width. The stages of
``stage_with_dcn`` (MODEL.VOVNET.STAGE_WITH_DCN, standard bodies) take
deformable 3x3 layers (``layers/deform.py::DeformConvBlock``, DCN v2 with
``with_modulated_dcn``).

The captured serving program on CUDA runs these maps channels-last, and
each FrozenBN conv with a ReLU after it, the s2d stem's among them, runs
its bias and ReLU in its conv's call (``ops/conv_bias_act.py``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import (Conv2d, ConvNormAct, DeformConvBlock, eSEModule,
                       get_norm, max_pool2d_ceil, prepared)
from ...ops.conv_bias_act import conv_bias_act
from ...utils import tracing

# Stage specs (reference vovnet.py:30-108, JAX vovnet.py:35-72).
VoVNet19_slim_dw_eSE = dict(
    stem=[64, 64, 64], stage_conv_ch=[64, 80, 96, 112],
    stage_out_ch=[112, 256, 384, 512], layer_per_block=3,
    block_per_stage=[1, 1, 1, 1], eSE=True, dw=True)
VoVNet19_dw_eSE = dict(
    stem=[64, 64, 64], stage_conv_ch=[128, 160, 192, 224],
    stage_out_ch=[256, 512, 768, 1024], layer_per_block=3,
    block_per_stage=[1, 1, 1, 1], eSE=True, dw=True)
VoVNet19_slim_eSE = dict(
    stem=[64, 64, 128], stage_conv_ch=[64, 80, 96, 112],
    stage_out_ch=[112, 256, 384, 512], layer_per_block=3,
    block_per_stage=[1, 1, 1, 1], eSE=True, dw=False)
VoVNet19_eSE = dict(
    stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
    stage_out_ch=[256, 512, 768, 1024], layer_per_block=3,
    block_per_stage=[1, 1, 1, 1], eSE=True, dw=False)
VoVNet39_eSE = dict(
    stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
    stage_out_ch=[256, 512, 768, 1024], layer_per_block=5,
    block_per_stage=[1, 1, 2, 2], eSE=True, dw=False)
VoVNet57_eSE = dict(
    stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
    stage_out_ch=[256, 512, 768, 1024], layer_per_block=5,
    block_per_stage=[1, 1, 4, 3], eSE=True, dw=False)
VoVNet99_eSE = dict(
    stem=[64, 64, 128], stage_conv_ch=[128, 160, 192, 224],
    stage_out_ch=[256, 512, 768, 1024], layer_per_block=5,
    block_per_stage=[1, 3, 9, 3], eSE=True, dw=False)

STAGE_SPECS = {
    "V-19-slim-dw-eSE": VoVNet19_slim_dw_eSE,
    "V-19-dw-eSE": VoVNet19_dw_eSE,
    "V-19-slim-eSE": VoVNet19_slim_eSE,
    "V-19-eSE": VoVNet19_eSE,
    "V-39-eSE": VoVNet39_eSE,
    "V-57-eSE": VoVNet57_eSE,
    "V-99-eSE": VoVNet99_eSE,
}

# stride of each out feature (vovnet.py:437-438,471-481)
FEATURE_STRIDES = {"stem": 4, "stage2": 4, "stage3": 8, "stage4": 16,
                   "stage5": 32}


def feature_channels(body: str) -> Dict[str, int]:
    spec = STAGE_SPECS[body]
    out = {"stem": spec["stem"][2]}
    for i, c in enumerate(spec["stage_out_ch"]):
        out[f"stage{i + 2}"] = c
    return out


def _embed_s2d_kernel(w: torch.Tensor, P: int, Q: int) -> torch.Tensor:
    """Zero-embed a (O, C, 3, 3) stride-1/pad-1 kernel as the (O, 4C, 2, 2)
    kernel computing output phase (P, Q) on a 2x2-s2d input (JAX
    ``vovnet.py:164-188``).

    Output row 2i+P taps input rows 2i+P+dy-1 (dy in 0..2). Writing that
    row as 2(i+a)+alpha, the window offsets a span {-1,0} for P=0 and
    {0,1} for P=1; the kernel entry at window position a', input phase
    (alpha, beta) is w[dy, dx] with dy = 2(a'+amin)+alpha-P+1 (zero when
    dy/dx falls outside 0..2). Channel blocks are (alpha, beta)-major,
    the (p, q) row-major phase packing stem_1 emits."""
    O, C, kh, kw = w.shape
    K = w.new_zeros((O, 4 * C, 2, 2))
    amin = -1 if P == 0 else 0
    bmin = -1 if Q == 0 else 0
    for ap in range(2):
        for bp in range(2):
            for alpha in range(2):
                for beta in range(2):
                    dy = 2 * (ap + amin) + alpha - P + 1
                    dx = 2 * (bp + bmin) + beta - Q + 1
                    if 0 <= dy < kh and 0 <= dx < kw:
                        blk = (alpha * 2 + beta) * C
                        K[:, blk:blk + C, ap, bp] = w[:, :, dy, dx]
    return K


def _embed_stem1_nat(w1: torch.Tensor) -> torch.Tensor:
    """Zero-embed the stem_1 (O, C, 3, 3) conv/s2/pad1 kernel as the
    (4O, 16C, 2, 2) kernel computing all four output phases of y1 in one
    2x2/VALID conv over the natural-order factor-4 s2d input (JAX
    ``vovnet.py:191-216``; channel rho*4C + kap*C + c of the input holds
    image pixel (4i + rho - 2, 4j + kap - 2)).

    y1[2i+p, 2j+q] = sum_{dy,dx} w1[dy, dx] * P4[4i + 2p + dy + 1, ...]
    where P4 is the image padded by 2 on every side; the conv window
    position a and input row-phase rho satisfy 4a + rho = 2p + dy + 1,
    so every tap lands in a unique (window, phase) slot. Output phases
    are packed (p, q) row-major along channels."""
    O, C, kh, kw = w1.shape
    K = w1.new_zeros((4 * O, 16 * C, 2, 2))
    for p in (0, 1):
        for q in (0, 1):
            for dy in range(kh):
                for dx in range(kw):
                    a, rho = divmod(2 * p + dy + 1, 4)
                    b, kap = divmod(2 * q + dx + 1, 4)
                    blk = (rho * 4 + kap) * C
                    out = (p * 2 + q) * O
                    K[out:out + O, blk:blk + C, a, b] = w1[:, :, dy, dx]
    return K


class S2DStemKernels(NamedTuple):
    """What ``s2d_stem_forward`` convolves with, in the compute dtype: the
    zero-embedded kernels and the FrozenBN affines tiled over phases,
    each affine a (scale, bias) pair shaped (1, C, 1, 1); folded (the
    scales in the kernels), each a (None, bias (C,)) pair, the bias the
    conv's."""

    k1: torch.Tensor  # (4*C1, 48, 2, 2): all four phases of stem_1
    k2: Tuple[torch.Tensor, torch.Tensor]  # (2*C2, 4*C1, 2, 3) per P
    k3: Tuple[torch.Tensor, torch.Tensor]  # (C3, 2*C2, 2, 2) per P
    a1: Tuple[torch.Tensor, torch.Tensor]
    a2: Tuple[torch.Tensor, torch.Tensor]
    a3: Tuple[torch.Tensor, torch.Tensor]


StemParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def s2d_stem_kernels(k1: StemParams, k2: StemParams, k3: StemParams,
                     dtype: torch.dtype, fold: bool = False
                     ) -> S2DStemKernels:
    """Build the s2d stem's kernels from the logical stem parameters,
    each a (weight (O, I, 3, 3), frozen_scale, frozen_bias) triple.
    ``fold`` (the captured serving program's prepared weights,
    ``layers/prepared.py``): each FrozenBN scale multiplies its kernel in
    float32 before the embedding and the one rounding to ``dtype``, and
    the biases become the convs' (stem_3's once, on its first half).

    XLA folds these into constants of the JAX program; in eager PyTorch
    they cost some eighty small launches on every forward, which the
    captured serving program leaves out: it reads them folded from its
    prepared weights, built once per set of weights. The build is linear
    in the parameters and differentiable (slice writes into zeros).
    Packing (JAX ``vovnet.py:244-254``): stem_1's
    four phases in one conv; stem_2's phases paired over Q in (2, 3)
    kernels with each phase's 2x2 kernel at column offset Q; stem_3's
    phase-(0,0) kernel split channel-wise over the two stem_2 pairs."""
    (w1, s1, b1), (w2, s2, b2), (w3, s3, b3) = k1, k2, k3
    if fold:
        w1, w2, w3 = (w.float() * s.float()[:, None, None, None]
                      for w, s in ((w1, s1), (w2, s2), (w3, s3)))
    C2 = w2.shape[0]
    pairs = []
    for P in (0, 1):
        kp = w2.new_zeros((2 * C2, 4 * w1.shape[0], 2, 3))
        for Q in (0, 1):
            kp[Q * C2:(Q + 1) * C2, :, :, Q:Q + 2] = _embed_s2d_kernel(w2, P, Q)
        pairs.append(kp.to(dtype))
    k3e = _embed_s2d_kernel(w3, 0, 0)

    def affine(s, b, rep):
        if fold:
            return None, b.float().repeat(rep).to(dtype)
        return (s.repeat(rep).to(dtype)[None, :, None, None],
                b.repeat(rep).to(dtype)[None, :, None, None])

    return S2DStemKernels(
        k1=_embed_stem1_nat(w1).to(dtype), k2=tuple(pairs),
        k3=tuple(k3e[:, 2 * P * C2:2 * (P + 1) * C2].to(dtype).contiguous()
                 for P in (0, 1)),
        a1=affine(s1, b1, 4), a2=affine(s2, b2, 2), a3=affine(s3, b3, 1))


def s2d_stem_forward(xd2: torch.Tensor,
                     kernels: S2DStemKernels) -> torch.Tensor:
    """The whole VoVNet stem evaluated in space-to-depth coordinates (JAX
    ``vovnet.py:225-296``).

    xd2: (B, 48, Hd, Wd), the NCHW view of the host's factor-4 s2d input
    (``data/preprocess.py::stem_space_to_depth``). Every stem tensor lives
    at stride-4 spatial size with 48-256 channels and all three convs
    are 2x2 VALID convs with zero-embedded kernels: the same sums as the
    plain stem up to rounding order. Folded kernels (the captured
    serving program's) run each conv with its bias and ReLU in one call
    (``conv_bias_act``), stem_3's second half added in the first's; the
    output is laid out as ``xd2`` is. Returns the stem output
    (B, C3, Hd-1, Wd-1)."""
    kn = kernels
    folded = kn.a1[0] is None

    def conv_act(x, k, a, z=None):  # relu(affine(conv(x, k) + z))
        if folded:  # the scale in k and z; bias, z, ReLU in the conv's call
            return conv_bias_act(x, k, a[1], z)
        y = F.conv2d(x, k)
        return F.relu((y if z is None else y + z) * a[0] + a[1])

    # stem_1: the 4 output phases of y1, packed (p, q) row-major
    y1d = conv_act(xd2.to(kn.k1.dtype), kn.k1, kn.a1)
    # stem_2: conv3x3/s1/p1 in s2d space, 2 paired phase convs over the
    # 1-padded y1d (zero rows/cols of y1d are exactly y1's conv padding)
    y1p = F.pad(y1d, (1, 1, 1, 1))
    h = y1d.shape[2]
    y2_pairs = [conv_act(y1p[:, :, P:P + h + 1], kn.k2[P], kn.a2)
                for P in (0, 1)]
    # stem_3: conv3x3/s2/p1, whose stride-2 output lands on the s2d grid:
    # one phase-(0,0) conv as two channel-half convs over the top/left
    # zero-padded stem_2 pairs, the second half added to the first's
    part = F.conv2d(F.pad(y2_pairs[1], (1, 0, 1, 0)), kn.k3[1])
    return conv_act(F.pad(y2_pairs[0], (1, 0, 1, 0)), kn.k3[0], kn.a3, part)


class DWConvBlock(nn.Module):
    """3x3 depthwise conv (``groups = features``, no bias, no norm) -> 1x1
    pointwise conv -> ``pw_norm`` -> relu (reference dw_conv3x3,
    vovnet.py:110-130; JAX ``vovnet.py:86-110``). The input has
    ``features`` channels."""

    def __init__(self, features: int, strides: Tuple[int, int] = (1, 1),
                 norm: str = "FrozenBN", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dw_conv = Conv2d(features, features, (3, 3), strides, (1, 1),
                              groups=features, use_bias=False,
                              init="kaiming_fan_out", dtype=dtype)
        self.pw_conv = Conv2d(features, features, (1, 1), padding=(0, 0),
                              use_bias=False, init="kaiming_fan_out",
                              dtype=dtype)
        self.pw_norm = get_norm(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pw_conv(self.dw_conv(x))
        if self.pw_norm is not None:
            x = self.pw_norm(x)
        return F.relu(x)


class OSAModule(nn.Module):
    """One-Shot-Aggregation block (reference _OSA_module,
    vovnet.py:263-332). eSE is unconditional, as in the reference
    forward (vovnet.py:326). ``depthwise``: the layers are
    ``DWConvBlock``s, after a 1x1 ``reduction`` to ``stage_ch`` when the
    input is wider or narrower (the concat still takes the input as it
    came); else with ``with_dcn`` they are ``DeformConvBlock``s (JAX
    ``vovnet.py:369-375``)."""

    def __init__(self, in_channels: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, identity: bool = False,
                 depthwise: bool = False, with_dcn: bool = False,
                 with_modulated_dcn: bool = False,
                 deformable_groups: int = 1, norm: str = "FrozenBN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.identity = identity
        self.reduction = None
        if depthwise and in_channels != stage_ch:
            self.reduction = ConvNormAct(in_channels, stage_ch, (1, 1),
                                         padding=(0, 0), norm=norm,
                                         dtype=dtype)
        ch = in_channels
        for i in range(layer_per_block):
            if depthwise:
                layer = DWConvBlock(stage_ch, norm=norm, dtype=dtype)
            elif with_dcn:
                layer = DeformConvBlock(
                    ch, stage_ch, modulated=with_modulated_dcn,
                    deformable_groups=deformable_groups, norm=norm,
                    dtype=dtype)
            else:
                layer = ConvNormAct(ch, stage_ch, norm=norm, dtype=dtype)
            self.add_module(f"layer{i}", layer)
            ch = stage_ch
        self.layer_per_block = layer_per_block
        self.concat = ConvNormAct(
            in_channels + layer_per_block * stage_ch, concat_ch, (1, 1),
            padding=(0, 0), norm=norm, dtype=dtype)
        self.ese = eSEModule(concat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity_feat = x
        outputs = [x]
        if self.reduction is not None:
            x = self.reduction(x)
        for i in range(self.layer_per_block):
            x = getattr(self, f"layer{i}")(x)
            outputs.append(x)
        xt = self.ese(self.concat(torch.cat(outputs, dim=1)))
        if self.identity:
            xt = xt + identity_feat
        return xt


class VoVNet(nn.Module):
    """VoVNetV2 trunk. Returns a dict of the requested out_features.

    ``s2d_input``: the input is the host's factor-4 s2d layout
    (B, 16 * in_channels, H/4+1, W/4+1) and the stem runs in s2d
    coordinates (``s2d_stem_forward``); standard-conv bodies with
    FrozenBN only, as in the JAX package. The parameters stay the
    logical ``stem_{1,2,3}`` 3x3 kernels, so checkpoints load unchanged.
    In the captured serving program the embedded kernels come folded from
    the prepared weights (``layers/prepared.py``), made once per set of
    weights outside the graph. Everywhere else they are built from the
    parameters on every forward: inside the autograd graph in training,
    so the stem trains as the plain stem does; traced by ``torch.export``;
    recorded by any other CUDA graph, whose replays then read the stem's
    weights as they are (training updates them in place)."""

    def __init__(self, body: str = "V-39-eSE",
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4",
                                                "stage5"),
                 norm: str = "FrozenBN", in_channels: int = 3,
                 s2d_input: bool = False,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 with_modulated_dcn: bool = False,
                 deformable_groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        spec = STAGE_SPECS[body]
        if s2d_input and (spec["dw"] or norm != "FrozenBN"):
            raise ValueError(
                f"the s2d stem supports standard-conv bodies with FrozenBN "
                f"only, got {body!r} with norm {norm!r}")
        self.s2d_input = s2d_input
        self.dtype = dtype
        self.out_features = tuple(out_features)
        stem = spec["stem"]
        self.stem_1 = ConvNormAct(in_channels, stem[0], strides=(2, 2),
                                  norm=norm, dtype=dtype)
        if spec["dw"]:
            self.stem_2 = DWConvBlock(stem[1], norm=norm, dtype=dtype)
            self.stem_3 = DWConvBlock(stem[2], strides=(2, 2), norm=norm,
                                      dtype=dtype)
        else:
            self.stem_2 = ConvNormAct(stem[0], stem[1], norm=norm,
                                      dtype=dtype)
            self.stem_3 = ConvNormAct(stem[1], stem[2], strides=(2, 2),
                                      norm=norm, dtype=dtype)
        self.blocks = []
        ch = stem[2]
        for i in range(4):
            stage_num = i + 2
            names = []
            for b in range(spec["block_per_stage"][i]):
                name = f"OSA{stage_num}_{b + 1}"
                self.add_module(name, OSAModule(
                    ch, spec["stage_conv_ch"][i], spec["stage_out_ch"][i],
                    spec["layer_per_block"], identity=b > 0,
                    depthwise=spec["dw"], with_dcn=bool(stage_with_dcn[i]),
                    with_modulated_dcn=with_modulated_dcn,
                    deformable_groups=deformable_groups, norm=norm,
                    dtype=dtype))
                ch = spec["stage_out_ch"][i]
                names.append(name)
            self.blocks.append(names)

    def _stem_sources(self) -> List[torch.Tensor]:
        return [t for m in (self.stem_1, self.stem_2, self.stem_3)
                for t in (m.conv.weight, m.norm.frozen_scale,
                          m.norm.frozen_bias)]

    prepared_counts = (3, 3)  # the s2d stem's convs and FrozenBNs

    def prepared_sources(self) -> List[torch.Tensor]:
        return self._stem_sources() if self.s2d_input else []

    def prepare_weights(self, nhwc: bool) -> Tuple[torch.Tensor, ...]:
        """The s2d stem's kernels with the FrozenBNs folded, flat: k1, the
        two k2 pairs, the two k3 halves (channels-last for a channels-last
        input), the three biases."""
        srcs = [t.detach() for t in self._stem_sources()]
        kn = s2d_stem_kernels(*(tuple(srcs[i:i + 3]) for i in (0, 3, 6)),
                              self.dtype, fold=True)
        fmt = torch.channels_last if nhwc else torch.contiguous_format
        return (*(k.contiguous(memory_format=fmt)
                  for k in (kn.k1, *kn.k2, *kn.k3)),
                kn.a1[1], kn.a2[1], kn.a3[1])

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        if not self.s2d_input:
            return self.stem_3(self.stem_2(self.stem_1(x)))
        store = prepared.active()
        if store is not None:  # the captured serving program's, folded
            k1, k2a, k2b, k3a, k3b, b1, b2, b3 = store.get(
                self, prepared.is_channels_last(x), fused=4)
            return s2d_stem_forward(x, S2DStemKernels(
                k1, (k2a, k2b), (k3a, k3b), (None, b1), (None, b2),
                (None, b3)))
        srcs = self._stem_sources()
        return s2d_stem_forward(x, s2d_stem_kernels(
            *(tuple(srcs[i:i + 3]) for i in (0, 3, 6)), self.dtype))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem(x)
        tracing.mark("stem")
        outputs: Dict[str, torch.Tensor] = {}
        if "stem" in self.out_features:
            outputs["stem"] = x
        for i, names in enumerate(self.blocks):
            stage_num = i + 2
            if stage_num != 2:
                x = max_pool2d_ceil(x, kernel=3, stride=2)
            for name in names:
                x = getattr(self, name)(x)
            if f"stage{stage_num}" in self.out_features:
                outputs[f"stage{stage_num}"] = x
        return outputs
