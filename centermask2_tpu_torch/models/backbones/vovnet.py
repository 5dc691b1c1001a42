"""VoVNetV2 backbone (One-Shot Aggregation + eSE), NCHW (the port of
``centermask2_tpu/models/backbones/vovnet.py``).

Plain stem of 3 convs at strides 2/1/2, OSA modules (input + k
sequential 3x3 convs concatenated, 1x1 aggregate, eSE gate, identity
residual on non-first blocks), and a ceil-mode 3x3/s2 max-pool opening
stages 3-5. Only the standard-conv bodies are ported here; the
depthwise bodies, DCN stages and the space-to-depth stem raise
``NotImplementedError`` (ROADMAP queue 1, items 9, 11 and 12).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ...layers import ConvNormAct, eSEModule, max_pool2d_ceil

# Stage specs of the standard-conv bodies (reference vovnet.py:30-108,
# JAX vovnet.py:43-72).
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
    "V-19-slim-eSE": VoVNet19_slim_eSE,
    "V-19-eSE": VoVNet19_eSE,
    "V-39-eSE": VoVNet39_eSE,
    "V-57-eSE": VoVNet57_eSE,
    "V-99-eSE": VoVNet99_eSE,
}

# stride of each out feature (vovnet.py:437-438,471-481)
FEATURE_STRIDES = {"stem": 4, "stage2": 4, "stage3": 8, "stage4": 16,
                   "stage5": 32}


def _spec(body: str) -> Dict:
    if body not in STAGE_SPECS:
        raise NotImplementedError(
            f"VoVNet body {body!r} is not ported yet: the depthwise bodies "
            "come with ROADMAP queue 1, item 11")
    return STAGE_SPECS[body]


def feature_channels(body: str) -> Dict[str, int]:
    spec = _spec(body)
    out = {"stem": spec["stem"][2]}
    for i, c in enumerate(spec["stage_out_ch"]):
        out[f"stage{i + 2}"] = c
    return out


class OSAModule(nn.Module):
    """One-Shot-Aggregation block (reference _OSA_module,
    vovnet.py:263-332). eSE is unconditional, as in the reference
    forward (vovnet.py:326)."""

    def __init__(self, in_channels: int, stage_ch: int, concat_ch: int,
                 layer_per_block: int, identity: bool = False,
                 norm: str = "FrozenBN", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.identity = identity
        ch = in_channels
        for i in range(layer_per_block):
            self.add_module(f"layer{i}", ConvNormAct(
                ch, stage_ch, norm=norm, dtype=dtype))
            ch = stage_ch
        self.layer_per_block = layer_per_block
        self.concat = ConvNormAct(
            in_channels + layer_per_block * stage_ch, concat_ch, (1, 1),
            padding=(0, 0), norm=norm, dtype=dtype)
        self.ese = eSEModule(concat_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity_feat = x
        outputs = [x]
        for i in range(self.layer_per_block):
            x = getattr(self, f"layer{i}")(x)
            outputs.append(x)
        xt = self.ese(self.concat(torch.cat(outputs, dim=1)))
        if self.identity:
            xt = xt + identity_feat
        return xt


class VoVNet(nn.Module):
    """VoVNetV2 trunk with the plain stem. Returns a dict of the requested
    out_features."""

    def __init__(self, body: str = "V-39-eSE",
                 out_features: Sequence[str] = ("stage2", "stage3", "stage4",
                                                "stage5"),
                 norm: str = "FrozenBN", in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        spec = _spec(body)
        self.out_features = tuple(out_features)
        stem = spec["stem"]
        self.stem_1 = ConvNormAct(in_channels, stem[0], strides=(2, 2),
                                  norm=norm, dtype=dtype)
        self.stem_2 = ConvNormAct(stem[0], stem[1], norm=norm, dtype=dtype)
        self.stem_3 = ConvNormAct(stem[1], stem[2], strides=(2, 2), norm=norm,
                                  dtype=dtype)
        self.blocks = []
        ch = stem[2]
        for i in range(4):
            stage_num = i + 2
            names = []
            for b in range(spec["block_per_stage"][i]):
                name = f"OSA{stage_num}_{b + 1}"
                self.add_module(name, OSAModule(
                    ch, spec["stage_conv_ch"][i], spec["stage_out_ch"][i],
                    spec["layer_per_block"], identity=b > 0, norm=norm,
                    dtype=dtype))
                ch = spec["stage_out_ch"][i]
                names.append(name)
            self.blocks.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = self.stem_3(self.stem_2(self.stem_1(x)))
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
