"""Random weights of a configuration, made on the device from the seed.

Every floating entry of the program's ``state_dict`` gets a value from
one recipe, so that nothing the program's own initializer drew reaches
either side of the comparison. The recipe keeps every layer's output at
the scale of its input, as a trained network's folded batch norms do:

- the weight of a convolution, deconvolution or dense layer: a normal
  draw of variance g / fan_in, g = 2 where the module is one that a ReLU
  follows (its ``init`` is ``kaiming_fan_out``), else 1; a deconvolution's
  fan-in is its input channels times its taps over its stride's area;
- the first FrozenBN scale (the stem's): 1/64, which brings pixels of
  +-128 to unit scale; the FrozenBN scale that closes a ResNet
  bottleneck's branch (``conv3``): 1/4, so that sixteen identity
  shortcuts grow the activations 1.6 times and not 256 (a trained
  ResNet's last norm of a branch is small for the same reason); every
  other FrozenBN scale, GroupNorm scale and FCOS per-level ``scale``: 1;
- every bias and FrozenBN shift: 0. The FCOS classification bias is 0
  too, not the focal-loss prior (-4.6), so that the decode keeps real
  candidates above its 0.05 threshold.

The program's own initializer (He by fan-out, and 0.01 and 0.001 stds on
the heads' last layers) leaves random activations of some hundreds by
the fifth VoVNet stage, where the eSE gate's hard sigmoid then switches
channels on and off with the smallest change of its input: the float32
reference and a bfloat16 run part far more than their precisions, and
the comparison could not tell bfloat16 from float8.

All of it is one normal draw from a ``torch.Generator`` on the device,
scaled and shifted by two per-element vectors: three large calls, in
float32, the type the parameters are kept in.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch

SEED_MOD = 2 ** 63


class Entry(NamedTuple):
    name: str
    shape: tuple
    std: float
    const: float


STEM_SCALE = 1.0 / 64
BRANCH_SCALE = 1.0 / 4


def _std(m: torch.nn.Module, weight: torch.Tensor) -> float:
    gain = 2.0 if m.init == "kaiming_fan_out" else 1.0
    taps = weight.shape[2] * weight.shape[3] if weight.dim() == 4 else 1
    if type(m).__name__ == "ConvTranspose2d":  # (I, O, kh, kw)
        fan_in = weight.shape[0] * taps / (m.stride[0] * m.stride[1])
    else:  # (O, I / groups, kh, kw) or (O, I)
        fan_in = weight.shape[1] * taps
    return math.sqrt(gain / fan_in)


def recipe(model: torch.nn.Module) -> List[Entry]:
    """One entry per ``state_dict`` key of ``model``, in its order."""
    stds = {}
    for mname, m in model.named_modules():
        w = getattr(m, "weight", None)
        if hasattr(m, "init") and isinstance(w, torch.Tensor):
            stds[f"{mname}.weight" if mname else "weight"] = _std(m, w)
    out = []
    stem = True
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if not t.is_floating_point():
            raise ValueError(f"{name}: a {t.dtype} entry has no recipe")
        if name in stds:
            out.append(Entry(name, shape, stds[name], 0.0))
        elif leaf == "frozen_scale":
            scale = STEM_SCALE if stem else (
                BRANCH_SCALE if name.endswith(".conv3.norm.frozen_scale")
                else 1.0)
            out.append(Entry(name, shape, 0.0, scale))
            stem = False
        elif leaf == "scale" or name.endswith("gn.weight"):
            out.append(Entry(name, shape, 0.0, 1.0))
        elif leaf in ("bias", "frozen_bias"):
            out.append(Entry(name, shape, 0.0, 0.0))
        else:
            raise ValueError(f"{name}: no recipe for this entry")
    return out


def make(entries: List[Entry], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} on ``device`` from ``seed``: views of one
    flat tensor."""
    numel = torch.tensor([math.prod(e.shape) for e in entries],
                         device=device)
    std = torch.tensor([e.std for e in entries], device=device)
    const = torch.tensor([e.const for e in entries], device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    total = int(numel.sum())
    flat = torch.randn(total, generator=gen, device=device)
    flat = torch.addcmul(const.repeat_interleave(numel, output_size=total),
                         flat, std.repeat_interleave(numel,
                                                     output_size=total))
    parts = flat.split([math.prod(e.shape) for e in entries])
    return {e.name: p.view(e.shape) for e, p in zip(entries, parts)}
