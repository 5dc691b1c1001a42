"""Parameter, FLOP and memory measures of a model (the counterpart of
``centermask2_tpu/utils/measures.py``).

``count_params`` and ``param_bytes`` run over the entries that
``checkpoint/from_jax.py`` maps from the JAX package's ``params``
collection (``params_entries``), so they count what the JAX package
counts: FrozenBN's folded scale and bias included, BatchNorm's running
statistics not. ``count_flops`` is the one FLOP counter of the port
(``export/aot.py::inference_flops`` calls it): ``FlopCounterMode`` over
one run, which counts the convolutions and matrix products (two FLOPs
per multiply-add). It is not XLA's cost analysis, which the JAX
package reads and which also counts elementwise work, so the two totals
differ by that work. ``count_grad_flops`` counts a forward with its
backward the same way. ``measure_model`` adds the peak device memory of
the run on CUDA (``torch.cuda.max_memory_allocated``).

``peaks_of`` gives a card's published peaks by its name: dense FLOP/s in
bf16, in TF32 and in f32 outside the tensor cores, and the HBM bytes/s
(``Peaks``); ``chip_peaks`` those of the current card and
``chip_peak_flops`` its bf16 rate. The roofline bounds of
``tools/roofline_bound.py`` and of ``chip_smoke.py`` read them.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..checkpoint.from_jax import params_entries



class Peaks(NamedTuple):
    """Published dense peaks of one card: FLOP/s by the type the tensor
    cores (or, for ``f32``, the plain FP32 units) compute in, and the
    device memory's bytes/s."""

    bf16: float
    tf32: float
    f32: float
    hbm_bytes_s: float

    def flops(self, dtype: torch.dtype, tf32: bool = False) -> float:
        """The peak for a product computed in ``dtype``: bf16 and fp16 on
        the tensor cores; float32 there in TF32 when ``tf32`` allows it,
        else on the FP32 units."""
        if dtype in (torch.bfloat16, torch.float16):
            return self.bf16
        return self.tf32 if tf32 else self.f32


# Peaks of one card by a substring of torch.cuda.get_device_name, most
# specific first. Source: NVIDIA's H100 data sheet, dense rates without
# sparsity, at the card's full power limit (SXM 700 W: 989 bf16, 495
# TF32, 67 f32 TFLOP/s, 3.35 TB/s; PCIe: 756, 378, 51, 2.0 TB/s).
_CHIP_PEAKS = (
    ("h100 pcie", Peaks(756e12, 378e12, 51e12, 2.0e12)),
    ("h100", Peaks(989e12, 495e12, 67e12, 3.35e12)),
)


def count_params(model: nn.Module) -> int:
    return sum(t.numel() for t in params_entries(model).values())


def param_bytes(model: nn.Module) -> int:
    return sum(t.numel() * t.element_size()
               for t in params_entries(model).values())


def count_flops(model: nn.Module, fn: Callable, *args) -> int:
    """FLOPs of one call ``fn(*args)`` that runs ``model``, counted by
    ``FlopCounterMode``."""
    # the counter's module tracker hooks every module output that requires
    # grad, and a view of a parameter (GroupNorm's bias over a group of
    # one value) does even under no_grad
    tracked = [p for p in model.parameters() if p.requires_grad]
    for p in tracked:
        p.requires_grad_(False)
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            fn(*args)
    finally:
        for p in tracked:
            p.requires_grad_(True)
    return int(counter.get_total_flops())


def count_grad_flops(fn: Callable, *args) -> int:
    """FLOPs of one call ``fn(*args)`` that runs a forward and its
    backward (the caller's ``backward()`` inside ``fn``), counted by
    ``FlopCounterMode``: the backward's products count as well."""
    with torch.enable_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def measure_model(model: nn.Module, fn: Callable, *args) -> Dict[str, float]:
    """``{"flops", "peak_bytes"}`` of one call ``fn(*args)``: the FLOPs
    (``count_flops``) and, on CUDA, the device memory the call allocated
    at its peak above what was allocated before it (not measured on the
    CPU: the key is absent)."""
    dev = next(model.parameters()).device
    out = {"flops": float(count_flops(model, fn, *args))}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        with torch.no_grad():
            fn(*args)
        torch.cuda.synchronize(dev)
        out["peak_bytes"] = float(torch.cuda.max_memory_allocated(dev) - base)
    return out


def peaks_of(kind: str) -> Optional[Peaks]:
    """The published peaks of a card by its ``get_device_name`` (or
    ``nvidia-smi``) name; None for a card the table does not know."""
    kind = kind.lower()
    for key, peaks in _CHIP_PEAKS:
        if key in kind:
            return peaks
    return None


def chip_peaks(device: Optional[torch.device] = None) -> Optional[Peaks]:
    """The peaks of a CUDA ``device`` (default: the current one); None
    when it is not a GPU or the table does not know it."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return peaks_of(torch.cuda.get_device_name(device))


def chip_peak_flops(device: Optional[torch.device] = None) -> float:
    """Peak dense bf16 FLOP/s of a CUDA ``device`` (default: the current
    one) from its name; 0.0 when the device is unknown or not a GPU,
    and callers then report no utilization."""
    peaks = chip_peaks(device)
    return peaks.bf16 if peaks is not None else 0.0
