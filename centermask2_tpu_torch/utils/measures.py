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
differ by that work. ``measure_model`` adds the peak device memory of
the run on CUDA (``torch.cuda.max_memory_allocated``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from ..checkpoint.from_jax import params_entries

# Peak dense bf16 tensor-core rates (FLOP/s) of one card, by a substring
# of torch.cuda.get_device_name, most specific first. Source: NVIDIA's
# H100 data sheet (SXM 989 TFLOP/s, PCIe 756 TFLOP/s, without sparsity),
# at the card's full power limit.
_CHIP_PEAKS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),
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


def chip_peak_flops(device: Optional[torch.device] = None) -> float:
    """Peak dense bf16 FLOP/s of a CUDA ``device`` (default: the current
    one) from its name; 0.0 when the device is unknown or not a GPU,
    and callers then report no utilization."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    kind = torch.cuda.get_device_name(device).lower()
    for key, peak in _CHIP_PEAKS:
        if key in kind:
            return peak
    return 0.0
