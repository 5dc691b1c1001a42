"""The yardstick's arithmetic, kept with the benchmark so that a change to
the program cannot move it: the card's published peaks, the FLOP count
of a program, and the operations and bytes of the hand kernels.

- ``PEAKS``: NVIDIA's H100 data sheet, dense rates without sparsity, at
  the card's full power limit (SXM 700 W: 989 bf16, 495 TF32, 67 f32
  TFLOP/s, 3.35 TB/s; PCIe: 756, 378, 51, 2.0 TB/s), by a substring of
  ``torch.cuda.get_device_name``, most specific first (a copy of the
  port's ``utils/measures.py::_CHIP_PEAKS``).
- ``count_flops``: ``FlopCounterMode`` over one eager call, which counts
  the convolutions and matrix products at two FLOPs a multiply-add and
  no elementwise work (a copy of ``utils/measures.py::count_flops``).
- ``nms_cost``: kernel 1 (``cm2::nms_keep_sorted``) over B images of N
  score-sorted boxes: 13 operations for each of the N (N - 1) / 2 IoU
  tests and 3 a box, 16 + 1 + 1 bytes a box (boxes and validity in, the
  keep flags out), as ``chip_smoke.py::nms_row`` counts them.
- ``vector_bound_s``: the least time of a kernel of f32 vector
  arithmetic: the larger of its bytes over HBM's rate and its operations
  over the f32 rate outside the tensor cores.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


class Peaks(NamedTuple):
    bf16: float
    tf32: float
    f32: float
    hbm_bytes_s: float


PEAKS = (
    ("h100 pcie", Peaks(756e12, 378e12, 51e12, 2.0e12)),
    ("h100", Peaks(989e12, 495e12, 67e12, 3.35e12)),
)


def peaks_of(kind: str) -> Optional[Peaks]:
    kind = kind.lower()
    for key, peaks in PEAKS:
        if key in kind:
            return peaks
    return None


def count_flops(model: torch.nn.Module, fn: Callable, *args) -> int:
    """FLOPs of one call ``fn(*args)`` that runs ``model``."""
    # the counter's module tracker hooks every module output that requires
    # grad, and a view of a parameter does even under no_grad
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


def nms_cost(images: int, n: int) -> Tuple[float, float]:
    """(operations, bytes) of kernel 1 over ``images`` x ``n`` boxes."""
    pairs = images * n * (n - 1) // 2
    return float(13 * pairs + 3 * images * n), float(images * n * 18)


def vector_bound_s(peaks: Peaks, ops: float, nbytes: float) -> float:
    return max(ops / peaks.f32, nbytes / peaks.hbm_bytes_s)
