"""Device resolution for the port's entry points.

Every entry point (``build_centermask``, the model, the ops that allocate)
runs on the GPU unless the caller asks for the CPU by name. With no CUDA
device and no explicit request it raises: the port never carries on
quietly on the CPU when the GPU was meant.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent); otherwise the
    requested device, which for ``cuda`` must exist."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the "
                "CPU (its kernels then take their plain PyTorch versions)")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
