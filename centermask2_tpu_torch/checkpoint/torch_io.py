"""Training checkpoints: save, load and find the newest (the counterpart
of ``centermask2_tpu/checkpoint/orbax_io.py``).

A checkpoint is a directory ``step_N`` holding ``state.pt``: the model's
state_dict, the optimizer's and the scheduler's, and the step, as
``torch.save`` writes them. It is written to a temporary name and renamed,
so a cut run never leaves half a checkpoint under a ``step_N`` name, and
read with ``weights_only=True`` (tensors and plain values only).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(directory: str, state: Dict[str, Any], step: int) -> str:
    """Save ``state`` under ``directory/step_{step}``; returns that path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    """The state saved under ``path`` (a ``step_N`` directory)."""
    return torch.load(os.path.join(path, STATE_FILE),
                      map_location=map_location, weights_only=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``step_N`` directory of ``directory`` with the largest N and a
    complete state file, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_"):
            continue
        try:
            n = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if os.path.exists(os.path.join(directory, name, STATE_FILE)):
            steps.append(n)
    if not steps:
        return None
    return os.path.join(os.path.abspath(directory), f"step_{max(steps)}")


def train_state(model, optimizer, scheduler, step: int) -> Dict[str, Any]:
    """The state ``save_checkpoint`` keeps for a training run."""
    return {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
            "scheduler": scheduler.state_dict(), "step": int(step)}


def restore_train_state(state: Dict[str, Any], model, optimizer,
                        scheduler) -> int:
    """Load a ``train_state`` into the objects; returns its step."""
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    scheduler.load_state_dict(state["scheduler"])
    return int(state["step"])
