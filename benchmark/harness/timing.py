"""Device events on the card, and their host-clock stand-ins for a
rehearsal on the CPU (where no number is a device number)."""

from __future__ import annotations

import time

import torch


class HostEvent:
    """A ``torch.cuda.Event`` look-alike on the host clock."""

    def __init__(self):
        self.t = None

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def event(cuda: bool):
    return torch.cuda.Event(enable_timing=True) if cuda else HostEvent()
