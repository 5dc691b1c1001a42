"""Training metrics storage, the detectron2 EventStorage analog (the
port's counterpart of ``centermask2_tpu/utils/events.py``): scalars put
during an iteration are written as one JSON line to ``metrics.jsonl``
when the iteration ends."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class EventStorage:
    def __init__(self, output_file: Optional[str] = None,
                 start_iter: int = 0):
        self._iter = start_iter
        self._latest: Dict[str, float] = {}
        self._file = None
        if output_file:
            os.makedirs(os.path.dirname(os.path.abspath(output_file)),
                        exist_ok=True)
            self._file = open(output_file, "a")

    def put_scalar(self, name: str, value) -> None:
        self._latest[name] = float(value)

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def step(self) -> None:
        """Write the iteration's scalars (if any) and advance."""
        if self._file is not None and self._latest:
            rec = {"iteration": self._iter, "time": time.time()}
            rec.update(self._latest)
            self._file.write(json.dumps(rec) + "\n")
            self._file.flush()
        self._iter += 1
        self._latest = {}

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> "EventStorage":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
