"""The port's tracing: section stamps that survive CUDA-graph capture,
host spans, and set-up counters. One module, three records, all kept in
memory for the process's life and read by whoever asks (the benchmark's
per-layer readers, ``benchmark/metrics/``).

**Section stamps.** A CUDA graph's replay carries no host ranges, so the
profiler cannot say which part of the model a replayed kernel belongs to.
``mark(section)`` writes the time into a ``Ring`` on the device from
inside the graph instead: on CUDA by ``ops/_kernels.py::section_stamp``
(``csrc/stamp.cu``, ``%globaltimer``), on the CPU in Python with the
host's clock (the plain version, which the tests rehearse with fake
graphs). ``mark`` is a no-op unless armed, and only
``export/captured.py::CapturedInference`` arms it, around the capture
of its graph: the warm-ups, eager calls and the train step write
nothing. ``CenterMask.inference`` marks ``start`` on entry and the end
of each of ``trace_sections.REPLAY_SECTIONS``:

- ``stem``: ``_pad_to_canvas``, ``_normalize_u8_s2d``, the s2d stem's
  kernels rebuilt and the stem convs (the mark at the end of each
  backbone's stem);
- ``backbone``: the other stages, to the end of ``self.backbone(x)`` in
  ``CenterMask.features``;
- ``fpn_head``: the FPN, the FCOS tower and head and the locations, to
  the end of ``_fcos_raw``;
- ``decode``: decode, top-k and kernel 1's NMS, to the end of
  ``_decode``;
- ``roi``: the ROI heads and the outputs' assembly, to the end of
  ``inference``.

A replay writes one row: the program's key (its index among the
object's programs, in capture order) and the six stamps in nanoseconds;
the last stamp advances the ring's cursor. ``replay_sections()`` reads
the newest ring's rows as milliseconds a section.

**Host spans.** ``span(name)`` records the name, start and end
(``time.time_ns()``, the clock of the profiler's chrome trace: ``ts``
plus ``baseTimeNanoseconds``) into a bounded buffer, while tracing is
on: after ``enable()``, or while a ``torch.profiler`` session records,
which then also shows the span as a ``cm2:<name>`` range.
Off, a span is a flag check and a shared null context. The program's
spans: ``pack`` (the native pass of ``data/preprocess.py::s2d_pack_u8``)
and ``to_host`` (``evaluation/loop.py::_to_host``).

**Set-up counters** (always on, one add an event): seconds of
``capture_s`` (every ``CapturedInference`` capture, warm-ups included:
the timing of the object's own ``capture_s``) and ``model_build_s``
(``models/meta.py::build_centermask``); counts of ``weights_prepared``,
``prepared_convs`` and ``folded_norms`` (``layers/prepared.py``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import Deque, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

from .trace_sections import REPLAY_SECTIONS

STAMPS = ("start",) + REPLAY_SECTIONS  # a row's stamps, in order
_SLOT = {name: i for i, name in enumerate(STAMPS)}
RING_ROWS = 16384  # a whole cell run's replays, and its warm-ups
SPAN_CAPACITY = 65536


class Ring:
    """Rows of (key, stamp per ``STAMPS``) int64 on ``device``, and the
    cursor that counts the rows written (row ``n`` at ``n % rows``;
    ``rows``: ``RING_ROWS`` unless given). The newest ring made is the
    one ``replay_sections`` reads."""

    def __init__(self, device, rows: Optional[int] = None):
        global _ring
        dev = torch.device(device)
        self.data = torch.zeros((rows or RING_ROWS, 1 + len(STAMPS)),
                                dtype=torch.int64, device=dev)
        self.cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        # a stamp into row 0, which the first replay rewrites: the kernel
        # is built and loaded before a capture records it
        self.stamp(0, 0, last=False)
        _ring = self

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    def stamp(self, slot: int, key: int, last: bool) -> None:
        """The time into stamp ``slot`` of the cursor's row; slot 0
        writes ``key`` too, ``last`` advances the cursor."""
        if self.data.is_cuda:
            from ..ops import _kernels

            _kernels.section_stamp(self.data, self.cursor, slot, key, last)
            return
        n = int(self.cursor)
        row = self.data[n % self.rows]
        if slot == 0:
            row[0] = key
        row[1 + slot] = time.time_ns()
        if last:
            self.cursor += 1

    def read(self) -> np.ndarray:
        """The rows written, oldest first: after a wrap the newest
        ``rows``. Waits for the device."""
        if self.data.is_cuda:
            torch.cuda.synchronize(self.data.device)
        n = int(self.cursor)
        data = self.data.cpu().numpy()
        if n <= self.rows:
            return data[:n]
        return np.roll(data, -(n % self.rows), axis=0)


_ring: Optional[Ring] = None
_armed = None  # (thread, ring, key) while a capture records its stamps


@contextmanager
def armed(ring: Ring, key: int):
    """``mark`` stamps into ``ring`` with program key ``key``, on this
    thread, inside the block."""
    global _armed
    _armed = (threading.get_ident(), ring, int(key))
    try:
        yield
    finally:
        _armed = None


def mark(section: str) -> None:
    """The end of ``section`` (or ``start``) of the armed program; a
    no-op unless armed on this thread."""
    a = _armed
    if a is None or a[0] != threading.get_ident():
        return
    slot = _SLOT[section]
    a[1].stamp(slot, a[2], slot == len(STAMPS) - 1)


def replay_sections() -> Optional[Dict[str, np.ndarray]]:
    """The newest ring's rows, oldest first: ``key`` and milliseconds for
    each of ``REPLAY_SECTIONS``; None when no ring has a row."""
    rows = None if _ring is None else _ring.read()
    if rows is None or not len(rows):
        return None
    ms = np.diff(rows[:, 1:], axis=1) * 1e-6
    out = {"key": rows[:, 0]}
    out.update({name: ms[:, i] for i, name in enumerate(REPLAY_SECTIONS)})
    return out


def section_mean_ms(section: str) -> Optional[float]:
    s = replay_sections()
    return None if s is None else float(np.mean(s[section]))


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


_enabled = False
_spans: Deque[Span] = deque(maxlen=SPAN_CAPACITY)
_NULL = nullcontext()


def enable(on: bool = True) -> None:
    """Record spans (a profiler session records them without this)."""
    global _enabled
    _enabled = bool(on)


class _Span:
    __slots__ = ("name", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function("cm2:" + self.name)
            self.range.__enter__()
        self.start = time.time_ns()  # inside the range: it holds the span
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _spans.append(Span(self.name, self.start, end))
        return False


def span(name: str):
    """A context that records the span ``name`` while tracing is on."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def spans(name: Optional[str] = None) -> List[Span]:
    """The spans recorded, oldest first (the newest ``SPAN_CAPACITY``)."""
    return [s for s in list(_spans) if name is None or s.name == name]


def span_median_ms(name: str) -> Optional[float]:
    ns = [s.end_ns - s.start_ns for s in spans(name)]
    return float(np.median(ns)) * 1e-6 if ns else None


_counters: Dict[str, float] = {}


def count(name: str, seconds: float) -> None:
    """Add ``seconds`` (or a count) to the set-up counter ``name``."""
    _counters[name] = _counters.get(name, 0.0) + float(seconds)


def counter(name: str) -> Optional[float]:
    """A counter's value; None when nothing was counted."""
    return _counters.get(name)


def reset() -> None:
    """Forget the ring, the spans and the counters, and stop recording
    spans."""
    global _ring, _enabled
    _ring = None
    _enabled = False
    _spans.clear()
    _counters.clear()
