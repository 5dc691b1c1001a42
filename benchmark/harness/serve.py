"""The serving loop: one configuration of ``centermask2_tpu_torch``
served under one traffic mix for one window.

Set-up builds the model (``models/meta.py::build_centermask``), loads
the seed's weights (``weights.py``), wraps ``CenterMask.inference`` in
``export/captured.py::CapturedInference`` and captures one graph for
each input canvas the traffic sends, warming every one up. The window
then sends the traffic's requests, each through the host path the
configuration serves by:

- TPU.S2D_STEM_INPUT: the uint8 pack over the quantized tight canvas
  (``data/preprocess.py::s2d_pack_u8`` over ``s2d_serving_canvas``),
  normalized on the device, which pads it back to the deploy square
  (``pad_to_deploy``) or runs at the tight canvas (``tight_compute``);
- otherwise: the float32 normalize and pad of the host
  (``single_preprocessing``) over the deploy square;

then the pinned copy to the card, the replay, and the outputs' copy into
pinned host buffers behind an event (``evaluation/loop.py::_to_host``).
A request is done when that event has fired: a thread waits on the
events in order and stamps each. An open loop times a request from the
moment it was due on its schedule; a closed loop keeps ``in_flight``
requests outstanding and counts those done inside the window.

The window keeps every number the readers need (``Record``), and a
sample of the requests' outputs, drawn from the seed as they complete
(a reservoir), with the largest image among them, for the comparison.
"""

from __future__ import annotations

import queue
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import traffic as traffic_mod
from . import weights
from .timing import event


class Record:
    """What a window measured; the per-layer readers take it."""

    def __init__(self):
        self.lat_ms = np.zeros(0)  # each counted request, from due to done
        self.host_ms = np.zeros(0)  # host span of each request's calls
        self.replay_ms = np.zeros(0)  # device time of each replay
        self.busy_ms = np.zeros(0)  # device time of each request
        self.flops = None  # FLOPs of each request's program, traced runs
        self.window_s = 0.0  # wall time of the window
        self.span_s = 0.0  # from the window's start to the last request done
        self.completed = 0  # requests done inside the window
        self.lateness_ms = np.zeros(0)  # how late each request was sent
        self.peaks = None  # the card's peaks (flops.Peaks)
        self.trace = None  # trace.Summary of the traced slice
        self.nms_shape = (1, 0)  # (images, boxes) of kernel 1's call
        self.canvases = []  # the compute canvas of each request
        self.attempted = 0  # requests sent
        self.failed = 0  # requests sent and never done


def _run_ctx(name: str, on: bool):
    return torch.profiler.record_function(name) if on else nullcontext()


class Feed:
    """The host path of one configuration under one traffic mix."""

    def __init__(self, cfg, traffic: Dict, dev: torch.device):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.u8 = bool(cfg.TPU.S2D_STEM_INPUT)
        self.edge = int(cfg.TPU.FIXED_EDGE_SIZE)
        self.short = int(traffic["sizes"]["short"])
        self.tight = traffic["canvas"] == "tight_compute"
        if self.tight and not self.u8:
            raise ValueError("tight_compute serves the uint8 s2d pack: the "
                             "configuration needs TPU.S2D_STEM_INPUT")

    def pack_canvas(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        from centermask2_tpu_torch.data.preprocess import s2d_serving_canvas

        if not self.u8:
            return (self.edge, self.edge)
        return s2d_serving_canvas(hw[0], hw[1], self.edge, self.short)

    def compute_canvas(self, hw: Tuple[int, int]) -> Tuple[int, int]:
        return self.pack_canvas(hw) if self.tight else (self.edge, self.edge)

    def host_input(self, img: np.ndarray) -> Tuple[torch.Tensor,
                                                   Optional[torch.Tensor]]:
        """(network input, valid_hw) on the host, pinned on the card's
        machine."""
        from centermask2_tpu_torch.data.preprocess import (
            s2d_pack_u8, single_preprocessing)

        if self.u8:
            x = torch.from_numpy(s2d_pack_u8(img, self.pack_canvas(
                img.shape[:2])))
            vh = torch.tensor([img.shape[:2]], dtype=torch.int32)
        else:
            x = torch.from_numpy(single_preprocessing(img, self.edge)[None])
            vh = None
        if self.cuda:
            x = x.pin_memory()
            vh = None if vh is None else vh.pin_memory()
        return x, vh

    def to_device(self, x, vh):
        x = x.to(self.dev, non_blocking=True)
        return x, None if vh is None else vh.to(self.dev, non_blocking=True)

    def call(self, prog, x, vh):
        canvas = None if self.tight or not self.u8 else (self.edge,
                                                         self.edge)
        return prog(x, None, vh, canvas)


def _to_host(out, cuda: bool):
    from centermask2_tpu_torch.evaluation.loop import _to_host as to_host

    return to_host(out, cuda)[0]


class Sampler:
    """A reservoir of ``size`` requests' outputs, drawn from the seed as
    they complete in order, and the first of the largest images."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 2])
        self.seen = 0
        self.kept: Dict[int, Dict] = {}
        self.slots: List[int] = []
        self.largest: Optional[Tuple[int, int, Dict]] = None

    def offer(self, index: int, area: int, outputs: Dict) -> None:
        if self.largest is None or area > self.largest[0]:
            self.largest = (area, index, outputs)
        n = self.seen
        self.seen += 1
        if n < self.size:
            self.slots.append(index)
        else:
            j = int(self.rng.integers(0, n + 1))
            if j >= self.size:
                return
            del self.kept[self.slots[j]]
            self.slots[j] = index
        self.kept[index] = outputs

    def sample(self) -> Dict[int, Dict]:
        out = dict(self.kept)
        if self.largest is not None:
            out[self.largest[1]] = self.largest[2]
        return out


class Server:
    """Set-up and window of the serving loop."""

    def __init__(self, cfg, traffic: Dict, seed: int, dev: torch.device,
                 program=None):
        from centermask2_tpu_torch.export import CapturedInference
        from centermask2_tpu_torch.models.meta import build_centermask

        traffic_mod.check(traffic)
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        self.cuda = dev.type == "cuda"
        self.feed = Feed(cfg, traffic, dev)
        self.model = build_centermask(cfg, device=dev)
        self.entries = weights.recipe(self.model)
        self.model.load_state_dict(weights.make(self.entries, seed, dev),
                                   strict=True)
        self.prog = program(self.model) if program is not None else (
            CapturedInference(self.model) if self.cuda
            else self.model.inference)
        self.images = traffic_mod.images(traffic, seed)

    def warm_up(self, calls: int = 3) -> None:
        """Capture and replay every canvas the traffic sends."""
        by_canvas = {}
        for (hw, v), img in self.images.items():
            by_canvas.setdefault(self.feed.pack_canvas(hw), img)
        for img in by_canvas.values():
            for _ in range(calls):
                x, vh = self.feed.to_device(*self.feed.host_input(img))
                _to_host(self.feed.call(self.prog, x, vh), self.cuda)
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def count_flops(self) -> Dict[Tuple[int, int], int]:
        """FLOPs of the program at each compute canvas, by one eager call
        each (the replay runs the same operations)."""
        from .flops import count_flops

        out = {}
        for (hw, v), img in self.images.items():
            canvas = self.feed.compute_canvas(hw)
            if canvas in out:
                continue
            x, vh = self.feed.to_device(*self.feed.host_input(img))
            out[canvas] = count_flops(
                self.model, lambda: self.feed.call(self.model.inference, x,
                                                   vh))
        return out

    def window(self, seconds: float, sample: Sampler,
               profiler=None) -> Record:
        """Send the traffic for ``seconds``. With ``profiler`` (a
        ``torch.profiler.profile`` not yet started) the whole window is
        traced and the host's steps are named in the trace."""
        arr = self.traffic["arrivals"]
        closed = arr["kind"] == "closed"
        reqs = traffic_mod.schedule(self.traffic, self.seed, seconds)
        done: Dict[int, float] = {}
        issued: List[tuple] = []  # (request, sent, host ms, events)
        flight = threading.Semaphore(int(arr["in_flight"])) if closed \
            else None
        q: "queue.Queue" = queue.Queue()
        failure: List[BaseException] = []
        named = profiler is not None

        def complete():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        return
                    i, last, outputs, area = item
                    last.synchronize()
                    done[i] = time.perf_counter()
                    sample.offer(i, area, outputs)
                    if flight is not None:
                        flight.release()
            except BaseException as e:  # re-raised by the window
                failure.append(e)
                if flight is not None:
                    flight.release()

        waiter = threading.Thread(target=complete, name="bench-complete",
                                  daemon=True)
        waiter.start()
        tracing = named
        if named:
            profiler.start()
        t_open = time.perf_counter()
        i = 0
        try:
            while closed or i < len(reqs):
                r = reqs[i % len(reqs)]
                if closed:
                    with _run_ctx("bench:wait_in_flight", tracing):
                        flight.acquire()
                    if time.perf_counter() - t_open >= seconds:
                        break
                else:
                    due = t_open + r.due_s
                    with _run_ctx("bench:wait_arrival", tracing):
                        while True:
                            left = due - time.perf_counter()
                            if left <= 0:
                                break
                            time.sleep(min(left, 0.002))
                if failure:
                    break
                t0 = time.perf_counter()
                img = self.images[(r.hw, r.variant)]
                with _run_ctx("bench:host_input", tracing):
                    x, vh = self.feed.host_input(img)
                evs = tuple(event(self.cuda) for _ in range(4))
                evs[0].record()
                with _run_ctx("bench:copy_in", tracing):
                    x, vh = self.feed.to_device(x, vh)
                evs[1].record()
                with _run_ctx("bench:replay", tracing):
                    out = self.feed.call(self.prog, x, vh)
                evs[2].record()
                with _run_ctx("bench:copy_out", tracing):
                    outputs = _to_host(out, self.cuda)
                evs[3].record()
                t1 = time.perf_counter()
                issued.append((r._replace(index=i), t0 - t_open,
                               (t1 - t0) * 1e3, evs))
                q.put((i, evs[3], outputs, r.hw[0] * r.hw[1]))
                i += 1
        finally:
            q.put(None)
            waiter.join()
            if named:
                profiler.stop()
        if failure:
            raise failure[0]
        return self._record(issued, done, t_open, seconds, closed)

    def _record(self, issued, done, t_open: float, seconds: float,
                closed: bool) -> Record:
        rec = Record()
        n = len(issued)
        t_done = np.array([done.get(k, np.nan) for k in range(n)])
        sent = np.array([s for _, s, _, _ in issued])
        if closed:
            rec.completed = int(np.sum(t_done <= t_open + seconds))
            rec.window_s = float(seconds)
            start = sent
        else:
            start = np.array([r.due_s for r, _, _, _ in issued])
            rec.completed = n
            rec.window_s = float(np.nanmax(t_done) - t_open) if n else 0.0
            rec.lateness_ms = (sent - start) * 1e3
        rec.span_s = float(np.nanmax(t_done) - t_open) if n else 0.0
        rec.lat_ms = (t_done - t_open - start) * 1e3
        rec.host_ms = np.array([h for _, _, h, _ in issued])
        rec.replay_ms = np.array([e[1].elapsed_time(e[2])
                                  for _, _, _, e in issued])
        rec.busy_ms = np.array([e[0].elapsed_time(e[3])
                                for _, _, _, e in issued])
        rec.canvases = [self.feed.compute_canvas(r.hw)
                        for r, _, _, _ in issued]
        rec.attempted = n
        rec.failed = int(np.sum(np.isnan(t_done)))
        self.requests = {r.index: r for r, _, _, _ in issued}
        return rec

    def close(self) -> None:
        """Free the program's state (graphs, pool, weights)."""
        self.prog = None
        self.model = None
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()
