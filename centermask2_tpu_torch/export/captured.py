"""Captured programs: the serving forward as CUDA graphs (the port's
counterpart of the JAX package's one jitted dispatch per request,
``tools/infer.py:115``).

``CapturedInference(model)`` records ``model.inference`` into one CUDA
graph per input signature it is called with (shapes and dtypes of the
image and of ``valid_hw``, and the canvas: the full canvas, each tight
s2d canvas, pad-back or tight compute). A graph owns static input
buffers and static outputs; a call copies the request into the inputs,
replays, and returns the static outputs (a keypoint model's
``pred_keypoints`` among them), which the next replay
overwrites: the caller copies them out first (``evaluation/loop.py``
queues the copy to the host behind an event, which the stream orders
before the next replay). All the graphs of one object share one memory
pool, since they replay one after another.

Before a capture the forward runs on a side stream (``WARMUP_CALLS``
times):
cuDNN's algorithm choice, the kernels' build at first use and their
``cudaFuncSetAttribute`` (``csrc/nms.cu``, ``csrc/roi_align.cu``) and
the allocator's first blocks happen there, outside the graph. A capture
that fails raises: there is no fallback to the eager call. On a CPU
model there are no graphs and the class raises; callers run
``model.inference`` there.

Each graph also holds the section stamps of ``utils/tracing.py``: the
capture, and only the capture, arms ``tracing.mark``, so the graph
records six one-thread stamp kernels (``csrc/stamp.cu``): the start of
``inference`` and the end of its stem, backbone, FPN and FCOS head,
decode and ROI heads. Every replay then writes one row of the object's
ring (``tracing.Ring``, 16384 rows of the program's key and six
``%globaltimer`` stamps, made at the first capture): a row a replay, the
newest kept when it wraps, read by ``tracing.replay_sections()`` (which
keeps the newest ring after the object is dropped). The stamps run in
the replay's stream order, so requests in flight do not mix their rows.
Each capture's seconds, warm-ups included, add to ``capture_s`` and to
the process's ``tracing`` counter of the same name.

``CudaGraphs`` is the CUDA side of capturing (side stream, pool,
``torch.cuda.graph``); ``train/trainer.py`` captures the train step
through it too. A caller may pass another object with the same two
methods (the tests rehearse the buffer handling with one on the CPU).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..utils import tracing

WARMUP_CALLS = 2  # side-stream calls of the forward before each capture


def supports_graphs(device) -> bool:
    """Whether captured programs run on ``device``: CUDA only."""
    return torch.device(device).type == "cuda"


class CudaGraphs:
    """Warm-up on one side stream and capture into one shared memory pool
    (``torch.cuda.graph_pool_handle``). Every warm-up runs on the same
    side stream, so that the allocator's blocks cached by one are there
    for the next (they are kept by stream). The capture is thread-local,
    so another thread's pinned allocations (the eval loop's prefetch) do
    not break it."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(self.device)

    def warm_up(self, fn: Callable[[], Any], n: int) -> Any:
        side = self.side
        side.wait_stream(torch.cuda.current_stream(self.device))
        out = None
        with torch.cuda.stream(side):
            for _ in range(n):
                out = fn()
        torch.cuda.current_stream(self.device).wait_stream(side)
        return out

    def capture(self, fn: Callable[[], Any]) -> Tuple[Any, Any]:
        """``fn()`` recorded, not run: returns (the graph, fn's outputs,
        which every replay rewrites)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out


class CapturedInference:
    """``model.inference`` replayed from one CUDA graph per input
    signature (the module docstring). Call it as ``model.inference``:
    ``(images, image_sizes=None, valid_hw=None, canvas_hw=None)``. Each
    graph records the section stamps (the module docstring)."""

    def __init__(self, model, *, graphs=None):
        dev = next(model.parameters()).device
        if graphs is None:
            if not supports_graphs(dev):
                raise ValueError(f"CapturedInference needs a CUDA model, got "
                                 f"{dev}: call model.inference there")
            graphs = CudaGraphs(dev)
        self.model = model
        self.device = dev
        self.graphs = graphs
        self.programs: Dict[tuple, tuple] = {}
        self.capture_s = 0.0  # warm-up and capture, all graphs
        self.ring: Optional[tracing.Ring] = None  # made at the first capture

    def __len__(self) -> int:
        return len(self.programs)

    def __call__(self, images: torch.Tensor,
                 image_sizes: Optional[torch.Tensor] = None,
                 valid_hw: Optional[torch.Tensor] = None,
                 canvas_hw: Optional[Tuple[int, int]] = None):
        args = (images, image_sizes, valid_hw)
        canvas = None if canvas_hw is None else tuple(int(v)
                                                      for v in canvas_hw)
        key = (tuple(None if a is None else (tuple(a.shape), a.dtype)
                     for a in args), canvas)
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = self._capture(args, canvas)
        static, graph, out = prog
        for s, a in zip(static, args):
            if s is not None:
                s.copy_(a, non_blocking=True)
        graph.replay()
        return out

    def _capture(self, args, canvas):
        t0 = time.perf_counter()
        static = tuple(None if a is None else
                       torch.empty(a.shape, dtype=a.dtype, device=self.device)
                       .copy_(a) for a in args)

        def run():
            return self.model.inference(*static, canvas)

        def staged():  # armed while captured, and where a replay reruns it
            with tracing.armed(self.ring, key):
                return run()

        self.graphs.warm_up(run, WARMUP_CALLS)
        if self.ring is None:
            self.ring = tracing.Ring(self.device)
        key = len(self.programs)
        graph, out = self.graphs.capture(staged)
        dt = time.perf_counter() - t0
        self.capture_s += dt
        tracing.count("capture_s", dt)
        return static, graph, out
