"""Dataset-evaluation loop (the torch counterpart of
``centermask2_tpu/evaluation/loop.py``): preprocess -> model -> host
postprocess -> mask-score-aware COCO evaluator, returning the metrics
{task: {metric: value}} with the class-agnostic box_proposals AR block.

The loop is pipelined: a prefetch thread reads, resizes and packs
images ahead of the device, and requests are queued on the device
without waiting for their results. On CUDA each pack goes to the card
from pinned memory with ``non_blocking=True``, and each request's
outputs are copied into pinned host buffers behind a CUDA event; the
host waits on that event when it postprocesses the request, up to
``pipeline_depth`` requests later, and never on the whole device.

By default on CUDA the requests replay captured CUDA graphs
(``export/captured.py::CapturedInference``, one per canvas met), the
counterpart of the JAX loop's jitted forward; ``fn=model.inference``
runs them eagerly.

With ``distributed=True`` in a process group each process evaluates its
strided share of the images (``parallel/distributed.py::process_subset``),
the predictions and proposals of every process are gathered, and rank 0
scores them; the other ranks return no metrics (JAX ``loop.py:119-188``).
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import (detector_postprocess, preprocess_for_model,
                    read_image_bgr, single_wrap_outputs)
from ..data.coco import CocoDataset
from ..data.prefetch import prefetch
from ..export.captured import CapturedInference, supports_graphs
from ..parallel.distributed import (all_gather_objects, is_main_process,
                                    process_count, process_subset)
from ..utils import tracing
from .coco_eval import COCOEvaluator, COCOGt


def _to_host(out, cuda: bool) -> Tuple[Dict[str, torch.Tensor],
                                       Optional[torch.cuda.Event]]:
    """Queue the copy of one request's outputs to the host; on CUDA into
    pinned buffers, with an event recorded behind the copies. The copy is
    queued before the next request: a captured program's outputs are the
    static buffers its next replay rewrites. On the CPU the outputs are
    the host's already. The ``tracing`` span ``to_host``."""
    with tracing.span("to_host"):
        fields = {k: t for k, t in out._asdict().items() if t is not None}
        if not cuda:
            return fields, None
        host = {}
        for k, t in fields.items():
            host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[k].copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


def evaluate_dataset(
    model,
    *,
    ann: str,
    image_root: str,
    fixed_size: int,
    min_size: int,
    max_size: int,
    tasks: Tuple[str, ...] = ("bbox", "segm"),
    limit: int = 0,
    ds: Optional[CocoDataset] = None,
    gt: Optional[COCOGt] = None,
    progress_every: int = 50,
    pipeline_depth: int = 2,
    tight: Optional[bool] = None,
    tight_compute: bool = False,
    read_image: Callable[[str], np.ndarray] = read_image_bgr,
    fn: Optional[Callable] = None,
    kpt_oks_sigmas: Optional[Sequence[float]] = None,
    distributed: bool = False,
):
    """Evaluate ``model`` (a ``CenterMask`` in eval mode, on its device)
    over a COCO-format dataset, one image per request.

    Returns (results, avg_ms_per_image, evaluator). ``avg_ms`` is the
    sustained wall-clock rate of the pipelined loop (host preprocess,
    transfer, device and postprocess overlapped, first-call costs
    included); ``evaluator.steady_ms_per_image`` (set from 4 images on)
    is the median interval between completions. The evaluator holds the
    COCO-json ``predictions``. ``ds``/``gt`` skip re-parsing ``ann``.

    With an s2d-input model the device gets the RAW uint8 s2d pack
    (normalized on the device), over the quantized TIGHT canvas
    (``tight``, default on) and padded back to (fixed_size, fixed_size)
    there, or over the full canvas (``tight=False``): equal outputs.
    ``tight_compute`` (s2d only; raises otherwise) runs each request at its tight canvas
    instead (at most 4 canvases); the canvas then reaches the numbers
    through the eSE global pool, receptive-field bleed past the image
    edge and the default image size of ROI level assignment, as
    detectron2's per-image /32 padding does. ``read_image``: path -> HWC
    uint8 BGR array.

    ``fn(images, image_sizes, valid_hw, canvas_hw)`` runs one request, as
    ``model.inference`` does (JAX ``loop.py:35``). By default it is a
    ``CapturedInference`` of ``model`` on CUDA (one graph per canvas, its
    capture seconds counted in ``avg_ms``) and ``model.inference`` on the
    CPU; pass ``model.inference`` for the eager loop on CUDA, or a
    ``CapturedInference`` built once to reuse its graphs over calls.

    A keypoint model's ``pred_keypoints`` go through the postprocess
    (scaled to the original image) into the evaluator, which scores the
    "keypoints" task by OKS with ``kpt_oks_sigmas``
    (TEST.KEYPOINT_OKS_SIGMAS; COCO's 17 when empty).

    ``distributed`` (in a process group of more than one process): this
    process runs its strided share of the images, every process's
    predictions are gathered, and rank 0 returns the metrics of all of
    them; the other ranks return ``{}``, their own ms per image and an
    evaluator holding every prediction.
    """
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    if fn is None:
        fn = CapturedInference(model) if supports_graphs(dev) \
            else model.inference
    s2d = bool(getattr(model, "s2d_input", False))
    if tight_compute and not s2d:
        raise ValueError("tight_compute runs the s2d serving pack at its "
                         "tight canvas: it needs an s2d-input model "
                         "(TPU.S2D_STEM_INPUT, a VoVNet backbone)")
    tight = (s2d if tight is None else bool(tight) or tight_compute) and s2d
    canvas = None if tight_compute else (fixed_size, fixed_size)

    if ds is None:
        ds = CocoDataset(ann, image_root, filter_empty=False)
    if gt is None:
        with open(ann) as f:
            gt = COCOGt(json.load(f))
    evaluator = COCOEvaluator(gt, tasks=tasks,
                              category_id_map=ds.contiguous_to_cat,
                              kpt_oks_sigmas=kpt_oks_sigmas)
    ids = ds.ids[:limit] if limit else ds.ids
    multiproc = distributed and process_count() > 1
    if multiproc:
        ids = list(process_subset(ids))

    def produce():
        for img_id in ids:
            pre = preprocess_for_model(
                ds.image_path(img_id), fixed_size, min_size, max_size,
                s2d=s2d, u8=s2d, tight=tight, read_image=read_image)
            x = torch.from_numpy(pre["input"])
            hw = torch.from_numpy(pre["valid_hw"])
            if cuda:  # pinned here, off the consumer's thread
                x, hw = x.pin_memory(), hw.pin_memory()
            yield img_id, pre, x, hw

    done_ts = []
    pending: deque = deque()
    t_start = time.perf_counter()

    def drain():
        img_id, pre, out, done = pending.popleft()
        if done is not None:
            done.synchronize()  # this request's copies only
        done_ts.append(time.perf_counter())
        o = {k: t.numpy() for k, t in out.items()}
        v = o["valid"][0]
        wrapped = single_wrap_outputs(
            [o[k][0][v] if k in o else None
             for k in ("locations", "mask_scores", "pred_boxes",
                       "pred_classes", "pred_masks", "scores",
                       "pred_keypoints")])
        h, w = pre["original_hw"]
        post = detector_postprocess(wrapped, h, w, short=pre["short"],
                                    max_size=pre["max_size"])
        evaluator.process(img_id, post)
        n = len(done_ts)
        if progress_every and n % progress_every == 0:
            rate = (time.perf_counter() - t_start) / n * 1000
            print(f"[eval {n}/{len(ids)}] {rate:.1f} ms/img sustained",
                  flush=True)

    for img_id, pre, x, hw in prefetch(produce(),
                                       depth=max(2, pipeline_depth)):
        x = x.to(dev, non_blocking=True)
        hw = hw.to(dev, non_blocking=True)
        out = fn(x, None, hw, canvas)
        pending.append((img_id, pre, *_to_host(out, cuda)))
        if len(pending) > pipeline_depth:
            drain()
    while pending:
        drain()
    wall = time.perf_counter() - t_start

    if multiproc:
        # the reference's cross-rank comm.gather, then rank 0 scores
        gathered = all_gather_objects(
            (evaluator.predictions, evaluator.proposals))
        evaluator.predictions = [p for preds, _ in gathered for p in preds]
        evaluator.proposals = {k: v for _, props in gathered
                               for k, v in props.items()}
        if not is_main_process():
            return {}, wall / max(len(ids), 1) * 1000.0, evaluator

    results = evaluator.evaluate()
    results["box_proposals"] = evaluator.evaluate_proposals()
    avg_ms = wall / max(len(ids), 1) * 1000.0
    if len(done_ts) >= 4:
        # the median interval between completions leaves out one-time
        # costs (cuDNN setup per canvas) that avg_ms spreads over the run
        gaps = np.diff(np.asarray(done_ts))
        evaluator.steady_ms_per_image = float(np.median(gaps)) * 1000.0
    return results, avg_ms, evaluator
