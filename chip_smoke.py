#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``centermask2_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

It builds the port's CUDA kernels from ``centermask2_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, serves the
V-39-eSE flagship (random weights from a seed) through the kernels, and
times the kernels and the end-to-end latency. Phases, in order:

1. card:    the card's name and power limit (nvidia-smi).
2. build:   nvcc of every kernel, in parallel; build seconds, and each
            kernel's registers/spills from ``-Xptxas=-v``.
3. kernels: NMS keep sets bit-equal to the plain version at N = 1024,
            2048, 8192 (invalid rows, duplicate and zero-area boxes,
            score ties, class offsets, a batch of 2), and at N = 1024 and
            8192 on disjoint boxes (all kept), a suppression chain across
            every 64-box word, and an all-invalid image; ROIAlign on the
            P3-P5 shapes of 800x1088 within tolerance in f32 and bf16 for
            (o, s) = (14, 2), (7, 2), (14, 1), (5, 3), C = 256 and 200,
            one image and a batch of 2, and ROIs all on P5 (a difference
            names its worst element); median times of kernel and plain
            version on synthetic inputs (NMS also at N = 2048 and 8192
            with B = 2; ROIAlign also on one tiny box repeated).
4. serve:   4 requests (3 at 800x1088, 1 at 1344x1344) in bf16 through
            ``build_centermask`` + ``inference``, with the launch counts
            reset before and read after (each kernel once per request),
            one request under CUDA's sync-debug mode (no host sync on the
            path), and an f32 request through the kernels and through the
            plain versions (swapped in for the kernels), compared slot by
            slot.
5. time:    each kernel against its plain version on the inputs
            captured from a served bf16 800x1088 request, then both timed
            there (the times of the ``kernels`` line), and the profiler's
            device time per CUDA kernel of each; per-image latency at
            B = 1, 800x1088 and 1344x1344, bf16 and f32, over timed
            windows of a few seconds, twice, with host enqueue and CPU
            time beside the device events; a profiler breakdown of one
            bf16 800x1088 request.
6. serving: the serving config (``zy_model_serving.yaml``) built with the
            parameters of ``serve``: a 1333x800 uint8 image packed tight
            on the host, padded back and normalized on the device,
            ``torch.equal`` to the host's f32 s2d input; the s2d stem
            against the plain stem in f32 (worst element printed); an f32
            request from the tight pack on 1344x1344 through the kernels
            against the same request through the plain versions and
            against the f32 NHWC request, slot by slot; 6 bf16 requests
            (three images, each padded back and at its tight canvas) with
            the launch counts read around them; one under sync-debug
            mode; one per-level request (TPU.NMS_CANDIDATES = 5000), one
            launch of each kernel, timed at N = 5000; each kernel held
            against its plain version on the inputs captured from every
            one of these requests (f32 and bf16, pad-back, the three
            tight canvases, per-level); device ms per request as a CUDA
            graph at each tight canvas and at 1344x1344 pad-back, host
            pack ms and bytes per request.
7. eval:    ``evaluation/loop.py::evaluate_dataset`` over a synthetic COCO
            set of 8 ``.npy`` images (the three canvases; polygons over
            four categories, a crowd region): the ground truth fed back
            scores AP 100.0 (bbox, segm); tight and full pack predictions
            equal; tight compute gives every metric, finite; launch counts
            read around each run; avg and steady ms per image.
8. train:   the flagship trained at full width in bf16 (1344x1344, B = 2,
            20 gt boxes an image, synthetic batches in ``train_batches``'
            format) through ``train/trainer.py::train_loop``: finite
            losses; one launch of kernel 1, kernel 2 and kernel 2b per step
            (counts read around every step); a step under sync-debug mode;
            ms per step (CUDA events, median and quartiles after warm-up),
            images per second, peak memory, the profiler's top kernels of
            one step; the three kernels against their plain versions on
            the inputs captured from a bf16 and an f32 step; the f32 step
            (TF32 off, deterministic cuDNN) through the kernels against
            the same step through the plain versions: losses equal,
            every gradient within 4x its noise floor; 20 bf16 steps on one
            batch that bring the loss down; a checkpoint round trip and
            one step after it equal to the step without it.
9. result:  a ``{"kernels": [...]}`` line whose launches sum the counts
            of ``serve``, ``serving``, ``eval`` and ``train``, then the last
            line ``{"ok": true, "device": {...}}``.

A failing phase raises, and the run exits non-zero without the last line.
It also exits non-zero, printing no result, with no CUDA device or when
the package is not beside this script.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PIXEL_MEAN = (103.53, 116.28, 123.675)

# H100 SXM published peaks (dense), used for the bounds: HBM bytes/s and
# f32 non-tensor-core flop/s (both kernels do f32 vector arithmetic).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

NMS_SOURCE = "centermask2_tpu_torch/csrc/nms.cu"
ROI_SOURCE = "centermask2_tpu_torch/csrc/roi_align.cu"
NMS_REPLACES = "centermask2_tpu/ops/nms_pallas.py:46"
ROI_REPLACES = "centermask2_tpu/ops/roi_align_pallas.py:46"
# kernel 2b has no Pallas kernel to replace: JAX computes the ROIAlign
# VJP in XLA (_separable_feature_grad)
ROI_BWD_REPLACES = "centermask2_tpu/ops/roi_align.py:325"

# tolerances of the kernel/plain comparisons on the card
ROI_F32_ATOL = 1e-5  # f32 sums in another order
ROI_BF16_RTOL = 2.0 ** -7  # both sides round an f32 sum to bf16: <= 1 ulp
ROI_BF16_ATOL = 1e-6
E2E_TOL = {"scores": (1e-6, 1e-5), "pred_boxes": (1e-6, 1e-4),
           "pred_masks": (0.0, 1e-4), "mask_scores": (1e-3, 1e-4)}
# kernel 2b against the plain VJP: its f32 atomics add in an order that
# changes from run to run, so f32 is held to 1e-5 of the largest plain
# value and bf16 to one bf16 ulp of each value plus that f32 term
ROI_BWD_REL = 1e-5
# the f32 train step through the kernels against the plain versions:
# every gradient within this factor of its noise floor
GRAD_NOISE_FACTOR = 4.0

# end-to-end timing: each canvas and dtype gets a warm-up, then a timed
# window of at least WINDOW_S seconds and MIN_TIMED requests; the sweep
# over canvases and dtypes runs twice (two windows each)
WARMUP_S = 1.5
WINDOW_S = 4.0
MIN_TIMED = 10
PASSES = 2

NMS_SIZES = (1024, 2048, 8192)
# sizes of the hard NMS cases (8192: the scan's dynamic shared memory)
NMS_SPECIAL_SIZES = (1024, 8192)
# (seed, H, W) of the served requests; the first is also the f32 check
REQUESTS = ((100, 800, 1088), (101, 800, 1088), (102, 800, 1088),
            (103, 1344, 1344))


def flagship_cfg():
    """``configs/centermask/zy_model_config.yaml`` merged over the defaults,
    built in Python (no yaml)."""
    from centermask2_tpu_torch.config import get_cfg

    cfg = get_cfg()
    # Base-CenterMask-VoVNet.yaml
    cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    cfg.MODEL.BACKBONE.NAME = "build_fcos_vovnet_fpn_backbone"
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    cfg.MODEL.VOVNET.OUT_FEATURES = ["stage3", "stage4", "stage5"]
    cfg.MODEL.FPN.IN_FEATURES = ["stage3", "stage4", "stage5"]
    cfg.MODEL.PROPOSAL_GENERATOR.NAME = "FCOS"
    cfg.MODEL.FCOS.POST_NMS_TOPK_TEST = 50
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.MASKIOU_ON = True
    cfg.MODEL.ROI_HEADS.NAME = "CenterROIHeads"
    cfg.MODEL.ROI_HEADS.IN_FEATURES = ["p3", "p4", "p5"]
    cfg.MODEL.ROI_MASK_HEAD.NAME = "SpatialAttentionMaskHead"
    cfg.MODEL.ROI_MASK_HEAD.ASSIGN_CRITERION = "ratio"
    cfg.MODEL.ROI_MASK_HEAD.NUM_CONV = 4
    cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    cfg.DATASETS.TRAIN = ("coco_2017_train",)
    cfg.DATASETS.TEST = ("coco_2017_val",)
    cfg.SOLVER.CHECKPOINT_PERIOD = 10000
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.STEPS = (60000, 80000)
    cfg.SOLVER.MAX_ITER = 90000
    cfg.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
    # zy_model_config.yaml (its WEIGHTS: "" merges as None)
    cfg.MODEL.WEIGHTS = None
    cfg.MODEL.VOVNET.CONV_BODY = "V-39-eSE"
    cfg.SOLVER.STEPS = (210000, 250000)
    cfg.SOLVER.MAX_ITER = 270000
    cfg.OUTPUT_DIR = "output/zy_outputs"
    return cfg


def serving_cfg():
    """``configs/centermask/zy_model_serving.yaml``: the flagship with the
    s2d stem input (the raw uint8 s2d pack, normalized on the device)."""
    cfg = flagship_cfg()
    cfg.TPU.S2D_STEM_INPUT = True
    return cfg


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_gpu_ms(fn, launches: int = 20, repeats: int = 7) -> float:
    """Median device ms per call of ``fn``: each repeat queues ``launches``
    calls behind a GPU sleep that outlasts their enqueue, so the host runs
    ahead and the events time the device work back to back, not the
    host's enqueue. (A ``fn`` that syncs the host, as the plain NMS's
    fixpoint loop does, is timed with its host time all the same.)"""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # torch.cuda._sleep spins SM clock cycles (1.98 GHz at most)
    cycles = int(1.98e9 * max(0.025, 2.0 * launches * enqueue_s))
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            fn()
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / launches)
    return float(np.median(per_call))


# --------------------------------------------------------------- kernels
def nms_inputs(rng: np.random.RandomState, n: int):
    """Clustered boxes of 80 classes with invalid rows, exact duplicates,
    zero-area boxes (pairs of them have union 0) and score ties."""
    n_obj = 40
    obj = rng.rand(n_obj, 2) * 1000.0
    pick = rng.randint(0, n_obj, n)
    centers = obj[pick] + rng.randn(n, 2) * 12
    sizes = 30 + rng.rand(n, 2) * 120
    boxes = np.concatenate([centers, centers + sizes], 1).astype(np.float32)
    classes = (pick % 80).astype(np.int32)
    scores = rng.rand(n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    dup = rng.choice(n, n // 16, replace=False)
    boxes[dup] = boxes[(dup + 1) % n]
    classes[dup] = classes[(dup + 1) % n]
    zero = rng.choice(n, n // 16, replace=False)
    boxes[zero, 2:] = boxes[zero, :2]
    boxes[zero[: len(zero) // 2]] = np.float32(5.0)  # identical points
    ties = rng.choice(n, n // 4, replace=False)
    scores[ties] = np.round(scores[ties] * 8) / 8
    return boxes, scores, classes, valid


KERNEL_FNS = ("nms_keep_sorted", "roi_align", "roi_align_backward")


@contextlib.contextmanager
def kernels_swapped(nms_fn, roi_fn, roi_bwd_fn=None):
    """Route the ops' kernel calls to ``nms_fn``/``roi_fn``/``roi_bwd_fn``
    (same signatures as ``_kernels.nms_keep_sorted``/``roi_align``/
    ``roi_align_backward``; None keeps the kernel) inside the block; the
    port itself has one path, by device."""
    from centermask2_tpu_torch.ops import _kernels

    saved = tuple(getattr(_kernels, n) for n in KERNEL_FNS)
    for name, fn in zip(KERNEL_FNS, (nms_fn, roi_fn, roi_bwd_fn)):
        if fn is not None:
            setattr(_kernels, name, fn)
    try:
        yield saved
    finally:
        for name, fn in zip(KERNEL_FNS, saved):
            setattr(_kernels, name, fn)


def plain_kernels():
    """The kernels' plain PyTorch versions in their place, on the card."""
    from centermask2_tpu_torch.ops.nms import greedy_keep_sorted_plain
    from centermask2_tpu_torch.ops.roi_align import (
        multilevel_roi_align_plain, roi_align_feature_grad_plain)

    return kernels_swapped(greedy_keep_sorted_plain,
                           multilevel_roi_align_plain,
                           roi_align_feature_grad_plain)


def nms_row(sboxes, svalid, thr: float, what: str) -> dict:
    """Median times of kernel 1 and its plain version on sorted boxes
    (B, N, 4) and validity (B, N), and the bound for this input."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.nms import greedy_keep_sorted_plain

    ms = time_gpu_ms(lambda: _kernels.nms_keep_sorted(sboxes, svalid, thr))
    plain_ms = time_gpu_ms(
        lambda: greedy_keep_sorted_plain(sboxes, svalid, thr), launches=3,
        repeats=5)
    kept = int(_kernels.nms_keep_sorted(sboxes, svalid, thr).sum())
    B, n = svalid.shape
    pairs = B * n * (n - 1) // 2
    flops = 13 * pairs + 3 * B * n  # min/max/sub x2, clamp x2, mul, add, sub, div, cmp
    nbytes = B * (n * 16 + n + n)  # boxes, valid in; keep out
    bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_FLOPS else \
        "operations"
    log(f"  nms {what}: N={n} B={B}, {int(svalid.sum())} valid, {kept} kept; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms "
        f"({by})")
    return {"name": "nms", "route": "cuda", "source": NMS_SOURCE,
            "replaces": NMS_REPLACES, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def sort_for_nms(boxes, scores, classes, valid):
    """Class-offset boxes sorted by descending score, as ``batched_nms``
    hands them to the greedy core: (B, N, 4) f32 and (B, N) bool."""
    B, n = scores.shape
    max_coord = torch.where(valid[..., None], boxes, 0.0).amax(dim=(1, 2))
    shifted = boxes + (classes.float() * (max_coord[:, None] + 1.0))[..., None]
    order = torch.sort(torch.where(valid, scores, -torch.inf), dim=1,
                       descending=True, stable=True).indices
    sboxes = torch.gather(shifted, 1, order[..., None].expand(B, n, 4))
    return sboxes.contiguous(), torch.gather(valid, 1, order).contiguous()


def nms_special_inputs(n: int, dev) -> dict:
    """Sorted (B = 2, N) inputs of the kernel's hard cases: disjoint boxes
    (every box kept: the most propagation work), a chain in which box i
    suppresses only i+1 (IoU 2/3 with i+1, 3/7 with i+2) across every
    64-box word, and an all-invalid image beside a valid one."""
    idx = np.arange(n)
    side = int(np.ceil(np.sqrt(n)))
    xy = np.stack([idx % side, idx // side], 1) * 20.0
    grid = np.concatenate([xy, xy + 10.0], 1)
    x = idx * 2.0
    chain = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1)
    gaps = np.ones(n, bool)
    gaps[np.random.RandomState(n).choice(n, n // 32, replace=False)] = False
    ones, none = np.ones(n, bool), np.zeros(n, bool)
    cases = {"all kept (disjoint boxes)": ((grid, grid[::-1]), (ones, ones)),
             "chain across words": ((chain, chain), (ones, gaps)),
             "image 0 all invalid": ((grid, chain), (none, ones))}
    return {name: (torch.from_numpy(np.stack(b).astype(np.float32)).to(dev),
                   torch.from_numpy(np.stack(v)).to(dev))
            for name, (b, v) in cases.items()}


def nms_case(sboxes, svalid, thr: float, what: str) -> int:
    """Kernel 1 and its plain version on sorted boxes: raises unless the
    keep sets are bit-equal. Returns the count of differing rows (0)."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.nms import greedy_keep_sorted_plain

    kk = _kernels.nms_keep_sorted(sboxes, svalid, thr)
    kp = greedy_keep_sorted_plain(sboxes, svalid, thr)
    torch.cuda.synchronize()
    diff = int((kk != kp).sum())
    kept = kk.sum(dim=1).tolist()
    if diff:
        raise AssertionError(f"NMS {what}: kernel keeps {kept}, plain "
                             f"{kp.sum(dim=1).tolist()}, {diff} rows differ")
    B, n = svalid.shape
    log(f"  nms {what}: N={n} B={B}, keep sets bit-equal ({kept} kept)")
    return diff


def check_nms(dev) -> int:
    """Keep sets of kernel and plain version, bit-equal in every case.
    Returns the largest count of differing keep rows over all cases."""
    from centermask2_tpu_torch.ops import batched_nms, nms_keep_mask

    thr = 0.6
    rng = np.random.RandomState(0)
    worst = 0
    for n in NMS_SIZES:
        batch = [nms_inputs(rng, n) for _ in range(2)]
        boxes, scores, classes, valid = (
            torch.from_numpy(np.stack([b[i] for b in batch])).to(dev)
            for i in range(4))
        valid = valid.bool()
        for name, run in (
                ("class-offset", lambda: batched_nms(
                    boxes, scores, classes, valid, thr)),
                ("plain-boxes", lambda: nms_keep_mask(
                    boxes, scores, valid, thr))):
            kk = run()
            with plain_kernels():
                kp = run()
            torch.cuda.synchronize()
            diff = int((kk != kp).sum())
            worst = max(worst, diff)
            if diff:
                raise AssertionError(
                    f"NMS n={n} {name}: kernel keeps {int(kk.sum())}, plain "
                    f"{int(kp.sum())}, {diff} rows differ")
            log(f"  nms n={n} B=2 {name}: keep sets bit-equal "
                f"({int(kk[0].sum())}, {int(kk[1].sum())} kept)")
        if n != 1024:  # batched synthetic timing, N > the main path's
            nms_row(*sort_for_nms(boxes, scores, classes, valid), thr,
                    "synthetic clustered boxes")
    for n in NMS_SPECIAL_SIZES:
        for name, (sboxes, svalid) in nms_special_inputs(n, dev).items():
            worst = max(worst, nms_case(sboxes, svalid, thr, name))

    # synthetic clustered boxes at the main path's shape: 1000 candidates
    # padded to 1024, one image, class-offset boxes (the served request's
    # own input is checked and timed in [time])
    boxes, scores, classes, valid = (torch.from_numpy(a).to(dev)[None]
                                     for a in nms_inputs(rng, 1024))
    sboxes, svalid = sort_for_nms(boxes, scores, classes, valid.bool())
    nms_row(sboxes, svalid, thr, "synthetic clustered boxes")
    return worst


def roi_inputs(rng: np.random.RandomState, H: int, W: int, R: int,
               C: int, B: int, dev, large: bool = False):
    """P3-P5 features of an H x W canvas and R boxes, some crossing or
    outside the borders, zero-area and large; with ``large`` every box
    covers at least 0.56 of the canvas, which puts them all on P5."""
    shapes = [(H // s, W // s) for s in (8, 16, 32)]
    feats = [torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).to(dev)
             for h, w in shapes]
    xy = rng.rand(R, 2) * [W, H]
    wh = 4 + rng.rand(R, 2) * [W / 2, H / 2]
    if large:
        xy = [W / 2, H / 2] + (rng.rand(R, 2) - 0.5) * [W / 4, H / 4]
        wh = (0.75 + 0.5 * rng.rand(R, 2)) * [W, H]
        boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1)
        return feats, torch.from_numpy(boxes.astype(np.float32)).to(dev)
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], 1).astype(np.float32)
    boxes[:5, 0] = -30.0  # crossing the left border
    boxes[5:10, 3] = H + 40.0  # crossing the bottom border
    boxes[10:13] = [W + 20.0, H + 20.0, W + 90.0, H + 60.0]  # outside
    boxes[13:15] = [10.0, 10.0, 10.0, 10.0]  # zero area
    boxes[15:18] = [[0.0, 0.0, W, H], [-50.0, 20.0, W - 30.0, H + 10.0],
                    [100.0, 50.0, W - 100.0, H - 20.0]]  # large: P5
    return feats, torch.from_numpy(boxes).to(dev)


def roi_touched_rows(boxes, bidx, levels, feats, scales, o, s) -> int:
    """Distinct feature pixels (image, level, y, x) whose taps carry
    weight for these ROIs: the input the op must read, per channel."""
    from centermask2_tpu_torch.ops.roi_align import _axis_coords, _bilinear_taps

    rows = set()
    b = boxes.float().cpu()
    lv = levels.long().cpu()
    im = bidx.long().cpu()
    for r in range(b.shape[0]):
        f = feats[int(lv[r])]
        H, W = f.shape[2], f.shape[3]
        ys, xs = _axis_coords(b[r:r + 1], torch.tensor([scales[int(lv[r])]]),
                              o, s, True)
        P = (o * s) ** 2
        ys = ys[:, :, None].expand(1, o * s, o * s).reshape(1, P)
        xs = xs[:, None, :].expand(1, o * s, o * s).reshape(1, P)
        yl, xl, w = _bilinear_taps(ys, xs, torch.tensor(float(H)),
                                   torch.tensor(float(W)))
        yh = torch.clamp(yl + 1, max=H - 1)
        xh = torch.clamp(xl + 1, max=W - 1)
        for t, (yy, xx) in enumerate(((yl, xl), (yl, xh), (yh, xl), (yh, xh))):
            sel = w[0, :, t] != 0
            for y, x in zip(yy[0][sel].tolist(), xx[0][sel].tolist()):
                rows.add((int(im[r]), int(lv[r]), y, x))
    return len(rows)


def roi_row(feats, boxes, bidx, levels, scales, o: int, s: int,
            aligned: bool, what: str) -> dict:
    """Median times of kernel 2 and its plain version on one input, and
    the bound for the pixels this input's ROIs touch."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.roi_align import multilevel_roi_align_plain

    args = (feats, boxes, bidx, levels, scales, o, s, aligned)
    ms = time_gpu_ms(lambda: _kernels.roi_align(*args))
    plain_ms = time_gpu_ms(lambda: multilevel_roi_align_plain(*args),
                           launches=5)
    R, C = boxes.shape[0], feats[0].shape[1]
    touched = roi_touched_rows(boxes, bidx, levels, feats, scales, o, s)
    elt = feats[0].element_size()
    nbytes = touched * C * elt + R * C * o * o * elt + R * (16 + 4 + 4)
    flops = R * C * o * o * (s * s * 12 + 1)
    bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_FLOPS else \
        "operations"
    log(f"  roi_align {what}: {feats[0].dtype} R={R} C={C}, levels used "
        f"{sorted(set(levels.tolist()))}; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}: {touched} touched "
        f"pixels x {C} ch read, {R}x{C}x{o}x{o} written)")
    return {"name": "roi_align", "route": "cuda", "source": ROI_SOURCE,
            "replaces": ROI_REPLACES, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def roi_case(feats, boxes, bidx, levels, scales, o: int, s: int,
             what: str) -> float:
    """Kernel 2 against its plain version on one input: f32 within
    ROI_F32_ATOL, bf16 within ROI_BF16_RTOL * |plain| + ROI_BF16_ATOL.
    Raises outside the tolerance; returns the max abs error."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.roi_align import multilevel_roi_align_plain

    args = (feats, boxes, bidx, levels, scales, o, s, True)
    k = _kernels.roi_align(*args)
    p = multilevel_roi_align_plain(*args)
    torch.cuda.synchronize()
    R, C = boxes.shape[0], feats[0].shape[1]
    if k.shape != (R, C, o, o) or k.dtype != feats[0].dtype:
        raise AssertionError(f"roi_align {what}: {k.shape} {k.dtype}")
    d = (k.float() - p.float()).abs()
    err = float(d.max()) if d.numel() else 0.0
    if feats[0].dtype == torch.float32:
        ok, tol = err <= ROI_F32_ATOL, f"atol {ROI_F32_ATOL}"
    else:
        ok = bool((d <= ROI_BF16_RTOL * p.float().abs()
                   + ROI_BF16_ATOL).all())
        tol = f"|d| <= 2^-7*|plain| + {ROI_BF16_ATOL}"
    where = ""
    if err > 0:  # the worst element: ROI, channel, bin, values, box, level
        i = np.unravel_index(int(d.argmax()), tuple(d.shape))
        where = (f"; worst at (r, c, ph, pw) {tuple(int(x) for x in i)}: "
                 f"kernel {float(k[i]):.9g} plain {float(p[i]):.9g}, box "
                 f"{boxes[i[0]].tolist()} level {int(levels[i[0]])}, "
                 f"{int((d > 0).sum())} values differ")
    if not ok or not torch.isfinite(k).all():
        raise AssertionError(f"roi_align {what}: max abs err {err} outside "
                             f"{tol}{where}")
    log(f"  roi_align {what}: {str(feats[0].dtype)[6:]} R={R} C={C} o={o} "
        f"s={s}, images {sorted(set(bidx.tolist()))}, levels "
        f"{sorted(set(levels.tolist()))}: max abs err {err:.3e} "
        f"(tolerance {tol}){where}")
    return err


# (B, C, o, s, large) of the ROIAlign checks on P3-P5 of 800x1088: the
# main path's (1, 256, 14, 2) first; odd o*o (7, 5) takes the bf16 scalar
# stores, C = 200 a ragged channel group, ``large`` puts every ROI on P5
ROI_CASES = ((1, 256, 14, 2, False), (2, 256, 14, 2, False),
             (2, 200, 7, 2, False), (2, 200, 14, 1, False),
             (2, 256, 5, 3, False), (2, 256, 14, 2, True))


def check_roi_align(dev) -> float:
    """Kernel 2 against its plain version in f32 and bf16 over
    ``ROI_CASES``, with ROIs of both images mixed at B = 2. Returns the
    largest abs error."""
    from centermask2_tpu_torch.ops import assign_boxes_by_ratio
    from centermask2_tpu_torch.structures import boxes as box_ops

    H, W, R = 800, 1088, 50
    scales = [1 / 8, 1 / 16, 1 / 32]
    rng = np.random.RandomState(1)
    worst = 0.0
    for B, C, o, s, large in ROI_CASES:
        feats32, boxes = roi_inputs(rng, H, W, R, C, B, dev, large)
        levels = assign_boxes_by_ratio(
            box_ops.area(boxes), torch.full((R,), float(H * W), device=dev),
            3, 5)
        bidx = (torch.arange(R, device=dev) % B).to(torch.int32)
        what = "large ROIs" if large else "synthetic boxes"
        for feats in (feats32, [f.bfloat16() for f in feats32]):
            worst = max(worst, roi_case(feats, boxes, bidx, levels, scales,
                                        o, s, what))
        if (B, C, o, s, large) == ROI_CASES[0]:  # the main path's shapes
            roi_row([f.bfloat16() for f in feats32], boxes, bidx, levels,
                    scales, o, s, True, "synthetic boxes")
            roi_row(feats32, boxes, bidx, levels, scales, o, s, True,
                    "synthetic boxes")
            # the same gathers on a few cache lines: one 32x30 box, 50 times
            tiny = torch.tensor([[400.0, 300.0, 432.0, 330.0]] * R,
                                device=dev)
            roi_row([f.bfloat16() for f in feats32], tiny, bidx,
                    assign_boxes_by_ratio(
                        box_ops.area(tiny),
                        torch.full((R,), float(H * W), device=dev), 3, 5),
                    scales, o, s, True, "one tiny box 50 times")
    return worst


# ----------------------------------------------------------------- serve
def make_image(seed: int, H: int, W: int, dev) -> torch.Tensor:
    """A normalized (1, H, W, 3) BGR - mean image from a seed."""
    g = torch.Generator().manual_seed(seed)
    img = torch.rand((1, H, W, 3), generator=g) * 255.0
    return (img - torch.tensor(PIXEL_MEAN)).to(dev)


def build_model(cfg, dev):
    from centermask2_tpu_torch import build_centermask

    model = build_centermask(cfg, device=dev, seed=0)
    # the prior bias (-4.6) leaves every random-weight score under the
    # 0.05 threshold; at 0 the decode yields real candidates
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    return model


def check_outputs(out, B: int, K: int, what: str) -> int:
    shapes = {"locations": (B, K, 2), "mask_scores": (B, K),
              "pred_boxes": (B, K, 4), "pred_classes": (B, K),
              "pred_masks": (B, K, 1, 28, 28), "scores": (B, K),
              "valid": (B, K)}
    for f, shp in shapes.items():
        t = getattr(out, f)
        if tuple(t.shape) != shp:
            raise AssertionError(f"{what}: {f} shape {tuple(t.shape)} != {shp}")
        if t.is_floating_point() and not torch.isfinite(t).all():
            raise AssertionError(f"{what}: {f} has non-finite values")
    if out.pred_classes.dtype != torch.int32:
        raise AssertionError(f"{what}: pred_classes {out.pred_classes.dtype}")
    n = int(out.valid.sum())
    if n == 0:
        raise AssertionError(f"{what}: no valid detection")
    return n


def serve(dev):
    from centermask2_tpu_torch.ops import _kernels

    cfg = flagship_cfg()
    model = build_model(cfg, dev)
    K = cfg.MODEL.FCOS.POST_NMS_TOPK_TEST
    images = [make_image(seed, H, W, dev) for seed, H, W in REQUESTS]
    model.inference(images[0])  # warm-up: cuDNN handles, allocator
    torch.cuda.synchronize()

    _kernels.reset_launch_counts()
    for i, ((seed, H, W), img) in enumerate(zip(REQUESTS, images)):
        before = (_kernels.nms_launches, _kernels.roi_align_launches)
        out = model.inference(img)
        n = check_outputs(out, 1, K, f"request {i} {H}x{W}")
        after = (_kernels.nms_launches, _kernels.roi_align_launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 1):
            raise AssertionError(f"request {i}: launches {before} -> {after}")
        log(f"  request {i} {H}x{W} bf16: {n} valid of {K}, launches "
            f"nms +1 roi_align +1, top score {float(out.scores.max()):.4f}")
    launches = {"nms": _kernels.nms_launches,
                "roi_align": _kernels.roi_align_launches}

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.inference(images[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_outputs(out, 1, K, "sync-debug request")
    log("  request under sync-debug mode 'error': no host sync on the path")

    # f32: kernels vs plain versions on the card, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = flagship_cfg()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = build_model(cfg32, dev)
    ok = model32.inference(images[0])
    with plain_kernels():
        op = model32.inference(images[0])
    n = compare_outputs(ok, op, K, "f32 kernels vs plain")
    log(f"  f32 {REQUESTS[0][1]}x{REQUESTS[0][2]}: {n} valid slots, "
        "classes equal")
    return {"bfloat16": model, "float32": model32}, launches, images


def compare_outputs(a, b, K: int, what: str) -> int:
    """Two requests' outputs slot by slot: equal valid masks and classes,
    the other heads within ``E2E_TOL``. Returns the valid count."""
    torch.cuda.synchronize()
    n = check_outputs(a, 1, K, what)
    check_outputs(b, 1, K, what)
    if not torch.equal(a.valid, b.valid):
        raise AssertionError(f"{what}: valid masks differ")
    v = a.valid[0]
    if not torch.equal(a.pred_classes[0][v], b.pred_classes[0][v]):
        raise AssertionError(f"{what}: classes differ")
    for f, (rtol, atol) in E2E_TOL.items():
        x, y = getattr(a, f)[0][v].double(), getattr(b, f)[0][v].double()
        err = float((x - y).abs().max())
        if not torch.allclose(x, y, rtol=rtol, atol=atol):
            raise AssertionError(f"{what} {f}: max abs err {err} outside "
                                 f"rtol {rtol} atol {atol}")
        log(f"  {what} {f}: max abs err {err:.3e} (rtol {rtol}, "
            f"atol {atol})")
    return n


# ------------------------------------------------------------------ time
def capture_kernel_inputs(request) -> dict:
    """The arguments the main path passes to each kernel in one request
    (``request()``, which runs through the kernels as usual)."""
    seen = {}

    def recorder(name, fn):
        def call(*args):
            seen[name] = args
            return fn(*args)
        return call

    from centermask2_tpu_torch.ops import _kernels

    with kernels_swapped(recorder("nms", _kernels.nms_keep_sorted),
                         recorder("roi_align", _kernels.roi_align)):
        request()
    torch.cuda.synchronize()
    if set(seen) != {"nms", "roi_align"}:
        raise AssertionError(f"request reached only {sorted(seen)}")
    return seen


def profile_kernels(seen) -> None:
    """Device time per CUDA kernel of each port kernel's launch on the
    served request's inputs (NMS is two: the mask and the scan)."""
    from torch.profiler import ProfilerActivity, profile

    from centermask2_tpu_torch.ops import _kernels

    for name, fn in (("nms", _kernels.nms_keep_sorted),
                     ("roi_align", _kernels.roi_align)):
        fn(*seen[name])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn(*seen[name])
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0]
        if not evs:
            log(f"  profiler, {name}: no device time recorded (not measured)")
        for e in evs:
            kernel = e.key.replace("(anonymous namespace)::", "")
            log(f"  profiler, {name} on the served input: "
                f"{e.device_time_total / e.count:.3f} us per launch of "
                f"{kernel.split('(')[0][-40:]} (x{e.count})")


def gpu_clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def device_ms_per_request(request, request_ms: float) -> float:
    """Device time of one request with the host out of the way: the
    request captured once into a CUDA graph (its ~1,500 launches overflow
    CUDA's launch queue, so queueing them behind a GPU sleep cannot hide
    the host), replayed back to back and timed by events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        request()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc = request()
    graph.replay()
    torch.cuda.synchronize()
    reps = int(min(50, max(3, 1000.0 / request_ms)))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    if not torch.isfinite(acc):
        raise AssertionError("non-finite result of the replayed request")
    return a.elapsed_time(b) / reps


def latency_window(model, img, seconds: float = WINDOW_S,
                   warmup_s: float = WARMUP_S) -> dict:
    """Per-request ms at B = 1 over a window of ``seconds`` (at least
    ``MIN_TIMED`` requests) after ``warmup_s`` of warm-up requests, every
    output head reduced into the result (nothing is left for the device to
    skip). Each request is timed by CUDA events around it (``ms``) and by
    the host's wall time to enqueue it (``enqueue``). Over the window: the
    calling thread's CPU time as a share of the enqueue time (the thread
    clock ticks too coarsely to read per request), Python's garbage
    collection time, and the thread's involuntary context switches. Then
    the device time per request, replayed as a CUDA graph."""
    def request():
        return reduce_outputs(model.inference(img))

    t_end = time.perf_counter() + warmup_s
    n = 0
    while n < 3 or time.perf_counter() < t_end:
        request()
        n += 1
    torch.cuda.synchronize()

    gc_s = [0.0, 0.0]  # start of the running collection, total

    def on_gc(phase, info):
        if phase == "start":
            gc_s[0] = time.perf_counter()
        else:
            gc_s[1] += time.perf_counter() - gc_s[0]

    ms, enqueue = [], []
    cpu_s = 0.0
    ru0 = resource.getrusage(resource.RUSAGE_THREAD)
    gc.callbacks.append(on_gc)
    try:
        t_end = time.perf_counter() + seconds
        while len(ms) < MIN_TIMED or time.perf_counter() < t_end:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            w0, c0 = time.perf_counter(), time.thread_time()
            acc = request()
            c1, w1 = time.thread_time(), time.perf_counter()
            b.record()
            b.synchronize()
            if not torch.isfinite(acc):
                raise AssertionError("non-finite timed result")
            ms.append(a.elapsed_time(b))
            enqueue.append((w1 - w0) * 1e3)
            cpu_s += c1 - c0
    finally:
        gc.callbacks.remove(on_gc)
    ru1 = resource.getrusage(resource.RUSAGE_THREAD)
    dev_ms = device_ms_per_request(request, float(np.median(ms)))
    q0, q1, q2, q3, q4 = np.percentile(ms, [0, 25, 50, 75, 100])
    return {"n": len(ms), "warmup": n, "min": q0, "q1": q1, "median": q2,
            "q3": q3, "max": q4, "first20": float(np.median(ms[:20])),
            "enqueue": float(np.median(enqueue)),
            "cpu_share": cpu_s * 1e3 / sum(enqueue),
            "gc_ms": gc_s[1] * 1e3 / len(ms),
            "ivcsw": (ru1.ru_nivcsw - ru0.ru_nivcsw) / len(ms),
            "device": dev_ms}


def profile_request(request, what: str) -> None:
    """Device kernel time of one ``request()`` by the profiler, against its
    wall time, and the largest CUDA kernels."""
    from torch.profiler import ProfilerActivity, profile

    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
           and getattr(e, "device_time_total", 0) > 0]
    total = sum(e.device_time_total for e in evs) / 1e3
    if total == 0:
        log("  profiler: no device time recorded (not measured)")
        return
    log(f"  profiler, one {what}: device kernel time "
        f"{total:.3f} ms in {wall:.3f} ms wall (device idle share "
        f"{max(0.0, 1 - total / wall):.3f}, profiler on)")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:12]:
        log(f"    {e.device_time_total / 1e3:8.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


# --------------------------------------------------------------- serving
FIXED = 1344  # the deployment canvas, TPU.FIXED_EDGE_SIZE
SHORT = 800  # INPUT.MIN_SIZE_TEST, the serving canvas's short side
# (seed, H, W) of the serving images, at their resized sizes: the first is
# the checks' image; the three cover the tight canvases 1344x800,
# 800x1344 and 800x800
SERVING_IMAGES = ((200, 1333, 800), (201, 800, 1333), (202, 800, 800))
# s2d stem against the plain stem in f32, TF32 off: max abs err within
# STEM_TOL of the largest plain output (cuDNN sums the 2x2 s2d convs and
# the 3x3 convs in different orders, by different algorithms); the CPU
# test of the same stems holds them to the same limit
STEM_TOL = 1e-5
PER_LEVEL_CANDIDATES = 5000  # TPU.NMS_CANDIDATES of the per-level request


def u8_image(seed: int, H: int, W: int) -> np.ndarray:
    """A uint8 (H, W, 3) BGR image from a seed, already at its resized
    size."""
    return np.random.RandomState(seed).randint(0, 256, (H, W, 3)) \
        .astype(np.uint8)


def serving_inputs(img: np.ndarray, fixed: int, short: int, dev):
    """The host's uint8 s2d pack of ``img`` over its quantized tight
    canvas, on the device, with its valid_hw and the canvas."""
    from centermask2_tpu_torch.data import s2d_pack_u8, s2d_serving_canvas

    h, w = img.shape[:2]
    canvas = s2d_serving_canvas(h, w, fixed, short)
    pack = torch.from_numpy(s2d_pack_u8(img, canvas)).to(dev)
    return pack, torch.tensor([[h, w]], dtype=torch.int32, device=dev), canvas


def reduce_outputs(out) -> torch.Tensor:
    """Every output head reduced into one value (nothing left for the
    device to skip)."""
    return out.locations.sum() + out.mask_scores.sum() + \
        out.pred_boxes.sum() + out.pred_classes.sum() + \
        out.pred_masks.sum() + out.scores.sum() + out.valid.sum()


def check_u8_normalization(model, img, fixed: int, short: int, dev):
    """The tight uint8 pack padded back and normalized on the device must
    be ``torch.equal`` to the host's f32 s2d input. Returns it (NHWC)."""
    from centermask2_tpu_torch.data import s2d_preprocess

    x, hw, canvas = serving_inputs(img, fixed, short, dev)
    got = model._normalize_u8_s2d(model._pad_to_canvas(x, (fixed, fixed)),
                                  hw)
    want = torch.from_numpy(s2d_preprocess(img, fixed)).to(dev)
    equal = torch.equal(got, want)
    log(f"  uint8 {img.shape[0]}x{img.shape[1]} packed over {canvas[0]}x"
        f"{canvas[1]} ({x.numel()} bytes), padded back to {fixed}x{fixed} "
        f"and normalized on the device: torch.equal to the host f32 s2d "
        f"input {tuple(want.shape)}: {equal}")
    if not equal:
        raise AssertionError("uint8 normalization differs from the host's")
    return got


def check_s2d_stem(model_s2d, model_plain, xd, img, fixed: int, dev) -> float:
    """The s2d stem on the normalized pack ``xd`` against the plain stem on
    the normalized image canvas, within STEM_TOL of the largest plain
    value. Returns the max abs error."""
    from centermask2_tpu_torch.data import single_preprocessing

    x = torch.from_numpy(single_preprocessing(img, fixed)[None]).to(dev)
    with torch.no_grad():
        want = model_plain.backbone.stem(x.permute(0, 3, 1, 2).contiguous())
        got = model_s2d.backbone.stem(xd.permute(0, 3, 1, 2).contiguous())
    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise AssertionError(f"s2d stem {tuple(got.shape)} vs plain "
                             f"{tuple(want.shape)}")
    d = (got - want).abs()
    err, scale = float(d.max()), float(want.abs().max())
    i = np.unravel_index(int(d.argmax()), tuple(d.shape))
    log(f"  s2d stem vs plain stem, f32: {tuple(got.shape)}, max abs err "
        f"{err:.3e} of max |plain| {scale:.3e} (tolerance {STEM_TOL} x "
        f"that); worst at (n, c, y, x) {tuple(int(v) for v in i)}: s2d "
        f"{float(got[i]):.9g} plain {float(want[i]):.9g}")
    if not err <= STEM_TOL * scale:
        raise AssertionError(f"s2d stem: max abs err {err} outside "
                             f"{STEM_TOL} x {scale}")
    return err


def graph_ms(request) -> tuple:
    """(eager ms, device ms as a CUDA graph) of one request."""
    for _ in range(3):  # cuDNN's first calls at a new shape
        request()
    torch.cuda.synchronize()
    eager = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        request()
        b.record()
        b.synchronize()
        eager.append(a.elapsed_time(b))
    med = float(np.median(eager))
    return med, device_ms_per_request(request, med)


def serving_times(model, imgs, fixed: int, short: int, dev) -> None:
    """Device ms per bf16 request by CUDA-graph replay at each tight
    canvas (tight compute) and at the deployment canvas (pad-back), the
    host's pack time per image, and the bytes each request sends."""
    from centermask2_tpu_torch.data import s2d_pack_u8, s2d_serving_canvas

    card = card_line()
    cases = []
    for img in imgs:
        x, hw, canvas = serving_inputs(img, fixed, short, dev)
        cases.append((f"{canvas[0]}x{canvas[1]} tight compute", x, hw, None))
    x, hw, _ = serving_inputs(imgs[1], fixed, short, dev)
    cases.append((f"{fixed}x{fixed} pad-back of the {imgs[1].shape[0]}x"
                  f"{imgs[1].shape[1]} pack", x, hw, (fixed, fixed)))
    for name, x, hw, canvas in cases:
        eager, device = graph_ms(
            lambda x=x, hw=hw, c=canvas: reduce_outputs(
                model.inference(x, None, hw, c)))
        log(f"  bf16 {name}: device {device:.3f} ms/req as a CUDA graph, "
            f"eager median of 5 {eager:.3f} ms ({card})")
    x, hw = cases[1][1:3]
    profile_request(lambda: model.inference(x, None, hw),
                    f"bf16 {cases[1][0]} request")
    for img in imgs:
        h, w = img.shape[:2]
        canvas = s2d_serving_canvas(h, w, fixed, short)
        times = []
        for _ in range(7):
            t0 = time.perf_counter()
            pack = s2d_pack_u8(img, canvas)
            times.append((time.perf_counter() - t0) * 1e3)
        full = (fixed // 4 + 1) ** 2 * 48
        log(f"  host pack {h}x{w} over {canvas[0]}x{canvas[1]}: median "
            f"{np.median(times):.3f} ms (numpy, 7 runs; "
            f"{len(os.sched_getaffinity(0))} host CPUs); bytes per request "
            f"{pack.nbytes} uint8 tight, {full} uint8 full canvas, "
            f"{fixed * fixed * 3 * 4} f32 NHWC canvas "
            f"({fixed * fixed * 12 / pack.nbytes:.2f}x the tight pack)")


def check_captured(seen, what: str, errs: dict) -> None:
    """Each kernel against its plain version on the inputs captured from
    one request (``capture_kernel_inputs``); the worst errors go into
    ``errs``."""
    errs["nms"] = max(errs["nms"], nms_case(*seen["nms"], what))
    errs["roi_align"] = max(errs["roi_align"],
                            roi_case(*seen["roi_align"][:7], what))


def serving(dev, models, cfg, fixed: int = FIXED, short: int = SHORT,
            shapes=SERVING_IMAGES, timing: bool = True):
    """The ``[serving]`` phase on the s2d serving config ``cfg``
    (``serving_cfg()``). ``models``: the NHWC models of ``[serve]`` by dtype
    name, whose parameters the s2d models load. Returns (the bf16 s2d
    model, launches of its main-path requests, launches of the per-level
    request, the largest kernel/plain error of each kernel)."""
    from centermask2_tpu_torch.data import single_preprocessing
    from centermask2_tpu_torch.ops import _kernels

    if not cfg.TPU.S2D_STEM_INPUT:
        raise ValueError("serving: the config needs TPU.S2D_STEM_INPUT")
    K = cfg.MODEL.FCOS.POST_NMS_TOPK_TEST
    model = build_model(cfg, dev)
    model.load_state_dict(models["bfloat16"].state_dict())
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = build_model(cfg32, dev)
    model32.load_state_dict(models["float32"].state_dict())
    imgs = [u8_image(*s) for s in shapes]
    errs = {"nms": 0, "roi_align": 0.0}

    xd = check_u8_normalization(model32, imgs[0], fixed, short, dev)
    check_s2d_stem(model32, models["float32"], xd, imgs[0], fixed, dev)
    x, hw, _ = serving_inputs(imgs[0], fixed, short, dev)
    nhwc = torch.from_numpy(single_preprocessing(imgs[0], fixed)[None]).to(dev)
    outs = []
    seen = capture_kernel_inputs(lambda: outs.append(
        model32.inference(x, None, hw, (fixed, fixed))))
    check_captured(seen, f"f32 uint8 {fixed}x{fixed} pad-back request", errs)
    with plain_kernels():
        plain = model32.inference(x, None, hw, (fixed, fixed))
    compare_outputs(outs[0], plain, K, f"f32 uint8 {fixed}x{fixed} kernels "
                    "vs plain")
    n = compare_outputs(outs[0], models["float32"].inference(nhwc), K,
                        "f32 uint8 tight pack vs f32 NHWC")
    log(f"  f32 {fixed}x{fixed}: {n} valid slots, classes equal")

    # the main path: each image's tight pack, padded back and at its own
    # canvas, in bf16 through the kernels, launch counts read around it;
    # each request's kernel inputs are captured (the capture passes the
    # calls through) and checked against the plain versions after it
    packs = [serving_inputs(img, fixed, short, dev) for img in imgs]
    model.inference(packs[0][0], None, packs[0][1], (fixed, fixed))  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    captured = []
    for img, (x, hw, canvas) in zip(imgs, packs):
        for c in ((fixed, fixed), None):
            outs = []
            seen = capture_kernel_inputs(lambda: outs.append(
                model.inference(x, None, hw, c)))
            where = f"{img.shape[0]}x{img.shape[1]} " + (
                f"{fixed}x{fixed} pad-back" if c else
                f"{canvas[0]}x{canvas[1]} tight compute")
            n = check_outputs(outs[0], 1, K, f"bf16 {where}")
            log(f"  bf16 {where}: {n} valid of {K}")
            captured.append((seen, f"bf16 {where}"))
    launches = {"nms": _kernels.nms_launches,
                "roi_align": _kernels.roi_align_launches}
    if set(launches.values()) != {len(captured)}:
        raise AssertionError(f"{len(captured)} serving requests: launches "
                             f"{launches}")
    log(f"  {len(captured)} bf16 serving requests: launches {launches}")
    for seen, what in captured:
        check_captured(seen, what, errs)
    del captured, seen

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.inference(x, None, hw, (fixed, fixed))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_outputs(out, 1, K, "sync-debug uint8 request")
    log("  uint8 request under sync-debug mode 'error', inputs on the "
        "device: no host sync on the path")

    per_level = per_level_request(cfg, models["bfloat16"], imgs[0], fixed,
                                  short, dev, K, timing, errs)
    if timing:
        serving_times(model, imgs, fixed, short, dev)
    return model, launches, per_level, errs


def per_level_request(cfg, params_from, img, fixed: int, short: int, dev,
                      K: int, timing: bool, errs: dict) -> dict:
    """One bf16 request with TPU.NMS_CANDIDATES = 5000 (every level's top
    PRE_NMS_TOPK_TEST into one NMS): one launch of each kernel, the keep
    set bit-equal to the plain NMS and the ROIAlign within tolerance of
    the plain version on the captured inputs. Returns the request's
    launches."""
    from centermask2_tpu_torch.ops import _kernels

    cfg = cfg.clone()
    cfg.TPU.NMS_CANDIDATES = PER_LEVEL_CANDIDATES
    model = build_model(cfg, dev)
    model.load_state_dict(params_from.state_dict())
    x, hw, _ = serving_inputs(img, fixed, short, dev)
    model.inference(x, None, hw, (fixed, fixed))  # warm-up
    torch.cuda.synchronize()
    outs = []
    _kernels.reset_launch_counts()
    seen = capture_kernel_inputs(lambda: outs.append(
        model.inference(x, None, hw, (fixed, fixed))))
    launches = {"nms": _kernels.nms_launches,
                "roi_align": _kernels.roi_align_launches}
    n = check_outputs(outs[0], 1, K, "per-level request")
    if set(launches.values()) != {1}:
        raise AssertionError(f"per-level request: launches {launches}")
    sboxes, svalid, thr = seen["nms"]
    log(f"  per-level bf16 request: NMS over N = {int(svalid.shape[1])} "
        f"sorted rows ({int(svalid.sum())} valid candidates), {n} valid of "
        f"{K}, launches {launches}")
    check_captured(seen, f"per-level request {fixed}x{fixed}", errs)
    if timing:
        nms_row(sboxes, svalid, thr, "per-level request")
    return launches


# ------------------------------------------------------------------ eval
# (H, W) of the eval images, already at their resized sizes (short edge
# 800, long edge up to 1333): landscape, portrait and square, so the
# three serving canvases all occur
EVAL_SHAPES = ((800, 1333), (1333, 800), (800, 800), (800, 1200),
               (1066, 800), (800, 1088), (1200, 800), (800, 800))
EVAL_CATEGORIES = (1, 3, 18, 44)


def _polygon(rng, x0, y0, bw, bh, kind: int):
    """A rectangle, triangle or hexagon in the box (x0, y0, bw, bh)."""
    if kind == 0:
        pts = [(0, 0), (1, 0), (1, 1), (0, 1)]
    elif kind == 1:
        pts = [(0, 1), (0.5, 0), (1, 1)]
    else:
        pts = [(0.25, 0), (0.75, 0), (1, 0.5), (0.75, 1), (0.25, 1), (0, 0.5)]
    return [float(v) for px, py in pts for v in (x0 + px * bw, y0 + py * bh)]


def make_coco_dataset(root: str, shapes=EVAL_SHAPES, seed: int = 7,
                      sides=(20, 64, 240)) -> str:
    """A COCO-format dataset from a seed: uint8 BGR images as ``.npy``,
    and per image a small, a medium and a large polygon (boxes of about
    ``sides``, within 10%) over the categories in turn, plus one crowd
    region in the first image. Returns the annotation json's path."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (H, W) in enumerate(shapes, 1):
        name = f"{i:012d}.npy"
        np.save(os.path.join(root, name), u8_image(seed + i, H, W))
        images.append({"id": i, "file_name": name, "height": H, "width": W})
        for j, side in enumerate(sides):
            bw, bh = side * (0.9 + 0.2 * rng.rand(2))
            x0, y0 = rng.rand() * (W - bw - 1), rng.rand() * (H - bh - 1)
            kind = (i + j) % 3
            area = bw * bh * (1.0, 0.5, 0.75)[kind]
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": EVAL_CATEGORIES[len(anns) % len(
                             EVAL_CATEGORIES)],
                         "bbox": [x0, y0, bw, bh], "area": area, "iscrowd": 0,
                         "segmentation": [_polygon(rng, x0, y0, bw, bh,
                                                   kind)]})
    H, W = shapes[0]
    anns.append({"id": len(anns) + 1, "image_id": 1,
                 "category_id": EVAL_CATEGORIES[0],
                 "bbox": [0.0, 0.0, W / 2, H / 2], "area": W * H / 4,
                 "iscrowd": 1,
                 "segmentation": [_polygon(rng, 0, 0, W / 2, H / 2, 0)]})
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c, "name": f"cat{c}"}
                                  for c in EVAL_CATEGORIES]}, f)
    return path


def check_ground_truth_ap(ann: str) -> dict:
    """The ground truth fed back as predictions (score 1, its masks
    rasterized at full resolution) must score AP 100.0, bbox and segm."""
    from centermask2_tpu_torch.evaluation import COCOEvaluator, COCOGt, rle

    with open(ann) as f:
        gt = COCOGt(json.load(f))
    cls = {c: i for i, c in enumerate(sorted(gt.cats))}
    ev = COCOEvaluator(gt, category_id_map={i: c for c, i in cls.items()})
    for img_id in sorted(gt.imgs):
        a = [x for x in gt.img_to_anns[img_id] if not x["iscrowd"]]
        xywh = np.array([x["bbox"] for x in a], np.float64)
        ones = np.ones(len(a))
        ev.process(img_id, {
            "pred_boxes": np.concatenate([xywh[:, :2],
                                          xywh[:, :2] + xywh[:, 2:]], 1),
            "scores": ones, "mask_scores": ones,
            "pred_classes": np.array([cls[x["category_id"]] for x in a]),
            "pred_masks": np.stack([rle.decode(gt.ann_rle(x)) for x in a])})
    res = ev.evaluate()
    ap = {t: res[t]["AP"] for t in ("bbox", "segm")}
    log(f"  evaluator, ground truth fed back: AP bbox {ap['bbox']:.4f}, "
        f"segm {ap['segm']:.4f}")
    if any(abs(v - 100.0) > 1e-9 for v in ap.values()):
        raise AssertionError(f"ground truth fed back scores {ap}")
    return ap


def eval_phase(dev, model, fixed: int = FIXED, min_size: int = SHORT,
               max_size: int = 1333, shapes=EVAL_SHAPES,
               sides=(20, 64, 240)) -> dict:
    """The ``[eval]`` phase: ``evaluate_dataset`` over a synthetic COCO set
    in a temporary directory, read through ``np.load``. The tight and the
    full pack must give equal predictions; tight compute must give finite
    metrics under every key. Returns the launches of its requests."""
    import tempfile

    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.ops import _kernels

    card = card_line()
    launches = {"nms": 0, "roi_align": 0}
    with tempfile.TemporaryDirectory() as root:
        ann = make_coco_dataset(root, shapes, sides=sides)
        check_ground_truth_ap(ann)
        common = dict(ann=ann, image_root=root, fixed_size=fixed,
                      min_size=min_size, max_size=max_size,
                      progress_every=0, read_image=np.load)
        runs = {}
        for mode, kw in (("tight pack, pad-back", {}),
                         ("full pack", {"tight": False}),
                         ("tight compute", {"tight_compute": True})):
            _kernels.reset_launch_counts()
            res, avg_ms, ev = evaluate_dataset(model, **kw, **common)
            got = {"nms": _kernels.nms_launches,
                   "roi_align": _kernels.roi_align_launches}
            if set(got.values()) != {len(shapes)}:
                raise AssertionError(f"eval {mode}: launches {got} for "
                                     f"{len(shapes)} images")
            for k in launches:
                launches[k] += got[k]
            runs[mode] = (res, ev)
            log(f"  eval {mode}: {len(shapes)} images, "
                f"{len(ev.predictions)} predictions, avg {avg_ms:.3f} "
                f"ms/img, steady {ev.steady_ms_per_image:.3f} ms/img "
                f"(median completion interval), bbox AP "
                f"{res['bbox']['AP']:.4f}, launches {got} ({card})")
    tight, full = runs["tight pack, pad-back"][1], runs["full pack"][1]
    if tight.predictions != full.predictions:
        raise AssertionError("eval: tight and full pack predictions differ")
    log(f"  eval: tight and full pack predictions equal "
        f"({len(tight.predictions)})")
    res = runs["tight compute"][0]
    want = {"bbox": {"AP", "AP50", "AP75", "APs", "APm", "APl", "AR1",
                     "AR10", "AR100"}, "segm": None, "box_proposals": {
                "AR@100", "ARs@100", "ARm@100", "ARl@100", "AR@1000",
                "ARs@1000", "ARm@1000", "ARl@1000"}}
    want["segm"] = want["bbox"]
    for task, keys in want.items():
        metrics = res.get(task, {})
        missing = keys - set(metrics)
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if missing or bad:
            raise AssertionError(f"eval tight compute {task}: missing "
                                 f"{sorted(missing)}, not finite {bad}")
    log(f"  eval tight compute: every metric present and finite; segm AP "
        f"{res['segm']['AP']:.4f}, AR@100 "
        f"{res['box_proposals']['AR@100']:.4f}")
    return launches


# ----------------------------------------------------------------- train
TRAIN_BATCH = 2  # the reference's per-GPU share of IMS_PER_BATCH 16 on 8
TRAIN_GT = 20  # gt boxes an image, 16 to 600 px
TRAIN_WARMUP = 3
TRAIN_TIMED = 10
OVERFIT_STEPS = 20
# the classification prior bias (-4.6) leaves every random-weight score
# under the 0.05 train threshold, so the train decode would hand NMS no
# candidate; at -2.5 (sigmoid 0.076) over 1000 pass while the focal loss
# of the ~6 M negatives stays of order 10
TRAIN_CLS_BIAS = -2.5


def _shape_patch(rng, p: int) -> np.ndarray:
    """A (p, p) {0, 1} mask: a rectangle, triangle or ellipse."""
    yy, xx = np.mgrid[0:p, 0:p].astype(np.float32) / p
    kind = rng.randint(3)
    if kind == 0:
        a, b = rng.rand(2) * 0.3
        return ((xx >= a) & (xx <= 1 - b) & (yy >= b) & (yy <= 1 - a)) \
            .astype(np.float32)
    if kind == 1:
        return (yy >= np.abs(xx - 0.5) * 2).astype(np.float32)
    return (((xx - 0.5) / 0.5) ** 2 + ((yy - 0.5) / 0.45) ** 2 <= 1) \
        .astype(np.float32)


def make_train_batch(seed: int, batch: int, fixed: int, n_gt: int,
                     max_gt: int, patch: int = 112,
                     sides=(16, 600)) -> dict:
    """A batch in ``data/coco.py::train_batches``' format from a seed, on
    (fixed, fixed) canvases: normalized-scale noise with each gt box
    painted in a texture, ``n_gt`` boxes of ``sides`` px (log-uniform) an
    image among ``max_gt`` slots, and 112x112 mask patches (rectangles,
    triangles, ellipses), so the card needs no cv2 or PIL."""
    rng = np.random.RandomState(seed)
    img = (rng.randn(batch, fixed, fixed, 3) * 0.3 - 1.0).astype(np.float32)
    boxes = np.zeros((batch, max_gt, 4), np.float32)
    classes = np.zeros((batch, max_gt), np.int32)
    valid = np.zeros((batch, max_gt), bool)
    patches = np.zeros((batch, max_gt, patch, patch), np.float32)
    sizes = np.zeros((batch, 2), np.int32)
    for b in range(batch):
        h, w = fixed - rng.randint(0, fixed // 8, 2)
        sizes[b] = h, w
        lo, hi = np.log(sides[0]), np.log(min(sides[1], h - 2, w - 2))
        img[b, h:], img[b, :, w:] = 0.0, 0.0
        for g in range(n_gt):
            bw, bh = np.exp(rng.uniform(lo, hi, 2))
            x0 = rng.rand() * (w - bw - 1)
            y0 = rng.rand() * (h - bh - 1)
            boxes[b, g] = x0, y0, x0 + bw, y0 + bh
            classes[b, g] = rng.randint(80)
            valid[b, g] = True
            patches[b, g] = _shape_patch(rng, patch)
            ys, xs = int(y0), int(x0)
            img[b, ys:int(y0 + bh), xs:int(x0 + bw)] += \
                np.float32(1.0 + classes[b, g] / 40.0)
    return {"image": img, "gt_boxes": boxes, "gt_classes": classes,
            "gt_valid": valid, "gt_mask_patches": patches,
            "image_size": sizes}


def build_trainer(cfg, dev, state=None):
    """The flagship model, its optimizer and schedule and the train step
    (``train/trainer.py::make_train_step``), random weights from seed 0
    with the classification bias at ``TRAIN_CLS_BIAS``, or ``state``'s
    parameters."""
    from centermask2_tpu_torch.train import (make_optimizer_from_cfg,
                                             make_train_step)

    model = build_model(cfg, dev).train()
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.fill_(TRAIN_CLS_BIAS)
    if state is not None:
        model.load_state_dict(state)
    opt, sched = make_optimizer_from_cfg(model, cfg)
    return model, opt, sched, make_train_step(model, opt, sched)


def check_losses(metrics: dict, what: str) -> dict:
    m = {k: float(v) for k, v in metrics.items()}
    want = {"loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr", "loss_mask",
            "loss_maskiou", "total_loss"}
    if set(m) != want or not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"{what}: losses {m}")
    return m


def capture_step_inputs(run) -> dict:
    """The arguments of each kernel's launch in one train step
    (``run()``, which goes through the kernels as usual)."""
    from centermask2_tpu_torch.ops import _kernels

    seen = {}

    def recorder(name, fn):
        def call(*args):
            seen[name] = args
            return fn(*args)
        return call

    with kernels_swapped(*(recorder(n, getattr(_kernels, n))
                           for n in KERNEL_FNS)):
        run()
    torch.cuda.synchronize()
    if set(seen) != set(KERNEL_FNS):
        raise AssertionError(f"the step reached only {sorted(seen)}")
    return seen


def roi_bwd_case(args, what: str) -> float:
    """Kernel 2b against the plain VJP on one input (tolerance above).
    Raises outside it; returns the max abs error."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.roi_align import \
        roi_align_feature_grad_plain

    k = _kernels.roi_align_backward(*args)
    p = roi_align_feature_grad_plain(*args)
    torch.cuda.synchronize()
    dtype = args[5]
    scale = max(float(t.float().abs().max()) for t in p)
    worst, bad = 0.0, []
    for lvl, (a, b) in enumerate(zip(k, p)):
        if a.shape != b.shape or a.dtype != dtype:
            raise AssertionError(f"roi_align_backward {what}: level {lvl} "
                                 f"{tuple(a.shape)} {a.dtype}")
        d = (a.float() - b.float()).abs()
        tol = torch.full_like(d, ROI_BWD_REL * scale)
        if dtype == torch.bfloat16:  # one bf16 ulp of each plain value
            mag = b.float().abs()
            tol = tol + torch.where(
                mag > 0, torch.exp2(torch.floor(torch.log2(mag)) - 7), 0.0)
        worst = max(worst, float(d.max()))
        if not (bool((d <= tol).all()) and bool(torch.isfinite(a).all())):
            bad.append(lvl)
    tol_s = (f"{ROI_BWD_REL} x max|plain|" if dtype == torch.float32 else
             f"1 bf16 ulp + {ROI_BWD_REL} x max|plain|")
    log(f"  roi_align_backward {what}: {str(dtype)[6:]} R={args[0].shape[0]} "
        f"C={args[0].shape[1]}, levels {[tuple(t.shape[2:]) for t in p]}: "
        f"max abs err {worst:.3e}, max |plain| {scale:.3e} (tolerance "
        f"{tol_s})")
    if bad:
        raise AssertionError(f"roi_align_backward {what}: levels {bad} "
                             f"outside {tol_s}")
    return worst


def check_roi_bwd_synthetic(dev, fixed: int, batch: int, R: int, C: int,
                            errs: dict, timing: bool) -> None:
    """Kernel 2b against the plain VJP on P3-P5 of the training canvas at
    the step's R and C, f32 and bf16, with ROIs on every level (the
    served and trained random-weight ROIs all land on P3): the synthetic
    boxes of ``[kernels]`` (timed with ``timing``), then ROIs all on
    P5."""
    from centermask2_tpu_torch.ops import assign_boxes_by_ratio
    from centermask2_tpu_torch.structures import boxes as box_ops

    rng = np.random.RandomState(2)
    scales = (1 / 8, 1 / 16, 1 / 32)
    for large in (False, True):
        feats, boxes = roi_inputs(rng, fixed, fixed, R, C, batch, dev, large)
        levels = assign_boxes_by_ratio(
            box_ops.area(boxes), torch.full((R,), float(fixed * fixed),
                                            device=dev), 3, 5)
        bidx = (torch.arange(R, device=dev) % batch).to(torch.int32)
        grad = torch.from_numpy(
            rng.randn(R, C, 14, 14).astype(np.float32)).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            args = (grad.to(dt), boxes, bidx, levels,
                    [tuple(f.shape) for f in feats], dt, scales, 14, 2, True)
            what = f"synthetic {'P5 ' if large else ''}ROIs, levels " \
                f"{sorted(set(levels.tolist()))}"
            errs["roi_align_backward"] = max(errs["roi_align_backward"],
                                             roi_bwd_case(args, what))
            if timing and not large:
                roi_bwd_row(args, what)


def check_step_kernels(seen, what: str, errs: dict) -> None:
    """The three kernels against their plain versions on one step's
    captured inputs; the worst errors go into ``errs``."""
    with torch.no_grad():
        errs["nms"] = max(errs["nms"],
                          nms_case(*seen["nms_keep_sorted"], what))
        errs["roi_align"] = max(errs["roi_align"],
                                roi_case(*seen["roi_align"][:7], what))
        errs["roi_align_backward"] = max(
            errs["roi_align_backward"],
            roi_bwd_case(seen["roi_align_backward"], what))


def roi_bwd_row(args, what: str) -> dict:
    """Median times of kernel 2b and the plain VJP on one input, and the
    bound: the gradient read and the level gradients written (bytes), or
    two flops a tap of every in-range sample (operations)."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.roi_align import (
        _axis_coords, roi_align_feature_grad_plain)

    grad, boxes, bidx, levels, shapes, dtype, scales, o, s, aligned = args
    ms = time_gpu_ms(lambda: _kernels.roi_align_backward(*args))
    plain_ms = time_gpu_ms(lambda: roi_align_feature_grad_plain(*args),
                           launches=3, repeats=5)
    R, C = grad.shape[:2]
    lv = levels.long().clamp(0, len(shapes) - 1)
    scale_r = torch.tensor(scales, device=boxes.device)[lv]
    ys, xs = _axis_coords(boxes.float(), scale_r, o, s, aligned)
    h = torch.tensor([shp[2] for shp in shapes], device=boxes.device)[lv]
    w = torch.tensor([shp[3] for shp in shapes], device=boxes.device)[lv]
    ok_y = ((ys >= -1) & (ys <= h[:, None].float())).sum(dim=1)
    ok_x = ((xs >= -1) & (xs <= w[:, None].float())).sum(dim=1)
    samples = int((ok_y * ok_x).sum())  # in-range samples of all ROIs
    elt = grad.element_size()
    level_elems = sum(int(np.prod(shp)) for shp in shapes)
    nbytes = grad.numel() * elt + level_elems * elt + R * (16 + 4 + 4)
    flops = C * samples * 4 * 2 + grad.numel()
    bound = max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS) * 1e3
    by = "bytes" if nbytes / PEAK_BYTES_S > flops / PEAK_F32_FLOPS else \
        "operations"
    own = (level_elems * 4 * 3 + grad.numel() * elt
           + (level_elems * elt if dtype != torch.float32 else 0))
    log(f"  roi_align_backward {what}: {str(dtype)[6:]} R={R} C={C}, "
        f"{samples} in-range samples, {C * samples * 4} atomic adds; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({by}: "
        f"{nbytes} bytes, {flops} flops); the kernel's own traffic (scratch "
        f"zeroed, added to, read by the cast) is {own} bytes, "
        f"{own / PEAK_BYTES_S * 1e3:.6f} ms at the peak rate")
    return {"name": "roi_align_backward", "route": "cuda",
            "source": ROI_SOURCE, "replaces": ROI_BWD_REPLACES, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def step_grads(model, images, gt, draws):
    """Losses and parameter gradients of one step, no update."""
    model.zero_grad(set_to_none=True)
    losses = model.loss(images, gt, draws=draws)
    sum(losses.values()).backward()
    torch.cuda.synchronize()
    return ({k: v.detach().clone() for k, v in losses.items()},
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None})


def check_f32_step(cfg, dev, state, images, gt, draws, errs: dict) -> None:
    """One f32 step (TF32 off, deterministic cuDNN) through the kernels
    against the same step through the plain versions: the losses equal,
    every parameter gradient within GRAD_NOISE_FACTOR x its noise floor,
    the larger of the two plain runs' difference, the two kernel runs'
    difference (kernel 2b's atomics) and 1e-6 of the tensor's largest
    value. The kernels are held against their plain versions on the
    step's captured inputs."""
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        model = build_trainer(cfg32, dev, state)[0]
        runs = {}
        seen = capture_step_inputs(lambda: runs.setdefault(
            "k1", step_grads(model, images, gt, draws)))
        check_step_kernels(seen, "f32 train step", errs)
        del seen
        runs["k2"] = step_grads(model, images, gt, draws)
        with plain_kernels():
            runs["p1"] = step_grads(model, images, gt, draws)
            runs["p2"] = step_grads(model, images, gt, draws)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = saved
    (lk, gk), (lp, gp) = runs["k1"], runs["p1"]
    for name in lk:
        a, b = float(lk[name]), float(lp[name])
        if not abs(a - b) <= 1e-6 * abs(b):
            raise AssertionError(f"f32 step {name}: kernels {a!r} plain {b!r}")
    log("  f32 train step, kernels vs plain, losses: " + ", ".join(
        f"{k} {float(lk[k]):.6f} (diff {float(lk[k] - lp[k]):.1e})"
        for k in lk))
    worst_ratio, worst_name, floors = 0.0, "", []
    for name, g in gk.items():
        p1, p2, k2 = gp[name], runs["p2"][1][name], runs["k2"][1][name]
        top = float(p1.abs().max())
        floor = max(float((p1 - p2).abs().max()),
                    float((g - k2).abs().max()), 1e-6 * top, 1e-30)
        ratio = float((g - p1).abs().max()) / floor
        if top > 0:
            floors.append(floor / top)
        if ratio > worst_ratio:
            worst_ratio, worst_name = ratio, name
    if set(gk) != set(gp) or worst_ratio > GRAD_NOISE_FACTOR:
        raise AssertionError(f"f32 step gradients: {worst_name} at "
                             f"{worst_ratio:.2f} x its noise floor")
    log(f"  f32 train step, kernels vs plain: {len(gk)} parameter gradients, "
        f"worst {worst_ratio:.2f} x its noise floor ({worst_name}); floors "
        f"{min(floors):.1e}-{max(floors):.1e} of each tensor's max "
        f"(tolerance {GRAD_NOISE_FACTOR} x)")
    del model, runs
    torch.cuda.empty_cache()


def profile_train_step(run) -> None:
    """Device time of one train step by the profiler, its largest CUDA
    kernels, and the port's kernels in microseconds."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
           and getattr(e, "device_time_total", 0) > 0]
    total = sum(e.device_time_total for e in evs) / 1e3
    if total == 0:
        log("  profiler: no device time recorded (not measured)")
        return
    log(f"  profiler, one bf16 train step: device kernel time {total:.3f} ms "
        f"in {wall:.3f} ms wall (device idle share "
        f"{max(0.0, 1 - total / wall):.3f}, profiler on)")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:15]:
        log(f"    {e.device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    for e in evs:
        if any(t in e.key for t in ("nms", "roi_align", "cast_bf16")):
            log(f"  profiler, port kernel in the train step: "
                f"{e.device_time_total / e.count:.3f} us per launch of "
                f"{e.key.replace('(anonymous namespace)::', '')[:60]} "
                f"(x{e.count})")


def train_phase(dev, cfg, fixed: int = FIXED, batch: int = TRAIN_BATCH,
                n_gt: int = TRAIN_GT, warmup: int = TRAIN_WARMUP,
                timed: int = TRAIN_TIMED, overfit: int = OVERFIT_STEPS,
                sides=(16, 600), roi_rc=(256, 256), timing: bool = True):
    """The ``[train]`` phase on the flagship config ``cfg``. Returns (the
    launches of its ``train_loop`` steps by kernel, the worst kernel/plain
    errors, kernel 2b's row or None without ``timing``)."""
    import itertools
    import tempfile

    from centermask2_tpu_torch.checkpoint.torch_io import (
        load_checkpoint, restore_train_state, save_checkpoint, train_state)
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.train import batch_to_device, train_loop

    card = card_line()
    max_gt = cfg.TPU.MAX_GT_INSTANCES
    batches = [make_train_batch(300 + i, batch, fixed, n_gt, max_gt,
                                sides=sides) for i in range(2)]
    model, opt, sched, step = build_trainer(cfg, dev)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    totals = {k: 0 for k in ("nms", "roi_align", "roi_align_backward")}

    # the CLI's loop: launch counts and a CUDA event after every step
    counts, events, metrics_seen = [], [], []

    def after_step(done, metrics):
        counts.append(_kernels.launch_counts())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        metrics_seen.append(metrics)

    def read_launches(n_steps: int, what: str) -> None:
        prev = {k: 0 for k in totals}
        for i, c in enumerate(counts):
            d = {k: c[k] - prev[k] for k in c}
            if set(d.values()) != {1}:
                raise AssertionError(f"{what} step {i}: launches {d}")
            prev = c
        if len(counts) != n_steps:
            raise AssertionError(f"{what}: {len(counts)} of {n_steps} steps")
        for k in totals:
            totals[k] += counts[-1][k]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    start_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    t0 = time.perf_counter()
    train_loop(step, itertools.cycle(batches), device=dev, start_iter=0,
               max_iter=warmup + timed, generator=gen, log_every=10 ** 9,
               after_step=after_step, log=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    read_launches(warmup + timed, "train_loop")
    ms = [a.elapsed_time(b) for a, b in zip(events[warmup - 1:],
                                            events[warmup:])]
    first = check_losses(metrics_seen[0], "step 1")
    last = check_losses(metrics_seen[-1], f"step {warmup + timed}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  {warmup + timed} bf16 steps through train_loop at {fixed}x{fixed}"
        f", B={batch}, {n_gt} gt an image: one launch of nms, roi_align and "
        f"roi_align_backward per step ({totals}); losses finite, step 1 "
        + ", ".join(f"{k} {v:.4f}" for k, v in first.items())
        + f"; step {warmup + timed} total {last['total_loss']:.4f}")
    if timing:
        q1, q2, q3 = np.percentile(ms, [25, 50, 75])
        log(f"  ms per bf16 train step (CUDA events over {timed} steps after "
            f"{warmup} of warm-up): median {q2:.3f} [q1 {q1:.3f}, q3 "
            f"{q3:.3f}] min {min(ms):.3f} max {max(ms):.3f}; "
            f"{batch / q2 * 1e3:.3f} images/s; loop wall "
            f"{wall / (warmup + timed) * 1e3:.3f} ms/step with the first "
            f"calls; peak memory {peak / 2 ** 30:.3f} GiB "
            f"(max_memory_allocated) ({card})")

    images, gt = batch_to_device(batches[0], dev)
    draws = torch.rand((batch, cfg.MODEL.FCOS.POST_NMS_TOPK_TRAIN + max_gt),
                       generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(images, gt, draws)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_losses(metrics, "sync-debug step")
    log("  a bf16 train step under sync-debug mode 'error', inputs on the "
        "device: no host sync in the step")

    seen = capture_step_inputs(lambda: step(images, gt, draws))
    check_step_kernels(seen, "bf16 train step", errs)
    with torch.no_grad():
        check_roi_bwd_synthetic(dev, fixed, batch, *roi_rc, errs, timing)
    row = None
    if timing:
        with torch.no_grad():
            nms_row(*seen["nms_keep_sorted"], "bf16 train step")
            roi_row(*seen["roi_align"], "bf16 train step")
            row = roi_bwd_row(seen["roi_align_backward"], "bf16 train step")
        profile_train_step(lambda: step(images, gt, draws))
    del seen

    check_f32_step(cfg, dev, init_state, images, gt, draws, errs)

    # overfit one batch: BASE_LR 0.01, no warm-up, global-norm clip 1.0
    cfg_fit = cfg.clone()
    cfg_fit.SOLVER.BASE_LR = 0.01
    cfg_fit.SOLVER.WARMUP_ITERS = 0
    cfg_fit.SOLVER.WARMUP_FACTOR = 1.0
    cfg_fit.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg_fit.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg_fit.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    del model, opt, sched, step
    torch.cuda.empty_cache()
    model, opt, sched, step = build_trainer(cfg_fit, dev, init_state)
    counts.clear()
    metrics_seen.clear()
    _kernels.reset_launch_counts()
    train_loop(step, itertools.repeat(batches[0]), device=dev, start_iter=0,
               max_iter=overfit, generator=gen, log_every=10 ** 9,
               after_step=after_step, log=log)
    read_launches(overfit, "overfit")
    losses = [check_losses(m, f"overfit step {i + 1}")["total_loss"]
              for i, m in enumerate(metrics_seen)]
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  overfit, {overfit} bf16 steps on one batch (BASE_LR 0.01, no "
        f"warm-up, global-norm clip 1.0): total loss "
        + " ".join(f"{v:.3f}" for v in losses)
        + f"; mean of the first 5 {head:.4f}, of the last 5 {tail:.4f}")
    if not tail < head:
        raise AssertionError(f"overfit: loss did not fall ({head} -> {tail})")

    # checkpoint round trip: every tensor back, and the next step equal
    with tempfile.TemporaryDirectory() as root:
        path = save_checkpoint(root, train_state(model, opt, sched, overfit),
                               overfit)
        state = load_checkpoint(path)

        def buffers(o):
            return [t for st in o.state.values() for t in st.values()
                    if torch.is_tensor(t)]

        before = {k: v.clone() for k, v in model.state_dict().items()}
        momentum = [t.clone() for t in buffers(opt)]
        epoch = sched.last_epoch
        ref = check_losses(step(images, gt, draws), "step before reload")
        ref_delta = {k: model.state_dict()[k] - before[k] for k in before}
        model2, opt2, sched2, step2 = build_trainer(cfg_fit, dev)
        if restore_train_state(state, model2, opt2, sched2) != overfit:
            raise AssertionError("checkpoint: step lost")
        restored = buffers(opt2)
        same = all(torch.equal(a, b) for a, b in zip(
            model2.state_dict().values(), before.values())) and \
            len(restored) == len(momentum) > 0 and \
            all(torch.equal(a, b) for a, b in zip(restored, momentum)) and \
            sched2.last_epoch == epoch
        again = check_losses(step2(images, gt, draws), "step after reload")
    delta = {k: model2.state_dict()[k] - before[k] for k in before}
    rel = max(float((delta[k] - ref_delta[k]).norm())
              / max(float(ref_delta[k].norm()), 1e-30)
              for k in delta if ref_delta[k].is_floating_point()
              and float(ref_delta[k].norm()) > 0)
    if not same or again != ref or rel > 1e-2:
        raise AssertionError(f"checkpoint round trip: state equal {same}, "
                             f"losses {ref} vs {again}, update rel {rel}")
    log(f"  checkpoint round trip on the card ({len(before)} model tensors, "
        f"momentum, schedule): state bit-equal; the step after reload gives "
        f"the same losses (total {again['total_loss']:.6f}) and an update "
        f"within {rel:.2e} of the step without it (kernel 2b's atomics "
        f"reorder its sums)")
    del model, model2, opt, opt2
    torch.cuda.empty_cache()
    return totals, errs, row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from centermask2_tpu_torch.ops import _kernels

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    secs = _kernels.build()
    log(f"[build] both sources (kernels 1, 2 and 2b) built in {secs:.1f} s")
    for name, text in _kernels.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    log("[kernels] each kernel against its plain version on the card")
    nms_err = check_nms(dev)
    roi_err = check_roi_align(dev)

    log("[serve] V-39-eSE flagship, random weights (seed 0), cls bias 0")
    models, launches, images = serve(dev)

    log("[time] each kernel on the inputs of a served bf16 "
        f"{REQUESTS[0][1]}x{REQUESTS[0][2]} request ({card})")
    seen = capture_kernel_inputs(lambda: models["bfloat16"].inference(
        images[0]))
    nms_err = max(nms_err, nms_case(*seen["nms"], "served request"))
    roi_args = seen["roi_align"]
    roi_err = max(roi_err, roi_case(*roi_args[:7], "served request"))
    nms = nms_row(*seen["nms"], "served request")
    roi = roi_row(*roi_args, "served request")
    profile_kernels(seen)
    nms["max_abs_err"], roi["max_abs_err"] = nms_err, roi_err
    del seen

    log(f"[time] per-image latency, B=1, CUDA events: {PASSES} passes over "
        f"the canvases and dtypes; each a {WARMUP_S} s warm-up, then a "
        f"window of >= {WINDOW_S} s and >= {MIN_TIMED} requests ({card}; "
        f"{len(os.sched_getaffinity(0))} host CPUs)")
    for p in range(1, PASSES + 1):
        for dtype_name, model in models.items():
            note = "bf16" if dtype_name == "bfloat16" else "f32, TF32 off"
            for img in (images[0], images[3]):
                H, W = img.shape[1:3]
                clk = gpu_clocks()
                r = latency_window(model, img)
                log(f"  pass {p} {H}x{W} {note}: {r['n']} requests after "
                    f"{r['warmup']} warm-up; ms/img median {r['median']:.3f} "
                    f"[q1 {r['q1']:.3f}, q3 {r['q3']:.3f}] min {r['min']:.3f} "
                    f"max {r['max']:.3f}, first 20 {r['first20']:.3f}; host "
                    f"enqueue median {r['enqueue']:.3f}, thread CPU share "
                    f"{r['cpu_share']:.3f}, gc {r['gc_ms']:.3f} ms/req, "
                    f"involuntary switches {r['ivcsw']:.2f}/req; device "
                    f"{r['device']:.3f} ms/req as a CUDA graph (idle share "
                    f"{max(0.0, 1 - r['device'] / r['median']):.3f}); sm/max "
                    f"MHz, C before: {clk} ({card})")
    profile_request(lambda: models["bfloat16"].inference(images[0]),
                    "bf16 800x1088 request")
    torch.cuda.synchronize()

    log("[serving] zy_model_serving.yaml: uint8 s2d tight packs, the s2d "
        "stem, the per-level decode, the same parameters as [serve]")
    s2d_model, serving_launches, per_level, errs = serving(dev, models,
                                                           serving_cfg())
    nms["max_abs_err"] = max(nms["max_abs_err"], errs["nms"])
    roi["max_abs_err"] = max(roi["max_abs_err"], errs["roi_align"])
    log("[eval] evaluate_dataset over a synthetic COCO set, serving model "
        "in bf16")
    eval_launches = eval_phase(dev, s2d_model)
    del s2d_model, models
    torch.cuda.empty_cache()

    log(f"[train] zy_model_config.yaml at full width in bf16, random weights "
        f"(seed 0), {FIXED}x{FIXED}, B={TRAIN_BATCH}, through train_loop "
        f"({card})")
    train_launches, train_errs, bwd = train_phase(dev, flagship_cfg())
    nms["max_abs_err"] = max(nms["max_abs_err"], train_errs["nms"])
    roi["max_abs_err"] = max(roi["max_abs_err"], train_errs["roi_align"])
    bwd["max_abs_err"] = train_errs["roi_align_backward"]

    for row in (nms, roi, bwd):
        row["launches"] = sum(c.get(row["name"], 0) for c in (
            launches, serving_launches, per_level, eval_launches,
            train_launches))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s total")
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in (nms, roi, bwd)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
