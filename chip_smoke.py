#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``centermask2_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

It builds the port's CUDA kernels from ``centermask2_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, serves the
V-39-eSE flagship (random weights from a seed) through the kernels, and
times the kernels and the end-to-end latency; then it serves and trains
the other backbone families and the person-keypoint model, serves
the flagship with the adaptive ROIAlign buckets and with deformable
convs, trains, serves and evaluates it data-parallel, and drives the
deployment toolchain (bins, the parity ladder, layer dumps, measures,
Cityscapes scoring, the native packer) and the port's measuring tools.
Phases, in order:

1. card:    the card's name and power limit (nvidia-smi).
2. build:   nvcc of every kernel, in parallel; build seconds, and each
            kernel's registers/spills from ``-Xptxas=-v``.
3. kernels: NMS keep sets bit-equal to the plain version at N = 1024,
            2048, 8192 (invalid rows, duplicate and zero-area boxes,
            score ties, class offsets, a batch of 2), and at N = 1024 and
            8192 on disjoint boxes (all kept), a suppression chain across
            every 64-box word, and an all-invalid image; ROIAlign on the
            P3-P5 shapes of 800x1088 within tolerance in f32 and bf16 for
            (o, s) = (14, 2), (7, 2), (14, 1), (5, 3), (14, 4), C = 256
            and 200, one image and a batch of 2, and ROIs all on P5 (a
            difference names its worst element); median times of kernel
            and plain version on synthetic inputs (NMS also at N = 2048
            and 8192 with B = 2; ROIAlign also on one tiny box repeated,
            and at s = 4); the section stamp (``check_section_stamp``):
            two CUDA graphs of the six stamps replayed 13 times into a
            ring of 5 rows, against the plain ``tracing.Ring`` on the
            host driven by the same calls.
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
6. graphs:  the flagship through ``export/captured.py::CapturedInference``
            at 800x1088 and 1344x1344, bf16 and f32: launch counts at the
            capture (warm-up + capture) and none at a replay, one launch
            of each kernel per replay by the profiler, the f32 replay
            against the eager request slot by slot, the bf16 one with
            its worst difference; per-request ms (bf16) with the input's
            and outputs' copies, host enqueue, device ms per replay and
            idle share beside the eager medians of ``time``; capture
            seconds and pool memory. Every ``graph_requests`` program
            (here and in the later phases) is held to its section ring
            (``check_ring_rows``): one row a call with its program's key
            and its six stamps non-decreasing, each row's first stamp at
            or after the row before it ended (a stamp that did not run
            would leave an earlier time), and on the card the five
            sections summed within ``SECTION_COVER`` of the CUDA events
            around a replay. The profiler does not count the stamp
            kernels: it loses a few records of a replay's first kernels
            now and then, and the ring's cursor counts them exactly.
7. serving: the serving config (``zy_model_serving.yaml``) built with the
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
            pack ms and bytes per request. ``serve`` and ``serving`` count
            the decode's top-k selections with a tie at the k-th place.
8. eval:    ``evaluation/loop.py::evaluate_dataset`` over a synthetic COCO
            set of 8 ``.npy`` images (the three canvases; polygons over
            four categories, a crowd region): the ground truth fed back
            scores AP 100.0 (bbox, segm); the tight pack through the
            loop's default (captured programs) and through
            ``fn=model.inference`` (eager) and the full pack give equal
            predictions; tight compute (a ``CapturedInference`` built
            here: its graphs and pool memory) gives every metric, finite;
            launch counts read around each run; avg and steady ms per
            image of each.
9. export:  ``export/aot.py`` artifacts of the uint8 s2d serving program
            (tight landscape pack padded back to 1344x1344) and of the
            f32-input 1344x1344 program, saved, loaded and run: outputs
            against the eager request slot by slot, one launch of kernels
            1 and 2 a call, export and load seconds, MB, GFLOPs.
10. train:  the flagship trained at full width in bf16 (1344x1344, B = 2,
            20 gt boxes an image, synthetic batches in ``train_batches``'
            format) through ``train/trainer.py::train_loop`` with the
            captured step (3 eager warm-up steps, the capture, replays):
            finite losses; one launch of kernel 1, kernel 2 and kernel 2b
            per eager step and at the capture, none at a replay (counts
            read around every step), one per replay by the profiler; a
            replay under sync-debug mode; ms per step (CUDA events, median
            and quartiles after the capture), images per second, peak
            memory, the profiler's device time of one replay; then the
            same for the eager step from the same weights,
            with the profiler's top kernels of one step; the three
            kernels against their plain versions on the inputs captured
            from an eager bf16 and f32 step; kernel 2b also on synthetic
            P3-P5 inputs (R = 0, ROIs outside the image, stacked tiny
            boxes, ROIs all on P5, C = 200, (o, s) = (7, 2), (14, 1), (5,
            3), (14, 4)), each time launched twice with bit-equal results
            and its
            prepass table equal to the CPU oracle's; the f32 step (TF32
            off, deterministic cuDNN) through the kernels against the same
            step through the plain versions: losses equal, every gradient
            within 4x its noise floor; three f32 steps captured against
            the same steps eagerly; 20 bf16 steps of the captured step on
            one batch that bring the loss down; a checkpoint round trip
            into new objects and into the captured step's own tensors,
            the step after it equal to the step without it.
11. backbones: the other backbone families from their yamls at full
            width in bf16 (``BACKBONES``, configs built in Python). R-50
            at 800x1088 and 1344x1344: an eager request and one through
            ``CapturedInference`` (one launch of kernels 1 and 2 an eager
            request, 3 at a capture, none at a replay; one per replay by
            the profiler; the replay equal to the eager request slot by
            slot), each kernel against its plain version on the
            request's inputs, a 4 s captured and a 4 s eager window; the
            same request in f32 (TF32 off) at 800x1088; the eval entry
            point over the 8-image synthetic set, captured and eager,
            equal predictions and proposals; training at 1344x1344, B = 2,
            FREEZE_AT 2, captured then eager (launches, finite losses,
            stem_conv1 and res2 bit-equal after the steps, ms a step,
            images/s, peak memory, a step's device time) and one f32 step
            through the kernels against the plain versions. R-101,
            MobileNetV2, V-19-dw-eSE and V-19-slim-dw-eSE: one 800x1088
            request each, eager and captured, with 2 s windows. A
            ``[backbones]`` line per model and canvas: captured ms and
            quartiles, device ms, idle share, eager ms, graph pool,
            parameters.
12. keypoints: ``centermask_V_39_eSE_FPN_keypoint_ms_3x.yaml`` from a
            Python copy (``keypoint_cfg``), full width, bf16: requests at
            800x1088 and 1344x1344 eagerly and through
            ``CapturedInference`` (launches, the replay equal to the
            eager request slot by slot, ``pred_keypoints`` included,
            kernels 1 and 2 against their plain versions on the request's
            inputs, 4 s captured and eager windows); the eval entry
            point over 8 synthetic person-keypoint images, captured and
            eager, equal predictions, the OKS task, and the ground truth
            fed back at AP 100; training captured then eager (launches,
            finite ``loss_keypoint``, ms a step, images/s, peak memory, a
            step's device time) and one f32 step through the kernels
            against the plain versions; the flagship with
            TPU.POOLER_SAMPLING_RATIO 0: a request eager and captured
            (three launches of kernel 2, s = 1, 2 and 4, each held
            against its plain version; kernel 2 at s = 4 timed) and one
            f32 step (three launches of kernels 2 and 2b, each held;
            kernel 2b at s = 4 timed); the flagship with modulated DCN in
            stages 4-5 and the deformable FCOS towers: a request eager
            and captured, the replay equal to eager, 2 s windows.
13. parallel: data parallelism (``parallel_phase``). A process group of
            one over NCCL in this process: the flagship bf16 train step
            through the data-parallel captured step (its all-reduce in
            the graph; launches as in ``train``, one per replay by the
            profiler, ms a step, images/s, peak memory, device time)
            beside the one-process captured step; five f32 steps (TF32
            off, deterministic cuDNN) bit-equal to the one-process
            captured step's; the three kernels against their plain
            versions on an eager data-parallel f32 step's inputs; the
            SyncBN, BN and TPU.REMAT_BACKBONE variants captured (finite
            losses, ms, peak memory); ``make_dp_inference`` of four bf16
            800x1088 images against ``inference_batched`` slot by slot.
            Then two gloo ranks on the card, processes of this script
            (``--rank``, ``rank_main``) that load the built kernels: an
            eager f32 data-parallel step of the flagship and of its
            SyncBN variant (B = 1 a rank) through the kernels against the
            same step through the plain versions, every gradient within
            4x its noise floor, and the ranks' parameters and buffers
            bit-equal after it; ``make_dp_inference`` of the four images
            against the one-process result; ``evaluate_dataset(
            distributed=True)`` over the 8-image synthetic set against
            the one-process run, and the ground truth fed back through
            the cross-rank merge at AP 100.
14. deploy: the deployment toolchain (``deploy_phase``) on the flagship
            at full width in f32 (TF32 off), 1344x1344, random weights:
            ``tools/preprocess_to_bin`` over the 8-image synthetic set
            (files of 4*3*1344^2 bytes, read back bit-equal to
            ``preprocess_for_model``'s input, ms/img); each bin through
            ``read_input_bin``, ``inference`` on the card and
            ``write_output_bins``, then ``tools/postprocess_bins``, its
            metrics equal to a ``COCOEvaluator`` fed the outputs in
            memory, and with one image's bins deleted, one reported
            missing; ``tools/parity_check`` (PARITY OK, direct | exported
            and direct | bins above cosine 1 - 1e-5, one launch of kernels
            1 and 2 a rung; both kernels against their plain versions on
            its input); ``check_layers``' dumps of the card and the CPU
            compared by name (up to the FCOS head above cosine 1 - 1e-5,
            the ROI stage where both decodes selected alike), the dump and
            compare CLIs on the FCOS logits; ``tools/measure``
            (parameters, bytes, FLOPs equal to ``inference_flops``, peak
            bytes); the Cityscapes scorers on arrays with PIL blocked (AP
            100, IoU 100); the eval loop's host split over 64 images with
            the numpy and the native s2d pack (read and pack ms/img, the
            packs bit-equal).
15. bench:  the port's measuring tools (``bench_phase``) in this
            process on the flagship at full width, bf16, with short
            windows: ``tools/bench`` (800x1088 and 1344x1344 requests as
            CUDA-graph replays, the serving loop, kernel 1 against its
            plain version on bench.py's 1000-box set), ``bench_train``
            (the captured step, 1344x1344, B = 2): each JSON line parses,
            its device values finite and positive, the card's name;
            ``bench_stages`` (with the ``nms_select`` arm) and
            ``bench_train_stages``: the cumulative arms' medians rise
            within their quartiles; ``profile_model`` of an eager request
            and an eager step: at least 95% of the kernel time in named
            sections, kernels 1 and 2 in the decode and ROI sections, 2b
            in the ROI section's backward; ``roofline_bound`` of both
            traces: no section's bound above 1.05x its measured time.
16. result: a ``{"kernels": [...]}`` line whose launches sum the counts
            of ``serve``, ``graphs``, ``serving``, ``eval``, ``export``,
            ``train``, ``backbones``, ``keypoints``, ``parallel``'s
            first part, ``deploy`` and ``bench`` (the launch functions'
            counts: eager launches and captures, not replays) and
            ``section_stamp_launches``, six a row of the rings checked
            (``STAMP_ROWS``: the stamp check's and every
            ``graph_requests`` program's), then the last line
            ``{"ok": true, "device": {...}}``.

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
# a keypoint model's (x, y, prob) of the same request replayed and eager:
# the same kernels on the same inputs, so within the scores' tolerance
KEYPOINT_TOL = (1e-6, 1e-4)
# kernel 2b against the plain VJP: both sum in f32, each in its own fixed
# order (the kernel pixel by pixel over the ROIs, the plain version in
# einsum order), so f32 is held to 1e-5 of the largest plain value and
# bf16 to one bf16 ulp of each value plus that f32 term
ROI_BWD_REL = 1e-5
# the f32 train step through the kernels against the plain versions:
# every gradient within this factor of its noise floor
GRAD_NOISE_FACTOR = 4.0
# gradients that are zero in exact arithmetic, so that both runs hold
# rounding noise only: the keypoint deconv's bias adds a constant to each
# map, which the bilinear upsample keeps constant and the softmax over the
# map's cells cancels. They are held to be noise, at most ZERO_GRAD_REL of
# the largest gradient of the same module, and not compared
ZERO_GRADS = ("roi_heads.keypoint_head.score_lowres.bias",)
ZERO_GRAD_REL = 1e-4

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


def base_cfg():
    """``configs/centermask/Base-CenterMask-VoVNet.yaml`` merged over the
    defaults, built in Python (no yaml): the base of every config here."""
    from centermask2_tpu_torch.config import get_cfg

    cfg = get_cfg()
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
    return cfg


def flagship_cfg():
    """``configs/centermask/zy_model_config.yaml`` (its WEIGHTS: "" merges
    as None)."""
    cfg = base_cfg()
    cfg.MODEL.WEIGHTS = None
    cfg.MODEL.VOVNET.CONV_BODY = "V-39-eSE"
    cfg.SOLVER.STEPS = (210000, 250000)
    cfg.SOLVER.MAX_ITER = 270000
    cfg.OUTPUT_DIR = "output/zy_outputs"
    return cfg


def resnet_cfg(depth: int = 50):
    """``centermask_R_50_FPN_ms_3x.yaml``, or with ``depth`` 101
    ``centermask_R_101_FPN_ms_3x.yaml``."""
    cfg = base_cfg()
    cfg.MODEL.BACKBONE.NAME = "build_fcos_resnet_fpn_backbone"
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.RESNETS.DEPTH = depth
    cfg.MODEL.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    return cfg


def mobilenet_cfg():
    """``centermask_mobilenetV2_FPN_ms_4x.yaml``."""
    cfg = base_cfg()
    cfg.MODEL.MOBILENET = True
    cfg.MODEL.BACKBONE.NAME = "build_fcos_mobilenetv2_fpn_backbone"
    cfg.MODEL.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    return cfg


def lite_cfg(body: str):
    """``centermask_lite_V_19_eSE_FPN_ms_4x.yaml`` with the VoVNet ``body``
    (the lite yamls of the depthwise bodies)."""
    cfg = base_cfg()
    cfg.MODEL.VOVNET.CONV_BODY = body
    cfg.MODEL.FCOS.POST_NMS_TOPK_TEST = 50
    cfg.SOLVER.STEPS = (300000, 340000)
    cfg.SOLVER.MAX_ITER = 360000
    cfg.INPUT.MIN_SIZE_TRAIN = (580, 600)
    cfg.INPUT.MAX_SIZE_TRAIN = 900
    cfg.INPUT.MIN_SIZE_TEST = 600
    cfg.INPUT.MAX_SIZE_TEST = 1000
    return cfg


# the [backbones] phase's models: name -> (config, its yaml)
BACKBONES = {
    "R-50": (lambda: resnet_cfg(50), "centermask_R_50_FPN_ms_3x.yaml"),
    "R-101": (lambda: resnet_cfg(101), "centermask_R_101_FPN_ms_3x.yaml"),
    "MobileNetV2": (mobilenet_cfg, "centermask_mobilenetV2_FPN_ms_4x.yaml"),
    "V-19-dw-eSE": (lambda: lite_cfg("V-19-dw-eSE"),
                    "centermask_lite_V_19_dw_eSE_FPN_ms_4x.yaml"),
    "V-19-slim-dw-eSE": (lambda: lite_cfg("V-19-slim-dw-eSE"),
                         "centermask_lite_V_19_slim_dw_eSE_FPN_ms_4x.yaml"),
}


def serving_cfg():
    """``configs/centermask/zy_model_serving.yaml``: the flagship with the
    s2d stem input (the raw uint8 s2d pack, normalized on the device)."""
    cfg = flagship_cfg()
    cfg.TPU.S2D_STEM_INPUT = True
    return cfg


KEYPOINT_YAML = "centermask_V_39_eSE_FPN_keypoint_ms_3x.yaml"


def keypoint_cfg():
    """``configs/centermask/centermask_V_39_eSE_FPN_keypoint_ms_3x.yaml``:
    the Base VoVNet config (V-39-eSE) for people, with the KRCNN keypoint
    head and neither mask nor MaskIoU head."""
    cfg = base_cfg()
    cfg.MODEL.KEYPOINT_ON = True
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.MASKIOU_ON = False
    cfg.MODEL.FCOS.NUM_CLASSES = 1
    return cfg


def adaptive_cfg():
    """The flagship with TPU.POOLER_SAMPLING_RATIO 0: the adaptive ROIAlign
    buckets (s = 1, 2 and 4)."""
    cfg = flagship_cfg()
    cfg.TPU.POOLER_SAMPLING_RATIO = 0
    return cfg


def dcn_cfg():
    """The flagship with modulated deformable convs in VoVNet stages 4 and
    5 and the deformable FCOS towers."""
    cfg = flagship_cfg()
    cfg.MODEL.VOVNET.STAGE_WITH_DCN = (False, False, True, True)
    cfg.MODEL.VOVNET.WITH_MODULATED_DCN = True
    cfg.MODEL.FCOS.USE_DEFORMABLE = True
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
def card_peaks():
    """The card's published peaks (``utils/measures.py::chip_peaks``)."""
    from centermask2_tpu_torch.utils.measures import chip_peaks

    peaks = chip_peaks()
    if peaks is None:
        raise RuntimeError(f"no published peaks for "
                           f"{torch.cuda.get_device_name(0)}")
    return peaks


def vector_bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the bound of a kernel of f32 vector
    arithmetic (kernels 1, 2 and 2b), the larger of its bytes over the
    card's HBM rate and its operations over its f32 rate outside the
    tensor cores."""
    peaks = card_peaks()
    t_bytes, t_ops = nbytes / peaks.hbm_bytes_s, flops / peaks.f32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


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


@contextlib.contextmanager
def exact_f32(deterministic: bool = False):
    """Inside the block, f32 convolutions (cuDNN) and matmuls (cuBLAS)
    without TF32, and cuDNN deterministic or not; the settings before it
    restored after it."""
    b = torch.backends
    saved = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic = deterministic
    try:
        yield
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
         b.cudnn.deterministic) = saved


@contextlib.contextmanager
def topk_ties(counts: dict):
    """Inside the block, count over the decode's top-k selections
    (``models/fcos/outputs.py::topk_lowest_index_first``) the rows whose
    k-th and (k+1)-th values are equal and a real candidate (> 0): a tie
    that straddles the k-th place, where the rule for ties decides the
    selected set. ``counts``: {"ties": [device counts], "rows": int}."""
    from centermask2_tpu_torch.models.fcos import outputs

    select = outputs.topk_lowest_index_first

    def counted(x, k):
        if k < x.shape[1]:
            v = torch.sort(x, dim=1, descending=True, stable=True).values
            counts["ties"].append(((v[:, k - 1] == v[:, k])
                                   & (v[:, k - 1] > 0)).sum())
        counts["rows"] += x.shape[0]
        return select(x, k)

    outputs.topk_lowest_index_first = counted
    try:
        yield counts
    finally:
        outputs.topk_lowest_index_first = select


def log_ties(counts: dict, what: str) -> int:
    ties = int(sum(int(t) for t in counts["ties"]))
    log(f"  top-k boundary ties over {what}: {ties} of {counts['rows']} "
        f"top-k selections (rows whose k-th and (k+1)-th candidate scores "
        f"are equal; ties are taken lowest index first, as lax.top_k "
        f"takes them)")
    return ties


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
    bound, by = vector_bound(nbytes, flops)
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
    bound, by = vector_bound(nbytes, flops)
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
# stores, C = 200 a ragged channel group, ``large`` puts every ROI on P5;
# s = 4 is the largest adaptive bucket (o * s = 56 of the 64 samples an
# axis the kernels' tables hold)
ROI_CASES = ((1, 256, 14, 2, False), (2, 256, 14, 2, False),
             (2, 200, 7, 2, False), (2, 200, 14, 1, False),
             (2, 256, 5, 3, False), (2, 256, 14, 2, True),
             (2, 256, 14, 4, False))


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
        if s == 4:  # the largest adaptive bucket
            roi_row([f.bfloat16() for f in feats32], boxes, bidx, levels,
                    scales, o, s, True, "synthetic boxes, s=4")
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


# the section stamp's check: two programs' keys, replayed in this order
# into a ring of STAMP_CHECK_ROWS rows (it wraps twice)
STAMP_CHECK_KEYS = (0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 0, 0)
STAMP_CHECK_ROWS = 5
# rows of the section rings checked: six stamp launches each
STAMP_ROWS = [0]


def check_section_stamp(dev) -> None:
    """The section stamp (``csrc/stamp.cu``) against its plain version,
    ``tracing.Ring`` on the host: one CUDA graph of the six stamps a
    program key, replayed in the order of ``STAMP_CHECK_KEYS`` into a
    ring of ``STAMP_CHECK_ROWS`` rows, and the host ring driven by the
    same calls. Each replay advances the cursor once; after the wraps
    both rings hold the newest rows, with the same keys, each row's
    stamps non-decreasing and the rows' first stamps rising oldest
    first."""
    from centermask2_tpu_torch.utils import tracing

    def stamps(ring, key):
        with tracing.armed(ring, key):
            for name in tracing.STAMPS:
                tracing.mark(name)

    ring = tracing.Ring(dev, rows=STAMP_CHECK_ROWS)
    plain = tracing.Ring("cpu", rows=STAMP_CHECK_ROWS)
    graphs = {}
    for key in sorted(set(STAMP_CHECK_KEYS)):
        graphs[key] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[key]):
            stamps(ring, key)
    if int(ring.cursor) != 0:
        raise AssertionError(f"section stamp: a capture advanced the "
                             f"cursor to {int(ring.cursor)}")
    for i, key in enumerate(STAMP_CHECK_KEYS):
        graphs[key].replay()
        stamps(plain, key)
        if int(ring.cursor) != i + 1:
            raise AssertionError(f"section stamp: cursor {int(ring.cursor)}"
                                 f" after {i + 1} replays")
    got, want = ring.read(), plain.read()
    n = len(STAMP_CHECK_KEYS)
    if got[:, 0].tolist() != want[:, 0].tolist() or \
            want[:, 0].tolist() != list(STAMP_CHECK_KEYS[-STAMP_CHECK_ROWS:]):
        raise AssertionError(f"section stamp: keys {got[:, 0].tolist()}, "
                             f"plain {want[:, 0].tolist()}")
    if not ((np.diff(got[:, 1:], axis=1) >= 0).all()
            and (np.diff(got[:, 1]) > 0).all()):
        raise AssertionError(f"section stamp: stamps out of order {got}")
    STAMP_ROWS[0] += n
    us = np.diff(got[:, 1:], axis=1).mean() * 1e-3
    log(f"  section stamp: {n} replays of two graphs into a ring of "
        f"{STAMP_CHECK_ROWS} rows: cursor {n}, the newest rows' keys "
        f"{got[:, 0].tolist()} as the plain ring's, each row's stamps "
        f"non-decreasing, rows oldest first; {us:.2f} us a stamp after "
        f"the one before it in a replay ({card_line()})")


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
    if out.pred_keypoints is not None:
        kp = out.pred_keypoints
        if tuple(kp.shape) != (B, K, 17, 3) or not torch.isfinite(kp).all():
            raise AssertionError(f"{what}: pred_keypoints {tuple(kp.shape)}, "
                                 f"finite {bool(torch.isfinite(kp).all())}")
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

    ties = {"ties": [], "rows": 0}
    _kernels.reset_launch_counts()
    for i, ((seed, H, W), img) in enumerate(zip(REQUESTS, images)):
        before = (_kernels.nms_launches, _kernels.roi_align_launches)
        with topk_ties(ties):
            out = model.inference(img)
        n = check_outputs(out, 1, K, f"request {i} {H}x{W}")
        after = (_kernels.nms_launches, _kernels.roi_align_launches)
        if (after[0] - before[0], after[1] - before[1]) != (1, 1):
            raise AssertionError(f"request {i}: launches {before} -> {after}")
        log(f"  request {i} {H}x{W} bf16: {n} valid of {K}, launches "
            f"nms +1 roi_align +1, top score {float(out.scores.max()):.4f}")
    launches = {"nms": _kernels.nms_launches,
                "roi_align": _kernels.roi_align_launches}
    log_ties(ties, f"the {len(REQUESTS)} bf16 requests")

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.inference(images[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_outputs(out, 1, K, "sync-debug request")
    log("  request under sync-debug mode 'error': no host sync on the path")

    # f32: kernels vs plain versions on the card, TF32 off
    cfg32 = flagship_cfg()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    model32 = build_model(cfg32, dev)
    with exact_f32():
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
    tols = dict(E2E_TOL)
    if a.pred_keypoints is not None or b.pred_keypoints is not None:
        tols["pred_keypoints"] = KEYPOINT_TOL
    for f, (rtol, atol) in tols.items():
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
    (``request()``, which runs through the kernels as usual), the last
    launch of each: "nms" and "roi_align"."""
    seen = record_launches(request)
    if not all(seen.values()):
        raise AssertionError(f"request reached only "
                             f"{sorted(k for k, v in seen.items() if v)}")
    return {"nms": seen["nms_keep_sorted"][-1],
            "roi_align": seen["roi_align"][-1]}


def record_launches(run, names=("nms_keep_sorted", "roi_align")) -> dict:
    """The arguments of every launch of each kernel of ``names`` (``_kernels``
    function names) in ``run()``, in order: name -> list of argument
    tuples (``capture_kernel_inputs`` keeps the last of one request)."""
    from centermask2_tpu_torch.ops import _kernels

    seen = {n: [] for n in names}

    def recorder(name, fn):
        def call(*args):
            seen[name].append(args)
            return fn(*args)
        return call

    with kernels_swapped(*(recorder(n, getattr(_kernels, n))
                           if n in names else None for n in KERNEL_FNS)):
        run()
    torch.cuda.synchronize()
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


# ---------------------------------------------------------------- graphs
# the CUDA kernels of each port kernel, as the profiler names them
KERNEL_CUDA_FNS = {"nms": ("nms_mask_kernel", "nms_scan_kernel"),
                   "roi_align": ("roi_align_kernel",),
                   "roi_align_backward": ("roi_prepass_kernel",
                                          "roi_align_backward_kernel")}
GRAPH_REPLAYS = 5  # replays profiled for their kernel launches
GRAPH_CANVASES = ((100, 800, 1088), (103, 1344, 1344))
# a device sleep (20 ms at 1.98 GHz) before and after each profiled call:
# without it the profiler loses records of the first call after it starts
# (an f32 1344x1344 replay, ~34k kernels, lost its port kernels in a
# window of 5 now and then; centermask2_tpu_torch/tools/profile_replays.py
# measures how often); with it, a window of five such replays (168,761
# device events) still lost one replay's records once, so each replay
# gets a window of its own
REPLAY_PAD_CYCLES = int(1.98e9 * 0.020)


def replay_launches(run, n: int, kernels, what: str, per_call=None) -> int:
    """Each port kernel of ``kernels`` launched once per call (or
    ``per_call[kernel]`` times) in ``n`` calls of ``run()``, counted by
    the profiler (a graph's replay does not pass through the launch
    functions, so their counts cannot see it), each call in a profiler
    window of its own between two device sleeps of
    ``REPLAY_PAD_CYCLES``. Raises on another count; returns the calls
    verified, 0 when the profiler records no device time (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    got = {fn: 0 for k in kernels for fn in KERNEL_CUDA_FNS[k]}
    events = []
    for _ in range(n if torch.cuda.is_available() else 0):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(REPLAY_PAD_CYCLES)
            run()
            torch.cuda._sleep(REPLAY_PAD_CYCLES)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if getattr(e, "device_time_total", 0) > 0]
        if not evs:
            break
        for fn in got:
            got[fn] += sum(e.count for e in evs if fn in e.key)
        events.append(sum(e.count for e in evs))
    if len(events) < n:
        log(f"  {what}: profiler recorded no device time; launches per "
            "replay not measured")
        return 0
    want = {fn: n * (per_call or {}).get(k, 1)
            for k in kernels for fn in KERNEL_CUDA_FNS[k]}
    if got != want:
        raise AssertionError(f"{what}: {n} calls launched {got}, {want} "
                             f"expected (device events in the windows: "
                             f"{events})")
    times = "once" if not per_call else ", ".join(
        f"{k} {v}x" for k, v in per_call.items())
    log(f"  {what}: the profiler counts each CUDA kernel of "
        f"{', '.join(kernels)} {times} per call over {n} calls, a window "
        f"each ({got}; device events in the windows {events})")
    return n


def pool_bytes(r0: int) -> int:
    """Device memory reserved above ``r0`` once the allocator's free
    blocks are released: what the live graphs' private pool holds."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() - r0


def captured_window(prog, x_host, seconds: float) -> dict:
    """Per-request ms at B = 1 through a captured program, each request
    a new input copied from pinned host memory into the graph's input,
    the replay, and the outputs copied into pinned host buffers, timed by
    CUDA events, with the host's enqueue time; then the device ms per
    replay alone (back to back, input already on the card)."""
    host = []

    def request():
        out = [t for t in prog(x_host) if t is not None]
        if not host:
            host.extend(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        for t in out)
        for h, t in zip(host, out):
            h.copy_(t, non_blocking=True)

    for _ in range(3):
        request()
    torch.cuda.synchronize()
    ms, enqueue = [], []
    t_end = time.perf_counter() + seconds
    while len(ms) < MIN_TIMED or time.perf_counter() < t_end:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        w0 = time.perf_counter()
        request()
        w1 = time.perf_counter()
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        enqueue.append((w1 - w0) * 1e3)
    x_dev = x_host.to(prog.device)
    prog(x_dev)
    torch.cuda.synchronize()
    reps = 30
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        prog(x_dev)
    b.record()
    b.synchronize()
    q1, q2, q3 = np.percentile(ms, [25, 50, 75])
    return {"n": len(ms), "q1": q1, "median": q2, "q3": q3,
            "enqueue": float(np.median(enqueue)),
            "device": a.elapsed_time(b) / reps}


# the five sections summed over the CUDA events around a replay: at most
# the events' time (less the input's copy and the launch), at least 98%
SECTION_COVER = (0.98, 1.001)
SECTION_COVER_REPLAYS = 5


class Counted:
    """A captured program with its calls counted (``calls``)."""

    def __init__(self, prog):
        self.prog, self.device, self.calls = prog, prog.device, 0

    def __call__(self, *args):
        self.calls += 1
        return self.prog(*args)


def check_ring_rows(prog, row0: int, calls: int, key: int, what: str,
                    run=None) -> None:
    """The section ring of ``prog`` (``utils/tracing.py``) after
    ``calls`` calls of its program ``key`` from cursor ``row0``: one row
    a call, each with ``key`` and non-decreasing stamps, starting at or
    after the row before it ended (the calls run in stream order). With
    ``run`` (on the card), ``SECTION_COVER_REPLAYS`` calls more, each
    between CUDA events behind a device sleep (the replay queued before
    the first event): the five sections summed within ``SECTION_COVER``
    of the events' time."""
    ring = prog.ring
    n = int(ring.cursor) - row0
    if n != calls or calls > ring.rows:
        raise AssertionError(f"{what}: {n} ring rows for {calls} calls")
    rows = ring.read()[-calls:]
    if (rows[:, 0] != key).any() or (np.diff(rows[:, 1:], axis=1) < 0).any() \
            or (rows[1:, 1] < rows[:-1, -1]).any():
        raise AssertionError(f"{what}: ring rows with keys "
                             f"{sorted(set(rows[:, 0].tolist()))} for key "
                             f"{key}, or stamps out of order")
    note = ""
    if run is not None:
        cover = []
        for _ in range(SECTION_COVER_REPLAYS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(REPLAY_PAD_CYCLES)
            a.record()
            run()
            b.record()
            b.synchronize()
            row = ring.read()[-1]
            cover.append((row[-1] - row[1]) * 1e-6 / a.elapsed_time(b))
        if not all(SECTION_COVER[0] <= c <= SECTION_COVER[1]
                   for c in cover):
            raise AssertionError(f"{what}: the sections cover {cover} of "
                                 f"the replays' event time")
        calls += SECTION_COVER_REPLAYS
        note = (f"; the five sections cover "
                + ", ".join(f"{c:.4f}" for c in cover)
                + " of the CUDA events around a replay")
    STAMP_ROWS[0] += calls
    log(f"  {what}: {calls} ring rows for {calls} calls, key {key}, "
        f"stamps non-decreasing{note}")


def graph_requests(dev, name: str, model, canvases, window_s: float = 0.0,
                   eager_ms=None, graphs=None, errs=None,
                   roi_per_request: int = 1) -> dict:
    """``model`` (``name``) at each canvas of ``canvases`` ((seed, H, W)),
    eagerly and through one ``CapturedInference``. Gates: one launch of
    kernel 1 and ``roi_per_request`` of kernel 2 (3 with the adaptive
    ROIAlign buckets) an eager request, ``WARMUP_CALLS`` + 1 times that
    at a capture (the side-stream warm-up and the capture) and none at a
    replay (launch counts), the same per replay (profiler); the replay
    against the eager request slot by slot (``compare_outputs``, a
    keypoint model's ``pred_keypoints`` included; bit-equality and the
    worst differences printed). With ``errs``, each kernel launch held
    against its plain version on the eager request's inputs, the worst
    errors into ``errs``. With ``window_s``, a captured window of that many
    seconds at each canvas beside the eager median of ``eager_ms`` at
    (H, W), or of an eager window of ``window_s`` where it has none; one
    line a canvas with the graph pool and the parameter count. After each
    canvas the program's section ring (``check_ring_rows``): a row a
    call, with the canvas's program key (its index in ``canvases``).
    Returns the launches counted."""
    from centermask2_tpu_torch.export import CapturedInference
    from centermask2_tpu_torch.export.captured import WARMUP_CALLS
    from centermask2_tpu_torch.ops import _kernels

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    card = card_line()
    short = "bf16" if model.dtype == torch.bfloat16 else "f32"
    K = model.decode_kwargs["post_nms_topk"]
    launches = {"nms": 0, "roi_align": 0}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
    prog = CapturedInference(model, graphs=graphs)
    call = Counted(prog)
    rows = []
    for key, (seed, H, W) in enumerate(canvases):
        img = make_image(seed, H, W, dev)
        what = f"{name} {short} {H}x{W}"
        row0 = 0 if prog.ring is None else int(prog.ring.cursor)
        calls0 = call.calls
        outs = []
        _kernels.reset_launch_counts()
        seen, peak = eager_peak(lambda: record_launches(
            lambda: outs.append(model.inference(img))))
        counts = [_kernels.launch_counts()]
        for _ in range(2):  # the warm-up and capture, then a replay
            _kernels.reset_launch_counts()
            got = call(img)
            counts.append(_kernels.launch_counts())
        want = [(n, n * roi_per_request) for n in (1, WARMUP_CALLS + 1, 0)]
        if [(c["nms"], c["roi_align"]) for c in counts] != want:
            raise AssertionError(f"{what}: launches {counts} for an eager "
                                 "request, a capture and a replay")
        for c in counts:
            for k in launches:
                launches[k] += c[k]
        got = type(got)(*(None if t is None else t.clone() for t in got))
        n = compare_outputs(got, outs[0], K, f"{what} replay vs eager")
        pairs = [(a, b) for a, b in zip(got, outs[0]) if a is not None]
        same = all(torch.equal(a, b) for a, b in pairs)
        fields = list(E2E_TOL) + (["pred_keypoints"]
                                  if got.pred_keypoints is not None else [])
        worst = {f: float((getattr(got, f).double()
                           - getattr(outs[0], f).double()).abs().max())
                 for f in fields}
        w = WARMUP_CALLS + 1
        how = (f"kernels 1 and 2 launched once by the eager request, {w} "
               f"times by the capture" if roi_per_request == 1 else
               f"kernel 1 launched once and kernel 2 {roi_per_request} "
               f"times by the eager request, {w} and {w * roi_per_request} "
               f"times by the capture")
        log(f"  {what}: {n} valid of {K}; {how} ({WARMUP_CALLS} warm-up "
            f"requests + the capture), not by a replay; the replay equals "
            f"the eager request slot by slot, every output bit-equal "
            f"{same}, worst abs differences "
            + ", ".join(f"{f} {v:.3e}" for f, v in worst.items())
            + f"; the eager request allocates at its peak "
            f"{peak / 2 ** 20:.1f} MiB above its start")
        if errs is not None:
            for args in seen["nms_keep_sorted"]:
                errs["nms"] = max(errs["nms"],
                                  nms_case(*args, f"{what} request"))
            for args in seen["roi_align"]:
                note = f", s={args[6]}" if roi_per_request > 1 else ""
                errs["roi_align"] = max(errs["roi_align"], roi_case(
                    *args[:7], f"{what} request{note}"))
        del seen
        replay_launches(lambda: call(img), GRAPH_REPLAYS,
                        ("nms", "roi_align"), f"{what} replays",
                        per_call={"nms": 1, "roi_align": roi_per_request})
        if window_s:
            r = captured_window(call, img.cpu().pin_memory(), window_s)
            eager = (eager_ms or {}).get((H, W))
            source = "[time]"
            if eager is None:
                eager = latency_window(model, img, window_s,
                                       warmup_s=0.5)["median"]
                source = f"a {window_s} s window"
            rows.append((H, W, r, eager, source))
        check_ring_rows(prog, row0, call.calls - calls0, key,
                        f"{what} section ring",
                        (lambda: call(img)) if cuda else None)
    pool = pool_bytes(r0) if cuda else 0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {name} {short}: {len(prog)} graphs captured in "
        f"{prog.capture_s:.3f} s (warm-up included); graph pool "
        f"{pool / 2 ** 20:.1f} MiB; {n_params} parameters ({card})")
    for H, W, r, eager, source in rows:
        log(f"  {name} {short} {H}x{W}: captured {r['median']:.3f} ms/img "
            f"[q1 {r['q1']:.3f}, q3 {r['q3']:.3f}] over {r['n']} requests "
            f"with the input's and the outputs' copies, host enqueue median "
            f"{r['enqueue']:.3f}; device {r['device']:.3f} ms a replay (idle "
            f"share {max(0.0, 1 - r['device'] / r['median']):.3f}); eager "
            f"median {eager:.3f} ms ({source}); graph pool "
            f"{pool / 2 ** 20:.1f} MiB ({len(prog)} graphs); {n_params} "
            f"parameters ({card})")
    del prog
    return launches


def graphs_phase(dev, models, eager_ms: dict, canvases=GRAPH_CANVASES,
                 graphs=None, timing: bool = True) -> dict:
    """The ``[graphs]`` phase: the flagship through ``CapturedInference``
    at each canvas, per dtype (``graph_requests``); with ``timing``, the
    bf16 requests' windows beside the eager medians of ``[time]``
    (``eager_ms`` by (H, W)); then where the f32 pool comes from
    (``f32_memory``). Returns the launches counted."""
    dev = torch.device(dev)
    launches = {"nms": 0, "roi_align": 0}
    for dtype_name, model in models.items():
        window = WINDOW_S if timing and dtype_name == "bfloat16" else 0.0
        for k, v in graph_requests(dev, "graph", model, canvases, window,
                                   eager_ms, graphs).items():
            launches[k] += v
    if dev.type == "cuda" and "float32" in models:
        f32_memory(models["float32"], make_image(*canvases[-1], dev),
                   card_line())
    return launches


def eager_peak(run):
    """``run()``'s result and the bytes allocated at its peak above its
    start (0 without CUDA)."""
    if not torch.cuda.is_available():
        return run(), 0
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - a0


def f32_memory(model, img, card: str) -> None:
    """Where an f32 graph's pool comes from at the canvas of ``img``: the
    largest allocations of one eager request with TF32 off (as the f32
    gates run), by the line of the port that made them; then one graph
    with cuDNN's default TF32, its pool beside the eager peak."""
    from centermask2_tpu_torch.export import CapturedInference

    H, W = img.shape[1:3]
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=100000,
                                             stacks="python")
    try:
        model.inference(img)
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    allocs = sorted((e for trace in snap["device_traces"] for e in trace
                     if e["action"] == "alloc"), key=lambda e: -e["size"])
    top = []
    for e in allocs[:4]:
        where = [f"{os.path.relpath(f['filename'], REPO)}:{f['line']}"
                 for f in e.get("frames", ())
                 if f["filename"].startswith(REPO)]
        top.append(f"{e['size'] / 2 ** 20:.1f} MiB at "
                   + " < ".join(where[:2]))
    log(f"  f32 {H}x{W}, TF32 off: the eager request's largest "
        f"allocations (of {len(allocs)}): " + "; ".join(top))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        peak = eager_peak(lambda: model.inference(img))[1]
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        prog = CapturedInference(model)
        prog(img)
        pool = pool_bytes(r0)
        del prog
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    log(f"  f32 {H}x{W} with cuDNN's default TF32: the eager request "
        f"allocates at its peak {peak / 2 ** 20:.1f} MiB above its start; "
        f"one graph's pool holds {pool / 2 ** 20:.1f} MiB ({card})")


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
    ties = {"ties": [], "rows": 0}
    for img, (x, hw, canvas) in zip(imgs, packs):
        for c in ((fixed, fixed), None):
            outs = []
            with topk_ties(ties):
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
    log_ties(ties, f"the {len(captured)} bf16 serving requests")
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
# images of the timed eval runs (the shapes in turn), and of the one the
# host split profiles: the loop's steady rate over a few hundred requests
EVAL_TIMED_IMAGES = 200
EVAL_SPLIT_IMAGES = 64


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
                      sides=(20, 64, 240), n_images: int = 0) -> str:
    """A COCO-format dataset from a seed: uint8 BGR images as ``.npy``,
    and per image a small, a medium and a large polygon (boxes of about
    ``sides``, within 10%) over the categories in turn, plus one crowd
    region in the first image. ``n_images`` (default: one a shape) takes
    the shapes in turn, the images of one shape sharing one file.
    Returns the annotation json's path."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(1, (n_images or len(shapes)) + 1):
        k = (i - 1) % len(shapes)
        H, W = shapes[k]
        name = f"{k + 1:012d}.npy"
        if i == k + 1:
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


def eval_host_split(run, n_images: int) -> dict:
    """The eval loop's host time by part, over one ``run(timed)`` of it:
    each part of the loop wrapped by ``timed`` in a clock (preprocess:
    read, resize and pack, in the prefetch thread; request: issuing it, a
    replay or the eager forward; wait: the host waiting for a request's
    outputs; postprocess: rescale and mask paste; evaluator: the RLE
    encoding and records; metrics: the COCO evaluation at the end), ms an
    image each, beside the run's wall time and, by the profiler, the
    device's kernel time. Returns the parts' ms an image."""
    from torch.profiler import ProfilerActivity, profile

    from centermask2_tpu_torch.evaluation import loop
    from centermask2_tpu_torch.evaluation.coco_eval import COCOEvaluator

    spent = {}  # each part runs in one thread only

    def timed(label, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[label] = spent.get(label, 0.0) \
                    + time.perf_counter() - t0
        return call

    parts = ((loop, "preprocess_for_model", "preprocess"),
             (loop, "detector_postprocess", "postprocess"),
             (COCOEvaluator, "process", "evaluator"),
             (COCOEvaluator, "evaluate", "metrics"),
             (torch.cuda.Event, "synchronize", "wait"))
    saved = [getattr(obj, name) for obj, name, _ in parts]
    for (obj, name, label), fn in zip(parts, saved):
        setattr(obj, name, timed(label, fn))
    cuda = torch.cuda.is_available()
    try:
        with (profile(activities=[ProfilerActivity.CUDA]) if cuda
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            run(timed)
            wall = time.perf_counter() - t0
    finally:
        for (obj, name, _), fn in zip(parts, saved):
            setattr(obj, name, fn)
    device = "not measured"
    if cuda:
        total = sum(e.device_time_total for e in prof.key_averages())
        device = f"{total / 1e3 / n_images:.3f} ms/img"
    log(f"  eval host split, one run of {n_images} images: wall "
        f"{wall * 1e3 / n_images:.3f} ms/img (the metrics' evaluation "
        f"included); host ms/img by part " + ", ".join(
            f"{k} {v * 1e3 / n_images:.3f}" for k, v in sorted(spent.items()))
        + f"; device kernel time {device} (profiler)")
    return {k: v * 1e3 / n_images for k, v in spent.items()}


def eval_runs(model, ann: str, modes, common: dict, n_images: int,
              graphs=None) -> tuple:
    """``evaluate_dataset`` of ``model`` over ``ann`` once a mode of
    ``modes``: (mode, the loop's arguments, graphs captured, the name of
    the captured program the run builds for itself or None). Gates:
    launches of kernels 1 and 2 one a request eagerly and
    ``WARMUP_CALLS`` + 1 a graph when captured (warm-up and capture; a
    replay launches nothing through the launch functions). Each
    program's graphs and pool are printed. Returns ({mode: (metrics,
    evaluator)}, {name: program}, the launches counted)."""
    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.export import CapturedInference
    from centermask2_tpu_torch.export.captured import WARMUP_CALLS
    from centermask2_tpu_torch.ops import _kernels

    cuda = next(model.parameters()).device.type == "cuda"
    card = card_line()
    launches = {"nms": 0, "roi_align": 0}
    runs, progs = {}, {}
    for mode, kw, n_graphs, name in modes:
        if name is not None:  # its pool: the reserved memory it adds
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                r0 = torch.cuda.memory_reserved()
            kw = dict(kw, fn=CapturedInference(model, graphs=graphs))
            progs[name] = kw["fn"]
        _kernels.reset_launch_counts()
        res, avg_ms, ev = evaluate_dataset(model, ann=ann, **kw, **common)
        got = _kernels.launch_counts()
        want = (WARMUP_CALLS + 1) * n_graphs if n_graphs else n_images
        if (got["nms"], got["roi_align"]) != (want, want):
            raise AssertionError(f"eval {mode}: launches {got}, {want} "
                                 f"expected for {n_images} images and "
                                 f"{n_graphs} graphs")
        for k in launches:
            launches[k] += got[k]
        runs[mode] = (res, ev)
        how = (f"{n_graphs} captured programs, {want} launches of each "
               f"kernel at their warm-up and capture" if n_graphs else
               f"eager, one launch of each kernel a request")
        n_prop = sum(len(p["boxes"]) for p in ev.proposals.values())
        log(f"  eval {mode}: {n_images} images, {len(ev.predictions)} "
            f"predictions of the set's categories, {n_prop} proposals, "
            + ", ".join(f"{t} AP {res[t]['AP']:.4f}" for t in
                        ("bbox", "keypoints") if t in res)
            + f"; {how}; avg {avg_ms:.3f} ms/img ({card})")
        if name is not None:
            prog = progs[name]
            pool = pool_bytes(r0) if cuda else 0
            log(f"  eval {name} program: {len(prog)} graphs (one a "
                f"canvas met) captured in {prog.capture_s:.3f} s "
                f"(warm-up included), pool {pool / 2 ** 20:.1f} MiB "
                f"({card})")
    return runs, progs, launches


def check_same_runs(runs: dict, modes, what: str) -> None:
    """The runs of ``modes`` give equal predictions and equal
    class-agnostic proposals (the evaluator's box_proposals input, which
    also keeps the detections of the classes the set has no category
    for), and some proposals."""
    def key(mode):
        ev = runs[mode][1]
        return ev.predictions, {i: (p["boxes"].tolist(),
                                    p["objectness"].tolist())
                                for i, p in ev.proposals.items()}

    first = key(modes[0])
    n_prop = sum(len(b) for b, _ in first[1].values())
    if n_prop == 0 or any(key(m) != first for m in modes[1:]):
        raise AssertionError(f"eval: {n_prop} proposals; the predictions or "
                             f"proposals of {what} differ")
    log(f"  eval: predictions ({len(first[0])}) and proposals ({n_prop}) of "
        f"{what} equal")


def eval_phase(dev, model, fixed: int = FIXED, min_size: int = SHORT,
               max_size: int = 1333, shapes=EVAL_SHAPES,
               sides=(20, 64, 240), timed_images: int = EVAL_TIMED_IMAGES,
               split_images: int = EVAL_SPLIT_IMAGES, graphs=None,
               pipeline_depth: int = 2) -> dict:
    """The ``[eval]`` phase: ``evaluate_dataset`` over synthetic COCO sets
    in a temporary directory, read through ``np.load``.

    Checks, over one image a shape: the tight pack padded back through
    the loop's default (captured programs on CUDA) and through ``fn=
    model.inference`` (eager), the full pack, their programs and tight
    compute give equal predictions and proposals (all but the last,
    ``check_same_runs``) and finite metrics under every key (the last);
    the launches of ``eval_runs``. The graphs of the pad-back, full-pack
    and tight-compute programs (one a canvas met) are built there, and
    each program's pool is read.

    Times, over ``timed_images`` images (the shapes in turn): the
    pad-back loop through its program, its graphs built before the
    window, and eagerly, with equal predictions: avg ms/img (the loop's
    wall over the images) and steady (the median interval between
    completions); then the host split of the captured loop over
    ``split_images``. ``graphs``: the programs' capturing object;
    ``pipeline_depth``: the loop's (a capturing object whose replays
    rewrite the outputs on the host at once needs 0). Returns the
    launches counted."""
    import tempfile

    from centermask2_tpu_torch.data import s2d_serving_canvas
    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.export import supports_graphs

    card = card_line()
    n_tight = len({s2d_serving_canvas(h, w, fixed, min_size)
                   for h, w in shapes})
    by_default = supports_graphs(torch.device(dev))
    modes = (("tight pack, pad-back", {}, n_tight if by_default else 0,
              None),
             ("tight pack, pad-back, eager", {"fn": model.inference}, 0,
              None),
             ("full pack", {"tight": False}, 1 if by_default else 0, None),
             ("tight compute", {"tight_compute": True}, n_tight,
              "tight compute"),
             ("tight pack, pad-back, program", {}, n_tight, "pad-back"),
             ("full pack, program", {"tight": False}, 1, "full pack"))
    with tempfile.TemporaryDirectory() as root:
        ann = make_coco_dataset(root, shapes, sides=sides)
        check_ground_truth_ap(ann)
        common = dict(image_root=root, fixed_size=fixed, min_size=min_size,
                      max_size=max_size, progress_every=0,
                      read_image=np.load, pipeline_depth=pipeline_depth)
        runs, progs, launches = eval_runs(model, ann, modes, common,
                                          len(shapes), graphs)
        check_same_runs(runs, [m for m, *_ in modes if m != "tight compute"],
                        "the default loop, the eager loop, the full pack "
                        "and their programs")
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

        # the loop's rate over many requests: the pad-back program's
        # graphs are all built (every canvas of the shapes met above)
        ann = make_coco_dataset(root, shapes, sides=sides,
                                n_images=timed_images)
        prog = progs["pad-back"]
        built = len(prog)
        got = {}
        for mode, fn in (("captured", prog), ("eager", model.inference)):
            res, avg_ms, ev = evaluate_dataset(model, ann=ann, fn=fn,
                                               **common)
            got[mode] = ev.predictions
            log(f"  eval timed, {mode}, tight pack padded back: "
                f"{timed_images} images, avg {avg_ms:.3f} ms/img (the "
                f"loop's wall over the images), steady "
                f"{ev.steady_ms_per_image:.3f} ms/img (median completion "
                f"interval) ({card})")
        if len(prog) != built or got["captured"] != got["eager"]:
            raise AssertionError(f"eval timed: {len(prog) - built} graphs "
                                 f"captured in the window; predictions "
                                 f"equal {got['captured'] == got['eager']}")
        log(f"  eval timed: no capture in the window; captured and eager "
            f"predictions equal ({len(got['eager'])})")
        eval_host_split(lambda timed: evaluate_dataset(
            model, ann=ann, fn=timed("request", prog), limit=split_images,
            **common), min(split_images, timed_images))
    del progs, prog
    return launches


# ---------------------------------------------------------------- export
def export_phase(dev, s2d_model, nhwc_model, fixed: int = FIXED,
                 short: int = SHORT, image=(200, 800, 1333)) -> dict:
    """The ``[export]`` phase: ``export/aot.py`` artifacts of the uint8 s2d
    serving program over the tight landscape canvas padded back to
    ``fixed`` (``s2d_model``) and of the f32-input program over the
    ``fixed`` square (``nhwc_model``), saved, loaded and run once each:
    one launch of kernels 1 and 2 a call, outputs equal to the eager
    request slot by slot (``E2E_TOL``; bit-equality printed); export and
    load seconds, artifact MB and GFLOPs printed. Returns the launches
    counted."""
    import tempfile

    from centermask2_tpu_torch.export import (export_serialized,
                                              inference_flops,
                                              load_serialized)
    from centermask2_tpu_torch.ops import _kernels

    img = u8_image(*image)
    x, hw, canvas = serving_inputs(img, fixed, short, dev)
    nhwc = make_image(103, fixed, fixed, dev)
    cases = (
        (f"uint8 s2d serving program, tight {canvas[0]}x{canvas[1]} padded "
         f"back to {fixed}x{fixed}", s2d_model, torch.uint8, (fixed, fixed),
         (x, hw)),
        (f"f32-input {fixed}x{fixed} program", nhwc_model, torch.float32,
         None, (nhwc,)))
    launches = {"nms": 0, "roi_align": 0}
    with tempfile.TemporaryDirectory() as root:
        for i, (what, model, dtype, cv, args) in enumerate(cases):
            K = model.decode_kwargs["post_nms_topk"]
            shape = tuple(args[0].shape)
            t0 = time.perf_counter()
            path = export_serialized(model, shape, os.path.join(
                root, f"program{i}.pt2"), input_dtype=dtype, canvas_hw=cv)
            export_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            program = load_serialized(path)
            load_s = time.perf_counter() - t0
            flops = inference_flops(model, shape, input_dtype=dtype,
                                    canvas_hw=cv)
            _kernels.reset_launch_counts()
            out = program(*args)
            got = {k: _kernels.launch_counts()[k] for k in launches}
            if set(got.values()) != {1}:
                raise AssertionError(f"{what}: launches {got} in one call")
            for k in launches:
                launches[k] += got[k]
            want = model.inference(args[0], None,
                                   args[1] if len(args) > 1 else None, cv)
            n = compare_outputs(out, want, K, f"{what} artifact vs eager")
            same = all(torch.equal(a, b) for a, b in zip(out, want)
                       if a is not None)
            log(f"  {what}: input {shape} {str(dtype)[6:]}, exported in "
                f"{export_s:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB, "
                f"loaded in {load_s:.2f} s; {flops / 1e9:.1f} GFLOP a call "
                f"(FlopCounterMode); one call: launches {got}, {n} valid "
                f"slots, every output bit-equal to the eager request {same}")
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
                     sides=(16, 600), keypoints: bool = False) -> dict:
    """A batch in ``data/coco.py::train_batches``' format from a seed, on
    (fixed, fixed) canvases: normalized-scale noise with each gt box
    painted in a texture, ``n_gt`` boxes of ``sides`` px (log-uniform) an
    image among ``max_gt`` slots, and 112x112 mask patches (rectangles,
    triangles, ellipses), so the card needs no cv2 or PIL. With
    ``keypoints``, a person-keypoint batch: every gt of class 0, and
    "gt_keypoints" (B, max_gt, 17, 3) as ``with_keypoints`` gives them, 17
    points inside each box, a fifth not labeled (zeroed), the others
    visible (2) or not (1); drawn after the rest, so the other arrays are
    those of the batch without keypoints."""
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
    out = {"image": img, "gt_boxes": boxes, "gt_classes": classes,
           "gt_valid": valid, "gt_mask_patches": patches,
           "image_size": sizes}
    if keypoints:
        kp = np.zeros((batch, max_gt, 17, 3), np.float32)
        u = rng.rand(batch, max_gt, 17, 3)
        kp[..., :2] = boxes[:, :, None, :2] + u[..., :2] * (
            boxes[:, :, None, 2:] - boxes[:, :, None, :2])
        kp[..., 2] = np.where(u[..., 2] < 0.2, 0, np.where(u[..., 2] < 0.6,
                                                           1, 2))
        kp[kp[..., 2] == 0] = 0
        kp[~valid] = 0
        out["gt_keypoints"] = kp
        out["gt_classes"] = np.zeros_like(classes)
    return out


def build_trainer(cfg, dev, state=None, capture=None, graphs=None,
                  group=None):
    """The flagship model, its optimizer and schedule and the train step
    (``train/trainer.py::make_train_step``: captured on CUDA unless
    ``capture`` is False), random weights from seed 0 with the
    classification bias at ``TRAIN_CLS_BIAS``, or ``state``'s
    parameters. ``graphs(model, opt, sched)``, if given, makes the
    capturing object of a captured step; ``group``: the data-parallel
    process group of the step."""
    from centermask2_tpu_torch.train import (make_optimizer_from_cfg,
                                             make_train_step)

    model = build_model(cfg, dev).train()
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.fill_(TRAIN_CLS_BIAS)
    if state is not None:
        model.load_state_dict(state)
    opt, sched = make_optimizer_from_cfg(model, cfg)
    if graphs is not None and capture is not False:
        capture, graphs = True, graphs(model, opt, sched)
    step = make_train_step(model, opt, sched, capture=capture, graphs=graphs,
                           group=group)
    return model, opt, sched, step


# the losses of a step: FCOS with the mask branch or the keypoint head
FCOS_LOSSES = {"loss_fcos_cls", "loss_fcos_loc", "loss_fcos_ctr",
               "total_loss"}
LOSS_SETS = (FCOS_LOSSES | {"loss_mask", "loss_maskiou"},
             FCOS_LOSSES | {"loss_keypoint"})


def check_losses(metrics: dict, what: str) -> dict:
    m = {k: float(v) for k, v in metrics.items()}
    if set(m) not in LOSS_SETS or not all(np.isfinite(v) for v in m.values()):
        raise AssertionError(f"{what}: losses {m}")
    return m


def capture_step_inputs(run) -> dict:
    """The arguments of each kernel's last launch in one train step
    (``run()``, which goes through the kernels as usual)."""
    seen = record_launches(run, KERNEL_FNS)
    if not all(seen.values()):
        raise AssertionError(f"the step reached only "
                             f"{sorted(k for k, v in seen.items() if v)}")
    return {k: v[-1] for k, v in seen.items()}


def roi_bwd_case(args, what: str) -> float:
    """Kernel 2b against the plain VJP on one input (tolerance above);
    two launches bit-equal; its prepass table of tap windows equal to the
    CPU oracle's (``ops/roi_align.py::roi_tap_windows``). Raises
    otherwise; returns the max abs error."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.roi_align import (
        roi_align_feature_grad_plain, roi_tap_windows)

    grad, boxes, bidx, levels, shapes, dtype, scales, o, s, aligned = args
    k = _kernels.roi_align_backward(*args)
    again = _kernels.roi_align_backward(*args)
    p = roi_align_feature_grad_plain(*args)
    win = _kernels.roi_tap_windows(boxes, bidx, levels, shapes, scales, o, s,
                                   aligned)
    torch.cuda.synchronize()
    want = roi_tap_windows(boxes.cpu(), bidx.cpu(), levels.cpu(), shapes,
                           scales, o, s, aligned)
    if not torch.equal(win.cpu(), want):
        bad = (win.cpu() != want).any(dim=1).nonzero().flatten()[:4].tolist()
        raise AssertionError(f"roi_align_backward {what}: prepass windows of "
                             f"ROIs {bad} differ from the CPU oracle's: "
                             f"{win[bad].tolist()} vs {want[bad].tolist()}")
    if not all(torch.equal(a, b) for a, b in zip(k, again)):
        raise AssertionError(f"roi_align_backward {what}: two launches on "
                             f"the same input differ")
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
    log(f"  roi_align_backward {what}: {str(dtype)[6:]} R={grad.shape[0]} "
        f"C={grad.shape[1]} o={o} s={s}, levels "
        f"{[tuple(t.shape[2:]) for t in p]}: max abs err {worst:.3e}, max "
        f"|plain| {scale:.3e} (tolerance {tol_s}); two launches bit-equal; "
        f"prepass windows equal to the CPU oracle's "
        f"({int((want[:, 2] <= want[:, 3]).sum())} nonempty)")
    if bad:
        raise AssertionError(f"roi_align_backward {what}: levels {bad} "
                             f"outside {tol_s}")
    return worst


# (boxes, C, o, s) of kernel 2b's synthetic checks on P3-P5 of the
# training canvas, C None the step's: "mixed" are roi_inputs' boxes over
# the three levels (the step's ROIs all land on P3), "P5" every ROI on P5,
# "none" R = 0, "outside" every ROI outside the canvas, "stacked" 1.25 R + 1
# copies of one 3x3 px box of one image (every ROI in one tile's list, in
# two rounds of the kernel's list at R = 256); C = 200 leaves a ragged
# channel group; s = 4, the largest adaptive bucket, fills 56 of the 64
# entries of the prepass's axis tables
ROI_BWD_CASES = (("mixed", None, 14, 2), ("P5", None, 14, 2),
                 ("none", None, 14, 2), ("outside", None, 14, 2),
                 ("stacked", None, 14, 2), ("mixed", 200, 7, 2),
                 ("mixed", 200, 14, 1), ("mixed", None, 5, 3),
                 ("mixed", None, 14, 4))


def roi_bwd_boxes(rng, kind: str, fixed: int, batch: int, R: int, C: int,
                  dev):
    """Boxes and image indices of one ``ROI_BWD_CASES`` kind; "mixed"
    and "P5" draw ``roi_inputs``' features too (unused), so that their
    boxes and gradients stay those of the earlier versions of this
    check, for comparisons across versions."""
    bidx = (torch.arange(R, device=dev) % batch).to(torch.int32)
    if kind in ("mixed", "P5"):
        return roi_inputs(rng, fixed, fixed, R, C, batch, dev,
                          kind == "P5")[1], bidx
    if kind == "none":
        boxes, bidx = np.zeros((0, 4)), bidx[:0]
    elif kind == "outside":  # right of the canvas, or above and left
        x = rng.rand(R) * fixed / 4
        boxes = np.stack([fixed + 40.0 + x, x, fixed + 140.0 + x,
                          100.0 + x], 1)
        boxes[::2] = [-200.0, -150.0, -60.0, -50.0]
    else:  # more than kernel 2b's 256 ROIs a round: two rounds
        x, y = 0.3 * fixed, 0.22 * fixed
        n = R + R // 4 + 1
        boxes = np.tile([[x, y, x + 3.0, y + 3.0]], (n, 1))
        bidx = torch.zeros(n, dtype=torch.int32, device=dev)
    return torch.from_numpy(boxes.astype(np.float32)).to(dev), bidx


def check_roi_bwd_synthetic(dev, fixed: int, batch: int, R: int, C: int,
                            errs: dict, timing: bool) -> None:
    """Kernel 2b against the plain VJP over ``ROI_BWD_CASES`` on P3-P5 of
    the training canvas at the step's R and C, f32 and bf16 (each also
    launched twice and its windows held, as ``roi_bwd_case`` does). With
    ``timing``, "mixed" at the step's shapes is timed in both dtypes (and
    at s = 4), "stacked" and "none" (every tile empty: the cost of the
    zeros) in bf16."""
    from centermask2_tpu_torch.ops import assign_boxes_by_ratio
    from centermask2_tpu_torch.structures import boxes as box_ops

    rng = np.random.RandomState(2)
    scales = (1 / 8, 1 / 16, 1 / 32)
    for kind, c, o, s in ROI_BWD_CASES:
        c = C if c is None else c
        boxes, bidx = roi_bwd_boxes(rng, kind, fixed, batch, R, c, dev)
        n = boxes.shape[0]
        levels = assign_boxes_by_ratio(
            box_ops.area(boxes), torch.full((n,), float(fixed * fixed),
                                            device=dev), 3, 5)
        shapes = [(batch, c, fixed // st, fixed // st) for st in (8, 16, 32)]
        grad = torch.from_numpy(
            rng.randn(n, c, o, o).astype(np.float32)).to(dev)
        what = f"synthetic {kind} ROIs, levels {sorted(set(levels.tolist()))}"
        for dt in (torch.float32, torch.bfloat16):
            args = (grad.to(dt), boxes, bidx, levels, shapes, dt, scales, o,
                    s, True)
            errs["roi_align_backward"] = max(errs["roi_align_backward"],
                                             roi_bwd_case(args, what))
            main = (c, o, s) == (C, 14, 2)
            if timing and (main or (c, o, s) == (C, 14, 4)) and (
                    kind == "mixed" or (main and kind in ("stacked", "none")
                                        and dt != torch.float32)):
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
    two flops a tap of every in-range sample (operations). Beside it the
    kernel's own traffic, counted from its design."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.ops.roi_align import (
        _axis_coords, roi_align_feature_grad_plain, roi_tap_windows)

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
    bound, by = vector_bound(nbytes, flops)
    # the design's own traffic: the prepass reads g once and writes its
    # tables (window, axis tables, a nonzero flag); every block tests the
    # R windows and flags; each (block, ROI) pair whose window reaches the
    # block's 16 x 32 tile, for a ROI whose g is not all zero, stages the
    # ROI's axis tables and the g slice of the block's 8 channels
    win = roi_tap_windows(boxes.cpu(), bidx.cpu(), levels.cpu(), shapes,
                          scales, o, s, aligned).long()
    tiles = torch.where(win[:, 2] <= win[:, 3],
                        (win[:, 3] // 16 - win[:, 2] // 16 + 1)
                        * (win[:, 5] // 32 - win[:, 4] // 32 + 1), 0)
    groups = -(-C // 8)
    nz = (grad.reshape(R, C * o * o) != 0).any(dim=1).cpu()
    staged = int((tiles * nz).sum()) * groups
    blocks = sum(shp[0] * -(-shp[2] // 16) * -(-shp[3] // 32)
                 for shp in shapes) * groups
    g_reads = staged * 8 * o * o * elt
    tables = R * (24 + 2176 + 1) + blocks * R * 25 + staged * 2176
    own = level_elems * elt + grad.numel() * elt + g_reads + tables
    log(f"  roi_align_backward {what}: {str(dtype)[6:]} R={R} C={C}, "
        f"{samples} in-range samples, {staged} staged (block, ROI) pairs; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.6f} ms "
        f"({by}: {nbytes} bytes, {flops} flops); the kernel's own traffic is "
        f"{own} bytes ({level_elems * elt} written once, "
        f"{grad.numel() * elt} of g read by the prepass, {g_reads} of g "
        f"staged by the blocks, {tables} of tables and tests, mostly L2), "
        f"{own / card_peaks().hbm_bytes_s * 1e3:.6f} ms at the peak rate")
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
    difference and 1e-6 of the tensor's largest value. Kernel 2b sums in
    a fixed order, so the kernel-run term is now zero unless another op
    of the step is not deterministic; the log gives it and the worst
    ratio. The kernels are held against their plain versions on the
    step's captured inputs."""
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    with exact_f32(deterministic=True):
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
    check_grad_runs(runs, "f32 train step")
    del model, runs
    torch.cuda.empty_cache()


def check_grad_runs(runs: dict, what: str) -> None:
    """The rule of ``check_f32_step`` on ``runs``: "k1"/"k2" (losses,
    gradients) of two runs through the kernels, "p1"/"p2" through the
    plain versions."""
    (lk, gk), (lp, gp) = runs["k1"], runs["p1"]
    for name in lk:
        a, b = float(lk[name]), float(lp[name])
        if not abs(a - b) <= 1e-6 * abs(b):
            raise AssertionError(f"{what} {name}: kernels {a!r} plain {b!r}")
    log(f"  {what}, kernels vs plain, losses: " + ", ".join(
        f"{k} {float(lk[k]):.6f} (diff {float(lk[k] - lp[k]):.1e})"
        for k in lk))
    worst_ratio, worst_name, floors = 0.0, "", []
    runs_diff = {"plain": 0.0, "kernel": 0.0}
    for name in ZERO_GRADS:
        if name not in gk:
            continue
        module = name.rsplit(".", 1)[0] + "."
        scale = max(float(gp[n].abs().max()) for n in gp
                    if n.startswith(module))
        noise = max(float(gk[name].abs().max()), float(gp[name].abs().max()))
        if noise > ZERO_GRAD_REL * scale:
            raise AssertionError(f"{what} {name}: {noise:.3e}, above "
                                 f"{ZERO_GRAD_REL} x {scale:.3e}")
        log(f"  {what}, {name}: zero in exact arithmetic, "
            f"{noise:.3e} in both runs at most ({noise / scale:.1e} of its "
            f"module's largest gradient, tolerance {ZERO_GRAD_REL})")
    for name, g in gk.items():
        if name in ZERO_GRADS:
            continue
        p1, p2, k2 = gp[name], runs["p2"][1][name], runs["k2"][1][name]
        top = float(p1.abs().max())
        d_plain = float((p1 - p2).abs().max())
        d_kernel = float((g - k2).abs().max())
        runs_diff["plain"] = max(runs_diff["plain"], d_plain)
        runs_diff["kernel"] = max(runs_diff["kernel"], d_kernel)
        floor = max(d_plain, d_kernel, 1e-6 * top, 1e-30)
        ratio = float((g - p1).abs().max()) / floor
        if top > 0:
            floors.append(floor / top)
        if ratio > worst_ratio:
            worst_ratio, worst_name = ratio, name
    if set(gk) != set(gp) or worst_ratio > GRAD_NOISE_FACTOR:
        raise AssertionError(f"{what} gradients: {worst_name} at "
                             f"{worst_ratio:.2f} x its noise floor")
    log(f"  {what}, kernels vs plain: {len(gk)} parameter gradients, "
        f"worst {worst_ratio:.2f} x its noise floor ({worst_name}); floors "
        f"{min(floors):.1e}-{max(floors):.1e} of each tensor's max "
        f"(tolerance {GRAD_NOISE_FACTOR} x); largest difference between the "
        f"two kernel runs {runs_diff['kernel']:.1e} (the floor's kernel-run "
        f"term; 0 = bit-equal), between the two plain runs "
        f"{runs_diff['plain']:.1e}")


def profile_train_step(run, what: str = "bf16 train step"):
    """Device time of one train step by the profiler against its wall
    time, its largest CUDA kernels, and the port's kernels in
    microseconds. Returns (device ms, wall ms), or None when the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the optimizer's step is also a range on the device's timeline
    # ("Optimizer.step#..."), over kernels the sum counts already; the
    # sum with those ranges (counted twice) is printed beside it
    cuda = [e for e in prof.key_averages()
            if getattr(e, "device_type", None)
            == torch.autograd.DeviceType.CUDA
            and getattr(e, "device_time_total", 0) > 0]
    evs = [e for e in cuda if not e.key.startswith("Optimizer.")]
    total = sum(e.device_time_total for e in evs) / 1e3
    if total == 0:
        log(f"  profiler, one {what}: no device time recorded (not "
            "measured)")
        return None
    twice = sum(e.device_time_total for e in cuda) / 1e3
    log(f"  profiler, one {what}: device kernel time {total:.3f} ms "
        f"in {wall:.3f} ms wall (device idle share "
        f"{max(0.0, 1 - total / wall):.3f}, profiler on); with the "
        f"optimizer's ranges counted too {twice:.3f} ms (idle share "
        f"{max(0.0, 1 - twice / wall):.3f})")
    for e in sorted(evs, key=lambda e: -e.device_time_total)[:15]:
        log(f"    {e.device_time_total / 1e3:8.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")
    for e in evs:
        if any(t in e.key for t in ("nms", "roi_")):
            log(f"  profiler, port kernel in the {what}: "
                f"{e.device_time_total / e.count:.3f} us per launch of "
                f"{e.key.replace('(anonymous namespace)::', '')[:60]} "
                f"(x{e.count})")
    return total, wall


def eval_beside_training(model, step, images, gt, draws, fixed: int,
                         requests: int = 3) -> None:
    """``tools/train_net``'s periodic evaluation: one ``CapturedInference``
    of the training model, held for the whole run beside the captured
    train step. Its graph (the full ``fixed`` canvas) is captured, its
    pool read, then train steps and evaluation requests alternate with
    both held: the process's reserved memory and its peak printed."""
    from centermask2_tpu_torch.export import CapturedInference

    dev = images.device
    img = make_image(5, fixed, fixed, dev)
    K = model.decode_kwargs["post_nms_topk"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    model.eval()
    prog = CapturedInference(model)
    prog(img)
    model.train()
    pool = pool_bytes(r0)
    torch.cuda.reset_peak_memory_stats()
    for i in range(requests):
        check_losses(step(images, gt, draws), f"train step {i} beside eval")
        model.eval()
        check_outputs(prog(img), 1, K, f"eval request {i} beside training")
        model.train()
    torch.cuda.synchronize()
    log(f"  train_net's evaluation program beside the captured train step: "
        f"its {fixed}x{fixed} graph captured in {time.perf_counter() - t0:.3f}"
        f" s, pool {pool / 2 ** 20:.1f} MiB; {requests} train steps and "
        f"requests alternated with both held: reserved "
        f"{torch.cuda.memory_reserved() / 2 ** 30:.3f} GiB, peak reserved "
        f"{torch.cuda.max_memory_reserved() / 2 ** 30:.3f} GiB, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"({card_line()})")
    del prog
    torch.cuda.empty_cache()


def check_f32_captured_step(cfg, dev, state, steps_in, graphs=None) -> None:
    """The f32 train step (TF32 off, deterministic cuDNN) captured against
    the same step eagerly, step by step: ``WARMUP_STEPS`` eager warm-up
    steps, then the capture and the replays, each from the state the
    eager run had before that step (written into the captured step's own
    tensors, as a restore writes a checkpoint). Over several steps the
    runs part at the f32 rounding level between streams (the eager step
    on a side stream does too), which the MaskIoU targets (masks
    thresholded) amplify, so each step is compared from one state.
    Equal losses and parameters expected bit for bit; else each loss
    within GRAD_NOISE_FACTOR x the two eager runs' difference, at least
    1e-6 of its value, and each parameter within GRAD_NOISE_FACTOR x the
    larger of the two eager runs' difference and 1e-6 of the tensor's
    largest value (a few f32 roundings), the rule of ``check_f32_step``.
    Runs on ``steps_in``'s tensors, which the captured step adopts."""
    import torch.utils._pytree as pytree

    from centermask2_tpu_torch.checkpoint.torch_io import (
        restore_train_state, train_state)
    from centermask2_tpu_torch.train.trainer import WARMUP_STEPS

    def snapshot(model, opt, sched):
        return pytree.tree_map(
            lambda t: t.detach().clone() if torch.is_tensor(t) else t,
            train_state(model, opt, sched, 0))

    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    runs, before = {}, []
    with exact_f32(deterministic=True):
        for name, capture in (("eager", False), ("eager again", False),
                              ("captured", True)):
            model, opt, sched, step = build_trainer(
                cfg32, dev, state, capture=capture,
                graphs=graphs if capture else None)
            out = []
            for i, args in enumerate(steps_in):
                if name == "eager":
                    before.append(snapshot(model, opt, sched))
                elif capture and i >= WARMUP_STEPS:
                    restore_train_state(before[i], model, opt, sched)
                losses = check_losses(step(*args), f"f32 {name} step {i + 1}")
                out.append((losses, {n: p.detach().clone()
                                     for n, p in model.named_parameters()}))
            runs[name] = out[WARMUP_STEPS:]
            del model, opt, sched, step, out
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    del before
    bit, worst, worst_name, eager_bit = True, 0.0, "", True
    for i, ((lc, pc), (le, pe), (le2, pe2)) in enumerate(zip(
            runs["captured"], runs["eager"], runs["eager again"])):
        what = f"f32 captured step {WARMUP_STEPS + i + 1}"
        for k in lc:
            floor = max(GRAD_NOISE_FACTOR * abs(le[k] - le2[k]),
                        1e-6 * abs(le[k]))
            if not abs(lc[k] - le[k]) <= floor:
                raise AssertionError(f"{what} {k}: {lc[k]!r} vs eager "
                                     f"{le[k]!r}")
        bit = bit and lc == le
        eager_bit = eager_bit and le == le2
        for n, p in pe.items():
            d_eager = float((pe2[n] - p).abs().max())
            floor = max(d_eager, 1e-6 * float(p.abs().max()), 1e-30)
            d = float((pc[n] - p).abs().max())
            bit = bit and d == 0
            eager_bit = eager_bit and d_eager == 0
            if d / floor > worst:
                worst, worst_name = d / floor, f"{n} at step " \
                    f"{WARMUP_STEPS + i + 1}"
    if worst > GRAD_NOISE_FACTOR:
        raise AssertionError(f"f32 captured step: {worst_name} at "
                             f"{worst:.2f} x its floor")
    n_pe = len(runs["eager"][0][1])
    log(f"  f32 train step captured vs eager: the capture and "
        f"{len(runs['captured']) - 1} replay(s) after {WARMUP_STEPS} eager "
        f"warm-up steps, each from the eager run's state before it: losses "
        f"and all {n_pe} parameters "
        + ("bit-equal" if bit else
           f"within {worst:.2f} x their floor ({worst_name}; tolerance "
           f"{GRAD_NOISE_FACTOR} x)")
        + f"; the two eager runs bit-equal {eager_bit}; last total loss "
        f"{runs['captured'][-1][0]['total_loss']:.6f}")


class TrainLoops:
    """``train/trainer.py::train_loop`` over ``batches`` as the CLI runs it,
    with the launch counts and a CUDA event read after every step;
    ``totals`` sums each kernel's launches over the runs."""

    def __init__(self, batches, dev, gen):
        self.batches, self.dev, self.gen = batches, dev, gen
        self.totals = {k: 0 for k in ("nms", "roi_align",
                                      "roi_align_backward")}
        self.counts, self.events, self.metrics = [], [], []

    def after_step(self, done, metrics):
        from centermask2_tpu_torch.ops import _kernels

        self.counts.append(_kernels.launch_counts())
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self.metrics.append(metrics)

    def read_launches(self, n_steps: int, what: str, eager_steps: int):
        """One launch of each kernel in each of the first ``eager_steps``
        steps (eager, or the warm-up and the capture of a captured step),
        none in the later ones (replays)."""
        prev = {k: 0 for k in self.totals}
        for i, c in enumerate(self.counts):
            d = {k: c[k] - prev[k] for k in c}
            if set(d.values()) != {int(i < eager_steps)}:
                raise AssertionError(f"{what} step {i}: launches {d}")
            prev = c
        if len(self.counts) != n_steps:
            raise AssertionError(f"{what}: {len(self.counts)} of {n_steps} "
                                 "steps")
        for k in self.totals:
            self.totals[k] += self.counts[-1][k]

    def run(self, step_fn, n_steps, first_timed, what, eager_steps,
            cycle=True):
        """``n_steps`` steps of ``step_fn`` (cycling over the batches, or
        the first one again); returns the CUDA-event ms of the steps from
        ``first_timed`` on, the loop's wall seconds and the peak memory."""
        import itertools

        from centermask2_tpu_torch.ops import _kernels
        from centermask2_tpu_torch.train import train_loop

        self.counts.clear()
        self.events.clear()
        self.metrics.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        train_loop(step_fn, itertools.cycle(self.batches) if cycle
                   else itertools.repeat(self.batches[0]), device=self.dev,
                   start_iter=0, max_iter=n_steps, generator=self.gen,
                   log_every=10 ** 9, after_step=self.after_step, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.read_launches(n_steps, what, eager_steps)
        ms = [a.elapsed_time(b) for a, b in zip(
            self.events[first_timed - 1:], self.events[first_timed:])]
        return ms, wall, torch.cuda.max_memory_allocated()


def log_train_times(ms, wall, peak, n_steps, first_timed, what, batch,
                    card):
    q1, q2, q3 = np.percentile(ms, [25, 50, 75])
    log(f"  ms per bf16 train step, {what} (CUDA events over "
        f"{len(ms)} steps after {first_timed}): median {q2:.3f} [q1 "
        f"{q1:.3f}, q3 {q3:.3f}] min {min(ms):.3f} max {max(ms):.3f}; "
        f"{batch / q2 * 1e3:.3f} images/s; loop wall "
        f"{wall / n_steps * 1e3:.3f} ms/step with the first calls; peak "
        f"memory {peak / 2 ** 30:.3f} GiB (max_memory_allocated) "
        f"({card})")


def train_phase(dev, cfg, fixed: int = FIXED, batch: int = TRAIN_BATCH,
                n_gt: int = TRAIN_GT, warmup: int = TRAIN_WARMUP,
                timed: int = TRAIN_TIMED, overfit: int = OVERFIT_STEPS,
                sides=(16, 600), roi_rc=(256, 256), timing: bool = True,
                graphs=None):
    """The ``[train]`` phase on the flagship config ``cfg``, through the
    captured train step (``graphs(model, opt, sched)`` makes its capturing
    object where given; on CUDA by default) and, for comparison, the
    eager one. Returns (the launches of its ``train_loop`` steps by
    kernel, the worst kernel/plain errors, kernel 2b's row or None
    without ``timing``)."""
    import itertools
    import tempfile

    from centermask2_tpu_torch.checkpoint.torch_io import (
        load_checkpoint, restore_train_state, save_checkpoint, train_state)
    from centermask2_tpu_torch.train import CapturedTrainStep, batch_to_device
    from centermask2_tpu_torch.train.trainer import WARMUP_STEPS

    dev = torch.device(dev)
    card = card_line()
    max_gt = cfg.TPU.MAX_GT_INSTANCES
    batches = [make_train_batch(300 + i, batch, fixed, n_gt, max_gt,
                                sides=sides) for i in range(2)]
    model, opt, sched, step = build_trainer(cfg, dev, graphs=graphs)
    captured = isinstance(step, CapturedTrainStep)
    init_state = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    runs = TrainLoops(batches, dev, gen)
    totals, loop = runs.totals, runs.run

    # the main path: the captured step (3 eager warm-up steps, the capture,
    # replays), timed after the capture
    n_eager = WARMUP_STEPS + 1 if captured else warmup
    ms, wall, peak = loop(step, n_eager + timed, n_eager, "train_loop",
                          n_eager if captured else n_eager + timed)
    first = check_losses(runs.metrics[0], "step 1")
    last = check_losses(runs.metrics[-1], f"step {n_eager + timed}")
    how = (f"captured: one launch of nms, roi_align and roi_align_backward "
           f"in each of the {WARMUP_STEPS} eager warm-up steps and at the "
           f"capture, none through the launch functions at a replay"
           if captured else "eager: one launch of each kernel per step")
    log(f"  {n_eager + timed} bf16 steps through train_loop at "
        f"{fixed}x{fixed}, B={batch}, {n_gt} gt an image, {how} ({totals}); "
        f"losses finite, step 1 "
        + ", ".join(f"{k} {v:.4f}" for k, v in first.items())
        + f"; step {n_eager + timed} total {last['total_loss']:.4f}")

    def log_times(ms, wall, peak, n_steps, first_timed, what):
        log_train_times(ms, wall, peak, n_steps, first_timed, what, batch,
                        card)

    if timing:
        log_times(ms, wall, peak, n_eager + timed, n_eager,
                  "captured" if captured else "eager")
        if captured:
            log(f"  the train step's capture took {step.capture_s:.3f} s "
                f"(after {WARMUP_STEPS} eager warm-up steps)")

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
    log(f"  a bf16 train step ({'a replay' if captured else 'eager'}) under "
        "sync-debug mode 'error', inputs on the device: no host sync")
    if captured:
        replay_launches(lambda: step(images, gt, draws), 3,
                        ("nms", "roi_align", "roi_align_backward"),
                        "train step replays")
    if timing:
        profile_train_step(lambda: step(images, gt, draws),
                           "bf16 train step" + (", a replay" if captured
                                                else ""))
        if captured:
            eval_beside_training(model, step, images, gt, draws, fixed)
    del model, opt, sched, step
    torch.cuda.empty_cache()

    # the eager step beside it, from the same weights; its
    # kernels held against their plain versions on its captured inputs
    model, opt, sched, estep = build_trainer(cfg, dev, init_state,
                                             capture=False)
    ms, wall, peak = loop(estep, warmup + timed, warmup, "eager train_loop",
                          warmup + timed)
    if timing:
        log_times(ms, wall, peak, warmup + timed, warmup, "eager")
    seen = capture_step_inputs(lambda: estep(images, gt, draws))
    check_step_kernels(seen, "bf16 train step", errs)
    with torch.no_grad():
        check_roi_bwd_synthetic(dev, fixed, batch, *roi_rc, errs, timing)
    row = None
    if timing:
        with torch.no_grad():
            nms_row(*seen["nms_keep_sorted"], "bf16 train step")
            roi_row(*seen["roi_align"], "bf16 train step")
            row = roi_bwd_row(seen["roi_align_backward"], "bf16 train step")
        profile_train_step(lambda: estep(images, gt, draws),
                           "bf16 train step, eager")
    del seen, model, opt, sched, estep
    torch.cuda.empty_cache()

    check_f32_step(cfg, dev, init_state, images, gt, draws, errs)
    steps_in = []  # the warm-up, the capture and one more replay
    for b in itertools.islice(itertools.cycle(batches), WARMUP_STEPS + 2):
        x, g = batch_to_device(b, dev)
        steps_in.append((x, g, torch.rand(draws.shape, generator=gen,
                                          device=dev)))
    check_f32_captured_step(cfg, dev, init_state, steps_in, graphs=graphs)
    del steps_in

    # overfit one batch: BASE_LR 0.01, no warm-up, global-norm clip 1.0
    cfg_fit = cfg.clone()
    cfg_fit.SOLVER.BASE_LR = 0.01
    cfg_fit.SOLVER.WARMUP_ITERS = 0
    cfg_fit.SOLVER.WARMUP_FACTOR = 1.0
    cfg_fit.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg_fit.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg_fit.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    model, opt, sched, step = build_trainer(cfg_fit, dev, init_state,
                                            graphs=graphs)
    loop(step, overfit, 1, "overfit",
         WARMUP_STEPS + 1 if captured else overfit, cycle=False)
    losses = [check_losses(m, f"overfit step {i + 1}")["total_loss"]
              for i, m in enumerate(runs.metrics)]
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  overfit, {overfit} bf16 steps on one batch through the "
        f"{'captured' if captured else 'eager'} step (BASE_LR 0.01, no "
        f"warm-up, global-norm clip 1.0, FrozenBN leaves counted in the "
        f"norm): total loss " + " ".join(f"{v:.3f}" for v in losses)
        + f"; mean of the first 5 {head:.4f}, of the last 5 {tail:.4f}")
    if not tail < head:
        raise AssertionError(f"overfit: loss did not fall ({head} -> {tail})")

    # checkpoint round trip: every tensor back, and the next step equal,
    # into new objects and into the captured step's own
    def buffers(o):
        return [t for st in o.state.values() for t in st.values()
                if torch.is_tensor(t)]

    with tempfile.TemporaryDirectory() as root:
        path = save_checkpoint(root, train_state(model, opt, sched, overfit),
                               overfit)
        state = load_checkpoint(path)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        momentum = [t.clone() for t in buffers(opt)]
        epoch = sched.last_epoch
        ref = check_losses(step(images, gt, draws), "step before reload")
        after = {k: v.clone() for k, v in model.state_dict().items()}
        ref_delta = {k: after[k] - before[k] for k in before}
        model2, opt2, sched2, step2 = build_trainer(cfg_fit, dev,
                                                    graphs=graphs)
        if restore_train_state(state, model2, opt2, sched2) != overfit:
            raise AssertionError("checkpoint: step lost")
        restored = buffers(opt2)
        same = all(torch.equal(a, b) for a, b in zip(
            model2.state_dict().values(), before.values())) and \
            len(restored) == len(momentum) > 0 and \
            all(torch.equal(a, b) for a, b in zip(restored, momentum)) and \
            sched2.last_epoch == epoch
        again = check_losses(step2(images, gt, draws), "step after reload")
        live = [id(t) for t in buffers(opt)] + [id(sched.count)]
        restore_train_state(state, model, opt, sched)
        kept = live == [id(t) for t in buffers(opt)] + [id(sched.count)]
        replay = check_losses(step(images, gt, draws), "replay after restore")
        same_replay = replay == ref and all(
            torch.equal(v, after[k]) for k, v in model.state_dict().items())
    delta = {k: model2.state_dict()[k] - before[k] for k in before}
    rel = max(float((delta[k] - ref_delta[k]).norm())
              / max(float(ref_delta[k].norm()), 1e-30)
              for k in delta if ref_delta[k].is_floating_point()
              and float(ref_delta[k].norm()) > 0)
    if not same or again != ref or rel > 1e-2 or not kept or \
            not same_replay:
        raise AssertionError(f"checkpoint round trip: state equal {same}, "
                             f"losses {ref} vs {again}, update rel {rel}; "
                             f"restore into the step's tensors {kept}, its "
                             f"next step equal {same_replay}")
    log(f"  checkpoint round trip on the card ({len(before)} model tensors, "
        f"momentum, schedule): state bit-equal; the step after reload gives "
        f"the same losses (total {again['total_loss']:.6f}) and an update "
        f"within {rel:.2e} in relative norm of the step without it; restored "
        f"into the {'captured' if captured else 'eager'} step's own tensors "
        f"(the same momentum buffers and count), its next step repeats the "
        f"step after the save bit for bit")
    del model, model2, opt, opt2, step, step2
    torch.cuda.empty_cache()
    return totals, errs, row


# ------------------------------------------------------------- backbones
BACKBONE_WINDOW_S = 2.0  # the windows of the backbones after R-50
FROZEN_R50 = ("backbone.stem_conv1.", "backbone.res2_")  # FREEZE_AT 2


def backbone_eval(dev, model, fixed: int = FIXED, min_size: int = SHORT,
                  max_size: int = 1333, shapes=EVAL_SHAPES,
                  sides=(20, 64, 240), graphs=None,
                  pipeline_depth: int = 2, dataset=None,
                  tasks=("bbox", "segm")) -> dict:
    """``evaluate_dataset`` with ``model`` (not s2d: the f32 image padded
    to ``fixed``) over the 8-image synthetic COCO set of ``[eval]``,
    through a ``CapturedInference`` (one canvas, one graph) and eagerly,
    with ``eval_runs``' launch gates; equal predictions and proposals
    (``check_same_runs``: an 80-class random model may detect none of
    the set's 4 categories). ``dataset(root, shapes, sides=)`` makes the
    set (``make_coco_dataset``'s by default) and ``tasks`` are the COCO
    tasks scored. Returns the launches counted."""
    import tempfile

    modes = (("captured", {}, 1, "padded"),
             ("eager", {"fn": model.inference}, 0, None))
    with tempfile.TemporaryDirectory() as root:
        ann = (dataset or make_coco_dataset)(root, shapes, sides=sides)
        common = dict(image_root=root, fixed_size=fixed, min_size=min_size,
                      max_size=max_size, progress_every=0,
                      read_image=np.load, pipeline_depth=pipeline_depth,
                      tasks=tuple(tasks))
        runs, _, launches = eval_runs(model, ann, modes, common, len(shapes),
                                      graphs)
    check_same_runs(runs, ("captured", "eager"), "the captured and the "
                    "eager loop")
    return launches


def backbone_train(dev, cfg, name: str, fixed: int = FIXED,
                   batch: int = TRAIN_BATCH, n_gt: int = TRAIN_GT,
                   warmup: int = TRAIN_WARMUP, timed: int = TRAIN_TIMED,
                   sides=(16, 600), graphs=None, timing: bool = True,
                   frozen_prefixes=FROZEN_R50, keypoints: bool = False):
    """The bf16 train step of ``cfg`` through ``train_loop``, captured and
    then eager from the same weights: one launch of each kernel a step (or
    at the warm-up and capture), one a replay by the profiler, finite
    losses, the parameters of ``frozen_prefixes`` (FREEZE_AT 2: the
    ResNet's ``stem_conv1`` and ``res2``; none for FREEZE_AT 0) frozen and
    bit-equal after the steps; ms a step, images/s, peak memory and a
    replay's device time by the profiler; then one f32 step through the
    kernels against the plain versions (``check_f32_step``). With
    ``keypoints`` the batches are person-keypoint batches
    (``make_train_batch``). Returns (the launches by kernel, the worst
    kernel/plain errors)."""
    from centermask2_tpu_torch.train import CapturedTrainStep, batch_to_device
    from centermask2_tpu_torch.train.trainer import WARMUP_STEPS

    dev = torch.device(dev)
    card = card_line()
    max_gt = cfg.TPU.MAX_GT_INSTANCES
    batches = [make_train_batch(300 + i, batch, fixed, n_gt, max_gt,
                                sides=sides, keypoints=keypoints)
               for i in range(2)]
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = TrainLoops(batches, dev, gen)
    errs = {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    images, gt = batch_to_device(batches[0], dev)
    draws = torch.rand((batch, cfg.MODEL.FCOS.POST_NMS_TOPK_TRAIN + max_gt),
                       generator=gen, device=dev)
    init_state = None
    for capture in (None, False):  # the captured step (on CUDA), eager
        model, opt, sched, step = build_trainer(
            cfg, dev, init_state, capture=capture,
            graphs=graphs if capture is None else None)
        if init_state is None:
            init_state = {k: v.clone() for k, v in model.state_dict().items()}
        frozen = {n: p.detach().clone() for n, p in model.named_parameters()
                  if frozen_prefixes and n.startswith(frozen_prefixes)}
        if bool(frozen) != bool(frozen_prefixes) or any(
                p.requires_grad for n, p in model.named_parameters()
                if n in frozen):
            raise AssertionError(f"{name}: FREEZE_AT "
                                 f"{cfg.MODEL.BACKBONE.FREEZE_AT} froze "
                                 f"{sorted(frozen)}")
        captured = isinstance(step, CapturedTrainStep)
        what = "captured" if captured else "eager"
        n_eager = WARMUP_STEPS + 1 if captured else warmup
        ms, wall, peak = runs.run(step, n_eager + timed, n_eager,
                                  f"{name} {what} train_loop",
                                  n_eager if captured else n_eager + timed)
        last = [check_losses(m, f"{name} {what} step {i + 1}")
                for i, m in enumerate(runs.metrics)][-1]
        moved = [n for n, p in model.named_parameters()
                 if n in frozen and not torch.equal(p, frozen[n])]
        if moved:
            raise AssertionError(f"{name} {what}: frozen {moved[:3]} moved")
        log(f"  {name} {what} train step, {n_eager + timed} bf16 steps at "
            f"{fixed}x{fixed}, B={batch}: one launch of each kernel "
            + (f"in each of the {WARMUP_STEPS} warm-up steps and at the "
               "capture, none at a replay" if captured else "a step")
            + f"; losses finite (last total {last['total_loss']:.4f}"
            + (f", loss_keypoint {last['loss_keypoint']:.4f}"
               if "loss_keypoint" in last else "") + ")"
            + (f"; the {len(frozen)} stem_conv1 and res2 parameters "
               "bit-equal after the steps" if frozen else ""))
        if captured:
            replay_launches(lambda: step(images, gt, draws), 3,
                            ("nms", "roi_align", "roi_align_backward"),
                            f"{name} train step replays")
        if timing:
            log_train_times(ms, wall, peak, n_eager + timed, n_eager,
                            f"{name}, {what}", batch, card)
            profile_train_step(lambda: step(images, gt, draws),
                               f"{name} bf16 train step, {what}")
        del model, opt, sched, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    check_f32_step(cfg, dev, init_state, images, gt, draws, errs)
    return runs.totals, errs


def backbones_phase(dev, cfgs=None, canvases=GRAPH_CANVASES,
                    windows=(WINDOW_S, BACKBONE_WINDOW_S), train=None,
                    eval_kw=None, graphs=None, train_graphs=None,
                    timing: bool = True):
    """The ``[backbones]`` phase: the other backbone families at full
    width, bf16, random weights from seed 0. R-50: requests at each canvas
    eagerly and captured (``graph_requests``, with the kernels held
    against their plain versions on its requests' inputs), the f32
    request at the first canvas with TF32 off, the eval entry point
    (``backbone_eval``), training (``backbone_train``). R-101, MobileNetV2
    and the two depthwise VoVNets: one request each at the first canvas.
    The bf16 work runs at PyTorch's default settings, as the entry points
    do (cuDNN's TF32 for MobileNetV2's f32 body). ``cfgs``: name -> config (``BACKBONES``' by default); ``train``,
    ``eval_kw``: keyword arguments of ``backbone_train`` and
    ``backbone_eval``; ``graphs``: the inference programs' capturing
    object, ``train_graphs(model, opt, sched)`` the train step's. Returns
    (the launches by kernel, the worst kernel/plain errors)."""
    if cfgs is None:
        cfgs = {n: build() for n, (build, _) in BACKBONES.items()}
    dev = torch.device(dev)
    launches = {"nms": 0, "roi_align": 0, "roi_align_backward": 0}
    errs = {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def drop():
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()

    cfg = cfgs["R-50"]
    model = build_model(cfg, dev)
    add(graph_requests(dev, "R-50", model, canvases,
                       windows[0] if timing else 0.0, graphs=graphs,
                       errs=errs))
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    with exact_f32():
        model32 = build_model(cfg32, dev)
        add(graph_requests(dev, "R-50, TF32 off,", model32, canvases[:1],
                           graphs=graphs))
    del model32
    drop()
    add(backbone_eval(dev, model, graphs=graphs, **(eval_kw or {})))
    del model
    drop()
    counts, train_errs = backbone_train(dev, cfg, "R-50", graphs=train_graphs,
                                        timing=timing, **(train or {}))
    add(counts)
    for k in errs:
        errs[k] = max(errs[k], train_errs[k])
    drop()
    for name in ("R-101", "MobileNetV2", "V-19-dw-eSE", "V-19-slim-dw-eSE"):
        model = build_model(cfgs[name], dev)
        add(graph_requests(dev, name, model, canvases[:1],
                           windows[1] if timing else 0.0, graphs=graphs))
        del model
        drop()
    return launches, errs


# ------------------------------------------------------------- keypoints
KEYPOINT_WINDOW_S = 2.0  # the windows of the adaptive and DCN requests
ADAPTIVE_SIDES = (16, 1300)  # gt sides of the adaptive step: every bucket


def make_keypoint_dataset(root: str, shapes=EVAL_SHAPES, seed: int = 11,
                          sides=(40, 120, 300)) -> str:
    """A COCO person-keypoint set from a seed: uint8 BGR ``.npy`` images
    and per image three people (boxes of about ``sides``, within 10%),
    each with 17 keypoints inside its box, a fifth of them not labeled
    (0, at the origin) and the others visible (2) or not (1),
    ``num_keypoints`` the labeled ones, and the box as its polygon.
    Returns the annotation json's path."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (H, W) in enumerate(shapes, 1):
        name = f"{i:012d}.npy"
        np.save(os.path.join(root, name), u8_image(seed + i, H, W))
        images.append({"id": i, "file_name": name, "height": H, "width": W})
        for side in sides:
            bw, bh = side * (0.9 + 0.2 * rng.rand(2))
            x0, y0 = rng.rand() * (W - bw - 1), rng.rand() * (H - bh - 1)
            kp = np.zeros((17, 3))
            kp[:, 0] = x0 + rng.rand(17) * bw
            kp[:, 1] = y0 + rng.rand(17) * bh
            u = rng.rand(17)
            kp[:, 2] = np.where(u < 0.2, 0, np.where(u < 0.6, 1, 2))
            kp[0, 2] = 2  # at least one labeled
            kp[kp[:, 2] == 0] = 0
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": 1, "bbox": [x0, y0, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "segmentation": [_polygon(rng, x0, y0, bw, bh, 0)],
                         "keypoints": [float(v) for v in kp.flatten()],
                         "num_keypoints": int((kp[:, 2] > 0).sum())})
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": [
            {"id": 1, "name": "person",
             "keypoints": [f"k{k}" for k in range(17)], "skeleton": []}]},
            f)
    return path


def check_keypoint_ground_truth_ap(ann: str) -> dict:
    """The ground truth fed back as predictions (score 1; each keypoint at
    its pixel centre, x, y + 0.5, which the evaluator takes back off, with
    probability 1) must score AP 100.0 for bbox and keypoints (OKS, COCO's
    17 sigmas)."""
    from centermask2_tpu_torch.evaluation import COCOEvaluator, COCOGt

    with open(ann) as f:
        gt = COCOGt(json.load(f))
    ev = COCOEvaluator(gt, tasks=("bbox", "keypoints"),
                       category_id_map={0: 1})
    for img_id in sorted(gt.imgs):
        a = gt.img_to_anns[img_id]
        xywh = np.array([x["bbox"] for x in a], np.float64)
        kp = np.array([x["keypoints"] for x in a], np.float64).reshape(
            len(a), 17, 3)
        kp[..., :2] += 0.5
        kp[..., 2] = 1.0
        ones = np.ones(len(a))
        ev.process(img_id, {
            "pred_boxes": np.concatenate([xywh[:, :2],
                                          xywh[:, :2] + xywh[:, 2:]], 1),
            "scores": ones, "mask_scores": ones,
            "pred_classes": np.zeros(len(a), np.int64),
            "pred_keypoints": kp})
    res = ev.evaluate()
    ap = {t: res[t]["AP"] for t in ("bbox", "keypoints")}
    log(f"  evaluator, person-keypoint ground truth fed back: AP bbox "
        f"{ap['bbox']:.4f}, keypoints (OKS) {ap['keypoints']:.4f}")
    if any(abs(v - 100.0) > 1e-9 for v in ap.values()):
        raise AssertionError(f"ground truth fed back scores {ap}")
    return ap


def keypoint_eval(dev, model, shapes=EVAL_SHAPES, sides=(40, 120, 300),
                  **kw) -> dict:
    """The eval entry point with the keypoint ``model`` over the synthetic
    person-keypoint set (``make_keypoint_dataset``), captured and eagerly,
    tasks bbox and keypoints (``backbone_eval``: equal predictions,
    ``pred_keypoints`` in their records, and proposals); before it, the
    set's ground truth fed back at AP 100. Returns the launches
    counted."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        check_keypoint_ground_truth_ap(make_keypoint_dataset(
            root, shapes, sides=sides))
    return backbone_eval(dev, model, shapes=shapes, sides=sides,
                         dataset=make_keypoint_dataset,
                         tasks=("bbox", "keypoints"), **kw)


def bucket_counts(args) -> dict:
    """ROIs of one kernel 2 or 2b launch (its arguments) by adaptive
    bucket (ceil(max(h, w) * scale / o), 4 above 4), of those with a
    gradient for kernel 2b (a nonzero row of g)."""
    if len(args) == 8:  # kernel 2: features, boxes, image, level, scales
        boxes, levels, scales, o = args[1], args[3], args[4], args[5]
        keep = torch.ones(boxes.shape[0], dtype=torch.bool,
                          device=boxes.device)
    else:  # kernel 2b: grad, boxes, image, level, shapes, dtype, scales
        boxes, levels, scales, o = args[1], args[3], args[6], args[7]
        keep = (args[0].reshape(args[0].shape[0], -1) != 0).any(dim=1)
    scale = torch.tensor(scales, device=boxes.device)[levels.long()]
    side = torch.maximum(boxes[:, 3] - boxes[:, 1], boxes[:, 2] - boxes[:, 0])
    need = torch.ceil(side * scale / o)[keep]
    return {s: int(((need <= s) & (need > lo)).sum()) if s < 4 else
            int((need > lo).sum())
            for s, lo in ((1, -1e9), (2, 1), (4, 2))}


def adaptive_step(dev, cfg, fixed: int = FIXED, batch: int = TRAIN_BATCH,
                  n_gt: int = TRAIN_GT, sides=ADAPTIVE_SIDES,
                  errs=None, timing: bool = True) -> dict:
    """One f32 step (TF32 off, deterministic cuDNN) of the adaptive config
    ``cfg``, eager, its gt boxes of ``sides`` px so that every bucket
    gets ROIs: one launch of kernel 1, three of kernel 2 (s = 1, 2, 4)
    and three of kernel 2b (launch counts), each launch against its plain
    version on its own inputs (kernel 2b: twice bit-equal and its prepass
    windows, ``roi_bwd_case``); with ``timing``, kernel 2b at s = 4 timed
    on the step's input in f32 and bf16. Returns the launches."""
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.train import batch_to_device

    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    max_gt = cfg.TPU.MAX_GT_INSTANCES
    images, gt = batch_to_device(make_train_batch(
        310, batch, fixed, n_gt, max_gt, sides=sides), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    draws = torch.rand((batch, cfg.MODEL.FCOS.POST_NMS_TOPK_TRAIN + max_gt),
                       generator=gen, device=dev)
    with exact_f32(deterministic=True):
        model = build_trainer(cfg32, dev, capture=False)[0]
        _kernels.reset_launch_counts()
        seen = record_launches(lambda: step_grads(model, images, gt, draws),
                               KERNEL_FNS)
        counts = _kernels.launch_counts()
    if counts != {"nms": 1, "roi_align": 3, "roi_align_backward": 3}:
        raise AssertionError(f"adaptive f32 step: launches {counts}")
    what = "adaptive f32 step"
    fwd = [a[6] for a in seen["roi_align"]]
    bwd = [a[8] for a in seen["roi_align_backward"]]
    if sorted(fwd) != [1, 2, 4] or sorted(bwd) != [1, 2, 4]:
        raise AssertionError(f"{what}: sampling ratios {fwd}, {bwd}")
    with torch.no_grad():
        errs["nms"] = max(errs["nms"], nms_case(
            *seen["nms_keep_sorted"][0], what))
        for args in seen["roi_align"]:
            errs["roi_align"] = max(errs["roi_align"], roi_case(
                *args[:7], f"{what}, s={args[6]}, ROIs by bucket "
                f"{bucket_counts(args)}"))
        for args in seen["roi_align_backward"]:
            errs["roi_align_backward"] = max(
                errs["roi_align_backward"], roi_bwd_case(
                    args, f"{what}, s={args[8]}, ROIs with a gradient by "
                    f"bucket {bucket_counts(args)}"))
    log(f"  {what} at {fixed}x{fixed}, B={batch}: kernel 1 launched once, "
        f"kernel 2 three times (s = {fwd}) and kernel 2b three times "
        f"(s = {bwd}); each launch held against its plain version")
    if timing:
        s4 = next(a for a in seen["roi_align_backward"] if a[8] == 4)
        roi_bwd_row(s4, f"{what}, s=4")
        b16 = (s4[0].bfloat16(), *s4[1:5], torch.bfloat16, *s4[6:])
        roi_bwd_row(b16, f"{what} input in bf16, s=4")
    del seen, model
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return counts


def keypoints_phase(dev, cfgs=None, canvases=GRAPH_CANVASES,
                    windows=(WINDOW_S, KEYPOINT_WINDOW_S), train=None,
                    eval_kw=None, adaptive=None, graphs=None,
                    train_graphs=None, timing: bool = True):
    """The ``[keypoints]`` phase, at full width, bf16, random weights from
    seed 0:

    1. the person-keypoint yaml (``keypoint_cfg``) served at each canvas,
       eagerly and through ``CapturedInference`` (``graph_requests``: the
       launches, the replay equal to the eager request slot by slot,
       ``pred_keypoints`` included, kernels 1 and 2 against their plain
       versions on the request's inputs, a captured and an eager window);
    2. its eval entry point over a synthetic person-keypoint set, captured
       and eager (``keypoint_eval``, the OKS task; the ground truth at AP
       100);
    3. its training, captured then eager, and one f32 step through the
       kernels against the plain versions (``backbone_train``);
    4. the adaptive ROIAlign buckets on the flagship (``adaptive_cfg``):
       one request, eager and captured (three launches of kernel 2 each,
       every one against its plain version; kernel 2 at s = 4 timed on the
       request's input), then ``adaptive_step``;
    5. the deformable convs on the flagship (``dcn_cfg``): one request,
       eager and captured, the replay equal to eager, timed.

    ``cfgs``: "keypoint", "adaptive", "dcn" -> config; ``train``,
    ``eval_kw``, ``adaptive``: keyword arguments of ``backbone_train``,
    ``keypoint_eval`` and ``adaptive_step``; ``graphs``, ``train_graphs``
    as ``backbones_phase``'s. Returns (the launches by kernel, the worst
    kernel/plain errors)."""
    if cfgs is None:
        cfgs = {"keypoint": keypoint_cfg(), "adaptive": adaptive_cfg(),
                "dcn": dcn_cfg()}
    dev = torch.device(dev)
    launches = {"nms": 0, "roi_align": 0, "roi_align_backward": 0}
    errs = {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def drop():
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()

    model = build_model(cfgs["keypoint"], dev)
    add(graph_requests(dev, "keypoint V-39", model, canvases,
                       windows[0] if timing else 0.0, graphs=graphs,
                       errs=errs))
    add(keypoint_eval(dev, model, graphs=graphs, **(eval_kw or {})))
    del model
    drop()
    counts, train_errs = backbone_train(
        dev, cfgs["keypoint"], "keypoint V-39", graphs=train_graphs,
        timing=timing, frozen_prefixes=(), keypoints=True, **(train or {}))
    add(counts)
    for k in errs:
        errs[k] = max(errs[k], train_errs[k])
    drop()

    model = build_model(cfgs["adaptive"], dev)
    add(graph_requests(dev, "adaptive V-39", model, canvases[:1],
                       windows[1] if timing else 0.0, graphs=graphs,
                       errs=errs, roi_per_request=3))
    if timing:
        img = make_image(*canvases[0], dev)
        seen = record_launches(lambda: model.inference(img))
        s4 = next(a for a in seen["roi_align"] if a[6] == 4)
        roi_row(*s4, "adaptive request, s=4")
        del seen, s4
    del model
    drop()
    add(adaptive_step(dev, cfgs["adaptive"], errs=errs, timing=timing,
                      **(adaptive or {})))
    drop()

    model = build_model(cfgs["dcn"], dev)
    add(graph_requests(dev, "DCN V-39", model, canvases[:1],
                       windows[1] if timing else 0.0, graphs=graphs,
                       errs=errs))
    del model
    drop()
    return launches, errs


# -------------------------------------------------------------- parallel
PARALLEL_TIMED = 6  # timed steps of each data-parallel variant
DP_IMAGES = ((400, 800, 1088), (401, 800, 1088), (402, 800, 1088),
             (403, 800, 1088))  # the data-parallel serving batch
RANK_TIMEOUT_S = 600
RANKS = 2  # the gloo ranks on the one card


def free_cuda() -> None:
    """Collect the dropped objects (a captured step in a reference cycle
    keeps its graph's pool) and give the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rows_of(out, i: int):
    """Slot ``i`` of a batched ``InferenceOutputs``, as a B = 1 output."""
    return type(out)(*(None if v is None else v[i:i + 1] for v in out))


def compare_batches(got, want, K: int, what: str) -> bool:
    """Two batched outputs slot by slot (``compare_outputs`` for each
    image); returns whether every output is bit-equal."""
    for i in range(want.valid.shape[0]):
        compare_outputs(rows_of(got, i), rows_of(want, i), K,
                        f"{what}, image {i}")
    return all(torch.equal(a, b) for a, b in zip(got, want)
               if a is not None)


def distributed_ground_truth_ap(ann: str) -> dict:
    """``check_ground_truth_ap`` through the cross-rank merge: each rank
    feeds back the ground truth of its strided share of the images,
    every rank's records are gathered (``all_gather_objects``) and rank 0
    scores them, AP 100.0 expected; other ranks return {}."""
    from centermask2_tpu_torch.evaluation import COCOEvaluator, COCOGt, rle
    from centermask2_tpu_torch.parallel import (all_gather_objects,
                                                is_main_process,
                                                process_subset)

    with open(ann) as f:
        gt = COCOGt(json.load(f))
    cls = {c: i for i, c in enumerate(sorted(gt.cats))}
    ev = COCOEvaluator(gt, category_id_map={i: c for c, i in cls.items()})
    for img_id in process_subset(sorted(gt.imgs)):
        a = [x for x in gt.img_to_anns[img_id] if not x["iscrowd"]]
        xywh = np.array([x["bbox"] for x in a], np.float64)
        ones = np.ones(len(a))
        ev.process(img_id, {
            "pred_boxes": np.concatenate([xywh[:, :2],
                                          xywh[:, :2] + xywh[:, 2:]], 1),
            "scores": ones, "mask_scores": ones,
            "pred_classes": np.array([cls[x["category_id"]] for x in a]),
            "pred_masks": np.stack([rle.decode(gt.ann_rle(x)) for x in a])})
    ev.predictions = [p for ps in all_gather_objects(ev.predictions)
                      for p in ps]
    if not is_main_process():
        return {}
    res = ev.evaluate()
    ap = {t: res[t]["AP"] for t in ("bbox", "segm")}
    if any(abs(v - 100.0) > 1e-9 for v in ap.values()):
        raise AssertionError(f"ground truth fed back over the ranks scores "
                             f"{ap}")
    return ap


def state_hashes(model) -> dict:
    """sha256 of every parameter and buffer's bytes (bit-equality of two
    ranks' models without moving them)."""
    import hashlib

    return {k: hashlib.sha256(v.detach().cpu().contiguous().view(-1)
                              .view(torch.uint8).numpy()).hexdigest()
            for k, v in model.state_dict().items()}


def check_ranks_equal(model, what: str) -> int:
    """Every rank's parameters and buffers bit-equal to rank 0's."""
    from centermask2_tpu_torch.parallel import all_gather_objects

    hashes = all_gather_objects(state_hashes(model))
    bad = sorted(k for h in hashes[1:] for k in h if h[k] != hashes[0][k])
    if bad:
        raise AssertionError(f"{what}: the ranks differ in {len(bad)} "
                             f"tensors, e.g. {bad[:3]}")
    return len(hashes[0])


def roi_align_feature_grad_f64(grad, boxes, batch_indices, levels, shapes,
                               dtype, scales, output_size,
                               sampling_ratio=2, aligned=True):
    """Kernel 2b's plain version (``ops/roi_align.py::
    roi_align_feature_grad_plain``) with its sums in float64, cast once:
    the same function rounded another way."""
    from centermask2_tpu_torch.ops import roi_align as R

    lv = torch.clamp(levels.long(), 0, len(shapes) - 1)
    scale_r = torch.full(lv.shape, float(scales[0]), device=boxes.device)
    for i in range(1, len(shapes)):
        scale_r = scale_r.masked_fill(lv == i, float(scales[i]))
    ys, xs = R._axis_coords(boxes.float(), scale_r, output_size,
                            sampling_ratio, aligned)
    bidx = batch_indices.long()
    out = []
    for lvl, (N, C, H, W) in enumerate(shapes):
        on_l = lv == lvl
        ay = R._axis_pool_matrix(ys, H, output_size, sampling_ratio, on_l,
                                 bidx * H, N * H).double()
        ax = R._axis_pool_matrix(xs, W, output_size, sampling_ratio, on_l,
                                 None, W).double()
        tmp = torch.einsum("rjx,rcij->rcix", ax, grad.double())
        d = torch.einsum("riy,rcix->cyx", ay, tmp)
        out.append(d.reshape(C, N, H, W).transpose(0, 1).to(dtype)
                   .contiguous())
    return out


def dp_f32_runs(cfg, dev, group, images, gt, draws) -> dict:
    """One eager f32 data-parallel step (TF32 off, deterministic cuDNN)
    through the kernels twice and the plain versions twice, each from the
    same initial state: {"k1", "k2", "p1", "p2"} -> (losses, the averaged
    gradients the update used), for ``check_grad_runs``, after one
    discarded step (the process's first f32 step at this size picks some
    cuDNN algorithms of its own: on the H100 its losses differed from
    the later steps', which repeated bit for bit). "p2" sums kernel 2b's
    plain version in float64 (``roi_align_feature_grad_f64``), so the
    floor's plain term is what a rounding change of the ROIAlign
    gradient alone moves each gradient by: train-mode SyncBN carries it
    back through the backbone amplified (on the H100 kernel 2b against
    its plain version moved one weight's gradient by 29x 1e-6 of its
    largest, with two plain runs bit-equal). After "k1" every rank's model is held bit-equal to rank
    0's; the kernels' launches of that step are returned under
    "launches"."""
    from centermask2_tpu_torch.ops.nms import greedy_keep_sorted_plain
    from centermask2_tpu_torch.ops.roi_align import \
        multilevel_roi_align_plain

    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.train import (make_optimizer_from_cfg,
                                             make_train_step)

    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    runs = {}
    with exact_f32(deterministic=True):
        model = build_trainer(cfg32, dev, capture=False, group=group)[0]
        init = {k: v.clone() for k, v in model.state_dict().items()}
        for name in ("warm-up", "k1", "k2", "p1", "p2"):
            model.load_state_dict(init)
            opt, sched = make_optimizer_from_cfg(model, cfg32)
            step = make_train_step(model, opt, sched, capture=False,
                                   group=group)
            ctx = plain_kernels() if name == "p1" else kernels_swapped(
                greedy_keep_sorted_plain, multilevel_roi_align_plain,
                roi_align_feature_grad_f64) if name == "p2" else \
                contextlib.nullcontext()
            _kernels.reset_launch_counts()
            with ctx:
                m = check_losses(step(images, gt, draws),
                                 f"data-parallel f32 step {name}")
            torch.cuda.synchronize()
            if name == "warm-up":
                continue
            if name == "k1":
                runs["launches"] = _kernels.launch_counts()
                runs["tensors"] = check_ranks_equal(
                    model, "data-parallel f32 step")
            runs[name] = ({k: v for k, v in m.items() if k != "total_loss"},
                          {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()
                           if p.grad is not None})
            del opt, sched, step
    del model, init
    free_cuda()
    return runs


def rank_main(rank: int, port: int, out_dir: str) -> int:
    """One of ``RANKS`` gloo ranks on the one card (``[parallel]``,
    part 2): the eager f32 data-parallel step of the flagship and of its
    SyncBN variant, kernels against plain versions and the ranks
    bit-equal after it; ``make_dp_inference`` against the one-process
    result the parent saved; ``evaluate_dataset(distributed=True)``
    against the parent's one-process run, and the ground truth fed back
    through the merge."""
    sys.path.insert(0, REPO)
    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.parallel import (init_distributed,
                                                local_rows, make_dp_inference,
                                                shutdown)
    from centermask2_tpu_torch.train import batch_to_device
    from centermask2_tpu_torch.utils.comm import world_group

    t0 = time.perf_counter()
    _kernels.build()  # loads the parent's libraries
    dev = torch.device("cuda:0")
    init_distributed(f"127.0.0.1:{port}", RANKS, rank, device=dev,
                     backend="gloo")
    group = world_group()
    main_rank = rank == 0
    if not main_rank:  # rank 0 speaks for both; a failure still prints
        sys.stdout = open(os.devnull, "w")
    ref = torch.load(os.path.join(out_dir, "single.pt"), weights_only=False)
    rows = local_rows(RANKS)

    for norm in ("FrozenBN", "SyncBN"):
        cfg = flagship_cfg()
        cfg.MODEL.VOVNET.NORM = norm
        batch = make_train_batch(500, RANKS, FIXED, TRAIN_GT,
                                 cfg.TPU.MAX_GT_INSTANCES)
        images, gt = batch_to_device(
            {k: v[rows] for k, v in batch.items()}, dev)
        draws = torch.rand((1, cfg.MODEL.FCOS.POST_NMS_TOPK_TRAIN
                            + cfg.TPU.MAX_GT_INSTANCES),
                           generator=torch.Generator().manual_seed(9)).to(dev)
        t1 = time.perf_counter()
        runs = dp_f32_runs(cfg, dev, group, images, gt, draws)
        if set(runs.pop("launches").values()) != {1}:
            raise AssertionError(f"{norm} data-parallel step: launches")
        n = runs.pop("tensors")
        if main_rank:
            check_grad_runs(runs, f"{RANKS}-rank gloo f32 {norm} step (the "
                            f"second plain run with kernel 2b's plain "
                            f"version summed in float64)")
        log(f"  {RANKS} gloo ranks, flagship {norm} f32 step at {FIXED}x"
            f"{FIXED}, B = 1 a rank: one launch of nms, roi_align and "
            f"roi_align_backward a step; after it the ranks' {n} "
            f"parameters and buffers bit-equal"
            + (" (running statistics included)" if norm != "FrozenBN"
               else "") + f"; five steps (one discarded) in "
            f"{time.perf_counter() - t1:.1f} s (a correctness run: gloo "
            f"stages each all-reduce through the host)")
        del runs
        free_cuda()

    cfg = flagship_cfg()
    model = build_model(cfg, dev)
    K = cfg.MODEL.FCOS.POST_NMS_TOPK_TEST
    imgs = torch.cat([make_image(s, H, W, dev) for s, H, W in DP_IMAGES])
    got = make_dp_inference(model, group)(imgs)
    same = compare_batches(got, ref["serve"], K,
                           f"{RANKS}-rank make_dp_inference vs one process")
    log(f"  {RANKS} gloo ranks, make_dp_inference of {len(DP_IMAGES)} bf16 "
        f"{DP_IMAGES[0][1]}x{DP_IMAGES[0][2]} images ({len(DP_IMAGES) // RANKS}"
        f" a rank, captured programs): every rank's gathered batch equals "
        f"the one-process batch slot by slot, bit-equal {same}")

    ann = ref["ann"]
    res, _, ev = evaluate_dataset(
        model, ann=ann, image_root=os.path.dirname(ann), fixed_size=FIXED,
        min_size=SHORT, max_size=1333, progress_every=0, read_image=np.load,
        distributed=True)
    if main_rank:
        preds = sorted(ev.predictions, key=lambda p: (p["image_id"],
                                                      -p["score"]))
        want = sorted(ref["eval_predictions"],
                      key=lambda p: (p["image_id"], -p["score"]))
        exact = preds == want
        if not exact:
            a = [(p["image_id"], p["category_id"]) for p in preds]
            b = [(p["image_id"], p["category_id"]) for p in want]
            if a != b or not np.allclose([p["score"] for p in preds],
                                         [p["score"] for p in want],
                                         rtol=1e-5, atol=1e-6):
                raise AssertionError("distributed evaluation: rank 0's "
                                     "predictions differ from one process")
        if sorted(ev.proposals) != sorted(ref["eval_proposals"]):
            raise AssertionError("distributed evaluation: proposals differ")
        log(f"  {RANKS} gloo ranks, evaluate_dataset(distributed=True) over "
            f"the {len(ev.proposals)}-image synthetic set: rank 0 holds the "
            f"one-process run's {len(preds)} predictions (bit-equal {exact})"
            f" and proposals of every image, bbox AP {res['bbox']['AP']:.4f}"
            f" (one process {ref['eval_ap']:.4f})")
    elif res != {}:
        raise AssertionError("distributed evaluation: rank 1 scored")
    ap = distributed_ground_truth_ap(ann)
    log(f"  {RANKS} gloo ranks, the ground truth fed back through the "
        f"cross-rank merge: AP bbox {ap.get('bbox', 0):.4f}, segm "
        f"{ap.get('segm', 0):.4f}; rank {rank} done in "
        f"{time.perf_counter() - t0:.1f} s")
    shutdown()
    return 0


def spawn_ranks(out_dir: str) -> float:
    """``RANKS`` processes of this script, each a gloo rank on the card
    (``rank_main``); their output is logged. Every process is stopped
    whatever happens. Returns the seconds they took."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--port", str(port), "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        for line in out.splitlines():
            if line.strip():
                log(f"  [rank {r}] {line.strip()}")
        if p.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}")
    return time.perf_counter() - t0


def dp_train_variant(dev, cfg, group, runs, what: str, batch: int,
                     card: str, timed: int = PARALLEL_TIMED, graphs=None):
    """``runs`` (a ``TrainLoops``) through the data-parallel captured step
    of ``cfg`` (or the one-process step with ``group`` None): finite
    losses, the launch gate of ``[train]``, ms a step; returns (the step
    and its objects, the median ms, the peak bytes). ``graphs``: as
    ``build_trainer``'s."""
    from centermask2_tpu_torch.train.trainer import WARMUP_STEPS

    model, opt, sched, step = build_trainer(cfg, dev, capture=True,
                                            graphs=graphs, group=group)
    n_eager = WARMUP_STEPS + 1
    ms, wall, peak = runs.run(step, n_eager + timed, n_eager, what, n_eager)
    last = check_losses(runs.metrics[-1], f"{what} step {n_eager + timed}")
    log_train_times(ms, wall, peak, n_eager + timed, n_eager, what, batch,
                    card)
    log(f"  {what}: losses finite, last total {last['total_loss']:.4f}; "
        f"capture {step.capture_s:.3f} s after {WARMUP_STEPS} eager warm-up "
        f"steps")
    return (model, opt, sched, step), float(np.median(ms)), peak


def dp_f32_equal(cfg, dev, group, steps_in, graphs=None) -> None:
    """The f32 step (TF32 off, deterministic cuDNN) captured with the
    process group of one against the one-process captured step over the
    same inputs (``WARMUP_STEPS`` warm-ups on a side stream, the capture,
    replays), each step from the one-process run's state before it
    (written into the step's own tensors, as ``check_f32_captured_step``
    does): losses and every parameter bit-equal after each step from the
    capture on (the all-reduce of one rank and the division by 1 are
    exact; the side-stream warm-ups are compared too, and their equality
    printed). The one-process run is made twice; where its captured steps
    do not repeat themselves bit for bit (the CPU rehearsal's fake
    graphs), each difference is held within GRAD_NOISE_FACTOR x the two
    one-process runs' own. On the card the three runs capture into one
    memory pool (an f32 graph with TF32 off holds ~22 GiB of cuDNN
    workspaces)."""
    import torch.utils._pytree as pytree

    from centermask2_tpu_torch.checkpoint.torch_io import (
        restore_train_state, train_state)
    from centermask2_tpu_torch.export.captured import (CudaGraphs,
                                                       supports_graphs)
    from centermask2_tpu_torch.train.trainer import WARMUP_STEPS

    if graphs is None and supports_graphs(dev):
        shared = CudaGraphs(dev)
        graphs = lambda m, o, s: shared  # noqa: E731

    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    res, before = {}, []
    with exact_f32(deterministic=True):
        for name, grp in (("one process", None), ("data-parallel", group),
                          ("one process again", None)):
            model, opt, sched, step = build_trainer(
                cfg32, dev, capture=True, graphs=graphs, group=grp)
            out = []
            for i, (x, g, d) in enumerate(steps_in):
                # a captured step adopts the tensors of its capturing
                # call as its inputs, and a replay writes into them
                args = (x.clone(), type(g)(*(None if t is None else t.clone()
                                             for t in g)), d.clone())
                if name == "one process":
                    before.append(pytree.tree_map(
                        lambda t: t.detach().clone() if torch.is_tensor(t)
                        else t, train_state(model, opt, sched, i)))
                else:
                    restore_train_state(before[i], model, opt, sched)
                m = check_losses(step(*args), f"f32 {name} step {i + 1}")
                out.append((m, [p.detach().clone()
                                for p in model.parameters()]))
            res[name] = out
            del model, opt, sched, step, out
            free_cuda()
            log(f"  f32 {name} run: {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
                f" GiB reserved after it")
    del before
    bit = repeat = warm = True
    for i, ((l1, p1), (l2, p2), (l3, p3)) in enumerate(zip(
            res["one process"], res["data-parallel"],
            res["one process again"])):
        same = l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
        if i < WARMUP_STEPS:
            warm = warm and same
            continue
        repeat = repeat and l1 == l3 and all(
            torch.equal(a, c) for a, c in zip(p1, p3))
        bit = bit and same
        for a, b, c in zip(p1, p2, p3):
            floor = GRAD_NOISE_FACTOR * float((a - c).abs().max())
            if float((a - b).abs().max()) > floor:
                raise AssertionError(
                    f"f32 data-parallel step {i + 1} differs from the "
                    f"one-process step beyond the one-process runs' own "
                    f"difference: {l2} vs {l1}")
    if repeat and not bit:
        raise AssertionError("f32 data-parallel steps not bit-equal to the "
                             "one-process steps, which repeat bit for bit")
    log(f"  f32 steps (TF32 off, deterministic cuDNN), captured with the "
        f"process group of one against the one-process captured step, each "
        f"from the one-process run's state before it: the capture and "
        f"{len(steps_in) - WARMUP_STEPS - 1} replays, losses and all "
        f"{len(res['one process'][0][1])} parameters after each bit-equal "
        f"{bit} (the one-process captured steps repeat themselves bit for "
        f"bit: {repeat}); the {WARMUP_STEPS} side-stream warm-up steps "
        f"bit-equal {warm}; total {res['one process'][-1][0]['total_loss']:.6f}")


def parallel_phase(dev, cfg=None, batch: int = TRAIN_BATCH,
                   fixed: int = FIXED, n_gt: int = TRAIN_GT,
                   timed: int = PARALLEL_TIMED, sides=(16, 600),
                   dp_images=DP_IMAGES, ranks: bool = True,
                   timing: bool = True, graphs=None):
    """The ``[parallel]`` phase. Part 1, a process group of one over NCCL
    in this process: the flagship bf16 train step through the
    data-parallel captured step (the all-reduce in the graph) beside the
    one-process captured step, the profiler's launches of a replay and
    its device time; the f32 steps bit-equal to the one-process ones; the
    kernels against their plain versions on an eager data-parallel f32
    step's inputs; the SyncBN, BN and ``TPU.REMAT_BACKBONE`` variants;
    ``make_dp_inference`` of a bf16 batch against ``inference_batched``.
    Part 2 (``ranks``): ``RANKS`` gloo ranks on the card
    (``rank_main``). ``timing`` off leaves out the profiler's reads;
    ``graphs``: the capturing object's maker, as ``build_trainer``'s (a
    CPU rehearsal passes fakes). Returns (launches by kernel over part
    1's main-path runs, the worst kernel/plain errors)."""
    import tempfile

    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.export.captured import (WARMUP_CALLS,
                                                       supports_graphs)
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.parallel import (init_distributed,
                                                make_dp_inference, shutdown)
    from centermask2_tpu_torch.train import batch_to_device
    from centermask2_tpu_torch.train.trainer import WARMUP_STEPS
    from centermask2_tpu_torch.utils.comm import world_group

    dev = torch.device(dev)
    cfg = flagship_cfg() if cfg is None else cfg
    card = card_line()
    t0 = time.perf_counter()
    init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    group = world_group()
    errs = {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    max_gt = cfg.TPU.MAX_GT_INSTANCES
    batches = [make_train_batch(600 + i, batch, fixed, n_gt, max_gt,
                                sides=sides) for i in range(2)]
    gen = torch.Generator(device=dev).manual_seed(0)
    runs = TrainLoops(batches, dev, gen)
    images, gt = batch_to_device(batches[0], dev)
    draws = torch.rand((batch, cfg.MODEL.FCOS.POST_NMS_TOPK_TRAIN + max_gt),
                       generator=gen, device=dev)

    objs, dp_ms, dp_peak = dp_train_variant(
        dev, cfg, group, runs, "data-parallel captured (world 1)",
        batch, card, timed, graphs)
    step = objs[3]
    if timing:
        replay_launches(lambda: step(images, gt, draws), 3,
                        ("nms", "roi_align", "roi_align_backward"),
                        "data-parallel train step replays")
        profile_train_step(lambda: step(images, gt, draws),
                           "data-parallel bf16 train step, a replay")
    del objs, step
    free_cuda()
    objs, one_ms, one_peak = dp_train_variant(
        dev, cfg, None, runs, "one-process captured, beside it", batch,
        card, timed, graphs)
    del objs
    free_cuda()
    log(f"  data-parallel step (world 1) against the one-process step: "
        f"{dp_ms:.3f} vs {one_ms:.3f} ms median ({dp_ms - one_ms:+.3f} ms: "
        f"the flat gradient buffer's copies and the all-reduce), peak "
        f"{dp_peak / 2 ** 30:.3f} vs {one_peak / 2 ** 30:.3f} GiB ({card})")

    steps_in = []  # the warm-ups, the capture and two replays
    for i in range(WARMUP_STEPS + 3):
        x, g = batch_to_device(batches[i % 2], dev)
        steps_in.append((x, g, torch.rand(draws.shape, generator=gen,
                                          device=dev)))
    dp_f32_equal(cfg, dev, group, steps_in, graphs)
    del steps_in
    cfg32 = cfg.clone()
    cfg32.TPU.COMPUTE_DTYPE = "float32"
    with exact_f32(deterministic=True):
        model, _, _, estep = build_trainer(cfg32, dev, capture=False,
                                           group=group)
        seen = capture_step_inputs(lambda: estep(images, gt, draws))
        check_step_kernels(seen, "data-parallel f32 step", errs)
    del seen, model, estep
    free_cuda()
    log(f"  after the f32 checks: {torch.cuda.memory_reserved() / 2 ** 30:.2f}"
        f" GiB reserved")

    for what, change in (("SyncBN", ("MODEL.VOVNET.NORM", "SyncBN")),
                         ("BN", ("MODEL.VOVNET.NORM", "BN")),
                         ("TPU.REMAT_BACKBONE", ("TPU.REMAT_BACKBONE",
                                                 True))):
        c = cfg.clone()
        c.merge_from_list(list(change))
        objs, ms, peak = dp_train_variant(
            dev, c, group, runs, f"data-parallel captured, {what}", batch,
            card, timed, graphs)
        del objs
        free_cuda()
        log(f"  {what} against the FrozenBN flagship, both data-parallel: "
            f"{ms:.3f} vs {dp_ms:.3f} ms median, peak {peak / 2 ** 30:.3f} "
            f"vs {dp_peak / 2 ** 30:.3f} GiB ({card})")
    totals = dict(runs.totals)

    serve_cfg = cfg.clone()
    serve_cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(serve_cfg, dev)
    K = cfg.MODEL.FCOS.POST_NMS_TOPK_TEST
    imgs = torch.cat([make_image(s, H, W, dev) for s, H, W in dp_images])
    want = model.inference_batched(imgs)
    _kernels.reset_launch_counts()
    captured = supports_graphs(dev)
    got = make_dp_inference(model, group)(imgs)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    n_want = WARMUP_CALLS + 1 if captured else len(dp_images)
    if (counts["nms"], counts["roi_align"]) != (n_want, n_want):
        raise AssertionError(f"make_dp_inference launches {counts}")
    for k in ("nms", "roi_align"):
        totals[k] += counts[k]
    same = compare_batches(got, want, K, "make_dp_inference vs "
                           "inference_batched")
    log(f"  make_dp_inference (world 1) of {len(dp_images)} bf16 "
        f"{dp_images[0][1]}x{dp_images[0][2]} images "
        + (f"through one captured program ({n_want} launches of kernels 1 "
           f"and 2 at its warm-up and capture, none at the replays)"
           if captured else "eagerly") + f" against inference_batched: "
        f"equal slot by slot, bit-equal {same}")
    shutdown()
    log(f"  part 1 (a process group of one) took "
        f"{time.perf_counter() - t0:.1f} s")
    if not ranks:
        return totals, errs

    with tempfile.TemporaryDirectory() as root:
        ann = make_coco_dataset(root)
        res, _, ev = evaluate_dataset(
            model, ann=ann, image_root=root, fixed_size=FIXED,
            min_size=SHORT, max_size=1333, progress_every=0,
            read_image=np.load)
        torch.save({"serve": want, "ann": ann,
                    "eval_predictions": ev.predictions,
                    "eval_proposals": list(ev.proposals),
                    "eval_ap": res["bbox"]["AP"]},
                   os.path.join(root, "single.pt"))
        del model, want, got, ev
        gc.collect()
        free_cuda()
        secs = spawn_ranks(root)
    log(f"  part 2 ({RANKS} gloo ranks on the card) took {secs:.1f} s, "
        f"spawn to exit")
    return totals, errs


# ---------------------------------------------------------------- deploy
# layers gated by [deploy] whatever the decode selected: everything up to
# and including the FCOS head's outputs
DEPLOY_GATED_STAGES = ("backbone/", "fpn/", "fcos_head/")
# the root outputs that say what the decode selected: locations, classes,
# valid (the ROI stage is gated where both runs selected alike)
DEPLOY_SELECTION_KEYS = ("__call__[0][0]", "__call__[0][3]",
                         "__call__[0][6]")
LAYER_COS = 1 - 1e-5  # the layer and parity criterion (run_shell.py:22)


def cfg_opts(cfg) -> list:
    """``cfg`` as the KEY VALUE overrides of the defaults that rebuild it
    in a CLI, each value a Python literal (read without yaml)."""
    from centermask2_tpu_torch.config import get_cfg

    def leaves(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    base = dict(leaves(get_cfg()))
    return [s for k, v in leaves(cfg) if base[k] != v for s in (k, repr(v))]


def same_metrics(a: dict, b: dict) -> bool:
    """Two (nested) metric dicts equal, NaN where both are NaN."""
    if set(a) != set(b):
        return False
    for k, x in a.items():
        y = b[k]
        if isinstance(x, dict):
            if not (isinstance(y, dict) and same_metrics(x, y)):
                return False
        elif not (x == y or (x != x and y != y)):
            return False
    return True


@contextlib.contextmanager
def launches_into(counts: dict):
    """Adds the launches of kernels 1 and 2 inside the block to
    ``counts``."""
    from centermask2_tpu_torch.ops import _kernels

    before = _kernels.launch_counts()
    try:
        yield
    finally:
        now = _kernels.launch_counts()
        for k in ("nms", "roi_align"):
            counts[k] = counts.get(k, 0) + now[k] - before[k]


def run_cli(main, argv) -> tuple:
    """(``main(argv)``'s return value, its standard output), the output
    also logged line by line."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"    | {line}")
    return rc, text


@contextlib.contextmanager
def no_pil():
    """PIL cannot be imported inside the block."""
    import importlib.abc

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == "PIL":
                raise ImportError(f"blocked: {name}")

    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] == "PIL"}
    blocker = Block()
    sys.meta_path.insert(0, blocker)
    try:
        yield
    finally:
        sys.meta_path.remove(blocker)
        sys.modules.update(saved)


def deploy_bins(dev, model, root: str, ann: str, fixed: int, short: int,
                max_size: int, launches: dict) -> dict:
    """Steps 1 and 2 of ``[deploy]``: the bin contract in and out around
    the device. Returns the first image's six output rows and its
    height and width."""
    from centermask2_tpu_torch.data import (bin_io, detector_postprocess,
                                            preprocess_for_model,
                                            single_wrap_outputs)
    from centermask2_tpu_torch.evaluation import COCOEvaluator, COCOGt
    from centermask2_tpu_torch.tools import (postprocess_bins,
                                             preprocess_to_bin)

    with open(ann) as f:
        dataset = json.load(f)
    images = sorted(dataset["images"], key=lambda im: im["id"])
    bins, dumps = os.path.join(root, "bins"), os.path.join(root, "dumps")
    t0 = time.perf_counter()
    paths = preprocess_to_bin.write_input_bins(
        ann, root, bins, read_image=np.load, fixed_size=fixed, short=short,
        max_size=max_size)
    write_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    for im, path in zip(images, paths):
        size = os.path.getsize(path)
        want = preprocess_for_model(os.path.join(root, im["file_name"]),
                                    fixed, short, max_size,
                                    read_image=np.load)["input"][0]
        got = bin_io.read_input_bin(path, fixed)
        if size != 4 * 3 * fixed * fixed or got.tobytes() != want.tobytes():
            raise AssertionError(f"bins in {path}: {size} bytes, equal to "
                                 f"preprocess_for_model's input "
                                 f"{got.tobytes() == want.tobytes()}")
    log(f"  bins in: preprocess_to_bin wrote {len(paths)} files of "
        f"{4 * 3 * fixed * fixed} bytes (f32 1x3x{fixed}x{fixed}), "
        f"{write_ms:.1f} ms/img; each read back equals preprocess_for_model's "
        f"input bit for bit")

    gt = COCOGt(dataset)
    ev = COCOEvaluator(gt, category_id_map=dict(enumerate(sorted(gt.cats))))
    served, n_valid, per_image = {}, 0, []
    os.makedirs(dumps)
    with launches_into(launches):
        for im, path in zip(images, paths):
            t0 = time.perf_counter()
            x = torch.from_numpy(bin_io.read_input_bin(path, fixed)[None]
                                 .copy()).to(dev)
            out = model.inference(x)
            v = out.valid[0]
            six = [getattr(out, n)[0][v].cpu().numpy()
                   for n in bin_io.OUTPUT_NAMES]
            stem = os.path.splitext(im["file_name"])[0]
            bin_io.write_output_bins(six, os.path.join(dumps, stem))
            per_image.append((time.perf_counter() - t0) * 1e3)
            served.setdefault("six", six)
            ev.process(im["id"], detector_postprocess(
                single_wrap_outputs(six), im["height"], im["width"],
                short=short, max_size=max_size))
            n_valid += len(six[0])
    want = ev.evaluate()
    t0 = time.perf_counter()
    got, missing = postprocess_bins.evaluate_bins(ann, dumps, short=short,
                                                  max_size=max_size)
    post_ms = (time.perf_counter() - t0) * 1e3 / len(images)
    if missing or not same_metrics(got, want):
        raise AssertionError(f"postprocess_bins: missing {missing}, metrics "
                             f"{got} against the evaluator's {want}")
    log(f"  device pipeline: read_input_bin, inference, write_output_bins: "
        f"the first image {per_image[0]:.1f} ms, the others' median "
        f"{np.median(per_image[1:]):.1f} ms ({n_valid} valid detections "
        f"over {len(images)} images); postprocess_bins {post_ms:.1f} "
        f"ms/img: bbox "
        f"AP {got['bbox']['AP']:.4f}, segm AP {got['segm']['AP']:.4f}, every "
        f"number equal to a COCOEvaluator fed the outputs in memory")
    stem = os.path.splitext(images[0]["file_name"])[0]
    for i in range(1, 7):
        os.unlink(os.path.join(dumps, f"{stem}_{i}.bin"))
    _, text = run_cli(postprocess_bins.main, ["--ann", ann, "--bin-dir",
                                              dumps])
    if "1 images missing bins (skipped)" not in text:
        raise AssertionError("postprocess_bins did not report the image "
                             "whose bins were deleted")
    log("  postprocess_bins with one image's bins deleted: reports 1 "
        "missing, returns normally")
    return served["six"], images[0]["height"], images[0]["width"]


def deploy_layers(dev, model, cfg, x, root: str, cli: list,
                  launches: dict) -> None:
    """Step 4 of ``[deploy]``: ``check_layers``' dump of the model on the
    card against the same model on the CPU, by name; then the CLI's dump
    of the FCOS logits on the card against the CPU's, by the CLI."""
    from centermask2_tpu_torch import build_centermask
    from centermask2_tpu_torch.tools import check_layers

    t0 = time.perf_counter()
    with launches_into(launches):
        card = check_layers.capture_layers(model, x)
    card_s = time.perf_counter() - t0
    host_model = build_centermask(cfg, device="cpu")
    host_model.load_state_dict({k: v.cpu()
                                for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    host = check_layers.capture_layers(host_model, x.cpu())
    cpu_s = time.perf_counter() - t0
    del host_model
    rows, only_card, only_cpu = check_layers.compare_layers(card, host)
    if only_card or only_cpu:
        raise AssertionError(f"layer keys of one dump only: {only_card[:5]} "
                             f"{only_cpu[:5]}")
    same_pick = all(np.array_equal(card[k], host[k])
                    for k in DEPLOY_SELECTION_KEYS)
    gated = [r for r in rows
             if r[2].startswith(DEPLOY_GATED_STAGES) or same_pick]
    roi = [r for r in rows if not r[2].startswith(DEPLOY_GATED_STAGES)]
    mb = sum(a.nbytes for a in card.values()) / 1e6
    log(f"  layers, card against CPU: {len(rows)} layers compared "
        f"({mb:.0f} MB a dump), dumped in {card_s:.1f} s on the card and "
        f"{cpu_s:.1f} s on the CPU; worst cosine up to the FCOS head "
        f"{min(r[0] for r in rows if r not in roi):.12f}; the decode's "
        f"selections equal {same_pick}, so the {len(roi)} ROI-stage and "
        f"output layers are {'gated' if same_pick else 'printed only'}")
    for c, m, k in roi[:8]:
        log(f"    {c:.12f} {m:.3e}  {k}")
    bad = [r for r in gated if not r[0] > LAYER_COS]
    if bad:
        raise AssertionError(f"layers below cosine {LAYER_COS}: {bad[:5]}")
    logits = {k: v for k, v in host.items() if "/cls_logits/" in k}
    del card, host

    dumps = [os.path.join(root, f"{w}.npz") for w in ("card", "cpu")]
    np.savez(dumps[1], **logits)
    with launches_into(launches):
        run_cli(check_layers.main, ["dump", "--out", dumps[0], "--filter",
                                    "cls_logits", "--list", "1"] + cli)
    rc, _ = run_cli(check_layers.main, ["compare", *dumps, "--show", "3"])
    if rc:
        raise AssertionError("check_layers compare of the card's CLI dump "
                             "(the FCOS logits) against the CPU's exited 1")


def deploy_cityscapes(six, h: int, w: int) -> None:
    """Step 6 of ``[deploy]``: the Cityscapes scorers on arrays, with no
    PIL. The ground truth is a served image's own masks (``six``, the
    output contract's rows), pasted by ``paste_masks_np`` into the cells
    of a grid over its ``h`` x ``w`` (the random weights' boxes span a few
    pixels, below the scorer's 100-pixel minimum); the predictions are
    the same masks with their mask scores."""
    from centermask2_tpu_torch.data import paste_masks_np
    from centermask2_tpu_torch.evaluation.cityscapes_scoring import (
        INSTANCE_LABELS, MIN_REGION_SIZE, score_instances)
    from centermask2_tpu_torch.evaluation.cityscapes_semseg import \
        score_semseg

    masks, classes, mask_scores = six[4][:, 0], six[3], six[1]
    n = len(masks)
    cols = int(np.ceil(np.sqrt(n)))
    cell = min(h // -(-n // cols), w // cols)
    boxes = np.array([[(i % cols) * cell, (i // cols) * cell,
                       (i % cols + 1) * cell - 1, (i // cols + 1) * cell - 1]
                      for i in range(n)], np.float32)
    pasted = paste_masks_np(masks, boxes, (h, w), 0.5)
    labels = sorted(INSTANCE_LABELS)
    inst = np.full((h, w), 7, np.int64)  # road
    for i in range(n):
        inst[pasted[i]] = labels[int(classes[i]) % len(labels)] * 1000 + i
    ids, area = np.unique(inst[inst >= 1000], return_counts=True)
    preds = [(inst == i, int(i) // 1000, float(mask_scores[int(i) % 1000]))
             for i in ids]
    sem = np.where(inst >= 1000, inst // 1000, inst).astype(np.uint8)
    with no_pil():
        ins = score_instances([inst], [preds])
        seg = score_semseg([(sem, sem)], [(sem, inst)])
    scored = int((area >= MIN_REGION_SIZE).sum())
    if not scored or abs(ins["AP"] - 100.0) > 1e-9 or \
            abs(seg["IoU"] - 100.0) > 1e-9:
        raise AssertionError(f"cityscapes on arrays: {scored} of {len(ids)} "
                             f"instances scored, AP {ins['AP']}, IoU "
                             f"{seg['IoU']}")
    log(f"  cityscapes on arrays, PIL blocked: a served {h}x{w} image's {n} "
        f"masks pasted into {cell} px cells, {len(ids)} non-empty, {scored} "
        f"of {MIN_REGION_SIZE} px or more: AP {ins['AP']:.4f}, AP50 "
        f"{ins['AP50']:.4f}; the labeling against itself: IoU "
        f"{seg['IoU']:.4f}, IoU_sup {seg['IoU_sup']:.4f}")


def deploy_packer(dev, cfg, root: str, shapes, sides, fixed: int,
                  short: int, max_size: int, n_images: int,
                  launches: dict) -> None:
    """Step 7 of ``[deploy]``: the eval loop's host split over the same
    images with the numpy pack and with the native one; the packs
    bit-equal."""
    from centermask2_tpu_torch.data import preprocess
    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset

    model = build_model(cfg, dev)
    ann = make_coco_dataset(root, shapes, sides=sides, n_images=n_images)
    # the native library is built at its first use: before the clocks
    preprocess.s2d_pack_u8(np.zeros((4, 4, 3), np.uint8), 4)
    common = dict(image_root=root, fixed_size=fixed, min_size=short,
                  max_size=max_size, progress_every=0, read_image=np.load)
    native = preprocess.s2d_pack_u8
    packs, ms = {}, {}
    for name, pack in (("numpy", preprocess.s2d_pack_u8_plain),
                       ("native", native)):
        seen = packs.setdefault(name, [])

        def recorded(*args, _pack=pack, _seen=seen):
            _seen.append(_pack(*args))
            return _seen[-1]

        preprocess.s2d_pack_u8 = recorded
        try:
            with launches_into(launches):
                parts = eval_host_split(lambda timed: evaluate_dataset(
                    model, ann=ann, fn=timed("request", model.inference),
                    **common), n_images)
        finally:
            preprocess.s2d_pack_u8 = native
        ms[name] = parts["preprocess"]
    equal = len(packs["numpy"]) == len(packs["native"]) == n_images and all(
        a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        for a, b in zip(packs["numpy"], packs["native"]))
    if not equal:
        raise AssertionError(f"packs: {len(packs['numpy'])} numpy, "
                             f"{len(packs['native'])} native, not bit-equal")
    log(f"  native packer: read and pack {ms['numpy']:.3f} ms/img with the "
        f"numpy pack, {ms['native']:.3f} with the native one "
        f"({len(os.sched_getaffinity(0))} host CPUs), over {n_images} "
        f"images; the {n_images} packs bit-equal")


def deploy_phase(dev, cfg=None, serving=None, shapes=EVAL_SHAPES,
                 sides=(20, 64, 240),
                 split_images: int = EVAL_SPLIT_IMAGES) -> tuple:
    """The ``[deploy]`` phase: the deployment toolchain on the flagship in
    f32 (``cfg``; the caller sets TF32 off) and the native packer on the
    serving config (``serving``), random weights (seed 0, cls bias 0),
    over synthetic sets of ``shapes`` at their resize (``cfg``'s canvas
    and resize).

    1. bins in: ``preprocess_to_bin`` over the synthetic set; every file
       4*3*fixed^2 bytes, read back bit-equal to ``preprocess_for_model``.
    2. the device pipeline: each bin through ``read_input_bin``,
       ``model.inference`` and ``write_output_bins``; ``postprocess_bins``'
       metrics equal to a ``COCOEvaluator`` fed the outputs in memory;
       one image's bins deleted: reported missing, not fatal.
    3. ``parity_check`` (the CLI, on the model's weights as a converted
       checkpoint): ``PARITY OK``, one launch of kernels 1 and 2 on each
       of the direct and exported rungs; each kernel held against its
       plain version on the ladder's input.
    4. ``check_layers``' dumps on the card and on the CPU, compared: every
       layer up to the FCOS head's outputs above cosine 1 - 1e-5, the ROI
       stage gated where both decodes selected alike; the dump CLI on the
       card (the FCOS logits) compared clean with the CPU's by the
       compare CLI.
    5. ``measure`` (the CLI): parameters, bytes, FLOPs equal to
       ``inference_flops``, peak bytes of one request.
    6. the Cityscapes scorers on arrays with PIL blocked: AP 100 and IoU
       100 on ground truth painted from a served image's masks.
    7. the eval loop's host split over ``split_images`` images with the
       numpy and the native pack: read and pack ms/img, packs bit-equal.

    Returns (the launches of kernels 1 and 2 counted, the kernels' worst
    errors against their plain versions)."""
    import tempfile

    from centermask2_tpu_torch.checkpoint.torch_io import save_checkpoint
    from centermask2_tpu_torch.export import inference_flops
    from centermask2_tpu_torch.tools import measure, parity_check

    if cfg is None:
        cfg = flagship_cfg()
        cfg.TPU.COMPUTE_DTYPE = "float32"
    fixed, short = cfg.TPU.FIXED_EDGE_SIZE, cfg.INPUT.MIN_SIZE_TEST
    max_size = cfg.INPUT.MAX_SIZE_TEST
    card = card_line()
    model = build_model(cfg, dev)
    launches = {"nms": 0, "roi_align": 0}
    steps = {}
    with tempfile.TemporaryDirectory() as root:
        weights = os.path.join(root, "weights")
        save_checkpoint(weights, {"model": model.state_dict(), "step": 0}, 0)
        cli = ["--weights", weights, "--device", str(dev)] + cfg_opts(cfg)

        t0 = time.perf_counter()
        ann = make_coco_dataset(root, shapes, sides=sides)
        served = deploy_bins(dev, model, root, ann, fixed, short, max_size,
                             launches)
        steps["bins in and out"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        ladder = {}
        with launches_into(ladder):
            rc, text = run_cli(parity_check.main, cli)
        cos = [float(v) for ln in text.splitlines()[1:8]
               for v in ln.split()[1::2]]
        if rc or "PARITY OK" not in text or ladder != {"nms": 2,
                                                       "roi_align": 2}:
            raise AssertionError(f"parity_check: exit {rc}, launches "
                                 f"{ladder} (one a rung)")
        for k in launches:
            launches[k] += ladder[k]
        x = parity_check.model_input(model, cfg)
        seen = capture_kernel_inputs(lambda: model.inference(x))
        errs = {"nms": nms_case(*seen["nms"], "parity ladder input"),
                "roi_align": roi_case(*seen["roi_align"][:7],
                                      "parity ladder input")}
        del seen
        log(f"  parity ladder at {fixed}x{fixed} f32: PARITY OK, worst "
            f"cosine {min(cos):.6f} (the CLI's digits) over the direct | "
            f"exported and direct | bins columns; launches {ladder} (direct "
            f"and exported rungs)")
        steps["parity ladder"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        deploy_layers(dev, model, cfg, x, root, cli, launches)
        steps["layers"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with launches_into(launches):
            _, text = run_cli(measure.main, cli)
        full = text.split("full inference: ")[1]
        flops = int(full.split("[")[1].split("]")[0])
        want = inference_flops(model, tuple(x.shape))
        if flops != want:
            raise AssertionError(f"measure: {flops} FLOPs, inference_flops "
                                 f"{want}")
        log(f"  measures ({card}): {text.splitlines()[1].split(': ', 1)[1]}; "
            f"{flops / 1e9:.1f} GFLOP at {fixed}x{fixed}, equal to "
            f"inference_flops; one request{full.split(']')[1].rstrip()}")
        steps["measures"] = time.perf_counter() - t0

        deploy_cityscapes(*served)
        del model
        gc.collect()
        free_cuda()

        t0 = time.perf_counter()
        deploy_packer(dev, serving or serving_cfg(), root, shapes, sides,
                      fixed, short, max_size, split_images, launches)
        steps["native packer"] = time.perf_counter() - t0
    log(f"  [deploy] seconds by step: " + ", ".join(
        f"{k} {v:.1f}" for k, v in steps.items()) + f"; launches {launches}")
    return launches, errs


# ----------------------------------------------------------------- bench
# the tools' knobs in [bench]: short windows, the real widths
BENCH_ENV = {"BENCH_ITERS": "10", "BENCH_BUDGET_S": "1",
             "BENCH_DEADLINE_S": "300", "BENCH_REPS": "4"}
# finite positive device values of the bench and bench_train lines
BENCH_KEYS = ("value", "vs_baseline", "window_spread", "model_tflops",
              "achieved_tflops", "mfu", "chip_peak_tflops",
              "host_preprocess_ms", "host_pack_u8_ms",
              "sustained_images_per_sec", "sustained_ms_per_image",
              "batched_images_per_sec", "sustained_tight_images_per_sec",
              "device_resident_images_per_sec", "transfer_mb_per_image",
              "link_mb_per_sec", "projected_host_attached_images_per_sec")
BENCH_TRAIN_KEYS = ("value", "imgs_per_sec", "step_tflops",
                    "achieved_tflops", "mfu", "peak_memory_gib")
# a section's bound may exceed its measured time by this factor at most
BOUND_SLACK = 1.05
PROFILE_SHARE = 0.95  # of the device kernel time in named sections


@contextlib.contextmanager
def tool_env(env: dict):
    """``os.environ`` with ``env`` set inside the block."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_tool(main, argv, env: dict, counts: dict):
    """``run_cli`` of one tool with ``env``, the launches of kernels 1, 2
    and 2b inside it added to ``counts``."""
    from centermask2_tpu_torch.ops import _kernels

    before = _kernels.launch_counts()
    with tool_env(env):
        out = run_cli(main, argv)
    for k, n in _kernels.launch_counts().items():
        counts[k] = counts.get(k, 0) + n - before[k]
    return out


def json_line(text: str, what: str) -> dict:
    """The last line of a tool's output as JSON."""
    try:
        return json.loads(text.strip().splitlines()[-1])
    except (IndexError, ValueError) as e:
        raise AssertionError(f"{what}: no JSON line ({e})") from None


def check_bench_line(line: dict, keys, cuda: bool, what: str) -> None:
    """Each of ``keys`` finite and positive on the card (null on the CPU,
    where only the host's ``host_*``/``transfer_*``/``model_tflops``/
    ``step_tflops`` counts are real), and the card's name."""
    if "error" in line:
        raise AssertionError(f"{what}: {line['error']}")
    host = ("host_", "transfer_", "model_tflops", "step_tflops")
    for k in keys:
        v = line.get(k, "absent")
        if cuda or k.startswith(host):
            if not isinstance(v, (int, float)) or not np.isfinite(v) or \
                    v <= 0:
                if not (k == "window_spread" and v == 0):
                    raise AssertionError(f"{what}: {k} = {v}")
        elif v is not None:
            raise AssertionError(f"{what}: {k} = {v} on the CPU")
    if cuda and line["device"]["name"] != card_line().split(",")[0].strip():
        raise AssertionError(f"{what}: device {line['device']}")


def check_rising(rows, what: str, cuda: bool = True) -> None:
    """Each arm's median above the previous arm's, or below it by less
    than the larger of the two arms' interquartile ranges (on the card;
    a CPU rehearsal's host-clock medians are only logged)."""
    for (na, a), (nb, b) in zip(rows if cuda else (), rows[1:]):
        slack = max(a["q3_ms"] - a["q1_ms"], b["q3_ms"] - b["q1_ms"])
        if b["median_ms"] < a["median_ms"] - slack:
            raise AssertionError(
                f"{what}: {nb} {b['median_ms']:.3f} ms below {na} "
                f"{a['median_ms']:.3f} ms beyond the quartiles ({slack:.3f})")
    log(f"  {what}: the arms' medians "
        f"{'rise within their quartiles' if cuda else '(host clock)'}: "
        + ", ".join(f"{n} {r['median_ms']:.3f} [{r['q1_ms']:.3f}, "
                    f"{r['q3_ms']:.3f}]" for n, r in rows))


def check_profile(summary: dict, cuda: bool, train: bool, what: str) -> None:
    """At least ``PROFILE_SHARE`` of the kernel time in named sections;
    kernels 1 and 2 in the decode and ROI sections, 2b in the ROI
    section's backward."""
    want = {"nms": "decode+nms", "roi_align": "roi+mask+maskiou"}
    if train:
        want["roi_align_backward"] = "roi+mask+maskiou [bwd]"
    # on the CPU the ops' own names stand in for their kernels
    names = KERNEL_CUDA_FNS if cuda else {
        k: (f"cm2.{fn}.",) for k, fn in zip(("nms", "roi_align",
                                             "roi_align_backward"),
                                            KERNEL_FNS)}
    found = {}
    for sec, ks in summary["section_kernels"].items():
        for name in ks:
            for k in want:
                if any(f in name for f in names[k]):
                    found.setdefault(k, set()).add(sec)
    bad = {k: found.get(k) for k, sec in want.items()
           if found.get(k) != {sec}}
    share = summary["attributed_share"]
    if share < PROFILE_SHARE or bad:
        raise AssertionError(f"{what}: {share:.4f} of the kernel time in "
                             f"named sections; kernels in {bad}, want {want}")
    log(f"  {what}: {share:.4f} of {summary['ms_per_run']:.3f} ms a run in "
        f"named sections; {', '.join(f'{k} in {v}' for k, v in want.items())}"
        f"; a replay {summary['replay_device_ms']} ms")


def check_bounds(table: dict, what: str) -> None:
    """No section's summed bound above ``BOUND_SLACK`` x its time."""
    over = {s: r for s, r in table["sections"].items()
            if r["bound_ms"] > BOUND_SLACK * r["actual_ms"]}
    if over:
        raise AssertionError(f"{what}: bounds above the measured times: "
                             f"{over}")
    log(f"  {what}: every section's bound within {BOUND_SLACK}x its time; "
        f"total {table['total_ms']:.3f} ms, bound {table['bound_ms']:.3f} ms")


def bench_phase(dev, opts=(), edge: int = FIXED, train_edge: int = FIXED,
                batch: int = TRAIN_BATCH, profile_runs: int = 2,
                trace_dir=None) -> tuple:
    """The ``[bench]`` phase: the port's measuring tools (six CLIs and
    ``utils/trace_sections.py``), in this process, on the flagship
    (``configs/centermask/zy_model_config.yaml`` with ``opts``) with
    short windows (``BENCH_ENV``):

    1. ``tools/bench``: the 800x1088 request and the ``edge`` square as
       CUDA-graph replays, the serving loop, the NMS check; its JSON
       line's device values finite and positive, the card's name,
       ``nms_kernel_equal`` true.
    2. ``tools/bench_train``: the captured step at ``train_edge``, B =
       ``batch``; its line likewise.
    3. ``tools/bench_stages`` at ``edge`` with the ``nms_select`` arm and
       4. ``tools/bench_train_stages`` at ``train_edge``: the cumulative
       arms' medians rise within their quartiles.
    5. ``tools/profile_model`` of the eager request and (``--train``)
       the eager step, ``profile_runs`` and 1 runs, their traces under
       ``trace_dir`` (a temporary directory by default): at least
       ``PROFILE_SHARE`` of the kernel time in named sections, kernels 1
       and 2 in the decode and ROI sections, 2b in the ROI section's
       backward.
    6. ``tools/roofline_bound`` of both traces: no section's bound above
       ``BOUND_SLACK`` x its time.

    On the CPU (a rehearsal) the device values are null and held so.
    Returns (the launches of kernels 1, 2 and 2b counted, each tool's
    ``(main's return value, standard output)`` by name)."""
    import tempfile

    from centermask2_tpu_torch.tools import (bench, bench_stages,
                                             bench_train, bench_train_stages,
                                             profile_model, roofline_bound)

    dev = torch.device(dev)
    cuda = dev.type == "cuda"
    counts, out = {}, {}
    argv = ["--device", str(dev), *opts]
    rc, text = out["bench"] = run_tool(
        bench.main, argv, {**BENCH_ENV, "BENCH_EDGE": edge}, counts)
    line = json_line(text, "bench")
    keys = BENCH_KEYS + ((f"square_{edge}_ms", f"square_{edge}_mfu")
                         if edge >= 1088 else ())
    check_bench_line(line, keys, cuda, "bench")
    if rc != 0 or line["nms_kernel_equal"] is not (True if cuda else None):
        raise AssertionError(f"bench: exit {rc}, nms_kernel_equal "
                             f"{line['nms_kernel_equal']}")
    log(f"  bench: {line['value']} ms at {line['canvas']}, square "
        f"{line.get(f'square_{edge}_ms')} ms, mfu {line['mfu']}, sustained "
        f"{line['sustained_images_per_sec']} img/s; kernel 1 equal to its "
        f"plain version on the 1000-box set ({line['nms_kernel_keep_count']} "
        "kept)")

    train_env = {**BENCH_ENV, "BENCH_EDGE": train_edge, "BENCH_BATCH": batch}
    _, text = out["bench_train"] = run_tool(bench_train.main, argv,
                                            train_env, counts)
    line = json_line(text, "bench_train")
    check_bench_line(line, BENCH_TRAIN_KEYS, cuda, "bench_train")
    log(f"  bench_train: {line['value']} ms a step, {line['imgs_per_sec']} "
        f"img/s, mfu {line['mfu']}, peak {line['peak_memory_gib']} GiB")

    rows, _ = out["bench_stages"] = run_tool(
        bench_stages.main, argv,
        {**BENCH_ENV, "BENCH_EDGE": edge, "BENCH_NMS": 1}, counts)
    check_rising([(r["name"], r) for r in rows["stages"]], "bench_stages",
                 cuda)
    rows, _ = out["bench_train_stages"] = run_tool(
        bench_train_stages.main, argv, train_env, counts)
    st = rows["stages"]
    check_rising([(n, st[n]) for n in ("loss-fwd", "loss-fwd+bwd",
                                       "full-step")], "bench_train_stages",
                 cuda)
    check_rising([(n, st[n]) for n in ("fcos-only fwd+bwd",
                                       "loss-fwd+bwd")],
                 "bench_train_stages, the ROI branch", cuda)

    with contextlib.ExitStack() as stack:
        root = trace_dir or stack.enter_context(tempfile.TemporaryDirectory())
        for train, runs in ((False, profile_runs), (True, 1)):
            what = "profile_model" + (" --train" if train else "")
            trace = os.path.join(root, "train" if train else "request")
            pargv = ["--device", str(dev), "--runs", str(runs), "--top",
                     "15", "--trace-dir", trace, "--batch",
                     str(batch if train else 1), *(["--train"] * train),
                     "TPU.FIXED_EDGE_SIZE", str(train_edge if train
                                                else edge), *opts]
            summary, _ = out[what] = run_tool(profile_model.main, pargv, {},
                                              counts)
            check_profile(summary, cuda, train, what)
            rargv = [trace, "--top", "10"]
            if not cuda:  # a CPU trace names no card
                rargv += ["--peak-tflops", "1", "--peak-gbps", "100"]
            table, _ = out["roofline_bound" + " --train" * train] = \
                run_tool(roofline_bound.main, rargv, {}, counts)
            if cuda:
                check_bounds(table, "roofline_bound "
                             + ("step" if train else "request"))
    return counts, out


def flagship_phases(dev, nms_err: int, roi_err: float):
    """``[serve]``, ``[time]``, ``[graphs]``, ``[serving]``, ``[eval]``,
    ``[export]`` and ``[train]``: the V-39 flagship and its serving
    config. ``nms_err``, ``roi_err``: the worst kernel/plain errors of
    ``[kernels]``. Returns the ``kernels`` rows of kernels 1, 2 and 2b
    and the launches each phase counted."""
    card = card_line()
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
    eager_ms = {}
    for p in range(1, PASSES + 1):
        for dtype_name, model in models.items():
            note = "bf16" if dtype_name == "bfloat16" else "f32, TF32 off"
            for img in (images[0], images[3]):
                H, W = img.shape[1:3]
                clk = gpu_clocks()
                r = latency_window(model, img)
                if dtype_name == "bfloat16":
                    eager_ms[(H, W)] = r["median"]
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

    log("[graphs] the flagship through CapturedInference (one CUDA graph "
        f"per canvas), bf16 and f32 (TF32 off) ({card})")
    graph_launches = graphs_phase(dev, models, eager_ms)

    log("[serving] zy_model_serving.yaml: uint8 s2d tight packs, the s2d "
        "stem, the per-level decode, the same parameters as [serve]")
    s2d_model, serving_launches, per_level, errs = serving(dev, models,
                                                           serving_cfg())
    nms["max_abs_err"] = max(nms["max_abs_err"], errs["nms"])
    roi["max_abs_err"] = max(roi["max_abs_err"], errs["roi_align"])
    log("[eval] evaluate_dataset over a synthetic COCO set, serving model "
        "in bf16")
    eval_launches = eval_phase(dev, s2d_model)
    log("[export] export/aot.py artifacts of the serving model and of the "
        "flagship, saved, loaded and run")
    export_launches = export_phase(dev, s2d_model, models["bfloat16"])
    del s2d_model, models
    torch.cuda.empty_cache()

    log(f"[train] zy_model_config.yaml at full width in bf16, random weights "
        f"(seed 0), {FIXED}x{FIXED}, B={TRAIN_BATCH}, through train_loop "
        f"({card})")
    train_launches, train_errs, bwd = train_phase(dev, flagship_cfg())
    nms["max_abs_err"] = max(nms["max_abs_err"], train_errs["nms"])
    roi["max_abs_err"] = max(roi["max_abs_err"], train_errs["roi_align"])
    bwd["max_abs_err"] = train_errs["roi_align_backward"]
    return nms, roi, bwd, (launches, graph_launches, serving_launches,
                           per_level, eval_launches, export_launches,
                           train_launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from centermask2_tpu_torch.ops import _kernels
    from centermask2_tpu_torch.utils import tracing

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    secs = _kernels.build()
    log(f"[build] the sources (kernels 1, 2 and 2b, the section stamp) "
        f"built in {secs:.1f} s")
    for name, text in _kernels.build_logs().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    log("[kernels] each kernel against its plain version on the card")
    nms_err = check_nms(dev)
    roi_err = check_roi_align(dev)
    check_section_stamp(dev)

    # the V-39 phases run f32 without TF32, as their f32 gates (the s2d
    # stem within STEM_TOL, f32 replays against eager) and f32 times
    # need; [backbones] runs at PyTorch's defaults, as the entry points do
    with exact_f32():
        nms, roi, bwd, v39_launches = flagship_phases(dev, nms_err, roi_err)

    log("[backbones] R-50, R-101, MobileNetV2, V-19-dw-eSE and "
        "V-19-slim-dw-eSE from their yamls at full width, bf16, random "
        f"weights (seed 0) ({card})")
    bb_launches, bb_errs = backbones_phase(dev)
    log(f"[keypoints] {KEYPOINT_YAML} at full width, bf16, random weights "
        "(seed 0): served, evaluated by OKS and trained; the flagship with "
        f"the adaptive ROIAlign buckets and with deformable convs ({card})")
    kp_launches, kp_errs = keypoints_phase(dev)
    log(f"[parallel] data parallelism: the flagship at full width through "
        f"a process group of one over NCCL (the train step captured with its "
        f"all-reduce, SyncBN, BN, TPU.REMAT_BACKBONE, make_dp_inference), "
        f"then {RANKS} gloo ranks on the card ({card})")
    dp_launches, dp_errs = parallel_phase(dev)
    free_cuda()
    log(f"[deploy] the deployment toolchain on the flagship at full width, "
        f"f32 (TF32 off), {FIXED}x{FIXED}, random weights (seed 0): bins in "
        f"and out, the parity ladder, layer dumps card against CPU, "
        f"measures, Cityscapes on arrays, the native packer ({card})")
    with exact_f32():
        dep_launches, dep_errs = deploy_phase(dev)
    for row in (nms, roi, bwd):
        row["max_abs_err"] = max(row["max_abs_err"], bb_errs[row["name"]],
                                 kp_errs[row["name"]], dp_errs[row["name"]],
                                 dep_errs.get(row["name"], 0))
    free_cuda()
    log(f"[bench] the port's measuring tools (tools/bench, bench_train, "
        f"bench_stages, bench_train_stages, profile_model, roofline_bound) "
        f"on the flagship at full width, bf16, random weights (seed 0): "
        f"800x1088 and {FIXED}x{FIXED} requests, {FIXED}x{FIXED} B="
        f"{TRAIN_BATCH} steps ({card})")
    bench_launches, _ = bench_phase(dev)

    for row in (nms, roi, bwd):
        row["launches"] = sum(c.get(row["name"], 0) for c in (
            *v39_launches, bb_launches, kp_launches, dp_launches,
            dep_launches, bench_launches))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"[done] {time.perf_counter() - t_start:.1f} s total")
    log(card)
    log(json.dumps({"kernels": [{k: r[k] for k in keys}
                                for r in (nms, roi, bwd)],
                    "section_stamp_launches":
                        len(tracing.STAMPS) * STAMP_ROWS[0]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:  # one gloo rank of [parallel] (spawn_ranks)
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--rank", type=int, required=True)
        ap.add_argument("--port", type=int, required=True)
        ap.add_argument("--out", required=True)
        a = ap.parse_args()
        sys.exit(rank_main(a.rank, a.port, a.out))
    sys.exit(main())
