"""Training-step benchmark on one card (the port's counterpart of the
repository's ``tools/bench_train.py``).

    python -m centermask2_tpu_torch.tools.bench_train [--device cpu] \\
        [--config-file configs/centermask/zy_model_config.yaml] [KEY VALUE ...]

Times one full train step (forward, backward, clipped SGD update) of the
flagship at the reference recipe's per-GPU batch (16 images on 8 GPUs =
2) as replays of ``train/trainer.py::CapturedTrainStep`` (after its
eager warm-up steps and the capture): CUDA events around ``BENCH_ITERS``
back-to-back replays make one sample, samples taken for
``BENCH_BUDGET_S`` (3 to ``BENCH_REPS`` of them), the value their
median. Knobs, as ``tools/bench_train.py`` reads them: ``BENCH_EDGE``
(896, a square edge, or ``HxW``), ``BENCH_BATCH`` (2), ``BENCH_ITERS``
(5), ``BENCH_REMAT`` (0/1: TPU.REMAT_BACKBONE), ``BENCH_S2D`` (0/1:
TPU.S2D_STEM_INPUT), ``BENCH_REPS`` (8), ``BENCH_BUDGET_S`` (120).

The batch is ``tools/bench_train.py``'s (seed 0): noise images, 20 gt
boxes an image, random 28x28 mask patches. The weights are random from
seed 0 with the classification bias at ``TRAIN_CLS_BIAS`` (as
``chip_smoke.py``'s ``[train]`` sets it), so that the train decode hands
NMS candidates.

Prints ONE JSON line with ``tools/bench_train.py:115-147``'s keys:
``value`` (ms/step), ``imgs_per_sec``, ``window_spread`` ((median - min)
/ min over the samples), ``step_tflops``, ``achieved_tflops`` and
``mfu``, the FLOPs from ``utils/measures.py::count_grad_flops`` over one
forward and backward (convolutions and matrix products only, not XLA's
cost analysis), against the card's bf16 peak; and beside them
``peak_memory_gib`` (the device memory allocated at the peak of the
eager warm-up steps, the capture and the timed replays) and
``device`` (the ``nvidia-smi`` name, power limit and card count). With
``--device cpu`` the step runs eagerly, every device metric is null and
the host-clock ms a step goes under ``rehearsal_ms``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from .bench import card, load_cfg, median_spread, parse_args, time_calls

METRIC = "centermask2_v39_train_step"
TRAIN_GT = 20  # gt boxes an image (tools/bench_train.py:62)
# the classification prior bias (-4.6) leaves every random-weight score
# under the 0.05 train threshold, so the train decode would hand NMS no
# candidate; at -2.5 (sigmoid 0.076) over 1000 pass (chip_smoke.py)
TRAIN_CLS_BIAS = -2.5


def edge_spec():
    """(spec, H, W) of ``BENCH_EDGE``: a square edge or ``HxW``."""
    spec = os.environ.get("BENCH_EDGE", "896")
    if "x" in spec:
        h, w = (int(v) for v in spec.split("x"))
    else:
        h = w = int(spec)
    return spec, h, w


def synthetic_batch(batch: int, h: int, w: int, dev, s2d: bool,
                    n_gt: int = TRAIN_GT):
    """``tools/bench_train.py``'s batch from seed 0 on ``dev``: images
    (B, H, W, 3) of noise x 30 (the s2d layout with ``s2d``), and a
    ``GroundTruth`` of ``n_gt`` valid boxes an image (40 to min(H, W)/2
    px), classes below 80 and {0, 1} 28x28 mask patches."""
    import torch

    from ..data.preprocess import stem_space_to_depth
    from ..models.meta import GroundTruth

    rng = np.random.RandomState(0)
    images = rng.randn(batch, h, w, 3).astype(np.float32) * 30
    if s2d:
        images = stem_space_to_depth(images)
    boxes = np.zeros((batch, n_gt, 4), np.float32)
    boxes[..., 2:] = rng.uniform(40, min(h, w) / 2, (batch, n_gt, 2))
    boxes[..., :2] = rng.uniform(0, min(h, w) / 2, (batch, n_gt, 2))
    boxes[..., 2:] += boxes[..., :2]
    gt = GroundTruth(
        boxes=torch.from_numpy(boxes).to(dev),
        classes=torch.from_numpy(rng.randint(0, 80, (batch, n_gt))
                                 .astype(np.int32)).to(dev),
        valid=torch.ones((batch, n_gt), dtype=torch.bool, device=dev),
        mask_patches=torch.from_numpy(
            (rng.rand(batch, n_gt, 28, 28) > 0.5).astype(np.float32)).to(dev))
    return torch.from_numpy(images).to(dev), gt


def train_cfg(args, h: int, w: int, remat: bool, s2d: bool,
              overrides=()):
    """The flagship with the mask branch on, ``TPU.REMAT_BACKBONE`` and
    ``TPU.S2D_STEM_INPUT`` as the knobs say, a tool's ``overrides``, then
    the caller's opts."""
    return load_cfg(args.config_file, [
        "MODEL.MASK_ON", True, "MODEL.MASKIOU_ON", True,
        "TPU.REMAT_BACKBONE", remat, "TPU.S2D_STEM_INPUT", s2d,
        "TPU.FIXED_EDGE_SIZE", max(h, w), *overrides], args.opts)


def build_train_model(cfg, dev):
    """The model (train mode, random weights from seed 0, classification
    bias at ``TRAIN_CLS_BIAS``), its optimizer and schedule."""
    import torch

    from ..models.meta import build_centermask
    from ..train import make_optimizer_from_cfg

    model = build_centermask(cfg, device=dev, seed=0).train()
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.fill_(TRAIN_CLS_BIAS)
    opt, sched = make_optimizer_from_cfg(model, cfg)
    return model, opt, sched


def loss_backward(model, images, gt, draws):
    """One forward of ``model.loss`` and the backward of its sum (the
    gradients set anew); returns the detached total."""
    model.zero_grad(set_to_none=True)
    total = sum(model.loss(images, gt, draws=draws).values())
    total.backward()
    return total.detach()


def run(args) -> dict:
    import torch

    from ..train import make_train_step
    from ..train.trainer import WARMUP_STEPS
    from ..utils.device import resolve_device
    from ..utils.measures import chip_peak_flops, count_grad_flops

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    spec, h, w = edge_spec()
    batch = int(os.environ.get("BENCH_BATCH", "2"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    remat = os.environ.get("BENCH_REMAT", "0") == "1"
    s2d = os.environ.get("BENCH_S2D", "0") == "1"
    reps = max(3, int(os.environ.get("BENCH_REPS", "8")))
    budget = float(os.environ.get("BENCH_BUDGET_S", "120"))

    cfg = train_cfg(args, h, w, remat, s2d)
    model, opt, sched = build_train_model(cfg, dev)
    images, gt = synthetic_batch(batch, h, w, dev, s2d)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = torch.rand(model.draws_shape(gt), generator=gen, device=dev) \
        if model.roi_training else None
    # FLOPs of one forward and backward, before the step owns the grads
    flops = count_grad_flops(loss_backward, model, images, gt, draws)
    model.zero_grad(set_to_none=True)

    step = make_train_step(model, opt, sched)
    if cuda:  # the peak over the warm-up steps, the capture and replays
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(WARMUP_STEPS + 1 if cuda else 1):
        step(images, gt, generator=gen)
    if cuda:
        torch.cuda.synchronize(dev)
    print(f"warm-up{' and capture' if cuda else ''}: "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    win = (dict(iters=iters, min_reps=3, max_reps=reps) if cuda
           else dict(iters=1, min_reps=2, max_reps=2))
    ms, spread = median_spread(time_calls(
        lambda: step(images, gt, generator=gen), dev, budget_s=budget,
        **win))
    out = {"metric": METRIC, "value": round(ms, 2) if cuda else None,
           "unit": "ms/step", "edge": spec, "batch": batch, "remat": remat,
           "s2d": s2d,
           "imgs_per_sec": round(batch / ms * 1e3, 2) if cuda else None,
           "window_spread": round(spread, 3) if cuda else None,
           "step_tflops": round(flops / 1e12, 3)}
    peak = chip_peak_flops(dev)
    out["achieved_tflops"] = round(flops / ms / 1e9, 1) if cuda else None
    out["mfu"] = round(flops / ms / 1e9 / (peak / 1e12), 3) \
        if cuda and peak else None
    out["peak_memory_gib"] = round(torch.cuda.max_memory_allocated(dev)
                                   / 2 ** 30, 3) if cuda else None
    if not cuda:
        out["rehearsal_ms"] = {"value": round(ms, 3)}
    out["device"] = card(dev)
    return out


def main(argv=None) -> int:
    args = parse_args(argv, "Train-step benchmark (one JSON line)")
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
