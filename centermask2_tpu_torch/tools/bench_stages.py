"""Per-stage latency of the inference pipeline on one card, with a
per-stage roofline table (the port's counterpart of the repository's
``tools/bench_stages.py``).

    python -m centermask2_tpu_torch.tools.bench_stages [--device cpu] \\
        [--config-file configs/centermask/zy_model_config.yaml] [KEY VALUE ...]

Four cumulative arms, each a prefix of ``CenterMask.inference``
(``stage_fns``) captured as a CUDA graph of its own: backbone+fpn
(``features``), +fcos head (``_fcos_raw``), +decode(topk+nms)
(``_decode``) and the full pipeline (``inference``); ``BENCH_NMS=1``
adds an ``nms_select`` arm over ``BENCH_NMS_N`` (1000) random boxes,
outside the cumulative table. ``timed_interleaved`` samples the arms
round-robin, so that every arm sees every window: each sample is CUDA
events around 10 back-to-back replays of one arm. The table gives each
stage's increment over the previous arm: ms (of the medians), GFLOP
(``utils/measures.py::count_flops`` over each prefix: convolutions and
matrix products), TFLOP/s and % of the card's bf16 peak.

Knobs: ``BENCH_EDGE`` (1344, or ``HxW``), ``BENCH_S2D`` (1:
TPU.S2D_STEM_INPUT), ``BENCH_BF16`` (1: TPU.COMPUTE_DTYPE bfloat16, else
float32), ``BENCH_NMS``, ``BENCH_NMS_N``. The model is the flagship
with ``bench.py``'s serving overrides, random weights from seed 0, the
classification bias at 0. With ``--device cpu`` the arms run eagerly and
the times are the host's (a rehearsal, not device metrics).
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from .bench import card, load_cfg, parse_args

LABELS = {"backbone+fpn": "backbone+fpn", "fcos head": "+fcos head",
          "decode": "+decode(topk+nms)", "roi+mask+maskiou": "full pipeline"}
ITERS = 10  # replays in one sample
REPEATS = 6  # samples of each arm


def stage_fns(model) -> "OrderedDict[str, callable]":
    """The cumulative prefixes of ``model.inference`` as functions of the
    network input: the FPN features (a dict of P3-P7), + the FCOS head's
    raw outputs (locations, logits, reg, ctr), + the decoded proposals,
    + the full ``InferenceOutputs``."""
    import torch

    @torch.no_grad()
    def feats(x):
        return model.features(x)

    @torch.no_grad()
    def head(x):
        return model._fcos_raw(model.features(x))

    @torch.no_grad()
    def decode(x):
        return model._decode(*model._fcos_raw(model.features(x)))

    return OrderedDict([("backbone+fpn", feats), ("fcos head", head),
                        ("decode", decode),
                        ("roi+mask+maskiou", model.inference)])


def timed_interleaved(named_fns, x, dev, repeats: int = REPEATS,
                      iters: int = ITERS):
    """Samples (ms per call) of each ``(name, fn)`` called on ``x``,
    taken round-robin so that every arm sees every measurement window.
    On the card each ``fn(x)`` is captured as a CUDA graph of its own
    (``export/captured.py::CudaGraphs``, after its side-stream warm-up
    calls) and a sample is CUDA events around ``iters`` replays; on the
    CPU the calls run eagerly, one a sample (two a arm), on the host
    clock. Returns
    ``{name: [ms, ...]}``."""
    import time

    import torch

    from ..export.captured import WARMUP_CALLS, CudaGraphs

    if dev.type != "cuda":  # a rehearsal of the control flow
        repeats = min(repeats, 2)
    runs = []
    for name, fn in named_fns:
        if dev.type == "cuda":
            graphs = CudaGraphs(dev)
            graphs.warm_up(lambda f=fn: f(x), WARMUP_CALLS)
            graph, _ = graphs.capture(lambda f=fn: f(x))
            runs.append((name, graph.replay))
        else:
            runs.append((name, lambda f=fn: f(x)))
    samples = {name: [] for name, _ in runs}
    for _ in range(repeats):
        for name, run in runs:
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    run()
                end.record()
                end.synchronize()
                samples[name].append(start.elapsed_time(end) / iters)
            else:
                t0 = time.perf_counter()
                run()
                samples[name].append((time.perf_counter() - t0) * 1e3)
    return samples


def quartiles(samples):
    """(median, q1, q3) of a list of samples."""
    q1, med, q3 = np.percentile(np.asarray(samples), (25, 50, 75))
    return float(med), float(q1), float(q3)


def stage_table(rows, peak: float, cuda: bool, width: int = 18) -> list:
    """Printed lines of the roofline table over cumulative ``rows``
    (dicts with ``name``, ``median_ms``, ``flops``); adds each row's
    increments (``inc_ms``, ``inc_gflop``, ``tflops``, ``pct_peak``)."""
    lines = [f"{'stage':>{width}s} {'ms':>7s} {'GFLOP':>8s} {'TFLOP/s':>8s} "
             f"{'%peak':>6s}"]
    prev_t = prev_f = 0.0
    for r in rows:
        dt, df = r["median_ms"] - prev_t, r["flops"] - prev_f
        prev_t, prev_f = r["median_ms"], r["flops"]
        r["inc_ms"], r["inc_gflop"] = dt, df / 1e9
        r["tflops"] = df / dt / 1e9 if cuda and dt > 0 else None
        r["pct_peak"] = 100.0 * r["tflops"] * 1e12 / peak \
            if r["tflops"] is not None and peak else None
        tf = "n/a" if r["tflops"] is None else f"{r['tflops']:.1f}"
        pct = "n/a" if r["pct_peak"] is None else f"{r['pct_peak']:.1f}"
        lines.append(f"{r['name']:>{width}s} {dt:7.2f} {df / 1e9:8.2f} "
                     f"{tf:>8s} {pct:>6s}")
    return lines


def run(args) -> dict:
    import torch

    from ..data.preprocess import stem_space_to_depth
    from ..models.meta import build_centermask
    from ..ops.nms import nms_select
    from ..utils.device import resolve_device
    from ..utils.measures import chip_peak_flops, count_flops

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    spec = os.environ.get("BENCH_EDGE", "1344")
    eh, ew = ((int(v) for v in spec.split("x")) if "x" in spec
              else (int(spec),) * 2)
    s2d = os.environ.get("BENCH_S2D", "1") == "1"
    bf16 = os.environ.get("BENCH_BF16", "1") == "1"
    cfg = load_cfg(args.config_file, [
        "TPU.S2D_STEM_INPUT", s2d, "MODEL.FCOS.POST_NMS_TOPK_TEST", 50,
        "TPU.NMS_CANDIDATES", 1000,
        "TPU.COMPUTE_DTYPE", "bfloat16" if bf16 else "float32",
        "TPU.FIXED_EDGE_SIZE", max(eh, ew)], args.opts)
    model = build_centermask(cfg, device=dev, seed=0)
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    rng = np.random.RandomState(0)
    x_img = rng.randn(1, eh, ew, 3).astype(np.float32) * 30
    x = torch.from_numpy(stem_space_to_depth(x_img) if s2d else x_img) \
        .to(dev)

    arms = list(stage_fns(model).items())
    extra = []
    if os.environ.get("BENCH_NMS", "0") == "1":
        nb = int(os.environ.get("BENCH_NMS_N", "1000"))
        rb = rng.rand(nb, 4).astype(np.float32) * 600
        boxes = torch.from_numpy(np.concatenate(
            [rb[:, :2], rb[:, :2] + 16 + rb[:, 2:] * 20], 1))[None].to(dev)
        scores = torch.from_numpy(rng.rand(nb).astype(np.float32))[None] \
            .to(dev)
        classes = torch.from_numpy(rng.randint(0, 80, nb).astype(np.int32)
                                   )[None].to(dev)
        valid = torch.ones((1, nb), dtype=torch.bool, device=dev)
        extra.append(("nms_select", lambda _x: nms_select(
            boxes, scores, classes, valid, 0.6, 50)))
    samples = timed_interleaved(arms + extra, x, dev)

    rows = []
    for name, fn in arms:
        med, q1, q3 = quartiles(samples[name])
        print(f"{LABELS[name]}: {med:.2f} ms [q1 {q1:.2f}, q3 {q3:.2f}]")
        rows.append({"name": name, "median_ms": med, "q1_ms": q1,
                     "q3_ms": q3, "flops": float(count_flops(model, fn, x))})
    extras = {}
    for name, _ in extra:
        med, q1, q3 = quartiles(samples[name])
        extras[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3}
        print(f"[extra] {name}: {med:.2f} ms [q1 {q1:.2f}, q3 {q3:.2f}]")
    peak = chip_peak_flops(dev)
    print()
    for line in stage_table(rows, peak, cuda):
        print(line)
    if cuda:
        print(f"(card peak {peak / 1e12:.0f} TFLOP/s bf16; incremental "
              "flops from FlopCounterMode: convolutions and matrix "
              "products)")
    else:
        print("(CPU rehearsal: host-clock ms of eager calls, not device "
              "metrics)")
    return {"clock": "cuda events" if cuda else "host (CPU rehearsal)",
            "edge": spec, "s2d": s2d, "bf16": bf16, "stages": rows,
            "extra": extras, "device": card(dev)}


def main(argv=None) -> dict:
    return run(parse_args(argv, "Per-stage inference latency"))


if __name__ == "__main__":
    main()
