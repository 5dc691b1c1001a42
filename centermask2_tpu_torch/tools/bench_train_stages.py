"""Per-stage breakdown of the train step on one card (the port's
counterpart of the repository's ``tools/bench_train_stages.py``).

    python -m centermask2_tpu_torch.tools.bench_train_stages [--device cpu] \\
        [--config-file configs/centermask/zy_model_config.yaml] [KEY VALUE ...]

Cumulative arms on the flagship (the same parameters), each captured as
a CUDA graph of its own:

  loss-fwd            ``CenterMask.loss`` under ``no_grad``
  loss-fwd+bwd        + the backward of the losses' sum
  full step           + the clipped SGD update (the step of bench_train)

and "fcos-only fwd+bwd", a second model with MODEL.MASK_ON and
MODEL.MASKIOU_ON off, to attribute the ROI branch's share. The arms are
sampled round-robin (``bench_stages.timed_interleaved``); each row gives
the median ms, the GFLOP of one call (``utils/measures.py``'s counts:
convolutions and matrix products, the backward's included), TFLOP/s and
% of the card's bf16 peak, then the increments: backward, optimizer and
ROI branch.

Knobs: ``BENCH_BODY`` (V-39-eSE), ``BENCH_EDGE`` (896, or ``HxW``),
``BENCH_BATCH`` (2), ``BENCH_S2D`` (0/1), ``BENCH_ONLY`` (a comma list of
arms); ``tools/bench_train_stages.py``'s ``BENCH_ITERS`` only sizes its
key table there and has no counterpart. The batch,
the weights and the classification bias are ``bench_train``'s. With
``--device cpu`` the arms run eagerly and the times are the host's (a
rehearsal, not device metrics).
"""

from __future__ import annotations

import os

from .bench import card, parse_args
from .bench_stages import quartiles, timed_interleaved
from .bench_train import (build_train_model, edge_spec, loss_backward,
                          synthetic_batch, train_cfg)


def train_arms(model, opt, sched, fcos_model, gt, draws):
    """``[(name, fn(images))]``: the four arms. The full step is the
    eager step of ``train/trainer.py::make_train_step`` with fixed
    draws."""
    import torch

    from ..train import make_train_step

    step = make_train_step(model, opt, sched, capture=False)

    @torch.no_grad()
    def loss_fwd(x):
        return sum(model.loss(x, gt, draws=draws).values())

    return [("loss-fwd", loss_fwd),
            ("loss-fwd+bwd", lambda x: loss_backward(model, x, gt, draws)),
            ("full-step", lambda x: step(x, gt, draws=draws)["total_loss"]),
            ("fcos-only fwd+bwd",
             lambda x: loss_backward(fcos_model, x, gt, None))]


def run(args) -> dict:
    import torch

    from ..utils.device import resolve_device
    from ..utils.measures import (chip_peak_flops, count_flops,
                                  count_grad_flops)

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    spec, h, w = edge_spec()
    batch = int(os.environ.get("BENCH_BATCH", "2"))
    s2d = os.environ.get("BENCH_S2D", "0") == "1"
    cfg = train_cfg(args, h, w, False, s2d, [
        "MODEL.VOVNET.CONV_BODY", os.environ.get("BENCH_BODY", "V-39-eSE")])
    model, opt, sched = build_train_model(cfg, dev)
    fcos_cfg = cfg.clone()
    fcos_cfg.merge_from_list(["MODEL.MASK_ON", False,
                              "MODEL.MASKIOU_ON", False])
    fcos_model, _, _ = build_train_model(fcos_cfg, dev)
    images, gt = synthetic_batch(batch, h, w, dev, s2d)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = torch.rand(model.draws_shape(gt), generator=gen, device=dev)

    arms = train_arms(model, opt, sched, fcos_model, gt, draws)
    only = os.environ.get("BENCH_ONLY")
    if only:
        arms = [a for a in arms if a[0] in set(only.split(","))]
    flops = {}
    for name, fn in arms:  # one call each, before the capture owns grads
        if name == "loss-fwd":
            flops[name] = count_flops(model, fn, images)
        else:
            flops[name] = count_grad_flops(fn, images)
    model.zero_grad(set_to_none=True)
    fcos_model.zero_grad(set_to_none=True)
    samples = timed_interleaved(arms, images, dev)

    peak = chip_peak_flops(dev)
    print(f"\n{'stage':>20s} {'ms':>8s} {'GFLOP':>9s} {'TFLOP/s':>8s} "
          f"{'%peak':>6s}")
    rows = {}
    for name, _ in arms:
        med, q1, q3 = quartiles(samples[name])
        f = flops[name]
        tf = f / med / 1e9 if cuda else None
        pct = 100.0 * tf * 1e12 / peak if tf is not None and peak else None
        rows[name] = {"median_ms": med, "q1_ms": q1, "q3_ms": q3,
                      "gflop": f / 1e9, "tflops": tf, "pct_peak": pct}
        print(f"{name:>20s} {med:8.2f} {f / 1e9:9.1f} "
              f"{'n/a' if tf is None else f'{tf:.1f}':>8s} "
              f"{'n/a' if pct is None else f'{pct:.1f}':>6s}")
    inc = {}
    if len(rows) == 4:
        t = {k: v["median_ms"] for k, v in rows.items()}
        inc = {"backward": t["loss-fwd+bwd"] - t["loss-fwd"],
               "optimizer": t["full-step"] - t["loss-fwd+bwd"],
               "roi_branch": t["loss-fwd+bwd"] - t["fcos-only fwd+bwd"]}
        print(f"\nincrements: backward {inc['backward']:.2f} ms, optimizer "
              f"{inc['optimizer']:.2f} ms, ROI branch (fwd+bwd, incl. its "
              f"fcos interactions) {inc['roi_branch']:.2f} ms")
    if not cuda:
        print("(CPU rehearsal: host-clock ms of eager calls, not device "
              "metrics)")
    return {"clock": "cuda events" if cuda else "host (CPU rehearsal)",
            "edge": spec, "batch": batch, "s2d": s2d, "stages": rows,
            "increments": inc, "device": card(dev)}


def main(argv=None) -> dict:
    return run(parse_args(argv, "Per-stage train-step latency"))


if __name__ == "__main__":
    main()
