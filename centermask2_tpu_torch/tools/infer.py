"""Inference + COCO evaluation over a dataset with the port (the
counterpart of the repository's ``tools/infer.py``).

    python -m centermask2_tpu_torch.tools.infer \\
        --config-file configs/centermask/zy_model_serving.yaml \\
        --ann instances_val2017.json --image-root val2017 \\
        [--weights model.pth|converted_dir] [--limit N] [--tight-compute] \\
        [--data-parallel --batch-size B] [--device cpu|cuda:N] \\
        [--output-dir out] [KEY VALUE ...]

Runs the model over a COCO-format dataset through
``evaluation/loop.py::evaluate_dataset`` (host resize and pack, device
inference, host rescale and mask paste, mask-score-aware COCO
evaluation; with MODEL.KEYPOINT_ON also the keypoints (OKS) task, with
TEST.KEYPOINT_OKS_SIGMAS), writes ``coco_instances_results.json`` and
``metrics.json`` to the output directory and prints the metric tables. The model runs on
the GPU unless ``--device cpu`` asks for the CPU; on the GPU each
canvas's requests replay one captured CUDA graph (the loop's default,
``export/captured.py``). Without ``--weights``
its weights are random, from seed 0. Reading image files needs PIL.

Several processes (one device each, named by ``--device``) join a process
group when ``CM2_COORDINATOR``, ``CM2_NUM_PROCESSES`` and
``CM2_PROCESS_ID`` are set (``parallel/distributed.py``); the group is
joined first, before the model is built. Without ``--data-parallel``
each process evaluates its strided share of the images and rank 0 scores
the gathered predictions. With ``--data-parallel`` the images go in
size-bucketed batches of ``--batch-size`` (TPU.SIZE_BUCKETS, or the
quantized tight canvases with ``--tight-compute``;
``data/bucketing.py``), each process runs its rows of every batch
(``parallel/serve.py::make_dp_inference``), and rank 0 postprocesses and
scores the gathered outputs; the batch size must be above 1 and divisible
by the number of processes. Only rank 0 writes the output directory.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default=None)
    p.add_argument("--ann", required=True, help="COCO annotations json")
    p.add_argument("--image-root", required=True)
    p.add_argument("--weights", default=None,
                   help="a reference-schema .pth checkpoint or a converted "
                        "checkpoint directory (tools/convert_weights.py)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=1,
                   help="requests in flight (the pipeline depth, at least "
                        "2); with --data-parallel the global batch")
    p.add_argument("--data-parallel", action="store_true",
                   help="size-bucketed batches split over the processes")
    p.add_argument("--output-dir", default="output/infer")
    p.add_argument("--tasks", default=None,
                   help="comma-separated COCO tasks; default bbox,segm, and "
                        "keypoints (OKS) with MODEL.KEYPOINT_ON")
    p.add_argument("--tight-compute", action="store_true",
                   help="run each request at its quantized tight canvas "
                        "(s2d models; at most 4 canvases) instead of "
                        "padding it back to the deployment square")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def finish(args, results, evaluator, avg_ms) -> None:
    """Persist predictions + metrics and print the summary tables."""
    from ..evaluation.coco_eval import print_csv_format

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir,
                           "coco_instances_results.json"), "w") as f:
        json.dump(evaluator.predictions, f)

    for task, metrics in results.items():
        summary = {k: v for k, v in metrics.items() if not k.startswith("AP-")}
        print(f"== {task} ==")
        print(", ".join(f"{k}={v:.2f}" for k, v in summary.items()))
        # per-category AP table (reference coco_evaluation.py:345-356)
        items = sorted((k[3:], v) for k, v in metrics.items()
                       if k.startswith("AP-"))
        for i in range(0, len(items), 3):
            print("  " + " | ".join(
                f"{n:>18s}: {v:6.2f}" for n, v in items[i:i + 3]))
    print_csv_format(results)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(f"avg inference: {avg_ms:.1f} ms/img")


def data_parallel_eval(args, cfg, model, tasks):
    """``--data-parallel``: size-bucketed batches through
    ``make_dp_inference``; rank 0 postprocesses and scores (JAX
    ``tools/infer.py:201-240``). Returns (results, avg_ms, evaluator) on
    rank 0 and None elsewhere."""
    import time

    import numpy as np
    import torch

    from ..data import (detector_postprocess, preprocess_for_model,
                        single_wrap_outputs)
    from ..data.bucketing import (batches_from_groups, group_by_bucket,
                                  group_by_serving_canvas)
    from ..data.coco import CocoDataset
    from ..evaluation.coco_eval import COCOEvaluator, COCOGt
    from ..parallel import is_main_process, make_dp_inference, process_count

    world = process_count()
    if args.batch_size <= 1 or args.batch_size % world:
        raise SystemExit(f"--data-parallel needs a --batch-size above 1 "
                         f"that {world} processes divide, got "
                         f"{args.batch_size}")
    fixed = cfg.TPU.FIXED_EDGE_SIZE
    short, max_size = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
    ds = CocoDataset(args.ann, args.image_root, filter_empty=False)
    ids = ds.ids[:args.limit] if args.limit else ds.ids
    main = is_main_process()
    evaluator = None
    if main:
        with open(args.ann) as f:
            gt = COCOGt(json.load(f))
        evaluator = COCOEvaluator(gt, tasks=tasks,
                                  category_id_map=ds.contiguous_to_cat,
                                  kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS)
    sizes = [(ds.imgs[i]["height"], ds.imgs[i]["width"]) for i in ids]
    if args.tight_compute:
        groups = group_by_serving_canvas(ids, sizes, fixed, short, max_size)
    else:
        groups = group_by_bucket(ids, sizes, cfg.TPU.SIZE_BUCKETS, short,
                                 max_size)
    dev = next(model.parameters()).device
    infer = make_dp_inference(model)
    s2d = model.s2d_input
    total = 0.0
    for bucket, chunk, n_real in batches_from_groups(groups,
                                                     args.batch_size):
        # s2d models take the RAW uint8 pack at the bucket canvas (or at
        # the group's tight canvas with --tight-compute)
        pres = [preprocess_for_model(
            ds.image_path(ids[i]), fixed if args.tight_compute else bucket,
            short, max_size, s2d=s2d, u8=s2d, tight=args.tight_compute)
            for i in chunk]
        batch = torch.from_numpy(np.concatenate([p["input"] for p in pres]))
        hw = torch.from_numpy(np.concatenate(
            [p["valid_hw"] for p in pres])) if s2d else None
        t0 = time.perf_counter()
        out = infer(batch.to(dev), None, None if hw is None else hw.to(dev))
        out = {k: v.cpu().numpy() for k, v in out._asdict().items()
               if v is not None}
        total += time.perf_counter() - t0
        if not main:
            continue
        for b in range(n_real):
            v = out["valid"][b]
            wrapped = single_wrap_outputs(
                [out[k][b][v] if k in out else None
                 for k in ("locations", "mask_scores", "pred_boxes",
                           "pred_classes", "pred_masks", "scores",
                           "pred_keypoints")])
            h, w = pres[b]["original_hw"]
            evaluator.process(ids[chunk[b]], detector_postprocess(
                wrapped, h, w, short=pres[b]["short"],
                max_size=pres[b]["max_size"]))
    if not main:
        return None
    results = evaluator.evaluate()
    results["box_proposals"] = evaluator.evaluate_proposals()
    return results, total / max(len(ids), 1) * 1000.0, evaluator


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..parallel import init_distributed, is_main_process, process_count

    # the process group first, before any model or CUDA work (the JAX CLI
    # joins its cluster after model.init, which jax.distributed refuses)
    init_distributed(device=args.device)
    from ..checkpoint.weights import load_weights
    from ..config import get_cfg
    from ..evaluation.loop import evaluate_dataset
    from ..models.meta import build_centermask

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = build_centermask(cfg, device=args.device, seed=0)
    if args.tight_compute and not model.s2d_input:
        raise SystemExit("--tight-compute requires an s2d-input model "
                         "(TPU.S2D_STEM_INPUT, a VoVNet or ResNet backbone)")
    if args.weights:
        load_weights(model, cfg, args.weights)

    tasks = tuple((args.tasks or "bbox,segm" + (
        ",keypoints" if cfg.MODEL.KEYPOINT_ON else "")).split(","))
    if args.data_parallel:
        done = data_parallel_eval(args, cfg, model, tasks)
        if done is not None:
            results, avg_ms, evaluator = done
            finish(args, results, evaluator, avg_ms)
        return
    results, avg_ms, evaluator = evaluate_dataset(
        model, ann=args.ann, image_root=args.image_root,
        fixed_size=cfg.TPU.FIXED_EDGE_SIZE, min_size=cfg.INPUT.MIN_SIZE_TEST,
        max_size=cfg.INPUT.MAX_SIZE_TEST,
        tasks=tasks, limit=args.limit,
        pipeline_depth=max(2, args.batch_size),
        tight_compute=args.tight_compute,
        kpt_oks_sigmas=cfg.TEST.KEYPOINT_OKS_SIGMAS,
        distributed=process_count() > 1)
    if is_main_process():
        finish(args, results, evaluator, avg_ms)


if __name__ == "__main__":
    main()
