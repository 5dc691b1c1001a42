"""Inference + COCO evaluation over a dataset with the port (the
counterpart of the repository's ``tools/infer.py``).

    python -m centermask2_tpu_torch.tools.infer \\
        --config-file configs/centermask/zy_model_serving.yaml \\
        --ann instances_val2017.json --image-root val2017 \\
        [--weights model.pth] [--limit N] [--tight-compute] \\
        [--device cpu] [--output-dir out] [KEY VALUE ...]

Runs the model over a COCO-format dataset through
``evaluation/loop.py::evaluate_dataset`` (host resize and pack, device
inference, host rescale and mask paste, mask-score-aware COCO
evaluation), writes ``coco_instances_results.json`` and ``metrics.json``
to the output directory and prints the metric tables. The model runs on
the GPU unless ``--device cpu`` asks for the CPU; on the GPU each
canvas's requests replay one captured CUDA graph (the loop's default,
``export/captured.py``). Without ``--weights``
its weights are random, from seed 0. Reading image files needs PIL.
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
                   help="a reference-schema .pth checkpoint")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=1,
                   help="requests in flight (the pipeline depth, at least 2)")
    p.add_argument("--output-dir", default="output/infer")
    p.add_argument("--tasks", default="bbox,segm")
    p.add_argument("--tight-compute", action="store_true",
                   help="run each request at its quantized tight canvas "
                        "(s2d models; at most 4 canvases) instead of "
                        "padding it back to the deployment square")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def load_weights(model, cfg, path: str) -> None:
    """Convert a reference .pth and load it with ``strict=True``."""
    from ..checkpoint.convert_torch import (convert_checkpoint,
                                            load_torch_checkpoint)
    from ..checkpoint.from_jax import load_jax_params
    from ..models.meta import backbone_type

    tree, report = convert_checkpoint(
        load_torch_checkpoint(path), conv_body=cfg.MODEL.VOVNET.CONV_BODY,
        backbone=backbone_type(cfg), resnet_depth=cfg.MODEL.RESNETS.DEPTH,
        fcos_norm=cfg.MODEL.FCOS.NORM, top_levels=cfg.MODEL.FCOS.TOP_LEVELS,
        num_cls_convs=cfg.MODEL.FCOS.NUM_CLS_CONVS,
        num_box_convs=cfg.MODEL.FCOS.NUM_BOX_CONVS,
        num_share_convs=cfg.MODEL.FCOS.NUM_SHARE_CONVS,
        num_levels=len(cfg.MODEL.FCOS.IN_FEATURES),
        mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
        maskiou_num_conv=cfg.MODEL.ROI_MASKIOU_HEAD.NUM_CONV)
    if report["unused_torch_keys"]:
        print(f"[warn] {len(report['unused_torch_keys'])} checkpoint keys "
              f"unused, e.g. {report['unused_torch_keys'][:5]}")
    load_jax_params(model, tree)


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


def main(argv=None) -> None:
    args = parse_args(argv)
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
                         "(TPU.S2D_STEM_INPUT, a VoVNet backbone)")
    if args.weights:
        load_weights(model, cfg, args.weights)

    results, avg_ms, evaluator = evaluate_dataset(
        model, ann=args.ann, image_root=args.image_root,
        fixed_size=cfg.TPU.FIXED_EDGE_SIZE, min_size=cfg.INPUT.MIN_SIZE_TEST,
        max_size=cfg.INPUT.MAX_SIZE_TEST,
        tasks=tuple(args.tasks.split(",")), limit=args.limit,
        pipeline_depth=max(2, args.batch_size),
        tight_compute=args.tight_compute)
    finish(args, results, evaluator, avg_ms)


if __name__ == "__main__":
    main()
