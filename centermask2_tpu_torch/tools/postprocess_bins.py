"""Evaluate device output ``.bin`` dumps, the output half of the
reference's device pipeline (the counterpart of the repository's
``tools/postprocess_bins.py`` and of the reference's
``postprocess_bin_outputs.py``).

    python -m centermask2_tpu_torch.tools.postprocess_bins \\
        --ann instances_val2017.json --bin-dir dumps [--tasks bbox,segm]

Reads each image's six tensors ``{image_stem}_{1..6}.bin``
(``data/bin_io.py``: dtypes and shapes of the reference contract),
keeps the top 50 rows (``single_wrap_outputs``), rescales them to the
original image and pastes the masks (``detector_postprocess``, at the
deployment's 800/1333 resize), and scores them with the port's
``COCOEvaluator``. Images whose bins are missing are counted, reported
and skipped, not fatal (reference :48-52). Host only: no model, no
device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

from ..data.preprocess import MAX_EDGE_SIZE, MIN_EDGE_SIZE


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann", required=True)
    p.add_argument("--bin-dir", required=True)
    p.add_argument("--tasks", default="bbox,segm")
    return p.parse_args(argv)


def evaluate_bins(ann: str, bin_dir: str, tasks=("bbox", "segm"),
                  short: int = MIN_EDGE_SIZE, max_size: int = MAX_EDGE_SIZE
                  ) -> Tuple[Dict[str, Dict[str, float]], List[str]]:
    """(the COCO metrics of the dumps under ``bin_dir``, the stems of
    the images whose bins are missing). ``short``/``max_size``: the
    resize the inputs had (the contract's unless a rehearsal at a small
    size asks for others)."""
    from ..data import detector_postprocess, single_wrap_outputs
    from ..data.bin_io import read_output_bins
    from ..evaluation import COCOEvaluator, COCOGt

    with open(ann) as f:
        gt = COCOGt(json.load(f))
    cat_ids = sorted(gt.cats.keys())
    evaluator = COCOEvaluator(
        gt, tasks=tuple(tasks),
        category_id_map={i: c for i, c in enumerate(cat_ids)})
    missing = []
    for img_id, img in gt.imgs.items():
        stem = os.path.splitext(img["file_name"])[0]
        outs = read_output_bins(os.path.join(bin_dir, stem))
        if outs is None:
            missing.append(stem)
            continue
        evaluator.process(img_id, detector_postprocess(
            single_wrap_outputs(outs), img["height"], img["width"],
            short=short, max_size=max_size))
    return evaluator.evaluate(), missing


def main(argv=None) -> None:
    args = parse_args(argv)
    results, missing = evaluate_bins(args.ann, args.bin_dir,
                                     args.tasks.split(","))
    if missing:
        print(f"{len(missing)} images missing bins (skipped)")
    for task, metrics in results.items():
        print(f"== {task} ==")
        print(", ".join(f"{k}={v:.2f}" for k, v in metrics.items()))


if __name__ == "__main__":
    main()
