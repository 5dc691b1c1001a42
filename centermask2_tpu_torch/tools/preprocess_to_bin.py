"""COCO images -> preprocessed ``.bin`` files, the input half of the
reference's device pipeline (the counterpart of the repository's
``tools/preprocess_to_bin.py`` and of the reference's
``preprocess_inputs_to_bin.py``).

    python -m centermask2_tpu_torch.tools.preprocess_to_bin \\
        --ann instances_val2017.json --image-root val2017 --out bins \\
        [--limit N]

Each image goes through ``data/preprocess.py::preprocess_for_model``
(ResizeShortestEdge 800/1333 with PIL, BGR mean subtraction, zero pad to
1344x1344) and is written as float32 NCHW 1x3x1344x1344, named
``{image_stem}.bin`` (``data/bin_io.py``), with the manifest
``bin_info.txt`` (reference get_bin_info.py). Host only: no model, no
device. Reading image files needs PIL.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, List

import numpy as np

from ..data.preprocess import FIXED_EDGE_SIZE, MAX_EDGE_SIZE, MIN_EDGE_SIZE


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ann", required=True)
    p.add_argument("--image-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=0)
    return p.parse_args(argv)


def write_input_bins(ann: str, image_root: str, out: str, limit: int = 0,
                     read_image: Callable[[str], np.ndarray] = None,
                     fixed_size: int = FIXED_EDGE_SIZE,
                     short: int = MIN_EDGE_SIZE,
                     max_size: int = MAX_EDGE_SIZE) -> List[str]:
    """Write one input ``.bin`` per image of the dataset (the first
    ``limit`` by id when ``limit``) and ``bin_info.txt``; returns the bin
    paths. ``read_image``: path -> HWC uint8 BGR (default: PIL). The
    canvas and resize are the contract's unless a caller (a rehearsal at
    a small size) asks for others."""
    from ..data import bin_io, preprocess_for_model, read_image_bgr
    from ..data.coco import CocoDataset

    ds = CocoDataset(ann, image_root, filter_empty=False)
    os.makedirs(out, exist_ok=True)
    ids = ds.ids[:limit] if limit else ds.ids
    paths = []
    for img_id in ids:
        path = ds.image_path(img_id)
        pre = preprocess_for_model(path, fixed_size, short, max_size,
                                   read_image=read_image or read_image_bgr)
        stem = os.path.splitext(os.path.basename(path))[0]
        paths.append(os.path.join(out, f"{stem}.bin"))
        bin_io.write_input_bin(pre["input"][0], paths[-1])
    with open(os.path.join(out, "bin_info.txt"), "w") as f:
        f.write(bin_io.bin_manifest(out, fixed_size, fixed_size))
    return paths


def main(argv=None) -> None:
    args = parse_args(argv)
    paths = write_input_bins(args.ann, args.image_root, args.out, args.limit)
    print(f"wrote {len(paths)} bins to {args.out}")


if __name__ == "__main__":
    main()
