"""Bin-file I/O of the reference's device pipeline, byte for byte (the
port's own copy of ``centermask2_tpu/data/bin_io.py``).

Inputs (reference: deploy_utils.py:178-194, preprocess_inputs_to_bin.py):
float32 NCHW 1x3x1344x1344 per image, file named {image_stem}.bin.

Outputs (reference: postprocess_bin_outputs.py:37-44): six arrays per image
with dtypes [f32, f32, f32, i64, f32, f32] and shapes
[(-1,2), (-1,), (-1,4), (-1,), (-1,1,28,28), (-1,)] in the order
locations, mask_scores, pred_boxes, pred_classes, pred_masks, scores,
files named {image_id}_{1..6}.bin. The model's int32 ``pred_classes``
widen to int64 here, at the boundary, not in the model.

numpy only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

OUTPUT_DTYPES = [np.float32, np.float32, np.float32, np.int64, np.float32,
                 np.float32]
OUTPUT_SHAPES = [(-1, 2), (-1,), (-1, 4), (-1,), (-1, 1, 28, 28), (-1,)]
OUTPUT_NAMES = ["locations", "mask_scores", "pred_boxes", "pred_classes",
                "pred_masks", "scores"]


def write_input_bin(image_hwc: np.ndarray, path: str) -> None:
    """HWC float32 -> NCHW float32 .bin (reference to_bin layout)."""
    nchw = np.ascontiguousarray(
        image_hwc.astype(np.float32).transpose(2, 0, 1)[None])
    nchw.tofile(path)


def read_input_bin(path: str, size: int = 1344) -> np.ndarray:
    """NCHW .bin -> HWC float32."""
    arr = np.fromfile(path, np.float32).reshape(1, 3, size, size)
    return arr[0].transpose(1, 2, 0)


def write_output_bins(outputs: Sequence[np.ndarray], prefix: str) -> None:
    """Write the 6-tensor contract as {prefix}_{i}.bin, i in 1..6."""
    if len(outputs) != 6:
        raise ValueError(f"the output contract has 6 tensors, got "
                         f"{len(outputs)}")
    for i, (arr, dt) in enumerate(zip(outputs, OUTPUT_DTYPES), start=1):
        np.ascontiguousarray(np.asarray(arr).astype(dt)).tofile(
            f"{prefix}_{i}.bin")


def read_output_bins(prefix: str) -> Optional[List[np.ndarray]]:
    """Read {prefix}_{1..6}.bin; None if any file is missing (tolerated,
    reference postprocess_bin_outputs.py:48-52)."""
    outs = []
    for i, (dt, shape) in enumerate(zip(OUTPUT_DTYPES, OUTPUT_SHAPES),
                                    start=1):
        path = f"{prefix}_{i}.bin"
        if not os.path.exists(path):
            return None
        outs.append(np.fromfile(path, dt).reshape(shape))
    return outs


def bin_manifest(bin_dir: str, width: int = 1344, height: int = 1344) -> str:
    """Manifest lines "idx path width height" (reference get_bin_info.py:6-14)."""
    lines = []
    files = sorted(f for f in os.listdir(bin_dir) if f.endswith(".bin"))
    for idx, f in enumerate(files):
        lines.append(f"{idx} {os.path.join(bin_dir, f)} {width} {height}")
    return "\n".join(lines)
