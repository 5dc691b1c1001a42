"""Host-side postprocessing (the port's own copy of
``centermask2_tpu/data/postprocess.py``): rescale boxes to the original
image and paste masks at its resolution.

Replicates reference deploy_utils.py:101-175 (single_wrap_outputs,
detector_postprocess, postprocess): truncate to top 50, recompute the
resize scale from the original (h, w), rescale+clip boxes, drop empty
boxes, paste 28x28 soft masks into full-resolution bool masks at
threshold 0.5. Pasting uses the separable-bilinear math of
``ops/paste_masks.py`` in numpy, restricted to each box's integer
footprint.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .preprocess import MAX_EDGE_SIZE, MIN_EDGE_SIZE, postprocess_scale


def _interp_matrix_1d(start: float, end: float, lo: int, hi: int,
                      mask_size: int):
    coords = np.arange(lo, hi, dtype=np.float32) + 0.5
    span = max(end - start, 1e-6)
    m = (coords - start) / span * mask_size - 0.5
    taps = np.arange(mask_size, dtype=np.float32)
    w = np.maximum(0.0, 1.0 - np.abs(m[:, None] - taps[None, :]))
    return w


def paste_masks_np(
    masks: np.ndarray,  # (R, M, M) soft masks
    boxes: np.ndarray,  # (R, 4)
    image_hw,
    threshold: float = 0.5,
) -> np.ndarray:
    H, W = image_hw
    R, M, _ = masks.shape
    out = np.zeros((R, H, W), bool)
    for r in range(R):
        x0, y0, x1, y1 = boxes[r]
        xi0, yi0 = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
        xi1, yi1 = min(int(np.ceil(x1)), W), min(int(np.ceil(y1)), H)
        if xi1 <= xi0 or yi1 <= yi0:
            continue
        wy = _interp_matrix_1d(y0, y1, yi0, yi1, M)  # (h, M)
        wx = _interp_matrix_1d(x0, x1, xi0, xi1, M)  # (w, M)
        patch = wy @ masks[r].astype(np.float32) @ wx.T
        out[r, yi0:yi1, xi0:xi1] = patch > threshold
    return out


def single_wrap_outputs(
    tuple_outputs: Sequence[np.ndarray],
    height: int = MAX_EDGE_SIZE,
    width: int = MAX_EDGE_SIZE,
    topk: int = 50,
) -> Dict[str, np.ndarray]:
    """Truncate the 6-tensor contract to the top ``topk`` rows
    (reference deploy_utils.py:101-114). A 7th tensor, pred_keypoints
    (R, K, 3), may follow when a keypoint head is on."""
    keys = ["locations", "mask_scores", "pred_boxes", "pred_classes",
            "pred_masks", "scores", "pred_keypoints"]
    out = {k: np.asarray(v)[:topk]
           for k, v in zip(keys, tuple_outputs) if v is not None}
    out["image_size"] = (height, width)
    return out


def detector_postprocess(
    results: Dict[str, np.ndarray], h: int, w: int, mask_threshold: float = 0.5,
    short: int = None, max_size: int = None
) -> Dict[str, np.ndarray]:
    """Rescale to the original (h, w) and paste masks
    (reference deploy_utils.py:129-158)."""
    scale = postprocess_scale(h, w, short or MIN_EDGE_SIZE,
                              max_size or MAX_EDGE_SIZE)
    inv = 1.0 / scale

    boxes = results["pred_boxes"].astype(np.float32) * inv
    boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, w)
    boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, h)
    nonempty = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])

    out = {}
    for k in ("locations", "mask_scores", "pred_classes", "scores"):
        out[k] = results[k][nonempty]
    out["pred_boxes"] = boxes[nonempty]

    masks = results["pred_masks"][nonempty]
    if masks.ndim == 4:  # (R, 1, M, M)
        masks = masks[:, 0]
    out["pred_masks"] = paste_masks_np(masks, out["pred_boxes"], (h, w),
                                       mask_threshold)
    if "pred_keypoints" in results:
        # d2 detector_postprocess: scale keypoint x, y to the original
        # resolution (visibility/prob column untouched)
        kp = results["pred_keypoints"][nonempty].astype(np.float32).copy()
        kp[..., 0] *= inv
        kp[..., 1] *= inv
        out["pred_keypoints"] = kp
    out["image_size"] = (h, w)
    return out


def postprocess(
    instances: List[Dict[str, np.ndarray]],
    heights: Sequence[int],
    widths: Sequence[int],
) -> List[Dict[str, np.ndarray]]:
    return [
        detector_postprocess(inst, h, w)
        for inst, h, w in zip(instances, heights, widths)
    ]
