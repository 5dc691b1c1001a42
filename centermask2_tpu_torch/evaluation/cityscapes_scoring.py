"""Self-contained Cityscapes instance-level AP scoring (the port's own
copy of ``centermask2_tpu/evaluation/cityscapes_scoring.py``; numpy
only, PIL read only by ``evaluate_prediction_dir``).

Implements the official cityscapesscripts
``evalInstanceLevelSemanticLabeling`` algorithm (the metric the reference
invokes through the package at cityscapes_evaluation.py:97-129) so the
evaluator produces numbers in environments without cityscapesscripts:

- gt instances come from *_instanceIds.png encoding (id = label*1000+n;
  ids below 1000 are semantic labels: instance-class semantic pixels are
  crowd/group regions),
- per (class, overlap in 0.5:0.05:0.95): greedy confidence-ranked
  matching with overlap = intersection / union (strict >), duplicate
  matches to one gt count the lower-confidence prediction as a false
  positive, unmatched gts are hard false negatives,
- gt instances below minRegionSize (100 px) are ignored; unmatched
  predictions are forgiven when their overlap with ignore regions (void
  semantic labels, same-class crowd regions, too-small same-class gts)
  exceeds the overlap threshold,
- AP integrates precision over recall with the official convolution
  step-width rule; allAp averages classes x overlaps, AP50 is the 0.5
  column.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# label ids of the 8 instance classes (official cityscapes labels)
INSTANCE_LABELS = {24: "person", 25: "rider", 26: "car", 27: "truck",
                   28: "bus", 31: "train", 32: "motorcycle", 33: "bicycle"}
# semantic labels excluded from evaluation (ignoreInEval in the official
# label table); predictions falling mostly on these are not penalized
VOID_LABELS = frozenset({0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18,
                         29, 30, 255})
OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZE = 100


def _collect_image(
    gt_ids: np.ndarray,  # (H, W) int32 instanceIds encoding
    preds: Sequence[Tuple[np.ndarray, int, float]],  # (mask, label, conf)
    min_region_size: int,
) -> Dict[int, Dict]:
    """Per-class match structures for one image."""
    sem = np.where(gt_ids >= 1000, gt_ids // 1000, gt_ids)
    void_mask = np.isin(sem, list(VOID_LABELS))
    out: Dict[int, Dict] = {}
    for label in INSTANCE_LABELS:
        inst_ids = np.unique(gt_ids[(sem == label) & (gt_ids >= 1000)])
        # crowd/group: semantic pixels of this class with no instance id
        crowd_mask = (sem == label) & (gt_ids < 1000)
        gts = []
        small_masks = []
        for iid in inst_ids:
            m = gt_ids == iid
            area = int(m.sum())
            if area < min_region_size:
                small_masks.append(m)
                continue
            gts.append({"mask": m, "area": area, "preds": []})
        ignore_mask = void_mask | crowd_mask
        for m in small_masks:
            ignore_mask = ignore_mask | m

        cls_preds = []
        for mask, plabel, conf in preds:
            if plabel != label:
                continue
            area = int(mask.sum())
            if area == 0:
                continue
            entry = {"area": area, "conf": float(conf), "gts": [],
                     "ignore_inter": int((mask & ignore_mask).sum())}
            pi = len(cls_preds)
            for gi, gt in enumerate(gts):
                inter = int((mask & gt["mask"]).sum())
                if inter > 0:
                    entry["gts"].append((gi, inter))
                    gt["preds"].append((pi, inter))
            cls_preds.append(entry)
        out[label] = {
            "gts": [{"area": g["area"], "preds": g["preds"]} for g in gts],
            "preds": cls_preds,
        }
    return out


def _average_precision(y_true: np.ndarray, y_score: np.ndarray,
                       hard_fns: int) -> float:
    """The official precision/recall integration (unique score
    thresholds, convolution step widths)."""
    order = np.argsort(y_score)
    y_score = y_score[order]
    y_true = y_true[order]
    cum_true = np.cumsum(y_true)
    thresholds = np.unique(y_score)
    n = len(y_score)
    n_true = int(cum_true[-1]) if n else 0
    precision = np.zeros(len(thresholds) + 1)
    recall = np.zeros(len(thresholds) + 1)
    idx_scores = np.searchsorted(y_score, thresholds)
    for i, s in enumerate(idx_scores):
        below = cum_true[s - 1] if s > 0 else 0
        tp = n_true - below
        fp = n - s - tp
        fn = below + hard_fns
        precision[i] = tp / float(tp + fp) if tp + fp else 0.0
        recall[i] = tp / float(tp + fn) if tp + fn else 0.0
    precision[-1] = 1.0
    recall[-1] = 0.0
    rc = np.concatenate([[recall[0]], recall, [0.0]])
    step_widths = np.convolve(rc, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step_widths))


def _score_class_overlap(per_image: List[Dict], min_overlap: float
                         ) -> Optional[float]:
    """AP of one class at one overlap threshold; None if no gt and no
    predictions exist anywhere."""
    y_true: List[float] = []
    y_score: List[float] = []
    hard_fns = 0
    have_gt = any(img["gts"] for img in per_image)
    have_pred = any(img["preds"] for img in per_image)
    for img in per_image:
        gts, preds = img["gts"], img["preds"]
        matched_conf = [None] * len(gts)
        for gi, gt in enumerate(gts):
            found = False
            for pi, inter in gt["preds"]:
                pred = preds[pi]
                overlap = inter / float(gt["area"] + pred["area"] - inter)
                if overlap > min_overlap:
                    conf = pred["conf"]
                    if matched_conf[gi] is not None:
                        # duplicate match: the lower-confidence prediction
                        # becomes a false positive
                        lo, hi = sorted([matched_conf[gi], conf])
                        matched_conf[gi] = hi
                        y_true.append(0.0)
                        y_score.append(lo)
                    else:
                        matched_conf[gi] = conf
                        found = True
            if not found and matched_conf[gi] is None:
                hard_fns += 1
        for gi, conf in enumerate(matched_conf):
            if conf is not None:
                y_true.append(1.0)
                y_score.append(conf)
        for pred in preds:
            matched = any(
                inter / float(gts[gi]["area"] + pred["area"] - inter)
                > min_overlap
                for gi, inter in pred["gts"])
            if matched:
                continue
            # ignore-region forgiveness: void/crowd/small-gt overlap
            n_ignore = pred["ignore_inter"]
            proportion = n_ignore / float(pred["area"])
            if proportion <= min_overlap:
                y_true.append(0.0)
                y_score.append(pred["conf"])
    if have_gt:
        return _average_precision(np.asarray(y_true), np.asarray(y_score),
                                  hard_fns)
    # no gt instances of this class anywhere: excluded from the average
    # (official evalInstanceLevelSemanticLabeling sets nan whether or not
    # the model emitted false positives of the class)
    return None


def score_instances(
    gt_instance_maps: Sequence[np.ndarray],
    predictions: Sequence[Sequence[Tuple[np.ndarray, int, float]]],
    min_region_size: int = MIN_REGION_SIZE,
) -> Dict[str, float]:
    """Dataset-level scoring. gt_instance_maps: per-image instanceIds
    arrays; predictions: per-image lists of (mask, label_id, confidence).
    Returns {"AP": allAp*100, "AP50": ..., "AP-{class}": ...}."""
    assert len(gt_instance_maps) == len(predictions)
    collected = [
        _collect_image(np.asarray(g, np.int64), p, min_region_size)
        for g, p in zip(gt_instance_maps, predictions)
    ]
    per_class_aps: Dict[int, List[Optional[float]]] = {}
    per_class_ap50: Dict[int, Optional[float]] = {}
    for label in INSTANCE_LABELS:
        per_image = [c[label] for c in collected]
        aps = [_score_class_overlap(per_image, ov) for ov in OVERLAPS]
        per_class_aps[label] = aps
        per_class_ap50[label] = aps[0]  # OVERLAPS[0] is exactly 0.5

    def mean(vals):
        vals = [v for v in vals if v is not None and v == v]
        return float(np.mean(vals)) if vals else float("nan")

    class_means = {l: mean(a) for l, a in per_class_aps.items()}
    results = {
        "AP": mean(class_means.values()) * 100,
        "AP50": mean(per_class_ap50.values()) * 100,
    }
    for l, v in class_means.items():
        results[f"AP-{INSTANCE_LABELS[l]}"] = (
            v * 100 if v == v else float("nan"))
    return results


def evaluate_prediction_dir(pred_dir: str, gt_dir: str) -> Dict[str, float]:
    """Score the evaluator's emitted files (``{base}_pred.txt`` + mask
    pngs) against ``{gt_dir}/**/*_gtFine_instanceIds.png``."""
    import glob
    import os

    from PIL import Image

    gt_files = sorted(glob.glob(
        os.path.join(gt_dir, "**", "*_gtFine_instanceIds.png"),
        recursive=True))
    gt_maps, preds = [], []
    for gt_path in gt_files:
        base = os.path.basename(gt_path).replace("_gtFine_instanceIds.png", "")
        gt_maps.append(np.asarray(Image.open(gt_path), np.int64))
        txt = os.path.join(pred_dir, base + "_leftImg8bit_pred.txt")
        if not os.path.exists(txt):
            txt = os.path.join(pred_dir, base + "_pred.txt")
        image_preds = []
        if os.path.exists(txt):
            with open(txt) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) != 3:
                        continue
                    png, label, conf = parts
                    mask = np.asarray(
                        Image.open(os.path.join(pred_dir, png))) > 0
                    image_preds.append((mask, int(label), float(conf)))
        preds.append(image_preds)
    return score_instances(gt_maps, preds)
