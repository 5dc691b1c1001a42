"""Built-in Cityscapes semantic-segmentation scoring (official algorithm;
the port's own copy of ``centermask2_tpu/evaluation/cityscapes_semseg.py``,
numpy only, PIL read only by ``evaluate_semseg_dirs``).

Replicates cityscapesscripts' evalPixelLevelSemanticLabeling — the
engine behind the reference's CityscapesSemSegEvaluator
(reference cityscapes_evaluation.py:133-198) — without the
cityscapesscripts dependency: a confusion matrix over label-id pngs vs
``*_gtFine_labelIds.png``, per-class IoU over the 19 eval classes, the
category (super-class) IoU, and the instance-weighted iIoU variants
when ``*_gtFine_instanceIds.png`` files are available.

Official scoring rules implemented here:
- confusion rows = ground-truth label, columns = prediction; every gt
  pixel participates (void rows included),
- class IoU = tp / (tp + fp + fn) with fp counted only from rows whose
  gt label is evaluated (predictions on void ground truth are never
  penalized) and fn over the full gt row,
- category IoU sums the member-class block of the confusion matrix;
  cross-class confusion INSIDE a category counts as tp,
- iIoU weights each gt instance's tp/fn by avgSize/instanceSize so
  small instances count as much as large ones. The official protocol's
  fixed average instance sizes (precomputed on the train split) are
  embedded below (AVG_CLASS_SIZE / AVG_CATEGORY_SIZE), so ``iIoU`` /
  ``iIoU_sup`` here are true-protocol numbers. ``iIoU_datanorm`` /
  ``iIoU_sup_datanorm`` variants are additionally reported with the
  normalizers computed from the evaluated ground truth, for use on
  non-Cityscapes data where the train-split constants don't apply.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Official label table: id -> (name, category, ignoreInEval)
LABELS: Dict[int, Tuple[str, str, bool]] = {
    0: ("unlabeled", "void", True),
    1: ("ego vehicle", "void", True),
    2: ("rectification border", "void", True),
    3: ("out of roi", "void", True),
    4: ("static", "void", True),
    5: ("dynamic", "void", True),
    6: ("ground", "void", True),
    7: ("road", "flat", False),
    8: ("sidewalk", "flat", False),
    9: ("parking", "flat", True),
    10: ("rail track", "flat", True),
    11: ("building", "construction", False),
    12: ("wall", "construction", False),
    13: ("fence", "construction", False),
    14: ("guard rail", "construction", True),
    15: ("bridge", "construction", True),
    16: ("tunnel", "construction", True),
    17: ("pole", "object", False),
    18: ("polegroup", "object", True),
    19: ("traffic light", "object", False),
    20: ("traffic sign", "object", False),
    21: ("vegetation", "nature", False),
    22: ("terrain", "nature", False),
    23: ("sky", "sky", False),
    24: ("person", "human", False),
    25: ("rider", "human", False),
    26: ("car", "vehicle", False),
    27: ("truck", "vehicle", False),
    28: ("bus", "vehicle", False),
    29: ("caravan", "vehicle", True),
    30: ("trailer", "vehicle", True),
    31: ("train", "vehicle", False),
    32: ("motorcycle", "vehicle", False),
    33: ("bicycle", "vehicle", False),
}
EVAL_IDS = [i for i, (_, _, ig) in LABELS.items() if not ig]
# instance-able classes among the evaluated ones (iIoU set)
INSTANCE_EVAL_IDS = [24, 25, 26, 27, 28, 31, 32, 33]
_N = 256  # confusion side (labels are uint8; 255 = ignore)

# Official cityscapesscripts normalizers for protocol iIoU: average
# instance size per class / per category, precomputed on the train split
# (cityscapesscripts evalPixelLevelSemanticLabeling.py, args.avgClassSize
# / args.avgCategorySize — the engine behind the reference's
# CityscapesSemSegEvaluator, reference cityscapes_evaluation.py:133-198).
# Embedding them lets score_semseg report true-protocol iIoU alongside
# the _datanorm variants.
AVG_CLASS_SIZE: Dict[str, float] = {
    "bicycle": 4672.3249222261,
    "caravan": 36771.8241758242,
    "motorcycle": 6298.7200839748,
    "rider": 3930.4788056518,
    "bus": 35732.1511111111,
    "train": 67583.7075812274,
    "car": 12794.0202738185,
    "person": 3462.4756337644,
    "truck": 27855.1264367816,
    "trailer": 16926.9763313609,
}
AVG_CATEGORY_SIZE: Dict[str, float] = {
    "vehicle": 9691.1128802817,
    "human": 3508.7580814139,
}


def add_to_confusion(pred: np.ndarray, gt: np.ndarray,
                     conf: np.ndarray) -> None:
    """conf[gt, pred] += counts, full-image (official generateMatrix)."""
    idx = gt.astype(np.int64).reshape(-1) * _N + pred.astype(np.int64).reshape(-1)
    conf += np.bincount(idx, minlength=_N * _N).reshape(_N, _N)


def _class_iou(conf: np.ndarray, label: int) -> float:
    tp = float(conf[label, label])
    fn = float(conf[label, :].sum()) - tp
    others = [l for l in EVAL_IDS if l != label]
    fp = float(conf[others, label].sum())
    denom = tp + fp + fn
    return tp / denom if denom > 0 else float("nan")


def _category_iou(conf: np.ndarray, category: str) -> float:
    members = [i for i in EVAL_IDS if LABELS[i][1] == category]
    if not members:
        return float("nan")
    block = conf[np.ix_(members, members)]
    tp = float(block.sum())
    fn = float(conf[members, :].sum()) - tp
    outside = [l for l in EVAL_IDS if LABELS[l][1] != category]
    fp = float(conf[np.ix_(outside, members)].sum())
    denom = tp + fp + fn
    return tp / denom if denom > 0 else float("nan")


class InstanceStats:
    """Accumulates instance-weighted tp/fn for the iIoU metrics."""

    def __init__(self):
        # per class: list of (instance_size, matched_pixels)
        self.by_class: Dict[int, List[Tuple[int, int]]] = {
            c: [] for c in INSTANCE_EVAL_IDS}

    def add_image(self, pred: np.ndarray, inst_gt: np.ndarray) -> None:
        """inst_gt: *_gtFine_instanceIds.png values (labelId*1000 + n for
        instances, plain labelId otherwise)."""
        inst_ids = np.unique(inst_gt[inst_gt >= 1000])
        for iid in inst_ids:
            label = int(iid) // 1000
            if label not in self.by_class:
                continue
            m = inst_gt == iid
            self.by_class[label].append(
                (int(m.sum()), int((pred[m] == label).sum())))

    def _weighted(self, classes: Sequence[int],
                  avg_size: Optional[float] = None) -> Tuple[float, float]:
        """avg_size=None: data-normalized (mean size of the evaluated GT
        instances); avg_size=<float>: official protocol constant."""
        if avg_size is None:
            sizes = [s for c in classes for (s, _) in self.by_class[c]]
            if not sizes:
                return 0.0, 0.0
            avg_size = float(np.mean(sizes))
        tp_w = fn_w = 0.0
        for c in classes:
            for size, matched in self.by_class[c]:
                w = avg_size / size
                tp_w += matched * w
                fn_w += (size - matched) * w
        return tp_w, fn_w

    def class_iiou(self, conf: np.ndarray, label: int,
                   avg_size: Optional[float] = None) -> float:
        tp_w, fn_w = self._weighted([label], avg_size)
        others = [l for l in EVAL_IDS if l != label]
        fp = float(conf[others, label].sum())
        denom = tp_w + fp + fn_w
        return tp_w / denom if denom > 0 else float("nan")

    def category_iiou(self, conf: np.ndarray, category: str,
                      avg_size: Optional[float] = None) -> float:
        members = [c for c in INSTANCE_EVAL_IDS if LABELS[c][1] == category]
        if not members:
            return float("nan")
        tp_w, fn_w = self._weighted(members, avg_size)
        outside = [l for l in EVAL_IDS if LABELS[l][1] != category]
        fp = float(conf[np.ix_(outside, members)].sum())
        denom = tp_w + fp + fn_w
        return tp_w / denom if denom > 0 else float("nan")


def score_semseg(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    instance_pairs: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
) -> Dict[str, float]:
    """pairs: (pred_label_ids, gt_label_ids) uint8 images;
    instance_pairs: optional (pred_label_ids, gt_instance_ids) for iIoU.
    Returns the reference's metric block as {IoU, iIoU, IoU_sup,
    iIoU_sup} (percentages; cityscapes_evaluation.py:192-197) plus
    per-class IoUs and the ``*_datanorm`` iIoU variants (instance
    weighting from the evaluated GT instead of the official train-split
    constants — see module docstring).
    """
    conf = np.zeros((_N, _N), np.int64)
    for pred, gt in pairs:
        assert pred.shape == gt.shape, (pred.shape, gt.shape)
        add_to_confusion(pred, gt, conf)

    per_class = {LABELS[i][0]: _class_iou(conf, i) for i in EVAL_IDS}
    vals = [v for v in per_class.values() if not np.isnan(v)]
    categories = sorted({LABELS[i][1] for i in EVAL_IDS})
    per_cat = {c: _category_iou(conf, c) for c in categories}
    cat_vals = [v for v in per_cat.values() if not np.isnan(v)]

    out = {
        "IoU": 100.0 * float(np.mean(vals)) if vals else float("nan"),
        "IoU_sup": 100.0 * float(np.mean(cat_vals))
        if cat_vals else float("nan"),
    }
    out.update({f"IoU-{n}": 100.0 * v for n, v in per_class.items()})

    if instance_pairs is not None:
        stats = InstanceStats()
        for pred, inst in instance_pairs:
            stats.add_image(pred, inst)
        icats = sorted({LABELS[c][1] for c in INSTANCE_EVAL_IDS})
        # Official-protocol iIoU / iIoU_sup: instance weights use the
        # cityscapesscripts train-split constants (AVG_CLASS_SIZE /
        # AVG_CATEGORY_SIZE above) — numerically reproduces the
        # reference's CityscapesSemSegEvaluator output.
        pvals = [stats.class_iiou(conf, c, AVG_CLASS_SIZE[LABELS[c][0]])
                 for c in INSTANCE_EVAL_IDS]
        pvals = [v for v in pvals if not np.isnan(v)]
        pcat_vals = [stats.category_iiou(conf, c, AVG_CATEGORY_SIZE[c])
                     for c in icats if c in AVG_CATEGORY_SIZE]
        pcat_vals = [v for v in pcat_vals if not np.isnan(v)]
        out["iIoU"] = (100.0 * float(np.mean(pvals))
                       if pvals else float("nan"))
        out["iIoU_sup"] = (100.0 * float(np.mean(pcat_vals))
                           if pcat_vals else float("nan"))
        # _datanorm variants: instance weights use the average instance
        # size computed from the EVALUATED ground truth instead — useful
        # on non-Cityscapes data where the train-split constants don't
        # apply; kept under a distinct suffix so they are never mistaken
        # for official-protocol numbers.
        ivals = [stats.class_iiou(conf, c) for c in INSTANCE_EVAL_IDS]
        ivals = [v for v in ivals if not np.isnan(v)]
        icat_vals = [stats.category_iiou(conf, c) for c in icats]
        icat_vals = [v for v in icat_vals if not np.isnan(v)]
        out["iIoU_datanorm"] = (100.0 * float(np.mean(ivals))
                                if ivals else float("nan"))
        out["iIoU_sup_datanorm"] = 100.0 * float(np.mean(icat_vals)) \
            if icat_vals else float("nan")
    return out


def evaluate_semseg_dirs(pred_dir: str, gt_dir: str) -> Dict[str, float]:
    """Score ``{basename}_pred.png`` files in ``pred_dir`` against
    ``*_gtFine_labelIds.png`` under ``gt_dir`` (city subdirs), with iIoU
    when the matching ``*_gtFine_instanceIds.png`` files exist."""
    from PIL import Image

    gt_files = sorted(glob.glob(
        os.path.join(gt_dir, "*", "*_gtFine_labelIds.png")))
    if not gt_files:  # flat layout fallback
        gt_files = sorted(glob.glob(
            os.path.join(gt_dir, "*_gtFine_labelIds.png")))
    pairs, instance_pairs = [], []
    have_instances = True
    for gt_path in gt_files:
        base = os.path.basename(gt_path)[: -len("_gtFine_labelIds.png")]
        pred_path = os.path.join(pred_dir, base + "_leftImg8bit_pred.png")
        if not os.path.exists(pred_path):
            pred_path = os.path.join(pred_dir, base + "_pred.png")
        if not os.path.exists(pred_path):
            raise FileNotFoundError(f"no prediction for {gt_path}")
        pred = np.asarray(Image.open(pred_path))
        gt = np.asarray(Image.open(gt_path))
        pairs.append((pred, gt))
        inst_path = gt_path.replace("_labelIds.png", "_instanceIds.png")
        if os.path.exists(inst_path):
            inst = np.asarray(Image.open(inst_path))
            instance_pairs.append((pred, inst.astype(np.int64)))
        else:
            have_instances = False
    return score_semseg(pairs, instance_pairs if have_instances else None)
