"""Cityscapes instance and semantic evaluation (the port's own copy of
``centermask2_tpu/evaluation/cityscapes_eval.py``).

Rebuilt from reference evaluation/cityscapes_evaluation.py:47-198: both
evaluators write per-image prediction files in the cityscapesscripts
exchange format (instance: a .txt listing per-instance mask .png files
with class id and confidence; semseg: id-encoded .pngs) and then score
them. The mask-score substitution carries over: instance confidences are
``mask_scores`` (cityscapes_evaluation.py:67-77).

The metric pass uses the official cityscapesscripts package when it is
importable, and otherwise the built-in scorers
(``cityscapes_scoring.py``, ``cityscapes_semseg.py``: the same published
algorithms, numpy only), which also score arrays directly
(``score_instances``, ``score_semseg``). PIL is imported only where a PNG
is written or read.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

# Cityscapes instance classes: name -> (train_id, label_id)
CITYSCAPES_INSTANCE_CLASSES = {
    "person": (0, 24),
    "rider": (1, 25),
    "car": (2, 26),
    "truck": (3, 27),
    "bus": (4, 28),
    "train": (5, 31),
    "motorcycle": (6, 32),
    "bicycle": (7, 33),
}
TRAIN_ID_TO_LABEL_ID = {t: l for t, l in CITYSCAPES_INSTANCE_CLASSES.values()}

# Semantic-segmentation train ids (cityscapesscripts trainId2label): the
# 19 eval classes in official order. Distinct from the 8-class INSTANCE
# train ids above — the semseg evaluator must use THIS table.
SEMSEG_TRAIN_ID_TO_LABEL_ID = {
    0: 7, 1: 8, 2: 11, 3: 12, 4: 13, 5: 17, 6: 19, 7: 20, 8: 21, 9: 22,
    10: 23, 11: 24, 12: 25, 13: 26, 14: 27, 15: 28, 16: 31, 17: 32, 18: 33,
}


class CityscapesInstanceEvaluator:
    """Writes {basename}.txt + per-instance mask pngs
    (reference cityscapes_evaluation.py:47-130)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._written: List[str] = []

    def reset(self):
        self._written = []

    def process(self, file_name: str, outputs: Dict[str, np.ndarray]) -> None:
        """outputs: pred_classes (train ids), mask_scores (the fork's
        rescored confidences), pred_masks (R, H, W) bool."""
        from PIL import Image

        basename = os.path.splitext(os.path.basename(file_name))[0]
        txt_path = os.path.join(self.output_dir, basename + "_pred.txt")
        classes = np.asarray(outputs["pred_classes"])
        scores = np.asarray(outputs.get("mask_scores", outputs.get("scores")))
        masks = np.asarray(outputs["pred_masks"])
        lines = []
        for i in range(len(classes)):
            label_id = TRAIN_ID_TO_LABEL_ID.get(int(classes[i]))
            if label_id is None:
                continue
            png_name = f"{basename}_{i}_{label_id}.png"
            Image.fromarray(masks[i].astype(np.uint8) * 255).save(
                os.path.join(self.output_dir, png_name))
            lines.append(f"{png_name} {label_id} {float(scores[i]):.6f}")
        with open(txt_path, "w") as f:
            f.write("\n".join(lines))
        self._written.append(txt_path)

    def evaluate(self, gt_dir: Optional[str] = None) -> Dict[str, float]:
        try:
            import cityscapesscripts.evaluation.evalInstanceLevelSemanticLabeling as ev
        except ImportError:
            if gt_dir is None:
                return {
                    "note": "no gt_dir given; predictions written to "
                            f"{self.output_dir} for offline scoring",
                    "num_images": len(self._written),
                }
            # built-in scorer implementing the official algorithm
            # (evaluation/cityscapes_scoring.py)
            from .cityscapes_scoring import evaluate_prediction_dir

            return evaluate_prediction_dir(self.output_dir, gt_dir)
        ev.args.predictionPath = os.path.abspath(self.output_dir)
        ev.args.predictionWalk = None
        ev.args.JSONOutput = False
        ev.args.colorized = False
        gt_glob = os.path.join(gt_dir, "*", "*_gtFine_instanceIds.png")
        gt_images = glob.glob(gt_glob)
        preds = [ev.getPrediction(ev.args, gt) for gt in gt_images]
        results = ev.evaluateImgLists(preds, gt_images, ev.args)["averages"]
        return {"AP": results["allAp"] * 100,
                "AP50": results["allAp50%"] * 100}


class CityscapesSemSegEvaluator:
    """Writes id-encoded semantic pngs
    (reference cityscapes_evaluation.py:133-198)."""

    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._written: List[str] = []

    def reset(self):
        self._written = []

    def process(self, file_name: str, sem_seg: np.ndarray,
                train_id_to_label_id: Optional[Dict[int, int]] = None) -> None:
        from PIL import Image

        basename = os.path.splitext(os.path.basename(file_name))[0]
        mapping = train_id_to_label_id or SEMSEG_TRAIN_ID_TO_LABEL_ID
        out = np.full(sem_seg.shape, 255, np.uint8)
        for t, l in mapping.items():
            out[sem_seg == t] = l
        path = os.path.join(self.output_dir, basename + "_pred.png")
        Image.fromarray(out).save(path)
        self._written.append(path)

    def evaluate(self, gt_dir: Optional[str] = None) -> Dict[str, float]:
        """Score the written label pngs with the built-in pixel-level
        scorer (evaluation/cityscapes_semseg.py — class mIoU and
        category IoU_sup per the official algorithm, plus
        official-protocol iIoU/iIoU_sup via the embedded train-split
        avgClassSize/avgCategorySize constants when instanceIds files
        exist, and data-normalized *_datanorm variants — see that
        module's docstring). Returns the reference's metric block
        (cityscapes_evaluation.py:192-197) with no cityscapesscripts
        dependency."""
        if gt_dir is None:
            return {
                "note": "no gt_dir given; predictions written to "
                        f"{self.output_dir} for offline scoring",
                "num_images": len(self._written),
            }
        from .cityscapes_semseg import evaluate_semseg_dirs

        return evaluate_semseg_dirs(self.output_dir, gt_dir)
