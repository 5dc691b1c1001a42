"""Self-contained COCO detection/segmentation evaluation (the port's own
copy of ``centermask2_tpu/evaluation/coco_eval.py``).

Reimplements the COCOeval protocol the reference uses through pycocotools
(reference: evaluation/coco_evaluation.py:543-592) — per-category greedy
matching at IoU thresholds 0.5:0.05:0.95, 101-point interpolated
precision, area ranges, maxDets — plus the fork's defining twist: for
segm evaluation, each instance's ``mask_score`` (MaskIoU-rescored)
replaces its box ``score`` (coco_evaluation.py:551-563).

No pycocotools dependency: IoU kernels come from the native RLE library
(evaluation/rle.py -> native/maskapi.cpp).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import rle as rle_lib

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
MAX_DETS = (1, 10, 100)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
# keypoint (OKS) protocol: maxDets [20], no "small" area bucket
# (pycocotools Params.setKpParams)
KPT_MAX_DETS = (20,)
KPT_AREA_RNG = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
# COCO 17-keypoint OKS sigmas (cocodataset.org/#keypoints-eval)
COCO_KPT_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89]) / 10.0


def compute_oks(
    dt_kpts: np.ndarray,  # (D, K*3) flattened x, y, v
    gts: List[Dict],
    sigmas: np.ndarray,
) -> np.ndarray:
    """pycocotools computeOks: per (dt, gt) object keypoint similarity.
    gts are COCO annotations with 'keypoints', 'bbox', 'area'."""
    D, G = len(dt_kpts), len(gts)
    ious = np.zeros((D, G))
    if D == 0 or G == 0:
        return ious
    variances = (sigmas * 2.0) ** 2
    k = len(sigmas)
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        bb = gt["bbox"]
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i in range(D):
            d = np.asarray(dt_kpts[i], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:  # no visible gt keypoints: distance to the doubled bbox
                dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
                dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
            e = (dx**2 + dy**2) / variances / (gt["area"] + np.spacing(1)) / 2
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.sum(np.exp(-e)) / e.shape[0] if e.shape[0] else 0.0
    return ious


class COCOGt:
    """Minimal COCO ground-truth container (from a COCO-format dict/json)."""

    def __init__(self, dataset: Dict):
        self.dataset = dataset
        self.imgs = {im["id"]: im for im in dataset.get("images", [])}
        self.cats = {c["id"]: c for c in dataset.get("categories", [])}
        self.img_to_anns = defaultdict(list)
        for ann in dataset.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)

    @classmethod
    def from_json(cls, path: str) -> "COCOGt":
        with open(path) as f:
            return cls(json.load(f))

    def ann_rle(self, ann: Dict) -> rle_lib.RLE:
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        seg = ann.get("segmentation")
        if isinstance(seg, dict):
            return rle_lib.from_coco(seg)
        return rle_lib.polygons_to_rle(seg, h, w)


def _match_image(
    dts: List[Dict], gts: List[Dict], ious: np.ndarray,
    area_rng, max_det: int, use_native: bool = True,
    gt_extra_ignore: Optional[np.ndarray] = None,
):
    """COCOeval.evaluateImg for one (img, cat, areaRng, maxDet).

    The O(T*D*G) greedy matching runs in native code by default
    (maskapi.cpp:coco_match — the reference stack's COCOeval_opt
    equivalent, coco_evaluation.py:25,566); ``use_native=False`` selects
    the pure-Python loop kept as the parity oracle. ``gt_extra_ignore``
    adds per-gt forced ignores (keypoint eval ignores gts with zero
    annotated keypoints, pycocotools COCOeval._prepare)."""
    T = len(IOU_THRS)
    gt_ignore = np.array(
        [bool(g.get("iscrowd", 0)) or g["area"] < area_rng[0]
         or g["area"] > area_rng[1] for g in gts], bool)
    if gt_extra_ignore is not None and len(gts):
        gt_ignore = gt_ignore | np.asarray(gt_extra_ignore, bool)
    # gts sorted: non-ignored first
    gt_order = np.argsort(gt_ignore, kind="stable")
    gts_sorted = [gts[i] for i in gt_order]
    gt_ig = gt_ignore[gt_order]

    dt_order = np.argsort([-d["score"] for d in dts], kind="stable")[:max_det]
    dts_sorted = [dts[i] for i in dt_order]

    iou_m = ious[dt_order][:, gt_order] if len(dts) and len(gts) else \
        np.zeros((len(dts_sorted), len(gts_sorted)))

    D, G = len(dts_sorted), len(gts_sorted)
    if use_native:
        dt_matches, _, dt_ignore = rle_lib.coco_match(
            IOU_THRS, iou_m, gt_ig,
            np.array([g.get("iscrowd", 0) for g in gts_sorted], np.uint8),
            np.array([g["id"] for g in gts_sorted], np.int64),
            np.array([d["id"] for d in dts_sorted], np.int64))
    else:
        dt_matches = np.zeros((T, D), np.int64)
        gt_matches = np.zeros((T, G), np.int64)
        dt_ignore = np.zeros((T, D), bool)
        for t, thr in enumerate(IOU_THRS):
            for d in range(D):
                best = min(thr, 1 - 1e-10)
                m = -1
                for g in range(G):
                    if gt_matches[t, g] > 0 and not gts_sorted[g].get("iscrowd", 0):
                        continue
                    # stop at ignored gt if a real match was already found
                    if m > -1 and not gt_ig[m] and gt_ig[g]:
                        break
                    if iou_m[d, g] < best:
                        continue
                    best = iou_m[d, g]
                    m = g
                if m == -1:
                    continue
                dt_ignore[t, d] = gt_ig[m]
                dt_matches[t, d] = gts_sorted[m]["id"]
                gt_matches[t, m] = dts_sorted[d]["id"]

    # unmatched dts outside area range are ignored
    a = np.array([
        d["area"] < area_rng[0] or d["area"] > area_rng[1]
        for d in dts_sorted], bool)
    dt_ignore = dt_ignore | ((dt_matches == 0) & a[None, :])

    return {
        "dt_scores": np.array([d["score"] for d in dts_sorted]),
        "dt_matches": dt_matches,
        "dt_ignore": dt_ignore,
        "num_gt": int((~gt_ig).sum()),
    }


class COCOEval:
    """COCOeval-compatible accumulate/summarize on (gt, detections).

    iou_type "keypoints" runs the OKS protocol (pycocotools kp params:
    maxDets [20], areas all/medium/large, metrics AP/AP50/AP75/APm/APl —
    reference coco_evaluation.py:64,80,310)."""

    def __init__(self, gt: COCOGt, iou_type: str = "bbox",
                 kpt_sigmas: Optional[Sequence[float]] = None):
        assert iou_type in ("bbox", "segm", "keypoints")
        self.gt = gt
        self.iou_type = iou_type
        self.img_ids = sorted(gt.imgs.keys())
        self.cat_ids = sorted(gt.cats.keys())
        if iou_type == "keypoints":
            self.max_dets = list(KPT_MAX_DETS)
            self.area_rng = dict(KPT_AREA_RNG)
            self.kpt_sigmas = np.asarray(
                kpt_sigmas if kpt_sigmas is not None and len(kpt_sigmas)
                else COCO_KPT_SIGMAS, np.float64)
        else:
            self.max_dets = list(MAX_DETS)
            self.area_rng = dict(AREA_RNG)

    def _dt_area(self, det: Dict) -> float:
        if self.iou_type == "segm":
            return float(rle_lib.area(rle_lib.from_coco(det["segmentation"])))
        if self.iou_type == "keypoints":
            # pycocotools loadRes: keypoint-extent area
            kp = np.asarray(det["keypoints"], np.float64)
            x, y = kp[0::3], kp[1::3]
            return float((x.max() - x.min()) * (y.max() - y.min()))
        b = det["bbox"]
        return float(b[2] * b[3])

    def _gt_extra_ignore(self, gts: List[Dict]) -> Optional[np.ndarray]:
        if self.iou_type != "keypoints":
            return None
        # ignore gts with no annotated keypoints (COCOeval._prepare)
        return np.array([
            int(g.get("num_keypoints",
                      int(np.count_nonzero(
                          np.asarray(g.get("keypoints", []))[2::3] > 0))
                      if "keypoints" in g else 0)) == 0
            for g in gts], bool)

    def evaluate(self, detections: List[Dict]) -> Dict[str, float]:
        """detections: COCO results list (bbox xywh and/or segmentation RLE
        + score + category_id + image_id). Returns the standard metrics."""
        dt_by_key = defaultdict(list)
        next_id = 1
        for det in detections:
            det = dict(det)
            det["id"] = next_id
            next_id += 1
            det["area"] = self._dt_area(det)
            dt_by_key[(det["image_id"], det["category_id"])].append(det)

        gt_by_key = defaultdict(list)
        for img_id in self.img_ids:
            for ann in self.gt.img_to_anns[img_id]:
                gt_by_key[(img_id, ann["category_id"])].append(ann)

        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(self.area_rng), len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        area_items = list(self.area_rng.items())
        for k, cat in enumerate(self.cat_ids):
            per_img = []
            for img_id in self.img_ids:
                dts = dt_by_key.get((img_id, cat), [])
                gts = gt_by_key.get((img_id, cat), [])
                if not dts and not gts:
                    per_img.append(None)
                    continue
                ious = self._iou(dts, gts)
                per_img.append((dts, gts, ious, self._gt_extra_ignore(gts)))

            for a, (_, rng) in enumerate(area_items):
                for m, max_det in enumerate(self.max_dets):
                    evals = [
                        _match_image(dts, gts, ious, rng, max_det,
                                     gt_extra_ignore=extra)
                        for entry in per_img if entry is not None
                        for (dts, gts, ious, extra) in [entry]
                    ]
                    if not evals:
                        continue
                    scores = np.concatenate([e["dt_scores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    matches = np.concatenate(
                        [e["dt_matches"] for e in evals], axis=1)[:, order]
                    ignore = np.concatenate(
                        [e["dt_ignore"] for e in evals], axis=1)[:, order]
                    num_gt = sum(e["num_gt"] for e in evals)
                    if num_gt == 0:
                        continue
                    tps = (matches > 0) & ~ignore
                    fps = (matches == 0) & ~ignore
                    tp_sum = np.cumsum(tps, axis=1).astype(float)
                    fp_sum = np.cumsum(fps, axis=1).astype(float)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / num_gt
                        pr = tp / np.maximum(tp + fp, np.finfo(float).eps)
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # precision envelope (monotone decreasing)
                        q = np.zeros(R)
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                        precision[t, :, k, a, m] = q

        self.precision = precision
        self.recall = recall
        return self._summarize()

    def _iou(self, dts: List[Dict], gts: List[Dict]) -> np.ndarray:
        """IoU matrix in ORIGINAL detection order (rows = dts as given).

        _match_image applies the single score-sort permutation
        (ious[dt_order]); sorting here too would double-permute and
        misalign rows whenever the input isn't already score-sorted —
        which segm eval always is not, after mask_score substitution.
        """
        if not dts or not gts:
            return np.zeros((len(dts), len(gts)))
        if self.iou_type == "keypoints":
            return compute_oks(
                np.array([d["keypoints"] for d in dts], np.float64),
                gts, self.kpt_sigmas)
        crowd = [int(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "bbox":
            d = np.array([x["bbox"] for x in dts], np.float64)
            g = np.array([x["bbox"] for x in gts], np.float64)
            return rle_lib.bbox_iou(d, g, crowd)
        d_rles = [rle_lib.from_coco(x["segmentation"]) for x in dts]
        g_rles = [self.gt.ann_rle(x) for x in gts]
        return rle_lib.iou(d_rles, g_rles, crowd)

    def per_category_ap(self, max_det: Optional[int] = None) -> Dict[str, float]:
        """Per-category AP table (reference coco_evaluation.py:345-356)."""
        a = list(self.area_rng.keys()).index("all")
        m = self.max_dets.index(max_det if max_det is not None
                                else self.max_dets[-1])
        out = {}
        for k, cat_id in enumerate(self.cat_ids):
            p = self.precision[:, :, k, a, m]
            p = p[p > -1]
            name = self.gt.cats[cat_id].get("name", str(cat_id))
            out[name] = float(np.mean(p)) * 100 if p.size else float("nan")
        return out

    def _summarize(self) -> Dict[str, float]:
        def s_ap(iou_thr=None, area="all", max_det=100):
            a = list(self.area_rng.keys()).index(area)
            m = self.max_dets.index(max_det)
            p = self.precision[:, :, :, a, m]
            if iou_thr is not None:
                t = np.where(np.isclose(IOU_THRS, iou_thr))[0]
                p = p[t]
            p = p[p > -1]
            return float(np.mean(p)) * 100 if p.size else float("nan")

        def s_ar(area="all", max_det=100):
            a = list(self.area_rng.keys()).index(area)
            m = self.max_dets.index(max_det)
            r = self.recall[:, :, a, m]
            r = r[r > -1]
            return float(np.mean(r)) * 100 if r.size else float("nan")

        if self.iou_type == "keypoints":
            # keypoint summary metrics (reference coco_evaluation.py:310)
            return {
                "AP": s_ap(max_det=20),
                "AP50": s_ap(0.5, max_det=20),
                "AP75": s_ap(0.75, max_det=20),
                "APm": s_ap(area="medium", max_det=20),
                "APl": s_ap(area="large", max_det=20),
                "AR20": s_ar(max_det=20),
            }
        return {
            "AP": s_ap(),
            "AP50": s_ap(0.5),
            "AP75": s_ap(0.75),
            "APs": s_ap(area="small"),
            "APm": s_ap(area="medium"),
            "APl": s_ap(area="large"),
            "AR1": s_ar(max_det=1),
            "AR10": s_ar(max_det=10),
            "AR100": s_ar(max_det=100),
        }


PROPOSAL_AREAS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
    "96-128": (96.0**2, 128.0**2),
    "128-256": (128.0**2, 256.0**2),
    "256-512": (256.0**2, 512.0**2),
    "512-inf": (512.0**2, 1e10),
}


def evaluate_box_proposals(
    proposals: Dict[int, Dict[str, np.ndarray]],
    gt: COCOGt,
    limit: int = 100,
    area: str = "all",
) -> Dict[str, np.ndarray]:
    """Class-agnostic proposal recall (AR@limit), the reference's
    _evaluate_box_proposals (coco_evaluation.py:432-540).

    proposals: image_id -> {"boxes": (N, 4) xyxy, "objectness": (N,)}.
    For each image, proposals are score-sorted and capped at ``limit``;
    each non-crowd, area-filtered gt greedily takes its best remaining
    proposal (global max-IoU pairing); AR averages recall over IoU
    thresholds 0.5:0.05:0.95.
    """
    area_rng = PROPOSAL_AREAS[area]
    gt_overlaps: List[np.ndarray] = []
    num_pos = 0
    for img_id in sorted(gt.imgs.keys()):
        entry = proposals.get(img_id)
        anns = gt.img_to_anns.get(img_id, [])
        gt_boxes = np.array(
            [[a["bbox"][0], a["bbox"][1],
              a["bbox"][0] + a["bbox"][2], a["bbox"][1] + a["bbox"][3]]
             for a in anns if not a.get("iscrowd", 0)
             and area_rng[0] <= a["area"] <= area_rng[1]],
            np.float64).reshape(-1, 4)
        num_pos += len(gt_boxes)
        if len(gt_boxes) == 0 or entry is None or len(entry["boxes"]) == 0:
            continue
        order = np.argsort(-np.asarray(entry["objectness"], np.float64),
                           kind="stable")[:limit]
        boxes = np.asarray(entry["boxes"], np.float64)[order]
        # xyxy -> xywh for the shared IoU kernel
        d = boxes.copy(); d[:, 2:] -= d[:, :2]
        g = gt_boxes.copy(); g[:, 2:] -= g[:, :2]
        overlaps = rle_lib.bbox_iou(d, g, [0] * len(g))

        matched = np.zeros(len(gt_boxes))
        ov = overlaps.copy()
        for _ in range(min(len(boxes), len(gt_boxes))):
            argmax = ov.argmax()
            di, gi = np.unravel_index(argmax, ov.shape)
            if ov[di, gi] < 0:
                break
            matched[gi] = ov[di, gi]
            ov[di, :] = -1
            ov[:, gi] = -1
        gt_overlaps.append(matched)

    gt_overlaps = (np.concatenate(gt_overlaps)
                   if gt_overlaps else np.zeros(0, np.float64))
    gt_overlaps = np.sort(gt_overlaps)
    thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    recalls = np.array(
        [(gt_overlaps >= t).sum() / float(max(num_pos, 1))
         for t in thresholds])
    return {
        "ar": float(recalls.mean()),
        "recalls": recalls,
        "thresholds": thresholds,
        "gt_overlaps": gt_overlaps,
        "num_pos": num_pos,
    }


def print_csv_format(results: Dict[str, Dict[str, float]]) -> str:
    """detectron2 print_csv_format analog (reference tester.py:130):
    per task, a 'copypaste:' header + comma-separated metric values.
    Per-category 'AP-{name}' keys are filtered out like detectron2's
    (`"-" not in k`), keeping the fixed reference column set."""
    lines = []
    for task, metrics in results.items():
        metrics = {k: v for k, v in metrics.items() if "-" not in k}
        lines.append(f"copypaste: Task: {task}")
        lines.append("copypaste: " + ",".join(metrics.keys()))
        lines.append("copypaste: " + ",".join(
            f"{v:.4f}" for v in metrics.values()))
    text = "\n".join(lines)
    print(text)
    return text


class COCOEvaluator:
    """The reference's mask-score-aware evaluator
    (coco_evaluation.py:33-359): collects per-image predictions, converts
    to COCO json records (instances_to_coco_json, :362-427 — including the
    mask_score field), and evaluates bbox + segm, substituting mask_score
    for score in segm scoring (:551-563)."""

    def __init__(self, gt: COCOGt, tasks=("bbox", "segm"),
                 category_id_map: Optional[Dict[int, int]] = None,
                 kpt_oks_sigmas: Optional[Sequence[float]] = None):
        self.gt = gt
        self.tasks = tasks
        self.kpt_oks_sigmas = kpt_oks_sigmas
        self.predictions: List[Dict] = []
        self.proposals: Dict[int, Dict[str, np.ndarray]] = {}
        # contiguous class index -> dataset category id
        if category_id_map is None:
            cat_ids = sorted(gt.cats.keys())
            category_id_map = {i: cid for i, cid in enumerate(cat_ids)}
        self.category_id_map = category_id_map

    def reset(self):
        self.predictions = []
        self.proposals = {}

    def process(self, image_id: int, outputs: Dict[str, np.ndarray]):
        """outputs: post-processed per-image dict with pred_boxes (xyxy),
        scores, pred_classes, pred_masks (R, h, w) bool, mask_scores."""
        boxes = np.asarray(outputs["pred_boxes"], np.float64)
        if boxes.size == 0:
            return
        xywh = boxes.copy()
        xywh[:, 2:] -= xywh[:, :2]
        scores = np.asarray(outputs["scores"], np.float64)
        classes = np.asarray(outputs["pred_classes"], np.int64)
        mask_scores = np.asarray(
            outputs.get("mask_scores", outputs["scores"]), np.float64)
        masks = outputs.get("pred_masks")
        # class-agnostic boxes for the proposal-AR mode
        # (reference _evaluate_box_proposals, coco_evaluation.py:432-540)
        self.proposals[image_id] = {"boxes": boxes, "objectness": scores}
        for i in range(len(boxes)):
            if int(classes[i]) not in self.category_id_map:
                # predicted class has no dataset category (e.g. an 80-class
                # model evaluated on a smaller-vocabulary dataset)
                self.num_unmapped = getattr(self, "num_unmapped", 0) + 1
                continue
            rec = {
                "image_id": image_id,
                "category_id": self.category_id_map[int(classes[i])],
                "bbox": xywh[i].tolist(),
                "score": float(scores[i]),
                "mask_score": float(mask_scores[i]),
            }
            if masks is not None and "segm" in self.tasks:
                rec["segmentation"] = rle_lib.to_coco(rle_lib.encode(masks[i]))
            kpts = outputs.get("pred_keypoints")
            if kpts is not None and "keypoints" in self.tasks:
                # predictions are float coordinates; COCO annotations are
                # pixel indices -> subtract 0.5 from x, y
                # (reference instances_to_coco_json, :402-427)
                kp = np.asarray(kpts[i], np.float64).copy()
                kp[:, :2] -= 0.5
                rec["keypoints"] = kp.flatten().tolist()
            self.predictions.append(rec)

    def evaluate(self) -> Dict[str, Dict[str, float]]:
        results = {}
        for task in self.tasks:
            preds = []
            for p in self.predictions:
                q = dict(p)
                if task == "segm":
                    if "segmentation" not in q:
                        continue
                    # the fork's substitution: segm scored by mask_score
                    q["score"] = q.get("mask_score", q["score"])
                    q.pop("bbox", None)
                if task == "keypoints" and "keypoints" not in q:
                    continue
                preds.append(q)
            ev = COCOEval(self.gt, task, kpt_sigmas=self.kpt_oks_sigmas)
            res = ev.evaluate(preds)
            # per-category AP keys, matching detectron2's
            # _derive_coco_results (reference coco_evaluation.py:345-356)
            res.update({f"AP-{n}": v for n, v in ev.per_category_ap().items()})
            results[task] = res
        return results

    def evaluate_proposals(
        self, limits=(100, 1000), areas=("all", "small", "medium", "large"),
    ) -> Dict[str, float]:
        """AR@{limits} by area over the collected class-agnostic boxes
        (reference 'box_proposals' task, coco_evaluation.py:254-271)."""
        out = {}
        for limit in limits:
            for area in areas:
                suffix = "" if area == "all" else area[0]
                stats = evaluate_box_proposals(
                    self.proposals, self.gt, limit=limit, area=area)
                out[f"AR{suffix}@{limit:d}"] = stats["ar"] * 100
        return out
