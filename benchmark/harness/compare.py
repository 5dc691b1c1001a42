"""The comparison that decides ``correct`` for a served model.

After the window, the plain reference (``benchmark/reference``, float32,
TF32 off) runs once over each sampled request's image at the canvas the
program computed at, and reads the program's outputs against its own,
teacher-forced where the program chose: at the location and class of
each served detection, and on each served box. Ties in the top-k or
near the NMS threshold can make the program and the reference choose
differently; reading the reference at the program's choices, and
comparing the ranked scores rather than the sets, leaves every layer in
the comparison and no choice to chance. The numbers, each the widest
over the sample's valid detections:

- ``score_gap``: a served score against the reference's
  sqrt(sigmoid(cls) sigmoid(ctr)) at its location and class (0 where the
  reference's class score is at or below the threshold);
- ``box_gap``: a served box's corners against the reference's box at its
  location, in units of that level's stride;
- ``mask_gap``: the root mean square difference of the logits of a
  served 28x28 mask and of the reference's mask for the served box and
  class (ROIAlign, SAG-Mask), over the root mean square of the
  reference's logits over all of the image's masks (probabilities
  clipped to [1e-6, 1 - 1e-6]);
- ``mask_score_gap``: a served mask score against the served score times
  the reference's MaskIoU output for the served box and class, over the
  served score times the root mean square of that box's MaskIoU outputs
  over all classes (a random MaskIoU head's outputs have no fixed
  scale: each box is read against its own);
- ``valid_gap``: the count of valid served detections against the
  count of the reference's own decode (two-stage top-k, class-aware
  NMS, post-NMS top-k): an exact comparison;
- ``set_gap``: the detections on which the served set and the
  reference's decode disagree, near ties left out (``set_gap`` below):
  an exact comparison of which detections the program picks;
- ``overlap``: the largest IoU of two valid served boxes of one class,
  in float32 as the NMS computes it; the configuration's NMS threshold
  (MODEL.FCOS.NMS_TH) is its limit.

The reference's own ranked scores are not compared: one box kept or
suppressed on either side of the NMS threshold shifts the list by a
place, so bfloat16 and float8 read alike there. ``set_gap`` compares
the sets instead, with the ties that the other limits allow left out.

A served detection off the location grid, or of a class out of range,
reads ``UNREADABLE``, and so does a number that is not a number.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

NUMBERS = ("score_gap", "box_gap", "mask_gap", "mask_score_gap",
           "valid_gap", "set_gap", "overlap")
EPS = 1e-6
UNREADABLE = 1e30


def gaps(ref, served: Dict[str, torch.Tensor], image_u8: torch.Tensor,
         canvas: Tuple[int, int], limits: Dict[str, float]
         ) -> Dict[str, float]:
    """The numbers of one request; ``served`` holds the program's seven
    outputs of a batch of one. ``limits``: the committed limits, whose
    ``score_gap``, ``box_gap`` and ``overlap`` set the ties that
    ``set_gap`` leaves out. Also ``judged``: the reference's candidates
    that ``set_gap`` held to a decision (not a number compared)."""
    dev = image_u8.device
    o = {k: v[0].to(dev) for k, v in served.items()}
    d = ref.dense(image_u8, canvas)
    own = ref.decode(d)
    valid = o["valid"].bool()
    out = {"valid_gap": float(abs(int(valid.sum()) - int(own["valid"].sum()))),
           "overlap": overlap(o["pred_boxes"][valid].float(),
                              o["pred_classes"][valid])}
    cls = o["pred_classes"][valid].long()
    idx = ref.index_of(d, o["locations"][valid].float().cpu().numpy())
    if (idx < 0).any() or bool((cls < 0).any()) or \
            bool((cls >= ref.classes).any()):
        out.update(score_gap=UNREADABLE, box_gap=UNREADABLE,
                   mask_gap=UNREADABLE, mask_score_gap=UNREADABLE,
                   set_gap=UNREADABLE, judged=0.0)
        return out
    idx_t = torch.from_numpy(idx).to(dev)
    out["set_gap"], out["judged"] = set_gap(
        ref, d, idx_t, cls, o["scores"][valid].float(),
        o["pred_boxes"][valid].float(), limits)
    if not bool(valid.any()):
        out.update(score_gap=0.0, box_gap=0.0, mask_gap=0.0,
                   mask_score_gap=0.0)
        return out
    ref_score = torch.sqrt(d.masked[idx_t, cls].clamp_min(0.0))
    out["score_gap"] = float((o["scores"][valid].float() - ref_score)
                             .abs().max())
    boxes = o["pred_boxes"][valid].float()
    out["box_gap"] = float(((boxes - d.boxes[idx_t]).abs()
                            / d.strides[idx_t][:, None]).max())
    lr, iou = ref.roi_outputs(d, boxes, cls, float(canvas[0] * canvas[1]))
    lr = logit(torch.sigmoid(lr))
    lp = logit(o["pred_masks"][valid].float().reshape(lr.shape))
    per_mask = (lp - lr).pow(2).mean(dim=(1, 2)).sqrt()
    out["mask_gap"] = float(per_mask.max()
                            / lr.pow(2).mean().sqrt().clamp_min(EPS))
    s_p = o["scores"][valid].float()
    sel = iou[torch.arange(len(cls), device=dev), cls]
    out["mask_score_gap"] = float(
        ((o["mask_scores"][valid].float() - s_p * sel).abs()
         / (s_p * iou.pow(2).mean(dim=1).sqrt()).clamp_min(EPS)).max())
    return {k: UNREADABLE if math.isnan(v) else v for k, v in out.items()}


def set_gap(ref, d, idx: torch.Tensor, cls: torch.Tensor,
            scores: torch.Tensor, boxes: torch.Tensor,
            limits: Dict[str, float]) -> Tuple[float, float]:
    """(disagreements, candidates judged) between the served set and the
    reference's decode.

    The served set is held to the rule that defines the reference's
    decode, over the reference's candidates (its top-K pairs of location
    and class) with their float32 scores and boxes: greedy NMS and a
    post-NMS top-k keep a set S exactly when no two kept boxes of a class
    overlap above NMS_TH (``overlap``), every candidate outside S is
    suppressed by a higher kept box of its class or ranks below the last
    of a full S, and every member of S is a candidate. Without ties this
    is S equal to the reference's own decode. Two kinds of
    disagreement are counted:

    - a candidate not served and not explained: not within 2 ``tie`` of
      the K-th candidate's score (a full candidate list), not within
      ``tie`` of the lowest served score (a full served list), and not
      overlapped by a served box of its class scored at least its score
      less ``tie``, at an IoU above NMS_TH less the rounding that
      ``overlap``'s limit allows, where the candidate's box may lie
      ``box_gap`` strides off the reference's;
    - a served detection that is no candidate of the reference's and
      scores more than 2 ``tie`` below the K-th candidate.

    ``tie`` is the ``score_gap`` limit: a served score may lie that far
    from the reference's, so two scores closer than twice it may swap.
    These ties are what the other numbers allow, so a cascade of them
    (a box kept on one side of the threshold, and what it suppresses)
    stays explained, and nothing else does. ``judged``: the candidates
    above every tie, each of which has to be served or suppressed.
    """
    tie = float(limits["score_gap"])
    th = ref.nms_thresh - (float(limits["overlap"]) - ref.nms_thresh)
    c = ref.candidates(d)
    ok = c["valid"]
    c_loc, c_cls, c_s = c["loc"][ok], c["cls"][ok], c["scores"][ok]
    full_k = len(ok) == ref.candidates_k and bool(ok.all())
    s_k = float(c_s.min()) if full_k else 0.0
    C = ref.classes
    c_key, s_key = c_loc * C + c_cls, idx * C + cls
    judge = torch.ones_like(c_s, dtype=torch.bool)
    if full_k:
        judge &= c_s >= s_k + 2 * tie
    if len(scores) >= ref.topk:
        judge &= c_s > float(scores.min()) + tie
    judged = float(judge.sum())
    open_ = judge & ~torch.isin(c_key, s_key)
    if len(scores):
        eps = float(limits["box_gap"]) * d.strides[c_loc]
        hit = ((c_cls[:, None] == cls[None, :])
               & (scores[None, :] >= c_s[:, None] - tie)
               & (iou_upper(boxes, d.boxes[c_loc], eps) > th))
        open_ &= ~hit.any(dim=1)
    ref_s = torch.sqrt(d.masked[idx, cls].clamp_min(0.0))
    extra = ~torch.isin(s_key, c_key) & (ref_s < s_k - 2 * tie)
    return float(open_.sum() + extra.sum()), judged


def iou_upper(a: torch.Tensor, b: torch.Tensor, eps: torch.Tensor
              ) -> torch.Tensor:
    """(N, S): an upper bound of the IoU of each box of ``a`` (S, 4) with
    any box whose corners lie within ``eps`` (N,) of the box of ``b``
    (N, 4): the intersection with b grown by eps, over the union with b
    shrunk by eps (the IoU grows with the one and falls with the
    other); 0 where even the grown box does not meet it."""
    e = eps[:, None]
    grown = torch.cat([b[:, :2] - e, b[:, 2:] + e], 1)
    shrunk_wh = (b[:, 2:] - b[:, :2] - 2 * e).clamp_min(0.0)
    lt = torch.maximum(grown[:, None, :2], a[None, :, :2])
    rb = torch.minimum(grown[:, None, 2:], a[None, :, 2:])
    inter = (rb - lt).clamp_min(0.0).prod(-1)
    area_a = (a[:, 2:] - a[:, :2]).clamp_min(0.0).prod(-1)
    den = area_a[None, :] + shrunk_wh.prod(-1)[:, None] - inter
    bound = torch.where(den > 0, inter / torch.where(den > 0, den, 1.0),
                        1.0).clamp_max(1.0)
    return torch.where(inter > 0, bound, 0.0)


def logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(EPS, 1.0 - EPS)
    return torch.log(p) - torch.log1p(-p)


def overlap(boxes: torch.Tensor, classes: torch.Tensor) -> float:
    """The largest IoU of two boxes of one class, in float32 in the
    order of ``structures/boxes.py::pairwise_iou``."""
    if boxes.shape[0] < 2:
        return 0.0
    lt = torch.maximum(boxes[:, None, :2], boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area[:, None] + area[None, :] - inter
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                      0.0)
    same = (classes[:, None] == classes[None, :]) & ~torch.eye(
        len(classes), dtype=torch.bool, device=boxes.device)
    return float(torch.where(same, iou, 0.0).max())


def widest(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out = {k: 0.0 for k in NUMBERS}
    for r in readings:
        for k in NUMBERS:
            out[k] = max(out[k], r[k])
    return out


def batch_of_one(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference's outputs shaped as the program's (batch of one)."""
    res = {k: v[None] for k, v in out.items()}
    res["pred_masks"] = res["pred_masks"][:, :, None]
    return res


def image_tensor(img: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img)).to(dev)
