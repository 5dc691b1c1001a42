"""FCOS decode (inference) with static shapes (the port of
``centermask2_tpu/models/fcos/outputs.py``).

Per-pixel sigmoid + score threshold, a two-stage exact top-k (locations
by their best class score, then the survivors' class rows), box decode
loc -/+ reg*stride, score sqrt(cls*ctr), class-aware greedy NMS and the
post-NMS top-k. The top-k runs fused across levels when
``nms_candidates <= pre_nms_topk``, else per level as the reference does
(each level's top ``pre_nms_topk``, concatenated, capped to
``nms_candidates``); either way one NMS runs per image. Everything is
fixed-capacity buffers plus validity masks, with a leading batch axis
written out (the JAX package vmaps).

The per-pixel stage stays in the head's compute dtype; everything after
the top-k gather is float32 (JAX ``outputs.py:129-131``).

Top-k ties: both top-k stages take equal values lowest index first, as
``lax.top_k`` does on the CPU reference (and the JAX split-merge, which
merges chunks in index order): a stable descending sort, not
``torch.topk``, whose order among ties is unspecified on CUDA. So the
selected set equals JAX's also when a tie straddles the k-th place,
which bf16 scores over ~20k locations make possible. (JAX on a TPU may
order exact ties otherwise, ``outputs.py:79-107``.)
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from ...ops import masked_topk, nms_select


def compute_locations_per_level(h: int, w: int, stride: int,
                                device: torch.device) -> torch.Tensor:
    """Pixel-center location grid, row-major (reference fcos.py:129-144):
    (h*w, 2) of (x, y) = (col*stride, row*stride) + stride // 2."""
    shift_x = torch.arange(0, w * stride, stride, dtype=torch.float32,
                           device=device)
    shift_y = torch.arange(0, h * stride, stride, dtype=torch.float32,
                           device=device)
    xs = shift_x[None, :].expand(h, w).reshape(-1)
    ys = shift_y[:, None].expand(h, w).reshape(-1)
    return torch.stack([xs, ys], dim=1) + stride // 2


def compute_locations(feature_shapes: Sequence[Tuple[int, int]],
                      strides: Sequence[int],
                      device: torch.device) -> List[torch.Tensor]:
    return [compute_locations_per_level(h, w, s, device)
            for (h, w), s in zip(feature_shapes, strides)]


class DecodedProposals(NamedTuple):
    """Fixed-capacity proposal buffers, (B, K, ...)."""

    pred_boxes: torch.Tensor  # (B, K, 4)
    scores: torch.Tensor  # (B, K)
    pred_classes: torch.Tensor  # (B, K) int32
    locations: torch.Tensor  # (B, K, 2)
    valid: torch.Tensor  # (B, K) bool


def topk_lowest_index_first(x: torch.Tensor, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of each row of (B, N) ``x``,
    equal values lowest index first."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _box_decode(per_locs: torch.Tensor, per_reg: torch.Tensor
                ) -> torch.Tensor:
    return torch.stack([per_locs[..., 0] - per_reg[..., 0],
                        per_locs[..., 1] - per_reg[..., 1],
                        per_locs[..., 0] + per_reg[..., 2],
                        per_locs[..., 1] + per_reg[..., 3]], dim=-1)


def _select(boxes, scores, classes, locs, valid, nms_thresh: float,
            post_nms_topk: int) -> DecodedProposals:
    keep_idx, keep_valid = nms_select(boxes, scores, classes, valid,
                                      nms_thresh, post_nms_topk)
    kept_scores = torch.gather(scores, 1, keep_idx)
    return DecodedProposals(
        pred_boxes=_gather_rows(boxes, keep_idx),
        scores=torch.where(keep_valid, kept_scores,
                           torch.zeros_like(kept_scores)),
        pred_classes=torch.gather(classes, 1, keep_idx),
        locations=_gather_rows(locs, keep_idx),
        valid=keep_valid,
    )


def decode_batch(
    locations: List[torch.Tensor],  # per level (HW, 2)
    logits: List[torch.Tensor],  # per level (B, C, H, W)
    reg: List[torch.Tensor],  # per level (B, 4, H, W), stride-normalized
    ctrness: List[torch.Tensor],  # per level (B, 1, H, W)
    strides: Sequence[int],
    pre_nms_thresh: float,
    pre_nms_topk: int,
    nms_thresh: float,
    post_nms_topk: int,
    nms_candidates: int = 1000,
    thresh_with_ctr: bool = False,
) -> DecodedProposals:
    """Reference forward_for_single_feature_map + select_over_all_levels
    (fcos_outputs.py:396-495) for a batch: the fused cross-level branch
    (JAX ``outputs.py:144-202``) or the per-level one (``:204-267``)."""
    B, C = logits[0].shape[:2]
    masked_levels = []
    for lg, ct in zip(logits, ctrness):
        cls_sig = torch.sigmoid(lg.permute(0, 2, 3, 1).reshape(B, -1, C))
        ctr_sig = torch.sigmoid(ct.reshape(B, -1))
        thr = torch.tensor(pre_nms_thresh, dtype=cls_sig.dtype)
        if thresh_with_ctr:
            cls_sig = cls_sig * ctr_sig[..., None]
        candidate_mask = cls_sig > thr
        if not thresh_with_ctr:
            cls_sig = cls_sig * ctr_sig[..., None]
        masked_levels.append(torch.where(
            candidate_mask, cls_sig, torch.full_like(cls_sig, -1.0)))
    flat_reg = [r.permute(0, 2, 3, 1).reshape(B, -1, 4) for r in reg]
    if nms_candidates > pre_nms_topk:
        return _decode_per_level(locations, masked_levels, flat_reg, strides,
                                 pre_nms_topk, nms_thresh, post_nms_topk,
                                 nms_candidates)

    # fused: the global top-K pairs all sit inside their own level's
    # top-K, so one top-k over the concatenated levels selects the same set
    scores_cat = torch.cat(masked_levels, dim=1)  # (B, L, C)
    loc_best = scores_cat.amax(dim=2).float()  # (B, L)
    locs_cat = torch.cat(locations, dim=0)  # (L, 2)
    reg_cat = torch.cat([r.float() * strides[lvl]
                         for lvl, r in enumerate(flat_reg)], dim=1)
    L = loc_best.shape[1]
    K = min(nms_candidates, L * C)
    k_loc = min(K, L)
    # a pair in the global top-K implies its location is in the top-K
    # locations by max-class score (its max dominates it)
    top_locs = topk_lowest_index_first(loc_best, k_loc)[1]  # (B, k_loc)
    rows = _gather_rows(scores_cat, top_locs).float()  # (B, k_loc, C)
    vals, flat_idx = topk_lowest_index_first(rows.reshape(B, -1),
                                             min(K, k_loc * C))
    valid = vals > 0.0
    loc_idx = torch.gather(top_locs, 1, flat_idx // C)
    classes = (flat_idx % C).to(torch.int32)

    per_locs = locs_cat[loc_idx]  # (B, K, 2)
    boxes = _box_decode(per_locs, _gather_rows(reg_cat, loc_idx))
    scores = torch.where(valid, torch.sqrt(torch.clamp(vals, min=0.0)),
                         torch.zeros_like(vals))
    return _select(boxes, scores, classes, per_locs, valid, nms_thresh,
                   post_nms_topk)


def _decode_per_level(locations, masked_levels, flat_reg, strides,
                      pre_nms_topk: int, nms_thresh: float,
                      post_nms_topk: int,
                      nms_candidates: int) -> DecodedProposals:
    """The reference-literal branch, for ``nms_candidates >
    pre_nms_topk`` where the per-level caps bind one by one: each level's
    exact two-stage top ``pre_nms_topk`` (in the head's dtype up to the
    row gather, as JAX has it), the levels concatenated, then capped to
    ``nms_candidates`` by score, and one NMS over the result."""
    cand = []
    for lvl, (locs, ms, rg) in enumerate(
            zip(locations, masked_levels, flat_reg)):
        B, HW, C = ms.shape
        k = min(pre_nms_topk, HW * C)
        k_loc = min(k, HW)
        top_locs = topk_lowest_index_first(ms.amax(dim=2), k_loc)[1]
        rows = _gather_rows(ms, top_locs).float()  # (B, k_loc, C)
        vals, flat_idx = topk_lowest_index_first(rows.reshape(B, -1), k)
        valid = vals > 0.0
        loc_idx = torch.gather(top_locs, 1, flat_idx // C)
        per_locs = locs[loc_idx]  # (B, k, 2)
        per_reg = _gather_rows(rg.float(), loc_idx) * strides[lvl]
        scores = torch.sqrt(torch.clamp(vals, min=0.0))
        cand.append((_box_decode(per_locs, per_reg),
                     torch.where(valid, scores, torch.zeros_like(scores)),
                     (flat_idx % C).to(torch.int32), per_locs, valid))
    boxes, scores, classes, locs, valid = (torch.cat(f, dim=1)
                                           for f in zip(*cand))
    # cap the NMS working set by score: exact greedy NMS is quadratic in it
    if boxes.shape[1] > nms_candidates:
        idx, valid, _ = masked_topk(scores, valid, nms_candidates)
        boxes = _gather_rows(boxes, idx)
        scores = torch.gather(scores, 1, idx)
        classes = torch.gather(classes, 1, idx)
        locs = _gather_rows(locs, idx)
    return _select(boxes, scores, classes, locs, valid, nms_thresh,
                   post_nms_topk)


def decode_single_image(locations, logits, reg, ctrness, strides,
                        **kwargs) -> DecodedProposals:
    """One image: per-level (1, C, H, W) head outputs -> (K, ...) buffers."""
    out = decode_batch(locations, logits, reg, ctrness, strides, **kwargs)
    return DecodedProposals(*(x[0] for x in out))
