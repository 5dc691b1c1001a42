"""Static-shape (padded) greedy NMS (the port of
``centermask2_tpu/ops/nms.py``).

Greedy class-aware NMS over a fixed-capacity candidate buffer, returning
a fixed number of output slots plus validity: no host sync, no
data-dependent shapes. Every function takes a leading batch axis
(B, N, ...), which the JAX package gets from vmap.

The greedy core runs over the score-sorted, tile-padded boxes through
the registered operator ``cm2::nms_keep_sorted``, which dispatches by
device:
- on a CUDA tensor, kernel 1 (``csrc/nms.cu`` via ``_kernels``);
- on a CPU tensor, its plain version ``greedy_keep_sorted_plain``, the
  tiled fixpoint of the JAX XLA path (``nms.py:107-131``).
Both give the exact greedy keep set. Its fake implementation states the
output, so ``torch.export`` traces through it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..structures import boxes as box_ops
from . import _kernels

TILE = 128


def _greedy_fixpoint(sup_mat: torch.Tensor,
                     alive0: torch.Tensor) -> torch.Tensor:
    """Greedy suppression inside one tile by fixpoint iteration:
    alive <- alive0 & ~any_i(sup_mat[i, j] & alive[i]) until stable (at
    most depth-of-the-suppression-DAG steps). sup_mat (B, t, t) is the
    strict upper triangle of the overlap matrix; alive0 (B, t)."""
    alive = alive0
    for _ in range(alive0.shape[-1] + 1):
        sup = (sup_mat & alive[:, :, None]).any(dim=1)
        new_alive = alive0 & ~sup
        if torch.equal(new_alive, alive):
            break
        alive = new_alive
    return alive


def greedy_keep_sorted_plain(sboxes: torch.Tensor, svalid: torch.Tensor,
                             iou_threshold: float,
                             tile: int = TILE) -> torch.Tensor:
    """Plain PyTorch version of kernel 1: keep mask (B, N) over boxes
    (B, N, 4) already sorted by descending score, N % tile == 0. Each
    tile is first suppressed by the kept boxes of earlier tiles, then
    settled by the fixpoint above."""
    B, n = svalid.shape
    overlap = box_ops.pairwise_iou(sboxes, sboxes) > torch.tensor(
        iou_threshold, dtype=torch.float32)
    tri = torch.triu(torch.ones((tile, tile), dtype=torch.bool,
                                device=sboxes.device), diagonal=1)
    keep = torch.zeros((B, n), dtype=torch.bool, device=sboxes.device)
    for start in range(0, n, tile):
        stop = start + tile
        # suppression by kept boxes of earlier tiles
        sup0 = (overlap[:, :start, start:stop]
                & keep[:, :start, None]).any(dim=1)
        alive0 = svalid[:, start:stop] & ~sup0
        intra = overlap[:, start:stop, start:stop] & tri
        keep[:, start:stop] = _greedy_fixpoint(intra, alive0)
    return keep


@torch.library.custom_op("cm2::nms_keep_sorted", mutates_args=(),
                         device_types="cpu")
def nms_keep_sorted_op(sboxes: torch.Tensor, svalid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    """Greedy keep mask (B, N) bool over score-sorted boxes (B, N, 4) f32
    and validity (B, N) bool: the plain version on the CPU."""
    return greedy_keep_sorted_plain(sboxes, svalid, iou_threshold)


@nms_keep_sorted_op.register_kernel("cuda")
def _(sboxes, svalid, iou_threshold):
    # looked up at each call, so a swap of _kernels' function reaches it
    return _kernels.nms_keep_sorted(sboxes, svalid, iou_threshold)


@nms_keep_sorted_op.register_fake
def _(sboxes, svalid, iou_threshold):
    return torch.empty_like(svalid)


def _keep_sorted(sboxes: torch.Tensor, svalid: torch.Tensor,
                 iou_threshold: float) -> torch.Tensor:
    return nms_keep_sorted_op(sboxes, svalid, float(iou_threshold))


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over (B, N, 4) boxes; returns the kept mask (B, N) bool.

    Boxes are sorted by descending score with a stable sort (invalid rows
    last), as ``jnp.argsort(-where(valid, scores, -inf))`` orders them,
    padded to a multiple of the 128 tile, run through the greedy core and
    scattered back to input order.
    """
    B, n = scores.shape
    key = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.sort(key, dim=1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes.float(), 1, order[..., None].expand(B, n, 4))
    svalid = torch.gather(valid, 1, order)
    pad = (-n) % TILE
    if pad:
        sboxes = torch.cat([sboxes, sboxes.new_zeros((B, pad, 4))], dim=1)
        svalid = torch.cat([svalid, svalid.new_zeros((B, pad))], dim=1)
    keep_sorted = _keep_sorted(sboxes.contiguous(), svalid.contiguous(),
                               iou_threshold)
    # sorted position i holds input row order[i]
    return torch.zeros_like(valid).scatter(1, order, keep_sorted[:, :n])


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Class-aware NMS via per-class coordinate offsets (torchvision
    batched_nms trick), per image. Returns the kept mask (B, N)."""
    masked = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
    max_coord = masked.amax(dim=(1, 2))  # (B,)
    offsets = classes.to(boxes.dtype) * (max_coord[:, None] + 1.0)
    shifted = boxes + offsets[..., None]
    return nms_keep_mask(shifted, scores, valid, iou_threshold)


def nms_select(boxes: torch.Tensor, scores: torch.Tensor,
               classes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float, max_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware NMS + top-``max_out`` by score.

    Returns (indices (B, max_out), out_valid (B, max_out)) into the input
    buffers, by descending score; equal scores keep input order, as
    ``lax.top_k`` orders them (a stable sort, not ``torch.topk``, whose
    order among ties is unspecified).
    """
    keep = batched_nms(boxes, scores, classes, valid, iou_threshold)
    kept = torch.where(keep, scores, torch.full_like(scores, -torch.inf))
    B, n = kept.shape
    if max_out > n:  # fewer candidates than output slots: pad with dead rows
        kept = torch.cat([kept, kept.new_full((B, max_out - n), -torch.inf)],
                         dim=1)
    top, idx = torch.sort(kept, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_out], idx[:, :max_out]
    return torch.clamp(idx, max=n - 1), top > -torch.inf
