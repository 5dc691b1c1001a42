"""Masked selection — the framework's nonzero replacement (the port of
``centermask2_tpu/ops/select.py``): selection returns a fixed-size index
buffer plus a validity mask, never a data-dependent shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k of ``scores`` along the last axis restricted to ``mask``;
    padded with invalid slots.

    Returns (indices (..., k), valid (..., k), values (..., k)). Invalid
    slots carry NEG_INF values. Equal values are taken lowest index
    first, as ``lax.top_k`` takes them: a stable descending sort, not
    ``torch.topk``, whose order among ties is unspecified. The training
    fg pick (``CenterMask.loss``) ranks 0/1 values, where ties are the
    rule.
    """
    masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return idx, vals > NEG_INF / 2, vals
