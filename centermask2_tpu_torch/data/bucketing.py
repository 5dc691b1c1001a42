"""Shape-bucketed batching for inference (the port's own copy of
``centermask2_tpu/data/bucketing.py``).

The reference deploys at one fixed shape (1344x1344). For batched COCO
evaluation each image can also be routed to the smallest padded size
bucket that fits its resized shape (TPU.SIZE_BUCKETS), or to its
quantized tight serving canvas, so that a batch shares one shape.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Sequence, Tuple

from .preprocess import compute_resize_shape, s2d_serving_canvas


def pick_bucket(h: int, w: int, buckets: Sequence[int]) -> int:
    """Smallest bucket edge >= max(h, w); falls back to the largest."""
    m = max(h, w)
    for b in sorted(buckets):
        if b >= m:
            return b
    return max(buckets)


def group_by_bucket(
    items: Sequence,
    sizes: Sequence[Tuple[int, int]],  # original (h, w) per item
    buckets: Sequence[int],
    short: int,
    max_size: int,
) -> Dict[int, List[int]]:
    """Map bucket edge -> list of item indices."""
    out: Dict[int, List[int]] = defaultdict(list)
    for i, (h, w) in enumerate(sizes):
        nh, nw = compute_resize_shape(h, w, short, max_size)
        out[pick_bucket(nh, nw, buckets)].append(i)
    return dict(out)


def group_by_serving_canvas(
    items: Sequence,
    sizes: Sequence[Tuple[int, int]],  # original (h, w) per item
    fixed_size: int,
    short: int,
    max_size: int,
) -> Dict[Tuple[int, int], List[int]]:
    """Map quantized tight canvas (ch, cw) -> item indices, for
    tight-compute batched serving: every image in a group shares the
    s2d_serving_canvas of its resized shape (at most 4 canvases)."""
    out: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, (h, w) in enumerate(sizes):
        nh, nw = compute_resize_shape(h, w, short, max_size)
        out[s2d_serving_canvas(nh, nw, fixed_size, short)].append(i)
    return dict(out)


def batches_from_groups(
    groups: Dict[int, List[int]], batch_size: int
) -> Iterator[Tuple[int, List[int], int]]:
    """Yield (bucket, index_batch, n_real) chunks; the trailing partial
    batch of each bucket is padded by repeating its last index (callers
    mask the duplicates out by position)."""
    for bucket, idxs in sorted(groups.items()):
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s : s + batch_size]
            n_real = len(chunk)
            while len(chunk) < batch_size:
                chunk = chunk + [chunk[-1]]
            yield bucket, chunk[:batch_size], n_real
