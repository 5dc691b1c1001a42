"""COCO-format dataset reading for training and evaluation (the port's
own copy of ``centermask2_tpu/data/coco.py``), without pycocotools.

The training side replaces detectron2's dataloader as the reference
uses it (ResizeShortestEdge multi-scale and horizontal flip,
Base-CenterMask-VoVNet.yaml:34-35): resize (PIL bilinear), flip,
normalize, pad to the canvas, and fixed-capacity ground truth: padded
boxes, classes, validity and, for each instance, its polygons rasterized
once over its own box into a P x P patch (``CenterMask.loss`` resamples
the patches at the proposals). cv2 is imported by the rasterizers only;
there is no other rasterizer. With ``with_keypoints`` (MODEL.KEYPOINT_ON)
each instance also carries its COCO keypoints in network input
coordinates, flipped as detectron2 flips them (x mirrored, left and
right members swapped) and zeroed where not labeled.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .preprocess import (PIXEL_MEAN, PIXEL_STD, compute_resize_shape,
                         read_image_bgr, resize_shortest_edge,
                         s2d_serving_canvas)

ReadImage = Callable[[str], np.ndarray]


class CocoDataset:
    def __init__(self, json_path: str, image_root: str,
                 filter_empty: bool = True):
        with open(json_path) as f:
            self.dataset = json.load(f)
        self.image_root = image_root
        self.imgs = {im["id"]: im for im in self.dataset["images"]}
        cat_ids = sorted(c["id"] for c in self.dataset.get("categories", []))
        # dataset category id -> contiguous [0, C)
        self.cat_to_contiguous = {cid: i for i, cid in enumerate(cat_ids)}
        self.contiguous_to_cat = {i: cid for cid, i in
                                  self.cat_to_contiguous.items()}
        anns = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            if a.get("iscrowd", 0):
                continue  # crowd regions are eval-only ignore regions
            anns[a["image_id"]].append(a)
        self.img_to_anns = anns
        ids = sorted(self.imgs.keys())
        if filter_empty:
            ids = [i for i in ids if len(anns[i]) > 0]
        self.ids = ids

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, img_id: int) -> str:
        return os.path.join(self.image_root, self.imgs[img_id]["file_name"])


def rasterize_polygons(polygons: List, h: int, w: int) -> np.ndarray:
    """Polygons (flat x, y lists) filled into an (h, w) uint8 mask."""
    import cv2

    mask = np.zeros((h, w), np.uint8)
    for p in polygons:
        pts = np.asarray(p, np.float64).reshape(-1, 2)
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask


def mask_patch_from_polygons(polygons: List, box: np.ndarray,
                             patch_size: int) -> np.ndarray:
    """Rasterize a gt instance into a (P, P) f32 patch over its box."""
    import cv2

    x0, y0, x1, y1 = box
    w = max(x1 - x0, 1e-3)
    h = max(y1 - y0, 1e-3)
    mask = np.zeros((patch_size, patch_size), np.uint8)
    for p in polygons:
        pts = np.asarray(p, np.float64).reshape(-1, 2).copy()
        pts[:, 0] = (pts[:, 0] - x0) / w * patch_size
        pts[:, 1] = (pts[:, 1] - y0) / h * patch_size
        cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
    return mask.astype(np.float32)


# detectron2's COCO person-keypoint horizontal-flip map: the left/right
# members swapped by a flip (0, the nose, has no pair)
COCO_KEYPOINT_HFLIP_PAIRS = ((1, 2), (3, 4), (5, 6), (7, 8), (9, 10),
                             (11, 12), (13, 14), (15, 16))


def filter_images_with_few_keypoints(ds: CocoDataset, min_kp: int) -> int:
    """Drop the training images whose annotations carry fewer than
    ``min_kp`` visible keypoints in all (detectron2
    filter_images_with_few_keypoints,
    MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE). Changes ``ds.ids``;
    returns the number of images dropped."""
    if min_kp <= 0:
        return 0

    def n_visible(img_id):
        return sum(int(sum(1 for v in (a.get("keypoints") or [])[2::3]
                           if v > 0))
                   for a in ds.img_to_anns[img_id])

    before = len(ds.ids)
    ds.ids = [i for i in ds.ids if n_visible(i) >= min_kp]
    return before - len(ds.ids)


def load_train_example(ds: CocoDataset, img_id: int, *, short_edge: int,
                       max_size: int = 1333, pad_to: Tuple[int, int],
                       max_gt: int = 100, patch_size: int = 112,
                       hflip: bool = False, with_keypoints: bool = False,
                       num_keypoints: int = 17,
                       read_image: ReadImage = read_image_bgr
                       ) -> Dict[str, np.ndarray]:
    """One training example: the resized, flipped, normalized image padded
    to ``pad_to``, and padded ground truth. ``read_image``: path -> HWC
    uint8 BGR array. ``with_keypoints`` adds "gt_keypoints" (max_gt, K, 3)
    x, y, visibility in network input coordinates."""
    img = read_image(ds.image_path(img_id))
    h, w = img.shape[:2]
    newh, neww = compute_resize_shape(h, w, short_edge, max_size)
    img = resize_shortest_edge(img, short_edge, max_size).astype(np.float32)
    sx, sy = neww / w, newh / h
    if hflip:
        img = img[:, ::-1].copy()
    img = (img - PIXEL_MEAN) / PIXEL_STD
    ph, pw = pad_to
    padded = np.zeros((ph, pw, 3), np.float32)
    padded[:newh, :neww] = img[:ph, :pw]

    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    patches = np.zeros((max_gt, patch_size, patch_size), np.float32)
    keypoints = (np.zeros((max_gt, num_keypoints, 3), np.float32)
                 if with_keypoints else None)
    for i, ann in enumerate(ds.img_to_anns[img_id][:max_gt]):
        x, y, bw, bh = ann["bbox"]
        box = np.array([x * sx, y * sy, (x + bw) * sx, (y + bh) * sy],
                       np.float32)
        seg = ann.get("segmentation") or []
        if hflip:
            box = np.array([neww - box[2], box[1], neww - box[0], box[3]],
                           np.float32)
        if box[2] <= box[0] or box[3] <= box[1]:
            continue
        boxes[i] = box
        classes[i] = ds.cat_to_contiguous[ann["category_id"]]
        valid[i] = True
        if seg and isinstance(seg, list):
            scaled = []
            for p in seg:
                p = np.asarray(p, np.float64).reshape(-1, 2) * np.array([sx, sy])
                if hflip:
                    p[:, 0] = neww - p[:, 0]
                scaled.append(p.reshape(-1))
            patches[i] = mask_patch_from_polygons(scaled, boxes[i], patch_size)
        if keypoints is not None and ann.get("keypoints"):
            kp = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
            kp = kp[:num_keypoints]
            kp[:, 0] *= sx
            kp[:, 1] *= sy
            if hflip:  # detectron2 transform_keypoint_annotations
                kp[:, 0] = neww - kp[:, 0]
                for a, b in COCO_KEYPOINT_HFLIP_PAIRS:
                    if a < len(kp) and b < len(kp):
                        kp[[a, b]] = kp[[b, a]]
            kp[kp[:, 2] == 0] = 0  # not labeled: zeroed, as detectron2
            keypoints[i, :len(kp)] = kp
    out = {"image": padded, "gt_boxes": boxes, "gt_classes": classes,
           "gt_valid": valid, "gt_mask_patches": patches,
           "image_size": np.array([newh, neww], np.int32),
           "image_id": img_id}
    if keypoints is not None:
        out["gt_keypoints"] = keypoints
    return out


BATCH_KEYS = ("image", "gt_boxes", "gt_classes", "gt_valid",
              "gt_mask_patches", "image_size")


def train_batches(
    ds: CocoDataset,
    batch_size: int,
    *,
    min_sizes: Sequence[int] = (640, 672, 704, 736, 768, 800),
    max_size: int = 1333,
    pad_to: Tuple[int, int] = (1344, 1344),
    max_gt: int = 100,
    patch_size: int = 112,
    seed: int = 0,
    epochs: Optional[int] = None,
    workers: int = 0,
    random_flip: str = "horizontal",  # INPUT.RANDOM_FLIP: horizontal|none
    sampling: str = "choice",  # INPUT.MIN_SIZE_TRAIN_SAMPLING: choice|range
    tight_pad: bool = False,  # TPU.TRAIN_TIGHT_PAD
    with_keypoints: bool = False,  # MODEL.KEYPOINT_ON: adds gt_keypoints
    read_image: ReadImage = read_image_bgr,
    rank: int = 0,
    world: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Endless (or ``epochs``-bounded) shuffled batches with multi-scale
    jitter and random horizontal flip (JAX ``coco.py:211-343``, batch for
    batch equal at one seed).

    ``sampling`` follows detectron2 ResizeShortestEdge: "choice" draws the
    short edge from ``min_sizes``, "range" uniformly from [min, max].
    ``workers > 0`` loads a batch's images on a thread pool; the
    augmentation draws happen first, in order, so the batches do not
    depend on it. ``tight_pad`` groups batches by orientation (detectron2's
    aspect-ratio grouping) and pads each to the quantized tight canvas
    covering it (``s2d_serving_canvas`` with short = the largest draw, at
    most 4 canvases); epoch tails that fill no group are batched mixed.

    ``batch_size`` is the global batch; with ``world`` ranks each yields
    its rows ``[rank * b, (rank + 1) * b)``, b = batch_size / world, of
    every global batch (``parallel/mesh.py::shard_batch``). Every rank
    draws the same shuffle and augmentations from ``seed`` (detectron2's
    TrainingSampler shares one seed), so the ranks' rows of a global batch
    are disjoint and together are the batch of a world of one, canvas
    included. The JAX CLI seeds each process with ``SEED + process`` and
    lets ranks draw one image twice into a global batch; the port does
    not."""
    if random_flip not in ("horizontal", "none"):
        raise ValueError(f"INPUT.RANDOM_FLIP {random_flip!r}")
    if sampling not in ("choice", "range"):
        raise ValueError(f"INPUT.MIN_SIZE_TRAIN_SAMPLING {sampling!r}")
    if batch_size % world or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of {world}: a global batch of "
                         f"{batch_size} does not split")
    local = batch_size // world
    pool = None
    if workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=workers)
    try:
        rng = np.random.RandomState(seed)
        lo, hi = int(min(min_sizes)), int(max(min_sizes))

        def draw_short_edge():
            if sampling == "range":
                return int(rng.randint(lo, hi + 1))
            return int(rng.choice(min_sizes))

        def emit(img_ids):
            jobs = [dict(img_id=int(i), short_edge=draw_short_edge(),
                         hflip=(random_flip == "horizontal"
                                and bool(rng.rand() < 0.5)))
                    for i in img_ids]
            batch_pad = pad_to
            if tight_pad:
                mh = mw = 1
                for job in jobs:
                    im = ds.imgs[job["img_id"]]
                    nh, nw = compute_resize_shape(
                        im["height"], im["width"], job["short_edge"],
                        max_size)
                    mh, mw = max(mh, nh), max(mw, nw)
                batch_pad = s2d_serving_canvas(mh, mw, pad_to, hi)

            def load(job):
                return load_train_example(
                    ds, job["img_id"], short_edge=job["short_edge"],
                    max_size=max_size, pad_to=batch_pad, max_gt=max_gt,
                    patch_size=patch_size, hflip=job["hflip"],
                    with_keypoints=with_keypoints, read_image=read_image)

            mine = jobs[rank * local:(rank + 1) * local]
            examples = list(pool.map(load, mine) if pool else map(load, mine))
            keys = BATCH_KEYS + (("gt_keypoints",) if with_keypoints else ())
            batch = {k: np.stack([e[k] for e in examples]) for k in keys}
            batch["image_ids"] = [e["image_id"] for e in examples]
            return batch

        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(ds.ids)
            if not tight_pad:
                for start in range(0, len(order) - batch_size + 1,
                                   batch_size):
                    yield emit(order[start:start + batch_size])
            else:
                queues = {True: [], False: []}
                for img_id in order:
                    im = ds.imgs[int(img_id)]
                    q = queues[im["height"] > im["width"]]
                    q.append(img_id)
                    if len(q) == batch_size:
                        yield emit(q)
                        q.clear()
                rest = queues[True] + queues[False]
                for start in range(0, len(rest) - batch_size + 1,
                                   batch_size):
                    yield emit(rest[start:start + batch_size])
            epoch += 1
    finally:
        if pool is not None:
            pool.shutdown(wait=False)
