"""Python interface to the native RLE mask ops (ctypes); the port's own
copy of ``centermask2_tpu/evaluation/rle.py``.

``native/maskapi.cpp`` is compiled with ``g++`` at first use into
``centermask2_tpu_torch/_build/maskapi-<hash>/libmaskapi.so`` by
``utils/native.py::load_library`` (under a lock; a failed build
raises). The helpers are pycocotools-mask compatible: encode / decode /
area / iou / merge and the compressed "counts" string codec.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np

from ..utils.native import BUILD_ROOT, load_library

_SRC = Path(__file__).resolve().parent / "native" / "maskapi.cpp"
_BUILD_ROOT = BUILD_ROOT
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def _declare(lib: ctypes.CDLL) -> None:
    i64, u32p, u8p = ctypes.c_int64, \
        np.ctypeslib.ndpointer(np.uint32), np.ctypeslib.ndpointer(np.uint8)
    i64p = np.ctypeslib.ndpointer(np.int64)
    f64p = np.ctypeslib.ndpointer(np.float64)
    i32p = np.ctypeslib.ndpointer(np.int32)
    lib.rle_encode.restype = i64
    lib.rle_encode.argtypes = [u8p, i64, i64, u32p]
    lib.rle_decode.restype = None
    lib.rle_decode.argtypes = [u32p, i64, i64, i64, u8p]
    lib.rle_area.restype = ctypes.c_uint64
    lib.rle_area.argtypes = [u32p, i64]
    lib.rle_to_string.restype = i64
    lib.rle_to_string.argtypes = [u32p, i64, ctypes.c_char_p, i64]
    lib.rle_from_string.restype = i64
    lib.rle_from_string.argtypes = [ctypes.c_char_p, i64, u32p, i64]
    lib.rle_iou.restype = None
    lib.rle_iou.argtypes = [u32p, i64p, i64p, i64, u32p, i64p, i64p, i64,
                            i32p, f64p]
    lib.bb_iou.restype = None
    lib.bb_iou.argtypes = [f64p, i64, f64p, i64, i32p, f64p]
    lib.rle_merge.restype = i64
    lib.rle_merge.argtypes = [u32p, i64, u32p, i64, ctypes.c_int32, u32p,
                              i64]
    lib.coco_match.restype = None
    lib.coco_match.argtypes = [f64p, i64, f64p, i64, i64, u8p, u8p, i64p,
                               i64p, i64p, i64p, u8p]


def _lib() -> ctypes.CDLL:
    """Build (once) and load the library; raises if g++ fails."""
    return load_library(_SRC, _FLAGS, _BUILD_ROOT, "maskapi", _declare)


class RLE:
    """One run-length-encoded mask: (h, w, counts uint32 array)."""

    __slots__ = ("h", "w", "counts")

    def __init__(self, h: int, w: int, counts: np.ndarray):
        self.h = int(h)
        self.w = int(w)
        self.counts = np.ascontiguousarray(counts, np.uint32)

    def __repr__(self):  # pragma: no cover
        return f"RLE(h={self.h}, w={self.w}, m={len(self.counts)})"


def encode(mask: np.ndarray) -> RLE:
    """(h, w) bool/uint8 mask -> RLE (column-major, COCO convention)."""
    h, w = mask.shape
    colmajor = np.ascontiguousarray(
        np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F"))
    out = np.empty(h * w + 1, np.uint32)
    m = _lib().rle_encode(colmajor, h, w, out)
    return RLE(h, w, out[:m].copy())


def decode(rle: RLE) -> np.ndarray:
    out = np.empty(rle.h * rle.w, np.uint8)
    _lib().rle_decode(rle.counts, len(rle.counts), rle.h, rle.w, out)
    return out.reshape((rle.h, rle.w), order="F").astype(bool)


def area(rle: RLE) -> int:
    return int(_lib().rle_area(rle.counts, len(rle.counts)))


def to_string(rle: RLE) -> str:
    cap = max(len(rle.counts) * 8, 64)
    buf = ctypes.create_string_buffer(cap)
    n = _lib().rle_to_string(rle.counts, len(rle.counts), buf, cap)
    assert n >= 0
    return buf.raw[:n].decode("ascii")


def from_string(s: Union[str, bytes], h: int, w: int) -> RLE:
    if isinstance(s, str):
        s = s.encode("ascii")
    cap = max(len(s) + 2, 64)
    out = np.empty(cap, np.uint32)
    m = _lib().rle_from_string(s, len(s), out, cap)
    if m < 0:
        raise ValueError("corrupt RLE string")
    return RLE(h, w, out[:m].copy())


def to_coco(rle: RLE) -> Dict:
    """pycocotools-compatible dict {'size': [h, w], 'counts': str}."""
    return {"size": [rle.h, rle.w], "counts": to_string(rle)}


def from_coco(obj: Dict) -> RLE:
    h, w = obj["size"]
    counts = obj["counts"]
    if isinstance(counts, (list, tuple)):  # uncompressed
        return RLE(h, w, np.asarray(counts, np.uint32))
    return from_string(counts, h, w)


def iou(dt: Sequence[RLE], gt: Sequence[RLE],
        iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """(len(dt), len(gt)) IoU matrix; crowd gt uses dt-area union."""
    if not dt or not gt:
        return np.zeros((len(dt), len(gt)))
    dt_counts = np.concatenate([r.counts for r in dt]).astype(np.uint32)
    gt_counts = np.concatenate([r.counts for r in gt]).astype(np.uint32)
    dt_len = np.array([len(r.counts) for r in dt], np.int64)
    gt_len = np.array([len(r.counts) for r in gt], np.int64)
    dt_off = np.concatenate([[0], np.cumsum(dt_len)[:-1]]).astype(np.int64)
    gt_off = np.concatenate([[0], np.cumsum(gt_len)[:-1]]).astype(np.int64)
    crowd = np.asarray(iscrowd if iscrowd is not None else
                       np.zeros(len(gt)), np.int32)
    out = np.empty((len(dt), len(gt)), np.float64)
    _lib().rle_iou(dt_counts, dt_off, dt_len, len(dt), gt_counts, gt_off,
                   gt_len, len(gt), crowd, out)
    return out


def coco_match(iou_thrs: np.ndarray, ious: np.ndarray,
               gt_ignore: np.ndarray, gt_crowd: np.ndarray,
               gt_ids: np.ndarray, dt_ids: np.ndarray):
    """Native COCOeval greedy matching (evaluateImg inner loop) for one
    (image, category, areaRng, maxDet) cell. ``ious`` is (D, G) in
    sorted-dt x sorted-gt order. Returns (dt_matches (T, D) int64 gt
    ids, gt_matches (T, G) int64 dt ids, dt_ignore (T, D) bool)."""
    T = len(iou_thrs)
    D, G = ious.shape
    dt_matches = np.zeros((T, D), np.int64)
    gt_matches = np.zeros((T, G), np.int64)
    dt_ignore = np.zeros((T, D), np.uint8)
    if D and G:
        _lib().coco_match(
            np.ascontiguousarray(iou_thrs, np.float64), T,
            np.ascontiguousarray(ious, np.float64), D, G,
            np.ascontiguousarray(gt_ignore, np.uint8),
            np.ascontiguousarray(gt_crowd, np.uint8),
            np.ascontiguousarray(gt_ids, np.int64),
            np.ascontiguousarray(dt_ids, np.int64),
            dt_matches, gt_matches, dt_ignore)
    return dt_matches, gt_matches, dt_ignore.astype(bool)


def bbox_iou(dt: np.ndarray, gt: np.ndarray,
             iscrowd: Optional[Sequence[int]] = None) -> np.ndarray:
    """COCO xywh box IoU matrix with crowd semantics."""
    dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    crowd = np.asarray(iscrowd if iscrowd is not None else
                       np.zeros(len(gt)), np.int32)
    out = np.empty((len(dt), len(gt)), np.float64)
    _lib().bb_iou(dt, len(dt), gt, len(gt), crowd, out)
    return out


def merge(rles: Sequence[RLE], intersect: bool = False) -> RLE:
    assert rles
    cur = rles[0]
    for r in rles[1:]:
        cap = len(cur.counts) + len(r.counts) + 2
        out = np.empty(cap, np.uint32)
        m = _lib().rle_merge(cur.counts, len(cur.counts), r.counts,
                             len(r.counts), int(intersect), out, cap)
        assert m >= 0
        cur = RLE(cur.h, cur.w, out[:m].copy())
    return cur


def _rle_from_polygon(xy: np.ndarray, h: int, w: int) -> RLE:
    """One polygon -> RLE with the published COCO-protocol rasterization
    (pycocotools rleFrPoly): trace the boundary densely on a 5x-upsampled
    grid, keep the column-crossing points, downsample to per-column
    y-toggles, and turn the sorted toggle positions into runs."""
    scale = 5.0
    pts = np.asarray(xy, np.float64).reshape(-1, 2)
    k = len(pts)
    # C-truncation of scale*v + .5 (coords are non-negative in COCO)
    x = np.trunc(scale * pts[:, 0] + 0.5).astype(np.int64)
    y = np.trunc(scale * pts[:, 1] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])

    us, vs = [], []
    for j in range(k):
        xs, xe, ys, ye = x[j], x[j + 1], y[j], y[j + 1]
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1)
            t = dx - d if flip else d
            us.append(t + xs)
            vs.append(np.trunc(ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1)
            t = dy - d if flip else d
            vs.append(t + ys)
            us.append(np.trunc(xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)

    # column-crossing points -> (x, ceil(y)) toggles, downsampled
    cross = u[1:] != u[:-1]
    uj, ujm1 = u[1:][cross], u[:-1][cross]
    vj, vjm1 = v[1:][cross], v[:-1][cross]
    xd = np.where(uj < ujm1, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    ok = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.where(vj < vjm1, vj, vjm1).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0, h))
    xs_ = xd[ok].astype(np.int64)
    ys_ = yd[ok].astype(np.int64)

    # toggle positions (column-major) -> alternating runs
    a = np.sort(xs_ * h + ys_)
    a = np.append(a, h * w)
    d = np.diff(np.concatenate([[0], a])).astype(np.int64)
    # collapse zero-length runs into the previous run (double toggles)
    b = [d[0]]
    j = 1
    while j < len(d):
        if d[j] > 0:
            b.append(d[j])
            j += 1
        else:
            j += 1
            if j < len(d):
                b[-1] += d[j]
                j += 1
    return RLE(h, w, np.asarray(b, np.uint32))


def polygons_to_rle(polygons: Sequence[np.ndarray], h: int, w: int) -> RLE:
    """Rasterize COCO polygon(s) -> merged RLE: the exact frPyObjects +
    merge pipeline of pycocotools' annToRLE."""
    rles = [_rle_from_polygon(p, h, w) for p in polygons]
    if not rles:
        return encode(np.zeros((h, w), bool))
    return merge(rles) if len(rles) > 1 else rles[0]
