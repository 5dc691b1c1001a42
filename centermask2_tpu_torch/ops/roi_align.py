"""Multilevel ROIAlign (aligned semantics) and its gradient (the port of
``centermask2_tpu/ops/roi_align.py``).

All FPN levels are pooled in one call: each ROI samples its own assigned
level, with no per-level loop and no scatter. Features are NCHW per
level, (N, C, Hl, Wl); the output is (R, C, o, o).

- On CUDA tensors the forward is kernel 2 (``csrc/roi_align.cu`` via
  ``_kernels``): level pick, sample coordinates, bilinear taps and the
  s x s bin mean in one launch; the backward is kernel 2b in the same
  source, which scatters each output gradient into the 4 taps of every
  sample with f32 atomics and casts the sums to the features' dtype.
- On CPU tensors the forward is the plain version
  ``multilevel_roi_align_plain``, which follows the JAX
  ``_multilevel_impl`` (``roi_align.py:251-291``): one (S, 4C) table of
  every level's 2x2 tap blocks, one row gather, the weighted tap combine
  and the bin average. The backward is ``roi_align_feature_grad_plain``,
  JAX's separable VJP (``_separable_feature_grad``, ``:325-349``): per
  level, two einsums with the 1-D pooling matrices of each axis.

``multilevel_roi_align`` is a ``torch.autograd.Function``: features get
their gradient, boxes, batch indices and levels none (JAX returns zeros
for boxes, ``:373``; proposals are detached before ROI training).

Bilinear tap semantics follow the JAX formulas (``roi_align.py:53-56``,
``:77-96``): samples with y < -1 or y > H contribute zero; in-range
coordinates clamp to [0, H-1] with taps at floor and min(floor+1, H-1).
Both forward versions do the same f32 operations (XLA's, with each
division by a constant a product with its f32 reciprocal), accumulate in
float32 and return the features' dtype.

Not ported here: ``sampling_ratio=0``'s adaptive buckets (ROADMAP queue
1, item 12).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, Tuple

import torch

from . import _kernels


def _axis_coords(boxes: torch.Tensor, scale: torch.Tensor, output_size: int,
                 sampling_ratio: int, aligned: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-axis sample positions (ys, xs), each (R, o*s), in level
    coords; index p along an axis is bin p // s, sample p % s."""
    offset = 0.5 if aligned else 0.0
    x0 = boxes[:, 0] * scale - offset
    y0 = boxes[:, 1] * scale - offset
    x1 = boxes[:, 2] * scale - offset
    y1 = boxes[:, 3] * scale - offset
    roi_w = x1 - x0
    roi_h = y1 - y0
    if not aligned:  # legacy ROIAlign forces min size 1
        roi_w = torch.clamp(roi_w, min=1.0)
        roi_h = torch.clamp(roi_h, min=1.0)
    # divisions by a constant as XLA evaluates them: products with the f32
    # reciprocal (kernel 2 does the same; a tensor / scalar on CUDA would
    # too, on the CPU it would divide)
    n_pts = output_size * sampling_ratio
    grid = (torch.arange(n_pts, dtype=torch.float32, device=boxes.device)
            + 0.5) * (1.0 / sampling_ratio)
    ys = y0[:, None] + grid[None, :] * (roi_h * (1.0 / output_size))[:, None]
    xs = x0[:, None] + grid[None, :] * (roi_w * (1.0 / output_size))[:, None]
    return ys, xs


def _bilinear_taps(ys, xs, height, width):
    """(R, P) sample coords -> (y_low, x_low) int64 and tap weights
    (R, P, 4), zero for samples outside [-1, H] x [-1, W]."""
    in_range = (ys >= -1.0) & (ys <= height) & (xs >= -1.0) & (xs <= width)
    y = torch.clamp(ys, min=0.0)
    x = torch.clamp(xs, min=0.0)
    y_low = torch.minimum(torch.floor(y), height - 1)
    x_low = torch.minimum(torch.floor(x), width - 1)
    y = torch.minimum(y, height - 1)
    x = torch.minimum(x, width - 1)
    ly = y - y_low
    lx = x - x_low
    hy, hx = 1.0 - ly, 1.0 - lx
    w = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], dim=-1)
    w = w * in_range[..., None]
    return y_low.long(), x_low.long(), w


def _blockify(f: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, 4C): each pixel's 2x2 tap neighbourhood
    [f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)] with +1 clamped at the
    border, the min(low+1, H-1) high-tap rule."""
    fx = torch.cat([f[:, :, 1:], f[:, :, -1:]], dim=2)
    fy = torch.cat([f[:, 1:], f[:, -1:]], dim=1)
    fxy = torch.cat([fx[:, 1:], fx[:, -1:]], dim=1)
    return torch.cat([f, fx, fy, fxy], dim=-1)


def multilevel_roi_align_plain(
    features: Sequence[torch.Tensor],  # per level (N, C, Hl, Wl)
    boxes: torch.Tensor,  # (R, 4) xyxy image coords
    batch_indices: torch.Tensor,  # (R,) int
    levels: torch.Tensor,  # (R,) int in [0, L)
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of kernel 2 -> (R, C, o, o)."""
    L = len(features)
    N, C = features[0].shape[:2]
    R = boxes.shape[0]
    dev = boxes.device
    o, s = output_size, sampling_ratio
    # per-level border clamp happens in each level's own geometry, then
    # all levels share one (S, 4C) f32 row table
    flat = torch.cat([_blockify(f.permute(0, 2, 3, 1).float()).reshape(-1, 4 * C)
                      for f in features], dim=0)

    lv = torch.clamp(levels.long(), 0, L - 1)

    def per_roi(values, dtype):
        """values[lv] built on the ROIs' device from Python constants (a
        host-to-device table copy would block the stream)."""
        out = torch.full((R,), values[0], dtype=dtype, device=dev)
        for i in range(1, L):
            out = out.masked_fill(lv == i, values[i])
        return out

    sizes = [f.shape[0] * f.shape[2] * f.shape[3] for f in features]
    scale_r = per_roi([float(s) for s in scales], torch.float32)
    h_r = per_roi([float(f.shape[2]) for f in features], torch.float32)
    w_r = per_roi([float(f.shape[3]) for f in features], torch.float32)
    plane_r = per_roi([f.shape[2] * f.shape[3] for f in features], torch.long)
    bidx = torch.clamp(batch_indices.long(), 0, N - 1)
    base_r = per_roi([sum(sizes[:i]) for i in range(L)], torch.long) \
        + bidx * plane_r

    ys, xs = _axis_coords(boxes.float(), scale_r, o, s, aligned)
    P = (o * s) ** 2
    ys = ys[:, :, None].expand(R, o * s, o * s).reshape(R, P)
    xs = xs[:, None, :].expand(R, o * s, o * s).reshape(R, P)
    y_low, x_low, w = _bilinear_taps(ys, xs, h_r[:, None], w_r[:, None])
    idx = y_low * w_r[:, None].long() + x_low + base_r[:, None]
    g = flat[idx]  # (R, P, 4C)
    vals = None
    for t in range(4):
        part = g[..., t * C:(t + 1) * C] * w[:, :, t, None]
        vals = part if vals is None else vals + part
    # (R, P, C) with P ordered (ph, iy, pw, ix) -> s x s bin means, the
    # samples added one by one in (iy, ix) order, as kernel 2 adds them (a
    # reduction over both axes sums in another order on CUDA than on CPU)
    vals = vals.reshape(R, o, s, o, s, C)
    total = vals[:, :, 0, :, 0]
    for i in range(1, s * s):
        total = total + vals[:, :, i // s, :, i % s]
    out = total * (1.0 / (s * s))
    return out.permute(0, 3, 1, 2).to(features[0].dtype).contiguous()


def _axis_pool_matrix(coords: torch.Tensor, size: int, output_size: int,
                      sampling_ratio: int, roi_mask: torch.Tensor,
                      offsets: Optional[torch.Tensor],
                      total: int) -> torch.Tensor:
    """The 1-D pooling operator of one axis, (R, o, total) f32: pooling
    along the axis is ``out[r, i] = sum_y A[r, i, y] * feat[y]`` (JAX
    ``roi_align.py:294-322``). The taps of ``_bilinear_taps`` (zero
    outside [-1, size], clamped, high tap min(low + 1, size - 1)), the
    1/s share of the bin mean, rows of ROIs not on this level zero;
    ``offsets`` shifts each ROI's rows into a (images x size)-tall
    axis."""
    fsize = float(size)
    inr = (coords >= -1.0) & (coords <= fsize)
    c = torch.clamp_min(coords, 0.0)
    low = torch.minimum(torch.floor(c), torch.full_like(c, fsize - 1.0))
    c = torch.minimum(c, torch.full_like(c, fsize - 1.0))
    lw = c - low
    hw = 1.0 - lw
    low_i = low.long()
    high_i = torch.clamp_max(low_i + 1, size - 1)
    if offsets is not None:
        low_i = low_i + offsets[:, None]
        high_i = high_i + offsets[:, None]
    cols = torch.arange(total, device=coords.device)
    w = hw[..., None] * (low_i[..., None] == cols) \
        + lw[..., None] * (high_i[..., None] == cols)
    w = w * (inr & roi_mask[:, None])[..., None]
    R = coords.shape[0]
    w = w.reshape(R, output_size, sampling_ratio, total)
    return w.sum(dim=2) * (1.0 / sampling_ratio)


def roi_align_feature_grad_plain(
    grad: torch.Tensor,  # (R, C, o, o)
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    shapes: Sequence[Tuple[int, int, int, int]],  # per level (N, C, H, W)
    dtype: torch.dtype,
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> List[torch.Tensor]:
    """Plain PyTorch version of kernel 2b: the feature gradient of the
    multilevel ROIAlign, one (N, C, H, W) tensor per level in ``dtype``.

    The pool is separable, out[r,c,i,j] = sum_y Ay[r,i,y] sum_x Ax[r,j,x]
    feat[b_r,c,y,x], so its transpose is two einsums per level, with the
    image index folded into Ay's rows (JAX ``_separable_feature_grad``).
    Computed in f32 and cast once (JAX casts the pooling matrices to the
    gradient's dtype instead: equal in f32)."""
    L = len(shapes)
    lv = torch.clamp(levels.long(), 0, L - 1)
    scale_r = torch.full(lv.shape, float(scales[0]), device=boxes.device)
    for i in range(1, L):
        scale_r = scale_r.masked_fill(lv == i, float(scales[i]))
    ys, xs = _axis_coords(boxes.float(), scale_r, output_size,
                          sampling_ratio, aligned)
    bidx = batch_indices.long()
    g = grad.float()
    out = []
    for lvl, (N, C, H, W) in enumerate(shapes):
        on_l = lv == lvl
        ay = _axis_pool_matrix(ys, H, output_size, sampling_ratio, on_l,
                               bidx * H, N * H)
        ax = _axis_pool_matrix(xs, W, output_size, sampling_ratio, on_l,
                               None, W)
        tmp = torch.einsum("rjx,rcij->rcix", ax, g)
        d = torch.einsum("riy,rcix->cyx", ay, tmp)  # (C, N*H, W)
        out.append(d.reshape(C, N, H, W).transpose(0, 1).to(dtype)
                   .contiguous())
    return out


def _forward(features, boxes, batch_indices, levels, scales, output_size,
             sampling_ratio, aligned) -> torch.Tensor:
    if boxes.is_cuda:
        return _kernels.roi_align(
            [f.contiguous() for f in features], boxes.float().contiguous(),
            batch_indices.to(torch.int32).contiguous(),
            levels.to(torch.int32).contiguous(), scales, output_size,
            sampling_ratio, aligned)
    return multilevel_roi_align_plain(features, boxes, batch_indices, levels,
                                      scales, output_size, sampling_ratio,
                                      aligned)


def _backward(grad, boxes, batch_indices, levels, shapes, dtype, scales,
              output_size, sampling_ratio, aligned) -> List[torch.Tensor]:
    if grad.is_cuda:
        return _kernels.roi_align_backward(
            grad.contiguous(), boxes.float().contiguous(),
            batch_indices.to(torch.int32).contiguous(),
            levels.to(torch.int32).contiguous(), shapes, dtype, scales,
            output_size, sampling_ratio, aligned)
    return roi_align_feature_grad_plain(grad, boxes, batch_indices, levels,
                                        shapes, dtype, scales, output_size,
                                        sampling_ratio, aligned)


class _MultilevelRoiAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, boxes, batch_indices, levels, scales, output_size,
                sampling_ratio, aligned, *features):
        ctx.save_for_backward(boxes, batch_indices, levels)
        ctx.args = (tuple(tuple(f.shape) for f in features),
                    features[0].dtype, tuple(scales), output_size,
                    sampling_ratio, aligned)
        return _forward(list(features), boxes, batch_indices, levels, scales,
                        output_size, sampling_ratio, aligned)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        boxes, batch_indices, levels = ctx.saved_tensors
        shapes, dtype, scales, o, s, aligned = ctx.args
        grads = _backward(grad, boxes, batch_indices, levels, shapes, dtype,
                          scales, o, s, aligned)
        return (None,) * 7 + tuple(grads)


def multilevel_roi_align(
    features: List[torch.Tensor],
    boxes: torch.Tensor,
    batch_indices: torch.Tensor,
    levels: torch.Tensor,
    scales: Sequence[float],
    output_size: int,
    sampling_ratio: int = 2,
    aligned: bool = True,
) -> torch.Tensor:
    """Multilevel ROIAlign -> (R, C, o, o): kernels 2 and 2b on CUDA
    tensors, the plain versions on CPU tensors; differentiable in the
    features."""
    if sampling_ratio == 0:
        raise NotImplementedError(
            "sampling_ratio=0 (adaptive buckets) is not ported yet "
            "(ROADMAP queue 1, item 12)")
    return _MultilevelRoiAlign.apply(
        boxes.detach(), batch_indices.detach(), levels.detach(),
        tuple(float(s) for s in scales), output_size, sampling_ratio,
        aligned, *features)


# the f32 reciprocal of the f32 log(2), as the Python float it equals
_INV_LN2_F32 = float(torch.tensor(1.0) / torch.log(torch.tensor(2.0)))


def _fused_level(base: float, x: torch.Tensor, sign: float) -> torch.Tensor:
    """``base + sign * log2(x)`` rounded as XLA evaluates the JAX
    expression: log2 as log(x) times the f32 reciprocal of log(2) (XLA
    turns the division by a constant into that product), fused with the
    add into one multiply-add that rounds once. The product of two f32
    values is exact in f64, so the f64 sum rounded to f32 is that single
    rounding. Levels on and next to power-of-two ratios then land on the
    same side of the ceil/floor as in JAX; within a few ulps of a power
    of two the libraries' logf can still differ by one ulp."""
    return (base + sign * (torch.log(x).double() * _INV_LN2_F32)).float()


def assign_boxes_by_ratio(box_areas: torch.Tensor, img_areas: torch.Tensor,
                          min_level: int, max_level: int) -> torch.Tensor:
    """CenterMask adaptive ROI level assignment, Eqn (2) (reference
    pooler.py:111-118): ceil(max - log2(img_area/box_area + eps)),
    clamped; 0-based level offsets. As in JAX the double eps is added to
    an f32 ratio (a no-op above ratio 2^-29)."""
    eps = sys.float_info.epsilon
    ratio = img_areas.float() / torch.clamp(box_areas.float(), min=1e-12)
    lv = torch.ceil(_fused_level(max_level, ratio + eps, -1.0))
    lv = torch.clamp(lv, min_level, max_level)
    return lv.to(torch.int32) - min_level


def assign_boxes_by_area(box_areas: torch.Tensor, min_level: int,
                         max_level: int, canonical_box_size: int = 224,
                         canonical_level: int = 4) -> torch.Tensor:
    """FPN paper Eqn (1) assignment (reference pooler.py:121-152)."""
    sizes = torch.sqrt(torch.clamp(box_areas.float(), min=0.0))
    eps = sys.float_info.epsilon
    lv = torch.floor(_fused_level(canonical_level,
                                  sizes / canonical_box_size + eps, 1.0))
    lv = torch.clamp(lv, min_level, max_level)
    return lv.to(torch.int32) - min_level
