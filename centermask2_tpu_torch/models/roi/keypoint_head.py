"""Keypoint head (KRCNN conv-deconv-upsample), its heatmap loss and its
decode, NCHW (the port of ``centermask2_tpu/models/roi/keypoint_head.py``).

- ``KRCNNConvDeconvUpsampleHead``: 8 x conv3x3(512) + relu, a
  ConvTranspose2d(k4, s2, p1) to K maps (14 -> 28), and a bilinear 2x
  upsample with half-pixel centers (28 -> 56), on (R, C, 14, 14) pooled
  features to (R, K, 56, 56) logits. JAX's ``lax.conv_transpose(...,
  padding=2 per side, transpose_kernel=True)`` with its (kh, kw, K, C)
  kernel is this deconv with the (C, K, kh, kw) weight
  (``checkpoint/from_jax.py`` permutes it as a conv's kernel).
- ``heatmaps_to_keypoints``: detectron2's decode in JAX's static-shape
  form. Each ROI's maps are upsampled to a fixed 112 x 112 grid with
  JAX's bicubic resize, which is not ``F.interpolate``'s: Keys' cubic
  with a = -0.5 (torch: -0.75), taps that fall outside the map dropped
  and each row of weights renormalized (torch clamps at the border).
  Here that resize is one (grid, S) weight matrix per axis
  (``bicubic_resize_matrix``), applied as ``W @ map @ W.T``. Then the
  argmax (ties: the first index, as ``jnp.argmax``), the cell centre
  mapped back through the box, and detectron2's softmax probability at
  the argmax cell.
- ``keypoints_to_heatmap`` and ``keypoint_rcnn_loss``: the flat heatmap
  index of each gt keypoint in its ROI (keypoints on the right and
  bottom box edges land in the last bin) and the masked cross-entropy
  over the S x S cells.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...layers import Conv2d, ConvTranspose2d


class KRCNNConvDeconvUpsampleHead(nn.Module):
    """(R, C, 14, 14) -> (R, K, 56, 56) keypoint logits."""

    def __init__(self, in_channels: int = 256, num_keypoints: int = 17,
                 conv_dims: Sequence[int] = (512,) * 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_conv = len(conv_dims)
        ch = in_channels
        for idx, dim in enumerate(conv_dims, 1):
            self.add_module(f"conv_fcn{idx}", Conv2d(
                ch, dim, init="kaiming_fan_out", dtype=dtype))
            ch = dim
        self.score_lowres = ConvTranspose2d(
            ch, num_keypoints, (4, 4), (2, 2), padding=(1, 1),
            init="kaiming_fan_out", dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for idx in range(1, self.num_conv + 1):
            x = F.relu(getattr(self, f"conv_fcn{idx}")(x))
        x = self.score_lowres(x)
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


_BICUBIC: Dict[Tuple[int, int, str], torch.Tensor] = {}


def bicubic_resize_matrix(size: int, grid: int,
                          device=None) -> torch.Tensor:
    """(grid, size) f32 matrix of ``jax.image.resize(..., "bicubic")``
    along one axis, upsampling ``size`` to ``grid``: Keys' cubic kernel
    with a = -0.5 at the sample points (i + 0.5) * size / grid - 0.5,
    each row divided by its sum over the taps inside the map. Built once
    per (size, grid, device) with device operations (no host copy)."""
    dev = torch.device("cpu" if device is None else device)
    key = (size, grid, str(dev))
    w = _BICUBIC.get(key)
    if w is None:
        a = -0.5
        centre = (torch.arange(grid, dtype=torch.float64, device=dev)
                  + 0.5) * (size / grid) - 0.5
        d = (torch.arange(size, dtype=torch.float64, device=dev)[None, :]
             - centre[:, None]).abs()
        near = ((a + 2) * d - (a + 3)) * d * d + 1
        far = ((a * d - 5 * a) * d + 8 * a) * d - 4 * a
        w = torch.where(d <= 1, near, torch.where(d < 2, far,
                                                  torch.zeros_like(d)))
        w = (w / w.sum(dim=1, keepdim=True)).float()
        _BICUBIC[key] = w
    return w


def heatmaps_to_keypoints(keypoint_logits: torch.Tensor,  # (R, K, S, S)
                          boxes: torch.Tensor,  # (R, 4)
                          grid: int = 112) -> torch.Tensor:
    """detectron2 heatmaps_to_keypoints in the static-shape form of the JAX
    package: (R, K, 4) of (x, y, logit, prob). The maps are upsampled to
    ``grid`` x ``grid`` (``bicubic_resize_matrix``), argmaxed, and the
    cell centre mapped back through the box, x = x0 + (xi + 0.5) / grid *
    max(width, 1). The probability is exp(0) / sum(exp(map - max_up))
    over the S x S map, at the argmax cell."""
    R, K, S, _ = keypoint_logits.shape
    maps = keypoint_logits.float()
    w = bicubic_resize_matrix(S, grid, maps.device)
    up = torch.matmul(torch.matmul(w, maps), w.t())  # (R, K, grid, grid)
    flat = up.reshape(R, K, grid * grid)
    max_up = flat.amax(dim=2)
    idx = flat.argmax(dim=2)  # the first of equal maxima, as jnp.argmax
    yi = torch.div(idx, grid, rounding_mode="floor").float() + 0.5
    xi = (idx % grid).float() + 0.5
    b = boxes.float()
    bw = torch.clamp_min(b[:, 2] - b[:, 0], 1.0)[:, None]
    bh = torch.clamp_min(b[:, 3] - b[:, 1], 1.0)[:, None]
    x = b[:, 0:1] + xi / grid * bw
    y = b[:, 1:2] + yi / grid * bh
    denom = torch.exp(maps - max_up[:, :, None, None]).sum(dim=(2, 3))
    prob = 1.0 / torch.clamp_min(denom, 1e-12)
    return torch.stack([x, y, max_up, prob], dim=-1)


def keypoint_rcnn_inference(keypoint_logits: torch.Tensor,
                            boxes: torch.Tensor) -> torch.Tensor:
    """(R, K, 3) of (x, y, prob): detectron2's keypoint_rcnn_inference
    keeps columns 0, 1 and 3 of ``heatmaps_to_keypoints`` (sliced, not
    indexed by a host list, which a CUDA graph could not capture)."""
    res = heatmaps_to_keypoints(keypoint_logits, boxes)
    return torch.cat([res[..., :2], res[..., 3:]], dim=-1)


def keypoints_to_heatmap(keypoints: torch.Tensor,  # (R, K, 3) x, y, vis
                         boxes: torch.Tensor,  # (R, 4)
                         heatmap_size: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """detectron2 Keypoints.to_heatmap: each keypoint's flat cell index in
    its ROI's S x S heatmap and whether it counts (inside the box and
    visible). A keypoint exactly on the right or bottom box edge takes
    the last bin and stays valid. Returns (index (R, K) int64, valid
    (R, K) bool)."""
    S = heatmap_size
    b = boxes.float()
    x0, y0 = b[:, 0:1], b[:, 1:2]
    scale_x = S / torch.clamp_min(b[:, 2:3] - x0, 1e-6)
    scale_y = S / torch.clamp_min(b[:, 3:4] - y0, 1e-6)
    kx, ky, vis = keypoints.float().unbind(-1)
    xf = torch.floor((kx - x0) * scale_x)
    yf = torch.floor((ky - y0) * scale_y)
    last = torch.full_like(xf, S - 1.0)
    xf = torch.where(kx == b[:, 2:3], last, xf)
    yf = torch.where(ky == b[:, 3:4], last, yf)
    inside = (xf >= 0) & (xf < S) & (yf >= 0) & (yf < S)
    x_idx = torch.clamp(xf, 0, S - 1).long()
    y_idx = torch.clamp(yf, 0, S - 1).long()
    return y_idx * S + x_idx, inside & (vis > 0)


def keypoint_rcnn_loss(keypoint_logits: torch.Tensor,  # (R, K, S, S)
                       heatmap_targets: torch.Tensor,  # (R, K) flat index
                       valid: torch.Tensor,  # (R, K) bool
                       normalizer: Optional[float] = None) -> torch.Tensor:
    """Softmax cross-entropy over the heatmap cells of the valid
    keypoints (reference keypoint_head.py:30-86), divided by the number of
    valid keypoints or by ``normalizer`` (at least 1); 0 when none is
    valid."""
    R, K, S, _ = keypoint_logits.shape
    logp = F.log_softmax(keypoint_logits.float().reshape(R * K, S * S),
                         dim=-1)
    nll = -torch.gather(logp, 1, heatmap_targets.reshape(R * K, 1).long())[:, 0]
    v = valid.reshape(R * K).float()
    total = (nll * v).sum()
    n = v.sum()
    norm = n if normalizer is None else torch.full_like(n, normalizer)
    return torch.where(n > 0, total / torch.clamp_min(norm, 1.0),
                       torch.zeros_like(total))
