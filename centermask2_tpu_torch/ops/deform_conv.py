"""Deformable convolution v1/v2, stride 1 (the port of
``centermask2_tpu/ops/deform_conv.py``), NCHW.

For each output pixel p and kernel tap k the input is sampled at
p + k * dilation - padding + offset[p, k] with bilinear interpolation,
zero outside the map tap by tap; with a modulation mask (DCN v2) each
sample is scaled by its mask value; then the taps contract with the
kernel. As in JAX it is an explicit gather of the four bilinear taps
(``torch.gather`` on the flattened map, XLA's gather there) and one
contraction, in f32, the result cast back to the input's dtype. JAX
runs it outside any Pallas kernel, so the port has no CUDA kernel for
it: the same operations run on the CPU and on the card. ``grid_sample``
is not used: its normalized coordinates round differently.
"""

from __future__ import annotations

from typing import Optional

import torch


def deform_conv2d(x: torch.Tensor,  # (N, C, H, W)
                  offsets: torch.Tensor,  # (N, 2*kh*kw, H, W): (dy, dx) a tap
                  weight: torch.Tensor,  # (O, C, kh, kw)
                  mask: Optional[torch.Tensor] = None,  # (N, kh*kw, H, W)
                  bias: Optional[torch.Tensor] = None,  # (O,)
                  padding: int = 1, dilation: int = 1) -> torch.Tensor:
    """Stride-1 deformable conv -> (N, O, H, W) in ``x``'s dtype. The taps
    are summed in JAX's order ((0, 0), (0, 1), (1, 0), (1, 1)) with the
    weights (wy * wx) * in-bounds."""
    N, C, H, W = x.shape
    O, _, kh, kw = weight.shape
    K = kh * kw
    dev = x.device
    off = offsets.float().reshape(N, K, 2, H, W)
    tap = torch.arange(K, device=dev)
    base_y = (torch.div(tap, kw, rounding_mode="floor") * dilation).float()
    base_x = ((tap % kw) * dilation).float()
    py = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None] \
        + base_y[:, None, None] - padding  # (K, H, 1)
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :] \
        + base_x[:, None, None] - padding  # (K, 1, W)
    ys = py[None] + off[:, :, 0]  # (N, K, H, W)
    xs = px[None] + off[:, :, 1]

    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    flat = x.float().reshape(N, C, H * W)
    out = None
    for dy, wy in ((0, 1.0 - ly), (1, ly)):
        for dx, wx in ((0, 1.0 - lx), (1, lx)):
            yy = y0 + dy
            xx = x0 + dx
            inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            idx = (torch.clamp(yy, 0, H - 1) * W
                   + torch.clamp(xx, 0, W - 1)).long()
            g = torch.gather(flat, 2, idx.reshape(N, 1, K * H * W)
                             .expand(N, C, K * H * W))
            w = (wy * wx * inb).reshape(N, 1, K * H * W)
            term = g * w
            out = term if out is None else out + term
    if mask is not None:
        out = out * mask.float().reshape(N, 1, K * H * W)
    cols = out.reshape(N, C * K, H * W)
    y = torch.matmul(weight.float().reshape(O, C * K), cols)
    y = y.reshape(N, O, H, W)
    if bias is not None:
        y = y + bias.float()[None, :, None, None]
    return y.to(x.dtype)
