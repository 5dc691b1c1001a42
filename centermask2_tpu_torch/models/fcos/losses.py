"""FCOS training targets and losses, vectorized and masked (the port of
``centermask2_tpu/models/fcos/losses.py``).

- Ground-truth assignment (reference fcos_outputs.py:229-315): the
  per-(location, gt) geometry as one (B, L, G) grid for the whole batch,
  with center sampling, size-of-interest ranges and the minimum-area
  match (``torch.argmin`` takes the first minimum, as ``jnp.argmin``).
- Losses (reference fcos_outputs.py:76-132): sigmoid focal (classes),
  centerness-weighted GIoU (boxes), BCE (centerness).

The two normalizers (positives, centerness sum) are means across data
replicas in the reference: ``reduce``, when given, is a callable that
returns the cross-replica mean of a scalar tensor, with no gradient
(``utils/comm.py::mean_reduce``, the JAX ``psum(x) / world``);
``None`` is one replica.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ...ops.losses import iou_loss, optax_sigmoid_bce, sigmoid_focal_loss

INF = 100000000.0

Reduce = Optional[Callable[[torch.Tensor], torch.Tensor]]


def level_metadata(num_locs: Sequence[int], strides: Sequence[int],
                   sizes_of_interest: Sequence[int],
                   device: torch.device = torch.device("cpu")
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-location stride (L,) and size-of-interest range (L, 2),
    concatenated over levels (reference fcos.py:52-58 builds
    [[-1, 64], [64, 128], ...]), filled on ``device`` (no host copy)."""
    soi: List[Tuple[float, float]] = []
    prev = -1.0
    for s in sizes_of_interest:
        soi.append((prev, float(s)))
        prev = float(s)
    soi.append((prev, INF))
    strides_per_loc = torch.cat([
        torch.full((n,), float(s), device=device)
        for n, s in zip(num_locs, strides)])
    ranges = torch.cat([
        torch.stack([torch.full((n,), lo, device=device),
                     torch.full((n,), hi, device=device)], dim=1)
        for n, (lo, hi) in zip(num_locs, soi)])
    return strides_per_loc, ranges


def assign_targets_single_image(
    locations: torch.Tensor,  # (L, 2) concatenated over levels
    strides_per_loc: torch.Tensor,  # (L,)
    size_ranges: torch.Tensor,  # (L, 2)
    gt_boxes: torch.Tensor,  # (B, G, 4) padded
    gt_classes: torch.Tensor,  # (B, G) int
    gt_valid: torch.Tensor,  # (B, G) bool
    num_classes: int,
    center_sample: bool = True,
    radius: float = 1.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (labels (B, L) int32, reg_targets (B, L, 4) in pixels) for
    a batch of images (the JAX function of this name is vmapped over it).

    labels == num_classes means background. Invalid gt rows are never
    assigned (their area is forced to INF)."""
    xs = locations[:, 0][None, :, None]  # (1, L, 1)
    ys = locations[:, 1][None, :, None]
    gx0, gy0, gx1, gy1 = (gt_boxes[..., i][:, None, :] for i in range(4))

    l = xs - gx0
    t = ys - gy0
    r = gx1 - xs
    b = gy1 - ys
    reg_targets = torch.stack([l, t, r, b], dim=3)  # (B, L, G, 4)

    if center_sample:
        # center region of each gt, clamped inside the gt box, with a
        # radius proportional to the location's stride (get_sample_region)
        cx = (gx0 + gx1) / 2
        cy = (gy0 + gy1) / 2
        rad = strides_per_loc[None, :, None] * radius  # (1, L, 1)
        xmin = torch.maximum(cx - rad, gx0)
        ymin = torch.maximum(cy - rad, gy0)
        xmax = torch.minimum(cx + rad, gx1)
        ymax = torch.minimum(cy + rad, gy1)
        inside = torch.stack([xs - xmin, ys - ymin, xmax - xs, ymax - ys],
                             dim=3).amin(dim=3) > 0
    else:
        inside = reg_targets.amin(dim=3) > 0

    max_reg = reg_targets.amax(dim=3)  # (B, L, G)
    cared = (max_reg >= size_ranges[None, :, 0:1]) & \
        (max_reg <= size_ranges[None, :, 1:2])

    areas = ((gx1 - gx0) * (gy1 - gy0)).expand_as(max_reg)
    loc_to_gt_area = torch.where(inside & cared & gt_valid[:, None, :],
                                 areas, torch.full_like(areas, INF))
    min_area, gt_inds = loc_to_gt_area.min(dim=2)  # first minimum
    # the JAX one-hot contractions select exactly these rows
    labels = torch.gather(gt_classes.to(torch.int32), 1, gt_inds)
    labels = torch.where(min_area == INF, num_classes, labels)
    reg = torch.gather(reg_targets, 2,
                       gt_inds[:, :, None, None].expand(-1, -1, 1, 4))[:, :, 0]
    return labels.to(torch.int32), reg


def compute_ctrness_targets(reg_targets: torch.Tensor) -> torch.Tensor:
    """sqrt((min(l,r)/max(l,r)) * (min(t,b)/max(t,b))) (reference
    fcos_outputs.py:66-73), safe on padded rows."""
    lr = reg_targets[:, 0::2]
    tb = reg_targets[:, 1::2]
    lr_min, lr_max = lr.amin(dim=-1), lr.amax(dim=-1)
    tb_min, tb_max = tb.amin(dim=-1), tb.amax(dim=-1)
    ratio = (lr_min / torch.maximum(lr_max, torch.full_like(lr_max, 1e-12))) \
        * (tb_min / torch.maximum(tb_max, torch.full_like(tb_max, 1e-12)))
    return torch.sqrt(torch.maximum(ratio, torch.zeros_like(ratio)))


def fcos_losses(
    labels: torch.Tensor,  # (T,) int, num_classes == background
    reg_targets: torch.Tensor,  # (T, 4) stride-normalized
    logits_pred: torch.Tensor,  # (T, C)
    reg_pred: torch.Tensor,  # (T, 4) stride-normalized
    ctrness_pred: torch.Tensor,  # (T,)
    num_classes: int,
    focal_alpha: float = 0.25,
    focal_gamma: float = 2.0,
    loc_loss_type: str = "giou",
    reduce: Reduce = None,
) -> Dict[str, torch.Tensor]:
    """Masked re-derivation of reference fcos_losses (fcos_outputs.py:
    76-132), in f32 whatever the head's dtype."""
    def mean(x):
        return x if reduce is None else reduce(x)

    pos_mask = (labels != num_classes) & (labels >= 0)
    posf = pos_mask.float()
    num_pos_avg = torch.clamp_min(mean(posf.sum()), 1.0)

    classes = torch.arange(num_classes, device=labels.device)
    # jax.nn.one_hot: the background id (== num_classes) gives a zero row
    class_target = (labels[:, None] == classes).float() * posf[:, None]
    class_loss = sigmoid_focal_loss(
        logits_pred.float(), class_target, focal_alpha,
        focal_gamma).sum() / num_pos_avg

    ctr_targets = compute_ctrness_targets(reg_targets) * posf
    ctrness_norm = torch.clamp_min(mean(ctr_targets.sum()), 1e-6)
    reg_loss = iou_loss(reg_pred.float(), reg_targets, weight=ctr_targets,
                        loss_type=loc_loss_type) / ctrness_norm
    ctr_loss = (optax_sigmoid_bce(ctrness_pred.float(), ctr_targets)
                * posf).sum() / num_pos_avg
    return {"loss_fcos_cls": class_loss, "loss_fcos_loc": reg_loss,
            "loss_fcos_ctr": ctr_loss}
