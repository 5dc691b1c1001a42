"""Port parity of the training losses and their targets against the JAX
package, on the CPU in float32: the loss primitives (``ops/losses.py``),
FCOS target assignment and losses, the mask targets
(``crop_and_resize_patches``, ``_patch_fraction_inside``), the MaskIoU
loss, and the ceil-mode max pool's gradient. Inputs come from a numpy
seed; where an op has a max, min, clip or abs, a case puts the tie under
the gradient.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grad_of(fn, *xs):
    """Values and gradients of sum(fn(*xs)) w.r.t. every float input."""
    ts = [t(x).requires_grad_(True) for x in xs]
    out = fn(*ts)
    out.sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in ts]


def test_bce_and_focal_match_jax_with_ties():
    from centermask2_tpu.ops import losses as jl
    from centermask2_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(0)
    logits = (rng.randn(64) * 3).astype(np.float32)
    logits[:8] = 0.0  # max(x, 0) and |x| at their tie
    targets = (rng.rand(64) > 0.5).astype(np.float32)
    targets[4:12] = rng.rand(8).astype(np.float32)
    for jf, tf in ((jl.optax_sigmoid_bce, tl.optax_sigmoid_bce),
                   (jl.sigmoid_focal_loss, tl.sigmoid_focal_loss)):
        want, jg = jax.value_and_grad(
            lambda a, b: jnp.sum(jf(a, b)), argnums=(0, 1))(
                jnp.asarray(logits), jnp.asarray(targets))
        got, tg = grad_of(tf, logits, targets)
        np.testing.assert_allclose(got.sum(), float(want), rtol=1e-6)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("loss_type", ["iou", "linear_iou", "giou"])
def test_iou_loss_matches_jax_with_ties(loss_type):
    from centermask2_tpu.ops import losses as jl
    from centermask2_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(1)
    pred = (rng.rand(40, 4) * 20).astype(np.float32)
    target = (rng.rand(40, 4) * 20).astype(np.float32)
    pred[:10] = target[:10]  # every min and max at its tie
    pred[10:14, :2] = target[10:14, :2]
    target[36:, :2] = -30.0  # negative intersections: the iou clip holds
    weight = rng.rand(40).astype(np.float32)

    def jf(p, q, w):
        return jl.iou_loss(p, q, w, loss_type)

    want, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight))
    got, tg = grad_of(lambda p, q, w: tl.iou_loss(p, q, w, loss_type),
                      pred, target, weight)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("floor", [0.0, 1e-8])
def test_max_floor_splits_the_tie_gradient_as_jnp_clip(floor):
    """``jnp.clip(x, floor)`` (iou_loss's clip, compute_ctrness_targets')
    gives x half the gradient at x == floor; ``torch.clamp`` would give
    all of it."""
    from centermask2_tpu_torch.ops.losses import _max0

    x = np.array([floor, floor + 1.0, floor - 1.0], np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, floor)))(jnp.asarray(x))
    _, (got,) = grad_of(lambda v: _max0(v, floor), x)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0] == 0.5


def _fcos_inputs(rng, B=2, G=4):
    from centermask2_tpu_torch.models.fcos import compute_locations

    shapes = [(8, 8), (4, 4), (2, 2), (1, 1), (1, 1)]
    strides = (8, 16, 32, 64, 128)
    locs = torch.cat(compute_locations(shapes, strides, torch.device("cpu")))
    boxes = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        for g in range(G):
            x0, y0 = rng.rand(2) * 40
            w, h = 8 + rng.rand(2) * 40
            boxes[b, g] = x0, y0, x0 + w, y0 + h
    # equal-area gt boxes over the same locations: the first one wins
    boxes[0, 1] = [4.0, 4.0, 36.0, 20.0]
    boxes[0, 2] = [4.0, 4.0, 20.0, 36.0]
    classes = rng.randint(0, 5, (B, G)).astype(np.int32)
    valid = np.ones((B, G), bool)
    valid[1, -1] = False
    return locs, shapes, strides, boxes, classes, valid


def test_target_assignment_matches_jax_with_equal_areas():
    from centermask2_tpu.models.fcos import losses as jfl
    from centermask2_tpu_torch.models.fcos import losses as tfl

    rng = np.random.RandomState(2)
    locs, shapes, strides, boxes, classes, valid = _fcos_inputs(rng)
    nums = [h * w for h, w in shapes]
    soi = (64, 128, 256, 512)
    js, jr = jfl.level_metadata(nums, strides, soi)
    ts, tr = tfl.level_metadata(nums, strides, soi)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    labels, reg = tfl.assign_targets_single_image(
        locs, ts, tr, t(boxes), t(classes), t(valid), 5, True, 1.5)
    for b in range(boxes.shape[0]):
        jlab, jreg = jfl.assign_targets_single_image(
            jnp.asarray(locs.numpy()), js, jr, jnp.asarray(boxes[b]),
            jnp.asarray(classes[b]), jnp.asarray(valid[b]), 5, True, 1.5)
        np.testing.assert_array_equal(labels[b].numpy(), np.asarray(jlab))
        np.testing.assert_array_equal(reg[b].numpy(), np.asarray(jreg))
    # the tie happened: locations covered by both equal-area boxes
    both = ((locs[:, 0] > 4) & (locs[:, 0] < 20) & (locs[:, 1] > 4)
            & (locs[:, 1] < 20))
    assert bool(both.any())


def test_fcos_losses_match_jax():
    from centermask2_tpu.models.fcos import losses as jfl
    from centermask2_tpu_torch.models.fcos import losses as tfl

    rng = np.random.RandomState(3)
    T, C = 120, 5
    labels = rng.randint(0, C + 1, T).astype(np.int32)
    reg_t = (rng.rand(T, 4) * 5).astype(np.float32)
    reg_t[:3, 0] = reg_t[:3, 2]  # min and max of l, r at their tie
    logits = rng.randn(T, C).astype(np.float32)
    reg = (rng.rand(T, 4) * 5).astype(np.float32)
    reg[5:9] = reg_t[5:9]
    ctr = rng.randn(T).astype(np.float32)

    def jf(lg, rg, ct):
        out = jfl.fcos_losses(jnp.asarray(labels), jnp.asarray(reg_t), lg,
                              rg, ct, C)
        return sum(out.values()), out

    (_, want), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(ctr))
    xs = [t(x).requires_grad_(True) for x in (logits, reg, ctr)]
    got = tfl.fcos_losses(t(labels), t(reg_t), *xs, C)
    sum(got.values()).backward()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6)
    for x, g in zip(xs, jg):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_crop_and_resize_and_fraction_inside_match_jax():
    from centermask2_tpu.models import meta as jm
    from centermask2_tpu_torch.models import meta as tm

    rng = np.random.RandomState(6)
    R, P = 12, 28
    patches = rng.rand(R, P, P).astype(np.float32)
    gt = np.concatenate([rng.rand(R, 2) * 50, rng.rand(R, 2) * 50 + 60],
                        1).astype(np.float32)
    prop = (gt + rng.randn(R, 4) * 8).astype(np.float32)
    prop[:3] = gt[:3]
    prop[3, 2:] = prop[3, :2] - 2  # inverted box
    prop[4] = [-40, -40, -20, -20]  # outside the patch
    want = jm.crop_and_resize_patches(jnp.asarray(patches), jnp.asarray(gt),
                                      jnp.asarray(prop), 28)
    got = tm.crop_and_resize_patches(t(patches), t(gt), t(prop), 28)
    # two f32 matmuls of 28-term sums, summed in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = jm._patch_fraction_inside(jnp.asarray(patches), jnp.asarray(gt),
                                     jnp.asarray(prop))
    got = tm._patch_fraction_inside(t(patches), t(gt), t(prop))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_mask_iou_loss_matches_jax():
    from centermask2_tpu.models.roi.maskiou_head import mask_iou_loss as jl
    from centermask2_tpu_torch.models.roi import mask_iou_loss

    rng = np.random.RandomState(7)
    R, C = 16, 5
    labels = rng.randint(0, C, R).astype(np.int32)
    pred = rng.rand(R, C).astype(np.float32)
    gt_iou = rng.rand(R).astype(np.float32)
    gt_iou[:3] = 0.0  # not positive
    gt_iou[5] = pred[5, labels[5]]  # |sel - gt| at its tie
    valid = rng.rand(R) > 0.2
    want, jg = jax.value_and_grad(
        lambda p: jl(jnp.asarray(labels), p, jnp.asarray(gt_iou),
                     jnp.asarray(valid), 2.0))(jnp.asarray(pred))
    got, (tg,) = grad_of(lambda p: mask_iou_loss(
        t(labels), p, t(gt_iou), t(valid), 2.0), pred)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=1e-6, atol=1e-8)
    none = mask_iou_loss(t(labels), t(pred), t(np.zeros(R, np.float32)),
                         t(valid))
    assert float(none) == 0.0


def test_ceil_max_pool_gradient_ties_match_jax():
    """Tied maxima inside a 3x3/s2 ceil-mode window: the gradient goes to
    the first max, as JAX's reduce_window VJP (blocks.py:294) routes
    it."""
    from centermask2_tpu.layers.blocks import max_pool2d_ceil as jpool
    from centermask2_tpu_torch.layers.blocks import max_pool2d_ceil

    rng = np.random.RandomState(11)
    x = np.round(rng.rand(2, 3, 9, 10) * 3).astype(np.float32)  # many ties
    x[:, :, :3, :3] = 1.0  # a whole window tied
    g = rng.randn(2, 3, 4, 5).astype(np.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    out, vjp = jax.vjp(jpool, xj)
    (want,) = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    xt = t(x).requires_grad_(True)
    got = max_pool2d_ceil(xt)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.transpose(np.asarray(out), (0, 3, 1, 2)))
    (got * t(g)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.transpose(np.asarray(want), (0, 3, 1, 2)))
