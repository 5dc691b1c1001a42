"""Port parity: ``centermask2_tpu_torch/ops/roi_align.py`` against the
JAX ROIAlign.

The port's plain multilevel ROIAlign (the CPU path of kernel 2) must match
both JAX ``multilevel_roi_align`` (the XLA gather) and
``multilevel_roi_align_pallas`` in interpret mode within 1e-5 in float32
(the bin average sums in another order), at C = 128 so that the Pallas
kernel path is taken. Boxes cross and lie outside the level borders, are
degenerate, and sit exactly on level-assignment boundaries.
"""

import importlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

# the JAX ops package re-exports a roi_align function under the module's name
jroi = importlib.import_module("centermask2_tpu.ops.roi_align")
from centermask2_tpu.ops.roi_align_pallas import multilevel_roi_align_pallas  # noqa: E402
from centermask2_tpu_torch.ops import _kernels  # noqa: E402
from centermask2_tpu_torch.ops import roi_align as troi  # noqa: E402

TOL = 1e-5
SCALES = [1 / 8, 1 / 16, 1 / 32]


def make_inputs(C: int, seed: int, N: int = 2, H: int = 96, W: int = 128):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(N, H // s, W // s, C).astype(np.float32)
             for s in (8, 16, 32)]
    boxes = np.array([
        [8, 8, 60, 40], [0, 0, 128, 96], [30.5, 10.2, 95.7, 80.1],
        [120, 90, 127, 95], [-20, -12, 30, 20],  # crosses the top-left
        [100, 70, 160, 130],  # crosses the bottom-right
        [140, 110, 180, 150], [-60, -50, -20, -10],  # outside
        [50, 50, 50, 50], [10, 20, 10.5, 60],  # zero area, thin
    ], np.float32)
    R = len(boxes)
    batch = rng.randint(0, N, R).astype(np.int32)
    levels = (np.arange(R) % 3).astype(np.int32)
    return feats, boxes, batch, levels


def port_pool(feats, boxes, batch, levels, o, s):
    out = troi.multilevel_roi_align(
        [torch.from_numpy(np.transpose(f, (0, 3, 1, 2))) for f in feats],
        torch.from_numpy(boxes), torch.from_numpy(batch),
        torch.from_numpy(levels), SCALES, o, s)
    return np.transpose(out.numpy(), (0, 2, 3, 1))  # -> (R, o, o, C)


@pytest.mark.parametrize("o,s", [(14, 2), (7, 2), (14, 1), (5, 3)])
def test_matches_xla(o, s):
    feats, boxes, batch, levels = make_inputs(C=16, seed=o * 10 + s)
    want = np.asarray(jroi.multilevel_roi_align(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        jnp.asarray(batch), jnp.asarray(levels), SCALES, o, s))
    got = port_pool(feats, boxes, batch, levels, o, s)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_matches_pallas_interpret():
    feats, boxes, batch, levels = make_inputs(C=128, seed=3, N=1)
    want = np.asarray(multilevel_roi_align_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(boxes),
        jnp.asarray(batch), jnp.asarray(levels), SCALES, 14, 2,
        interpret=True))
    got = port_pool(feats, boxes, batch, levels, 14, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bf16_features_accumulate_in_f32():
    feats, boxes, batch, levels = make_inputs(C=8, seed=4)
    tf = [torch.from_numpy(np.transpose(f, (0, 3, 1, 2))) for f in feats]
    args = (torch.from_numpy(boxes), torch.from_numpy(batch),
            torch.from_numpy(levels), SCALES, 14, 2)
    out = troi.multilevel_roi_align([f.bfloat16() for f in tf], *args)
    assert out.dtype == torch.bfloat16
    ref = troi.multilevel_roi_align([f.bfloat16().float() for f in tf], *args)
    assert torch.equal(out, ref.bfloat16())


def _near_powers_of_two(width: int = 5) -> np.ndarray:
    """f32 values on each power of two 2^-3 .. 2^7 and the ``width``
    neighbours on either side: the ratios where a level's ceil/floor
    flips."""
    vals = []
    for k in range(-3, 8):
        up = dn = np.float32(2.0 ** k)
        vals.append(up)
        for _ in range(width):
            up = np.nextafter(up, np.float32(np.inf))
            dn = np.nextafter(dn, np.float32(0))
            vals += [up, dn]
    return np.asarray(vals, np.float32)


def test_assign_boxes_by_ratio_matches_jax():
    """Boxes exactly on, and a few ulps around, the level boundaries
    (img/box = 1, 2, 4, ...), plus zero-area boxes. XLA fuses
    ``max - log(r) * (1/ln2)`` into one multiply-add; the port mirrors
    its single rounding (a plain f32 log(r) / log(2) put boxes one ulp
    from a boundary on another level than JAX)."""
    img = np.float32(800 * 1088)
    areas = np.concatenate([(img / _near_powers_of_two()).astype(np.float32),
                            np.float32([0, 1e-9, 3.0])])
    imgs = np.full_like(areas, img)
    want = np.asarray(jax.jit(
        lambda a, i: jroi.assign_boxes_by_ratio(a, i, 3, 5))(areas, imgs))
    got = troi.assign_boxes_by_ratio(torch.from_numpy(areas),
                                     torch.from_numpy(imgs), 3, 5).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {0, 1, 2}


def test_assign_boxes_by_area_matches_jax():
    sides = 224 * np.sqrt(_near_powers_of_two()).astype(np.float32)
    areas = np.concatenate([sides * sides, np.float32([0, 1, 1e6])])
    want = np.asarray(jax.jit(
        lambda a: jroi.assign_boxes_by_area(a, 2, 6))(areas))
    got = troi.assign_boxes_by_area(torch.from_numpy(areas), 2, 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == 5


def test_double_eps_is_a_noop_on_f32_ratios():
    """The reference adds the double eps to the ratio; on an f32 ratio it
    vanishes in rounding, in JAX and in the port alike."""
    r = torch.tensor([1.0, 2.0, 4.0])
    assert torch.equal(r + sys.float_info.epsilon, r)


def _bucket_inputs(C: int = 6, seed: int = 5):
    """P3-P5 of a 256x320 canvas and ROIs on each level whose adaptive
    ratio ceil(max(h, w) * scale / 14) is 1, 2, 3 or 4 (the 4 bucket) and
    5 (above 4, clamped to 4); ``levels`` cycles over P3-P5."""
    rng = np.random.RandomState(seed)
    N, H, W = 2, 256, 320
    feats = [rng.randn(N, H // s, W // s, C).astype(np.float32)
             for s in (8, 16, 32)]
    boxes, levels = [], []
    for lvl, stride in enumerate((8, 16, 32)):
        for need in (0.6, 1.5, 2.5, 3.7, 5.2):  # in units of 14 px a level
            side = need * 14 * stride
            x0, y0 = rng.rand(2) * [W - 20, H - 20]
            aspect = 0.5 + rng.rand()
            boxes.append([x0, y0, x0 + side, y0 + side * aspect])
            levels.append(lvl)
    boxes = np.asarray(boxes, np.float32)
    batch = rng.randint(0, N, len(boxes)).astype(np.int32)
    return feats, boxes, batch, np.asarray(levels, np.int32)


def _bucket_of(boxes, levels):
    scale = np.asarray(SCALES, np.float32)[levels]
    side = np.maximum(boxes[:, 3] - boxes[:, 1], boxes[:, 2] - boxes[:, 0])
    return np.ceil(side * scale / 14)


def test_sampling_ratio_zero_matches_jax():
    """TPU.POOLER_SAMPLING_RATIO 0: the adaptive buckets (pools at s = 1,
    2 and 4, each ROI's chosen by its ratio, 4 above it) equal JAX's, with
    ROIs in each bucket and above 4 on every level; each ROI equals the
    fixed-ratio pool of its bucket."""
    feats, boxes, batch, levels = _bucket_inputs()
    need = _bucket_of(boxes, levels)
    assert {1, 2, 3, 4, 5} <= set(need.tolist())
    want = np.asarray(jax.jit(
        lambda fs: jroi.multilevel_roi_align(
            fs, jnp.asarray(boxes), jnp.asarray(batch), jnp.asarray(levels),
            SCALES, 14, 0))([jnp.asarray(f) for f in feats]))
    got = port_pool(feats, boxes, batch, levels, 14, 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    bucket = np.where(need <= 1, 1, np.where(need <= 2, 2, 4))
    for s in (1, 2, 4):
        fixed = port_pool(feats, boxes, batch, levels, 14, s)
        np.testing.assert_array_equal(got[bucket == s], fixed[bucket == s])


def test_sampling_ratio_zero_gradient_matches_jax():
    """The feature gradient of the adaptive pool: three pools' VJPs, each
    with the other buckets' ROIs masked by the select, against
    ``jax.vjp`` of JAX's (its separable VJP a bucket)."""
    feats, boxes, batch, levels = _bucket_inputs(seed=6)
    g = np.random.RandomState(7).randn(len(boxes), 6, 14, 14) \
        .astype(np.float32)

    def jpool(*fs):
        return jroi.multilevel_roi_align(
            list(fs), jnp.asarray(boxes), jnp.asarray(batch),
            jnp.asarray(levels), SCALES, 14, 0)

    want = jax.jit(lambda fs, ct: jax.vjp(jpool, *fs)[1](ct))(
        [jnp.asarray(f) for f in feats],
        jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    tf = [torch.from_numpy(np.transpose(f, (0, 3, 1, 2))).requires_grad_(True)
          for f in feats]
    out = troi.multilevel_roi_align(
        tf, torch.from_numpy(boxes), torch.from_numpy(batch),
        torch.from_numpy(levels), SCALES, 14, 0)
    out.backward(torch.from_numpy(g))
    for lvl, (w, f) in enumerate(zip(want, tf)):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        np.testing.assert_allclose(f.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f"level {lvl}")
        assert np.abs(w).max() > 0


def test_kernel_wrapper_refuses_cpu_tensors():
    feats = [torch.zeros(1, 4, 8, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.roi_align(feats, torch.zeros(1, 4),
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), [0.125], 14, 2,
                           True)


@pytest.mark.parametrize("fn", ["roi_align_backward", "roi_tap_windows"])
def test_backward_wrappers_refuse_cpu_tensors(fn):
    """Kernel 2b and its prepass launch on CUDA tensors or raise; the CPU
    path (the plain VJP) is chosen in ops/roi_align.py, not here."""
    idx = torch.zeros(1, dtype=torch.int32)
    shapes = [(1, 4, 8, 8)]
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "roi_align_backward":
            _kernels.roi_align_backward(torch.zeros(1, 4, 14, 14),
                                        torch.zeros(1, 4), idx, idx, shapes,
                                        torch.float32, [0.125], 14, 2, True)
        else:
            _kernels.roi_tap_windows(torch.zeros(1, 4), idx, idx, shapes,
                                     [0.125], 14, 2, True)


def test_kernel_wrapper_refuses_more_samples_than_its_tables():
    """Kernel 2 keeps o*s samples per axis in fixed tables (64)."""
    feats = [torch.zeros(1, 4, 8, 8)]
    with pytest.raises(ValueError, match="samples per axis"):
        _kernels.roi_align(feats, torch.zeros(1, 4),
                           torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), [0.125], 33, 2,
                           True)
