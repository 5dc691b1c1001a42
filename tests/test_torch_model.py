"""Port parity for the whole slice: ``centermask2_tpu_torch`` CenterMask
inference against the JAX CenterMask, on the CPU in float32.

A narrow V-19-slim-eSE model (5 classes, FPN 64, mask/MaskIoU convs 16,
15 output slots) on a non-square 128x160 canvas: the JAX parameters,
perturbed from their init with numpy, go through
``checkpoint/from_jax.py`` into the port, and the valid output slots must
agree within the tolerances of tests/test_e2e_torch.py:514-520 (the two
frameworks' f32 convolutions sum in different orders). Also: one V-39
OSA module, the loader's failure modes, and ``build_centermask``'s
device rule and unported options.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models.backbones.vovnet import OSAModule as JaxOSA  # noqa: E402
from centermask2_tpu_torch import build_centermask, get_cfg  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402
from centermask2_tpu_torch.models.backbones import OSAModule  # noqa: E402
from centermask2_tpu_torch.models.meta import CenterMask  # noqa: E402

PIXEL_MEAN = np.asarray([103.53, 116.28, 123.675], np.float32)
SMALL = dict(conv_body="V-19-slim-eSE", num_classes=5, fpn_out_channels=64,
             mask_conv_dim=16, maskiou_conv_dim=16, post_nms_topk_test=15)


def _perturb(params, rng):
    """Move FrozenBN and biases off their init so that every affine term
    matters; zero the classification prior bias so that the decode keeps
    real candidates."""
    def leaf(path, x):
        name = path[-1].key
        if name == "frozen_scale":
            return (1 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        if name in ("bias", "frozen_bias"):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return np.asarray(x, np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, params)
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    return params


@pytest.fixture(scope="module")
def jax_and_port():
    rng = np.random.RandomState(0)
    img = (rng.rand(1, 128, 160, 3).astype(np.float32) * 255.0 - PIXEL_MEAN)
    jm = JaxCenterMask(**SMALL, dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(img))
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng)
    out = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(img))
    port = CenterMask(**SMALL, dtype=torch.float32).eval()
    load_jax_params(port, params)
    got = port.inference(torch.from_numpy(img))
    return out, got, params


def test_whole_slice_matches_jax(jax_and_port):
    out, got, _ = jax_and_port
    valid = np.asarray(out.valid[0])
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    n = int(valid.sum())
    assert n > 3, "the parity test needs detections to be meaningful"

    def pair(field):
        return np.asarray(getattr(out, field)[0])[:n], \
            getattr(got, field)[0][:n].numpy()

    j, t = pair("pred_classes")
    np.testing.assert_array_equal(t, j)
    np.testing.assert_allclose(*pair("locations")[::-1], atol=1e-3)
    np.testing.assert_allclose(*pair("scores")[::-1], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(*pair("pred_boxes")[::-1], rtol=1e-3,
                               atol=2e-2)
    np.testing.assert_allclose(*pair("pred_masks")[::-1], atol=2e-3)
    np.testing.assert_allclose(*pair("mask_scores")[::-1], rtol=2e-3,
                               atol=2e-3)


def test_output_contract(jax_and_port):
    _, got, _ = jax_and_port
    assert got.pred_masks.shape == (1, 15, 1, 28, 28)
    assert got.pred_classes.dtype == torch.int32
    assert got.valid.dtype == torch.bool
    invalid = ~got.valid[0]
    assert (got.pred_boxes[0][invalid] == 0).all()
    assert (got.scores[0][invalid] == 0).all()


def test_v39_osa_module_matches_jax():
    """A V-39 OSA module: 5 layers, identity residual, at narrow width."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 32, 12, 10).astype(np.float32)
    jmod = JaxOSA(stage_ch=16, concat_ch=32, layer_per_block=5,
                  identity=True, dtype=jnp.float32)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    params = jax.tree.map(np.asarray,
                          jmod.init(jax.random.PRNGKey(1), xj)["params"])
    params = _perturb_osa(params, rng)
    want = np.transpose(np.asarray(jmod.apply({"params": params}, xj)),
                        (0, 3, 1, 2))
    port = OSAModule(32, 16, 32, 5, identity=True)
    load_jax_params(port, params)
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _perturb_osa(params, rng):
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32),
        params)


def test_loader_fails_on_unused_or_missing_leaves(jax_and_port):
    _, _, params = jax_and_port
    port = CenterMask(**SMALL, dtype=torch.float32)
    extra = dict(params, stray={"kernel": np.zeros((1, 1, 2, 2), np.float32)})
    with pytest.raises(ValueError, match="stray/kernel"):
        load_jax_params(port, extra)
    fewer = {k: v for k, v in params.items() if k != "fpn"}
    with pytest.raises(ValueError, match="fpn"):
        load_jax_params(port, fewer)


def _small_cfg():
    cfg = get_cfg()
    cfg.MODEL.VOVNET.CONV_BODY = "V-19-slim-eSE"
    cfg.MODEL.FCOS.NUM_CLASSES = 3
    cfg.MODEL.FPN.OUT_CHANNELS = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 8
    cfg.MODEL.ROI_MASKIOU_HEAD.CONV_DIM = 8
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.MASKIOU_ON = True
    cfg.MODEL.ROI_MASK_HEAD.ASSIGN_CRITERION = "ratio"
    cfg.MODEL.FCOS.POST_NMS_TOPK_TEST = 10
    return cfg


def test_build_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_centermask(_small_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        build_centermask(_small_cfg(), device="cuda")


def test_build_on_cpu_runs_bf16_inference():
    cfg = _small_cfg()
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16"
    model = build_centermask(cfg, device="cpu", seed=3)
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    img = torch.from_numpy(
        np.random.RandomState(2).rand(2, 64, 96, 3).astype(np.float32) * 255
        - PIXEL_MEAN)
    out = model.inference(img)
    assert out.pred_masks.shape == (2, 10, 1, 28, 28)
    assert out.pred_masks.dtype == torch.float32
    assert int(out.valid.sum()) > 0
    for f in ("scores", "pred_boxes", "pred_masks", "mask_scores"):
        assert torch.isfinite(getattr(out, f)).all()
    # the same seed draws the same parameters
    again = build_centermask(cfg, device="cpu", seed=3)
    a, b = model.state_dict(), again.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a if "cls_logits.bias" not in k)
    with pytest.raises(ValueError, match="divisible by 32"):
        model.inference(img[:, :60])


@pytest.mark.parametrize("opts", [
    ["TPU.APPROX_TOPK", True],
    ["MODEL.BACKBONE.NAME", "build_fcos_resnet_fpn_backbone",
     "MODEL.RESNETS.RES5_DILATION", 2],
    ["MODEL.VOVNET.STAGE_WITH_DCN", "(False, False, True, True)",
     "MODEL.VOVNET.DEFORMABLE_GROUPS", 2],
    ["MODEL.VOVNET.STAGE_WITH_DCN", "(False, False, False, True)",
     "MODEL.VOVNET.WITH_MODULATED_DCN", True,
     "MODEL.VOVNET.DEFORMABLE_GROUPS", 4]],
    ids=lambda opts: "-".join(map(str, opts)))
def test_unported_options_raise(opts):
    """What the port refuses: the TPU's approximate top-k and the two
    options the JAX reference cannot run (RES5_DILATION 2, more than one
    deformable group)."""
    cfg = _small_cfg()
    cfg.merge_from_list([str(v) for v in opts])
    with pytest.raises(NotImplementedError):
        build_centermask(cfg, device="cpu")


@pytest.mark.parametrize("opts", [
    ["TPU.POOLER_SAMPLING_RATIO", 0], ["MODEL.KEYPOINT_ON", True],
    ["MODEL.FCOS.USE_DEFORMABLE", True],
    ["MODEL.VOVNET.STAGE_WITH_DCN", "(False, True, False, True)",
     "MODEL.VOVNET.WITH_MODULATED_DCN", True],
    ["TPU.REMAT_BACKBONE", True], ["MODEL.VOVNET.NORM", "BN"],
    ["MODEL.VOVNET.NORM", "SyncBN"], ["MODEL.ROI_MASK_HEAD.NORM", "BN"]],
    ids=lambda opts: "-".join(map(str, opts)))
def test_once_refused_options_build_and_serve(opts):
    """The options the port refused until the keypoint and the data
    parallel slices build and serve a 64x64 request with finite outputs
    (their parity with JAX: ``test_torch_keypoints.py``,
    ``test_torch_deform.py``, ``test_torch_roi_align.py``,
    ``test_torch_batchnorm.py`` and ``test_torch_parallel.py``)."""
    cfg = _small_cfg()
    cfg.merge_from_list([str(v) for v in opts])
    model = build_centermask(cfg, device="cpu")
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    img = torch.randn(1, 64, 64, 3) * 50
    out = model.inference(img)
    assert int(out.valid.sum()) > 0
    for f, v in out._asdict().items():
        if v is not None and v.is_floating_point():
            assert torch.isfinite(v).all(), f
    assert (out.pred_keypoints is not None) == cfg.MODEL.KEYPOINT_ON


def test_decode_matches_jax():
    """The fused cross-level decode (top-k, box decode, class-aware NMS,
    post-NMS top-k) on random head outputs of a 128x160 canvas."""
    from centermask2_tpu.models.fcos import outputs as jout
    from centermask2_tpu_torch.models.fcos import outputs as tout

    rng = np.random.RandomState(5)
    C, strides = 6, (8, 16, 32, 64, 128)
    shapes = [(-(-128 // s), -(-160 // s)) for s in strides]
    logits = [rng.randn(1, C, h, w).astype(np.float32) - 3.5
              for h, w in shapes]  # few candidates: some slots stay empty
    reg = [np.abs(rng.randn(1, 4, h, w)).astype(np.float32) * 3
           for h, w in shapes]
    ctr = [rng.randn(1, 1, h, w).astype(np.float32) for h, w in shapes]
    kw = dict(pre_nms_thresh=0.3, pre_nms_topk=1000, nms_thresh=0.6,
              post_nms_topk=30, nms_candidates=200)

    def hwc(x):  # (1, C, H, W) -> (H*W, C)
        return jnp.asarray(np.transpose(x[0], (1, 2, 0)).reshape(-1, x.shape[1]))

    want = jout.decode_single_image(
        jout.compute_locations(shapes, strides), [hwc(x) for x in logits],
        [hwc(x) for x in reg], [hwc(x)[:, 0] for x in ctr], strides, **kw)
    got = tout.decode_single_image(
        tout.compute_locations(shapes, strides, torch.device("cpu")),
        [torch.from_numpy(x) for x in logits],
        [torch.from_numpy(x) for x in reg],
        [torch.from_numpy(x) for x in ctr], strides, **kw)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert 3 < valid.sum() < 30
    for f in ("pred_classes", "locations"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.pred_boxes.numpy()[valid],
                               np.asarray(want.pred_boxes)[valid],
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("branch", ["fused", "per-level"])
def test_decode_boundary_tie_matches_jax(branch):
    """A tie planted across the k-th place of both top-k stages: 40
    locations of P3 share one best-class score, more than the 12
    candidates (fused) or the 12 a level (per-level) that the decode
    keeps. The port takes them lowest index first, as ``lax.top_k`` does
    on the CPU: the same candidate set, the same output slots and scores
    as JAX (scores within 1e-6 relative, boxes 1e-5 absolute)."""
    from centermask2_tpu.models.fcos import outputs as jout
    from centermask2_tpu_torch.models.fcos import outputs as tout

    C, strides = 3, (8, 16, 32, 64, 128)
    shapes = [(-(-128 // s), -(-160 // s)) for s in strides]
    logits = [np.full((1, C, h, w), -8.0, np.float32) for h, w in shapes]
    # 40 tied P3 locations, every other one along the first rows, class 1;
    # their class 0 and 2 scores tie below them
    tied = np.arange(0, 80, 2)
    flat = logits[0].reshape(C, -1)
    flat[1, tied] = 1.0
    flat[0, tied] = 0.5
    flat[2, tied] = 0.5
    flat[1, 101:103] = 2.0  # two untied candidates above the tie
    reg = [np.full((1, 4, h, w), 0.2, np.float32) for h, w in shapes]
    ctr = [np.full((1, 1, h, w), 3.0, np.float32) for h, w in shapes]
    kw = dict(pre_nms_thresh=0.3, nms_thresh=0.6, post_nms_topk=40)
    kw.update(dict(pre_nms_topk=1000, nms_candidates=12) if branch == "fused"
              else dict(pre_nms_topk=12, nms_candidates=30))

    def hwc(x):  # (1, C, H, W) -> (H*W, C)
        return jnp.asarray(np.transpose(x[0], (1, 2, 0)).reshape(
            -1, x.shape[1]))

    want = jout.decode_single_image(
        jout.compute_locations(shapes, strides), [hwc(x) for x in logits],
        [hwc(x) for x in reg], [hwc(x)[:, 0] for x in ctr], strides, **kw)
    got = tout.decode_single_image(
        tout.compute_locations(shapes, strides, torch.device("cpu")),
        [torch.from_numpy(x) for x in logits],
        [torch.from_numpy(x) for x in reg],
        [torch.from_numpy(x) for x in ctr], strides, **kw)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() == 12
    for f in ("pred_classes", "locations"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.pred_boxes.numpy()[valid],
                               np.asarray(want.pred_boxes)[valid],
                               rtol=1e-6, atol=1e-5)
    # the tied candidates kept are the lowest-index ones: the 10 first
    locs = got.locations.numpy()[valid]
    w3 = shapes[0][1]
    idx = sorted((locs[:, 1] // 8) * w3 + locs[:, 0] // 8)
    assert [int(i) for i in idx] == list(range(0, 20, 2)) + [101, 102]


@pytest.mark.slow
def test_whole_v39_flagship_matches_jax():
    """The whole V-39-eSE flagship at full width (80 classes, FPN 256, mask
    and MaskIoU convs 256, 50 slots), JAX against the port in f32, on a
    128x160 canvas: the JAX parameters perturbed as above go through
    ``load_jax_params``, and the valid slots agree within the tolerances
    of ``test_whole_slice_matches_jax``."""
    rng = np.random.RandomState(3)
    img = (rng.rand(1, 128, 160, 3).astype(np.float32) * 255.0 - PIXEL_MEAN)
    jm = JaxCenterMask(conv_body="V-39-eSE", dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(img))
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng)
    out = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(img))
    port = CenterMask(conv_body="V-39-eSE", dtype=torch.float32).eval()
    load_jax_params(port, params)
    got = port.inference(torch.from_numpy(img))

    valid = np.asarray(out.valid[0])
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    n = int(valid.sum())
    assert n > 3, "the parity test needs detections to be meaningful"

    def pair(field):
        return getattr(got, field)[0][:n].numpy(), \
            np.asarray(getattr(out, field)[0])[:n]

    np.testing.assert_array_equal(*pair("pred_classes"))
    np.testing.assert_allclose(*pair("locations"), atol=1e-3)
    np.testing.assert_allclose(*pair("scores"), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(*pair("pred_boxes"), rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(*pair("pred_masks"), atol=2e-3)
    np.testing.assert_allclose(*pair("mask_scores"), rtol=2e-3, atol=2e-3)
