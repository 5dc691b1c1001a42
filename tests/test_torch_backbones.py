"""Port parity for the other backbone families and the norms and top
blocks they bring: ResNet, MobileNetV2 and the depthwise VoVNets, the
FPN norms and top blocks, the FCOS tower and mask-head norms, each
against its JAX module on the CPU in float32; then whole models built
from the five yamls these backbones make buildable, against the JAX
``build_centermask`` of the same config.

Inputs and JAX parameters are drawn with numpy from a seed. The
parameters follow the JAX tree's shapes (``jax.eval_shape`` of its
init): convolution and dense kernels LeCun-scaled normals (std
``sqrt(1 / fan_in)``; at He's scale these random nets amplify f32
rounding several times a stage, the standard V-19-eSE included), and
FrozenBN, GroupNorm and bias leaves moved off their init as
``tests/test_torch_model.py::_perturb`` moves them, so that every affine
term matters. The same tree goes through ``checkpoint/from_jax.py``
into the port with ``strict=True``. The JAX modules run op by op, the
whole models under ``jit`` (an op-by-op first run of a whole model
spends some 20 s compiling its ops one at a time); no JAX init runs.

Tolerances: per module ``rtol = atol = 1e-4`` on the features (both
sides are f32 convolutions that sum in different orders); whole models
those of ``test_torch_model.py::test_whole_slice_matches_jax``, with
``valid`` and ``pred_classes`` exactly equal.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.config import get_cfg as jax_get_cfg  # noqa: E402
from centermask2_tpu.models.backbones import fpn as jfpn  # noqa: E402
from centermask2_tpu.models.backbones import mobilenet as jmobile  # noqa: E402
from centermask2_tpu.models.backbones import resnet as jresnet  # noqa: E402
from centermask2_tpu.models.backbones import vovnet as jvov  # noqa: E402
from centermask2_tpu.models.fcos.head import FCOSHead as JaxFCOSHead  # noqa: E402
from centermask2_tpu.models.meta import build_centermask as jax_build  # noqa: E402
from centermask2_tpu.models.roi.mask_head import (  # noqa: E402
    SpatialAttentionMaskHead as JaxMaskHead)
from centermask2_tpu_torch import build_centermask, get_cfg  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402
from centermask2_tpu_torch.models import backbones as T  # noqa: E402
from centermask2_tpu_torch.models.fcos.head import FCOSHead  # noqa: E402
from centermask2_tpu_torch.models.roi.mask_head import (  # noqa: E402
    SpatialAttentionMaskHead)

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "centermask")
PIXEL_MEAN = np.asarray([103.53, 116.28, 123.675], np.float32)
TOL = 1e-4
# narrow ResNet widths of the per-module and whole-model tests
NARROW_RESNET = dict(res2_out_channels=32, stem_out_channels=8,
                     width_per_group=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(jmod, rng, *inputs):
    """A parameter tree of ``jmod``'s shapes drawn from ``rng`` (module
    docstring)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *inputs)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("frozen_scale", "scale"):
            return (1 + 0.2 * rng.randn(*s.shape)).astype(np.float32)
        if name in ("bias", "frozen_bias"):
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        raise ValueError(f"unexpected JAX leaf {name!r}")

    return jax.tree_util.tree_map_with_path(leaf, shapes["params"])


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def run_both(jmod, port, x, seed=0):
    """The JAX module on NHWC ``x`` and the port, loaded from the same
    numpy parameters, on NCHW ``x``; returns (JAX, port) outputs, NCHW
    arrays or dicts of them, and the parameters."""
    params = numpy_params(jmod, np.random.RandomState(seed), nhwc(x))
    want = jmod.apply({"params": params}, nhwc(x))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    if isinstance(want, dict):
        return ({k: nchw(v) for k, v in want.items()},
                {k: v.numpy() for k, v in got.items()}, params)
    return nchw(want), got.numpy(), params


def assert_close(got, want, err_msg=""):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                               err_msg=err_msg)


def assert_features_equal(want: dict, got: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], k)


def image(seed=1, B=1, H=64, W=64):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 3, H, W) * 255.0
            - PIXEL_MEAN[None, :, None, None]).astype(np.float32)


@pytest.mark.parametrize("stride_in_1x1,groups,stride", [
    (True, 1, 2), (False, 1, 2), (True, 2, 1)])
def test_bottleneck_block_matches_jax(stride_in_1x1, groups, stride):
    """The stride in the first 1x1 and in the 3x3, and a grouped 3x3 with
    a projection shortcut for the width alone."""
    x = np.random.RandomState(2).randn(2, 16, 12, 10).astype(np.float32)
    jmod = jresnet.BottleneckBlock(out_channels=32, bottleneck_channels=8,
                                   stride=stride, stride_in_1x1=stride_in_1x1,
                                   num_groups=groups, dtype=jnp.float32)
    port = T.BottleneckBlock(16, 32, 8, stride, stride_in_1x1, groups)
    want, got, _ = run_both(jmod, port, x)
    assert got.shape == want.shape == (2, 32, 12 // stride, 10 // stride)
    assert_close(got, want)


def test_resnet50_trunk_matches_jax():
    """ResNet-50 at RES2_OUT_CHANNELS 32, STEM_OUT_CHANNELS 8 and
    WIDTH_PER_GROUP 8: the stem, its floor-mode max-pool and 16 blocks,
    every stage tapped."""
    feats = ("stem", "res2", "res3", "res4", "res5")
    jmod = jresnet.ResNet(depth=50, out_features=feats, dtype=jnp.float32,
                          **NARROW_RESNET)
    port = T.ResNet(50, out_features=feats, **NARROW_RESNET)
    want, got, _ = run_both(jmod, port, image())
    assert got["res5"].shape == (1, 256, 2, 2)
    assert_features_equal(want, got)


def test_mobilenet_v2_matches_jax():
    """MobileNetV2 at width 1: res2..res5 of 24/32/96/320 channels; its
    depthwise kernels (3, 3, 1, C) and ``features{i}/bn{j}`` FrozenBN
    leaves load with ``strict=True``."""
    jmod = jmobile.MobileNetV2(dtype=jnp.float32)
    port = T.MobileNetV2()
    want, got, params = run_both(jmod, port, image())
    assert {k: v.shape[1] for k, v in got.items()} == \
        T.MOBILENET_FEATURE_CHANNELS
    assert_features_equal(want, got)
    dw = params["features2"]["conv1"]["kernel"]  # 16 channels expanded 6x
    assert dw.shape == (3, 3, 1, 96)
    np.testing.assert_array_equal(port.features2.conv1.weight.detach().numpy(),
                                  np.transpose(dw, (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        port.features2.bn1.frozen_scale.numpy(),
        params["features2"]["bn1"]["frozen_scale"])


def test_depthwise_osa_module_matches_jax():
    """A depthwise OSA module whose input is wider than its stage: the 1x1
    reduction, three depthwise blocks, the concat of the unreduced input
    with them, eSE."""
    x = np.random.RandomState(3).randn(2, 24, 12, 10).astype(np.float32)
    jmod = jvov.OSAModule(stage_ch=16, concat_ch=32, layer_per_block=3,
                          depthwise=True, dtype=jnp.float32)
    port = T.OSAModule(24, 16, 32, 3, depthwise=True)
    want, got, params = run_both(jmod, port, x)
    assert "reduction" in params and port.reduction is not None
    assert_close(got, want)


def test_v19_slim_dw_trunk_matches_jax():
    """The V-19-slim-dw-eSE trunk: a standard stem_1, depthwise stem_2 and
    stem_3 (the latter at stride 2), depthwise OSA stages."""
    feats = ("stem", "stage2", "stage3", "stage4", "stage5")
    jmod = jvov.VoVNet(body="V-19-slim-dw-eSE", out_features=feats,
                       dtype=jnp.float32)
    port = T.VoVNet("V-19-slim-dw-eSE", out_features=feats)
    want, got, _ = run_both(jmod, port, image())
    assert {k: v.shape[1] for k, v in got.items()} == \
        T.feature_channels("V-19-slim-dw-eSE")
    assert_features_equal(want, got)
    with pytest.raises(ValueError, match="s2d stem"):
        T.VoVNet("V-19-slim-dw-eSE", s2d_input=True)


@pytest.mark.parametrize("norm,top_block", [
    ("GN", "p6p7"), ("FrozenBN", "p6p7"), ("", "p6"), ("", "maxpool"),
    ("GN", None)])
def test_fpn_matches_jax(norm, top_block):
    """The FPN over res3..res5 of a 64x96 canvas (one odd-sized level),
    with each norm and each top block."""
    rng = np.random.RandomState(4)
    chans = (16, 24, 40)
    feats = [rng.randn(1, c, 64 // s, 96 // s).astype(np.float32)
             for c, s in zip(chans, (8, 16, 32))]
    jmod = jfpn.FPN(in_strides=(8, 16, 32), out_channels=64, norm=norm,
                    top_block=top_block, dtype=jnp.float32)
    port = T.FPN(chans, (8, 16, 32), 64, norm, top_block=top_block)
    params = numpy_params(jmod, rng, [nhwc(f) for f in feats])
    want = jmod.apply({"params": params}, [nhwc(f) for f in feats])
    load_jax_params(port, params)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    levels = {"p6p7": ["p6", "p7"], "p6": ["p6"], "maxpool": ["p6"],
              None: []}[top_block]
    assert sorted(got) == ["p3", "p4", "p5"] + levels
    assert (port.fpn_lateral3.bias is None) == bool(norm)
    assert_features_equal({k: nchw(v) for k, v in want.items()},
                          {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("norm", ["", "FrozenBN"])
def test_fcos_towers_without_gn_match_jax(norm):
    """The FCOS towers apply GroupNorm only for "GN": "" and any other
    norm leave the towers' convs unnormalized, as the JAX head does."""
    rng = np.random.RandomState(5)
    feats = [rng.randn(1, 32, h, w).astype(np.float32)
             for h, w in ((8, 12), (4, 6))]
    kw = dict(num_classes=3, in_channels=32, num_cls_convs=2,
              num_box_convs=2, norm=norm, num_levels=2)
    jmod = JaxFCOSHead(dtype=jnp.float32, **kw)
    port = FCOSHead(**kw)
    params = numpy_params(jmod, rng, [nhwc(f) for f in feats])
    assert not any(k.startswith("norm") for k in params["cls_tower"])
    want = jmod.apply({"params": params}, [nhwc(f) for f in feats])
    load_jax_params(port, params)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            assert_close(g.numpy(), nchw(w))


@pytest.mark.parametrize("norm", ["GN", "FrozenBN"])
def test_mask_head_norm_matches_jax(norm):
    """ROI_MASK_HEAD.NORM: ``mask_fcn{k}_norm`` after each bias-free conv."""
    x = np.random.RandomState(6).randn(5, 32, 14, 14).astype(np.float32)
    jmod = JaxMaskHead(num_classes=3, conv_dims=32, num_conv=2, norm=norm,
                       dtype=jnp.float32)
    port = SpatialAttentionMaskHead(32, 3, 32, 2, norm)
    want, got, params = run_both(jmod, port, x)
    assert "bias" not in params["mask_fcn1"] and "mask_fcn1_norm" in params
    assert got.shape == (5, 3, 28, 28)
    assert_close(got, want)


@pytest.mark.parametrize("kind", ["mobilenet", "resnet"])
def test_bf16_backbone_output_dtype(kind):
    """Under a bf16 model MobileNetV2 computes in f32 in both packages
    (the JAX convs have no dtype, so flax promotes to the f32
    parameters) and ResNet in bf16."""
    x = image(H=32, W=32)
    if kind == "mobilenet":
        jmod, port = jmobile.MobileNetV2(dtype=jnp.bfloat16), T.MobileNetV2()
        dtypes = (jnp.float32, torch.float32)
    else:
        jmod = jresnet.ResNet(depth=50, out_features=("res2", "res3", "res4",
                                                      "res5"),
                              dtype=jnp.bfloat16, **NARROW_RESNET)
        port = T.ResNet(50, out_features=("res2", "res3", "res4", "res5"),
                        dtype=torch.bfloat16, **NARROW_RESNET)
        dtypes = (jnp.bfloat16, torch.bfloat16)
    params = numpy_params(jmod, np.random.RandomState(0), nhwc(x))
    want = jmod.apply({"params": params},
                      nhwc(x).astype(jnp.bfloat16))
    load_jax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(torch.bfloat16))
    assert sorted(got) == sorted(want) == ["res2", "res3", "res4", "res5"]
    assert {v.dtype for v in want.values()} == {jnp.dtype(dtypes[0])}
    assert {v.dtype for v in got.values()} == {dtypes[1]}


# ------------------------------------------------------------ whole models
NEW_YAMLS = ("centermask_R_50_FPN_ms_3x.yaml",
             "centermask_R_101_FPN_ms_3x.yaml",
             "centermask_mobilenetV2_FPN_ms_4x.yaml",
             "centermask_lite_V_19_dw_eSE_FPN_ms_4x.yaml",
             "centermask_lite_V_19_slim_dw_eSE_FPN_ms_4x.yaml")
SMALL_OPTS = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.FCOS.NUM_CLASSES", "3",
              "MODEL.FPN.OUT_CHANNELS", "64",
              "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
              "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8",
              "MODEL.FCOS.POST_NMS_TOPK_TEST", "10"]
RESNET_OPTS = ["MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
               "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
               "MODEL.RESNETS.WIDTH_PER_GROUP", "8"]


def _configs(yaml_name, opts):
    out = []
    for make in (jax_get_cfg, get_cfg):
        cfg = make()
        cfg.merge_from_file(os.path.join(CONFIGS, yaml_name))
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return out


def whole_model_parity(yaml_name, opts, seed=0):
    """One 128x160 image through JAX's and the port's
    ``build_centermask`` of ``yaml_name`` with ``opts``, from the same
    numpy parameters (the classification prior bias zeroed, so that the
    decode keeps real candidates); asserts the slots agree."""
    jcfg, tcfg = _configs(yaml_name, opts)
    rng = np.random.RandomState(seed)
    img = (rng.rand(1, 128, 160, 3) * 255.0 - PIXEL_MEAN).astype(np.float32)
    jm = jax_build(jcfg)
    params = numpy_params(jm, rng, jnp.asarray(img))
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    out = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(img))
    port = build_centermask(tcfg, device="cpu")
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
    return port


@pytest.mark.parametrize("yaml_name", NEW_YAMLS)
def test_whole_model_matches_jax(yaml_name):
    """Each yaml at narrow heads (and, for the ResNets, narrow trunks of
    their full depth) against JAX in f32."""
    resnet = "_R_" in yaml_name
    port = whole_model_parity(yaml_name, SMALL_OPTS
                              + (RESNET_OPTS if resnet else []))
    kind = {"_R_": "resnet", "mobilenet": "mobilenet"}
    assert port.backbone_type == next(
        (v for k, v in kind.items() if k in yaml_name), "vovnet")
    assert not port.s2d_input


@pytest.mark.slow
def test_r101_full_width_matches_jax():
    """R-101 at full width and depth (res5 2048 channels, FPN 256, 80
    classes, mask convs 256) against JAX in f32."""
    whole_model_parity("centermask_R_101_FPN_ms_3x.yaml",
                       ["TPU.COMPUTE_DTYPE", "float32",
                        "MODEL.FCOS.POST_NMS_TOPK_TEST", "10"])


@pytest.mark.parametrize("yaml_path", sorted(
    glob.glob(os.path.join(CONFIGS, "*.yaml"))), ids=os.path.basename)
def test_every_yaml_builds_but_keypoints(yaml_path):
    """Every shipped yaml builds on the CPU (narrow heads) except the
    keypoint one, whose head is not ported (ROADMAP queue 1)."""
    cfg = get_cfg()
    cfg.merge_from_file(yaml_path)
    cfg.merge_from_list(["MODEL.FPN.OUT_CHANNELS", "32",
                         "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
                         "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8"])
    if "keypoint" in yaml_path:
        with pytest.raises(NotImplementedError, match="keypoints"):
            build_centermask(cfg, device="cpu")
        return
    model = build_centermask(cfg, device="cpu")
    assert model.s2d_input == bool(cfg.TPU.S2D_STEM_INPUT)


def test_s2d_stem_input_is_the_vovnets_only():
    """TPU.S2D_STEM_INPUT turns off for the ResNet and the MobileNet, as
    in JAX (``meta.py:799``); the constructor refuses it for them."""
    _, cfg = _configs("centermask_R_50_FPN_ms_3x.yaml",
                      SMALL_OPTS + RESNET_OPTS + ["TPU.S2D_STEM_INPUT",
                                                  "True"])
    assert not build_centermask(cfg, device="cpu").s2d_input
    from centermask2_tpu_torch.models.meta import CenterMask

    with pytest.raises(ValueError, match="VoVNet only"):
        CenterMask(backbone_type="mobilenet", s2d_input=True,
                   fpn_in_features=("res3", "res4", "res5"))


@pytest.mark.parametrize("yaml_name,backbone", [
    ("centermask_R_50_FPN_ms_3x.yaml", "resnet"),
    ("centermask_mobilenetV2_FPN_ms_4x.yaml", "mobilenet")])
def test_convert_checkpoint_matches_jax(yaml_name, backbone):
    """A synthetic reference-schema state_dict (every key the JAX
    converter maps, detectron2's ResNet or the reference's MobileNetV2
    names) through both converters: equal trees leaf for leaf, no key
    unused, every leaf of the model filled; the port loads the tree with
    ``strict=True``."""
    from centermask2_tpu.checkpoint import convert_torch as jconv
    from test_torch_serving import _synth_torch_sd

    from centermask2_tpu_torch.checkpoint import convert_torch as tconv

    # the MaskIoU convs keep their width: the converters reshape its fc1
    # by the default 256 channels
    opts = ["TPU.COMPUTE_DTYPE", "float32", "MODEL.FCOS.NUM_CLASSES", "3",
            "MODEL.FPN.OUT_CHANNELS", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM",
            "8"] + (RESNET_OPTS if backbone == "resnet" else [])
    jcfg, tcfg = _configs(yaml_name, opts)
    jm = jax_build(jcfg)
    init = jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3)))["params"])
    _, report = jconv.convert_checkpoint({}, backbone=backbone)
    sd = _synth_torch_sd(init, report["mapping"], np.random.RandomState(7))
    sd = {"model.backbone.bottom_up." + k if not k.startswith(
        ("backbone.", "proposal_generator.", "roi_heads.")) else "model." + k:
        v for k, v in sd.items()}
    want, want_rep = jconv.convert_checkpoint(sd, backbone=backbone)
    got, got_rep = tconv.convert_checkpoint(sd, backbone=backbone)
    assert got_rep["unused_torch_keys"] == want_rep["unused_torch_keys"] == []
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])
    _, missing = jconv.merge_params(init, want)
    assert missing == []
    port = build_centermask(tcfg, device="cpu")
    load_jax_params(port, got)
    assert port.backbone_type == backbone


R50_CLI_OPTS = ["MODEL.FCOS.NUM_CLASSES", "2", "MODEL.FPN.OUT_CHANNELS", "32",
                "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
                "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8",
                "TPU.FIXED_EDGE_SIZE", "64", *RESNET_OPTS]


def test_r50_yaml_through_the_entry_points(tmp_path, capsys):
    """The infer and train_net CLIs run the R-50 yaml (narrow, on the
    CPU, a 64 canvas): metrics written, a step checkpointed; the s2d-only
    options refuse it instead of taking the float path quietly."""
    from test_torch_data import make_train_dataset
    from test_torch_evaluation import _png_dataset

    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.tools import export_model, infer, train_net

    yaml = os.path.join(CONFIGS, "centermask_R_50_FPN_ms_3x.yaml")
    (tmp_path / "val").mkdir()
    ann = _png_dataset(tmp_path / "val", np.random.RandomState(0))
    common = ["--device", "cpu", "--config-file", yaml, "--ann", str(ann),
              "--image-root", str(tmp_path / "val" / "images")]
    opts = [*R50_CLI_OPTS, "INPUT.MIN_SIZE_TEST", "32",
            "INPUT.MAX_SIZE_TEST", "60", "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"]
    infer.main([*common, "--output-dir", str(tmp_path / "out"), *opts])
    assert {"bbox", "segm"} <= set(json.loads(
        (tmp_path / "out" / "metrics.json").read_text()))
    with pytest.raises(SystemExit, match="s2d-input model"):
        infer.main([*common, "--tight-compute", *opts])
    with pytest.raises(SystemExit, match="--serving-u8 requires"):
        export_model.main(["--device", "cpu", "--config-file", yaml, "--out",
                           str(tmp_path / "x.pt2"), "--serving-u8", *opts])
    _, cfg = _configs("centermask_R_50_FPN_ms_3x.yaml", opts)
    with pytest.raises(ValueError, match="s2d-input model"):
        evaluate_dataset(build_centermask(cfg, device="cpu"), ann=str(ann),
                         image_root=str(tmp_path / "val" / "images"),
                         fixed_size=64, min_size=32, max_size=60,
                         tight_compute=True)

    train_ann, root = make_train_dataset(tmp_path / "train")
    out = tmp_path / "train_out"
    train_net.main(["--device", "cpu", "--config-file", yaml, "--ann",
                    train_ann, "--image-root", root, "--max-iter", "1",
                    "--log-every", "1", *R50_CLI_OPTS,
                    "TPU.COMPUTE_DTYPE", "float32", "INPUT.MIN_SIZE_TRAIN",
                    "(40, 48)", "INPUT.MAX_SIZE_TRAIN", "64",
                    "TPU.NMS_CANDIDATES", "50",
                    "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
                    "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
                    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
                    "TPU.MAX_FG_PROPOSALS", "8", "TPU.MAX_GT_INSTANCES", "8",
                    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD",
                    "1", "DATALOADER.NUM_WORKERS", "1", "OUTPUT_DIR",
                    str(out)])
    line = json.loads((out / "metrics.jsonl").read_text().splitlines()[0])
    assert np.isfinite(line["total_loss"])
    assert os.listdir(out / "checkpoints") == ["step_1"]


@pytest.mark.parametrize("yaml_name,dtype", [
    ("centermask_R_50_FPN_ms_3x.yaml", "float32"),
    ("centermask_mobilenetV2_FPN_ms_4x.yaml", "bfloat16")])
def test_export_cli_other_backbones(yaml_name, dtype, tmp_path, capsys):
    """``tools/export_model.py`` exports a ResNet (f32) and MobileNetV2
    (bf16 heads over its f32 body) at a 64 canvas, with the f32 NHWC input
    they take: the loaded artifact equals the eager request of the same
    model, output for output."""
    from centermask2_tpu_torch.export import load_serialized
    from centermask2_tpu_torch.tools import export_model

    opts = [*R50_CLI_OPTS, "TPU.COMPUTE_DTYPE", dtype,
            "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"]
    out = tmp_path / "m.pt2"
    export_model.main(["--device", "cpu", "--config-file",
                       os.path.join(CONFIGS, yaml_name), "--out", str(out),
                       *opts])
    assert "f32 input (1, 64, 64, 3)" in capsys.readouterr().out
    _, cfg = _configs(yaml_name, opts)
    model = build_centermask(cfg, device="cpu", seed=0)
    x = torch.from_numpy((np.random.RandomState(5).rand(1, 64, 64, 3) * 255.0
                          - PIXEL_MEAN).astype(np.float32))
    got, want = load_serialized(str(out))(x), model.inference(x)
    assert want.valid.any()
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
