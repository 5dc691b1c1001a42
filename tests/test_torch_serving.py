"""Port parity of the serving path: the s2d stem, the uint8 s2d input
with on-device normalization and tight-pack pad-back, tight compute,
the per-level decode branch, the device mask paste, and the reference
checkpoint converter, against the JAX package on the CPU in float32.

Tolerances: the s2d stem within 1e-4 of JAX's (atol and rtol; both
frameworks sum the zero-embedded 2x2 convs in their own order) and
within 1e-5 of the output's largest value of the port's plain stem; the uint8
normalization and the pad-back equal; whole-model outputs within the
tolerances of tests/test_torch_model.py::test_whole_slice_matches_jax;
the per-level decode with scores to 1e-6 relative and boxes to 1e-5
absolute (as test_decode_matches_jax); the paste within 1e-5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.data.preprocess import (  # noqa: E402
    s2d_pack_u8, s2d_pack_u8_tight)
from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models.backbones import vovnet as jvov  # noqa: E402
from centermask2_tpu_torch import build_centermask, get_cfg  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402
from centermask2_tpu_torch.models.backbones import vovnet as tvov  # noqa: E402
from centermask2_tpu_torch.models.meta import CenterMask  # noqa: E402

SMALL = dict(conv_body="V-19-slim-eSE", num_classes=5, fpn_out_channels=64,
             mask_conv_dim=16, maskiou_conv_dim=16, post_nms_topk_test=15)
CANVAS = (128, 160)


def _perturb(params, rng):
    """As tests/test_torch_model.py: FrozenBN and biases off their init,
    the classification prior bias at 0."""
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


def _stem_params(rng, c1, c2, c3):
    out = []
    for cin, cout in ((3, c1), (c1, c2), (c2, c3)):
        w = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.3
        s = (1 + 0.2 * rng.randn(cout)).astype(np.float32)
        b = (0.1 * rng.randn(cout)).astype(np.float32)
        out.append((w, s, b))
    return out


def test_s2d_stem_forward_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 17, 21, 48).astype(np.float32) * 50
    ks = _stem_params(rng, 8, 8, 16)
    want = np.asarray(jvov.s2d_stem_forward(
        jnp.asarray(x), *[tuple(map(jnp.asarray, k)) for k in ks],
        jnp.float32))
    kern = tvov.s2d_stem_kernels(
        *[(torch.from_numpy(w).permute(3, 2, 0, 1), torch.from_numpy(s),
           torch.from_numpy(b)) for w, s, b in ks], torch.float32)
    got = tvov.s2d_stem_forward(torch.from_numpy(x).permute(0, 3, 1, 2),
                                kern).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 16, 20, 16)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_s2d_stem_equals_plain_stem():
    """The s2d stem on a packed image is the plain stem on the image."""
    from centermask2_tpu_torch.data import s2d_preprocess, single_preprocessing

    rng = np.random.RandomState(1)
    img = (rng.rand(50, 61, 3) * 255).astype(np.uint8)
    plain = tvov.VoVNet("V-19-slim-eSE")
    s2d = tvov.VoVNet("V-19-slim-eSE", s2d_input=True)
    with torch.no_grad():
        for p in plain.parameters():
            p.normal_(0, 0.1, generator=torch.Generator().manual_seed(p.numel()))
        for m in (plain.stem_1, plain.stem_2, plain.stem_3):
            m.norm.frozen_scale.uniform_(0.8, 1.2)
            m.norm.frozen_bias.uniform_(-0.1, 0.1)
    s2d.load_state_dict(plain.state_dict())
    x = torch.from_numpy(single_preprocessing(img, 64)[None]).permute(0, 3, 1, 2)
    xd = torch.from_numpy(s2d_preprocess(img, 64)).permute(0, 3, 1, 2)
    want, got = plain.stem(x).detach().numpy(), s2d.stem(xd).detach().numpy()
    # the same f32 sums in another order: within 1e-5 of the output's scale
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_u8_normalize_and_pad_equal_jax():
    rng = np.random.RandomState(2)
    jm = JaxCenterMask(**SMALL, s2d_input=True, dtype=jnp.float32)
    port = CenterMask(**SMALL, s2d_input=True, dtype=torch.float32)
    for h, w in ((90, 140), (128, 160), (1, 1)):
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        pack = s2d_pack_u8_tight(img, 160, multiple=8)
        full = jm.apply({}, jnp.asarray(pack), CANVAS,
                        method=JaxCenterMask._pad_to_canvas)
        got = port._pad_to_canvas(torch.from_numpy(pack), CANVAS)
        np.testing.assert_array_equal(got.numpy(), np.asarray(full))
        np.testing.assert_array_equal(got.numpy(), s2d_pack_u8(img, CANVAS))
        for hw in (np.asarray([[h, w]], np.int32), None):
            want = jm.apply({}, full, None if hw is None else jnp.asarray(hw),
                            method=JaxCenterMask._normalize_u8_s2d)
            norm = port._normalize_u8_s2d(
                got, None if hw is None else torch.from_numpy(hw))
            assert norm.dtype == torch.float32
            np.testing.assert_array_equal(norm.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="s2d"):
        CenterMask(**SMALL)._normalize_u8_s2d(torch.zeros(1, 17, 17, 48,
                                                          dtype=torch.uint8),
                                              None)


@pytest.fixture(scope="module")
def serving_pair():
    """The JAX s2d model's outputs from a uint8 tight pack padded back to
    128x160, and at the tight canvas 96x160 (tight compute), beside the
    port's from the same parameters."""
    rng = np.random.RandomState(0)
    img = (rng.rand(90, 150, 3) * 255).astype(np.uint8)
    hw = np.asarray([[90, 150]], np.int32)
    jm = JaxCenterMask(**SMALL, s2d_input=True, dtype=jnp.float32)
    tight = s2d_pack_u8_tight(img, 160, multiple=8)  # 96x152 cells
    compute = s2d_pack_u8(img, (96, 160))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(compute))
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng)
    jp = jax.tree.map(jnp.asarray, params)
    want = {
        "pad_back": jax.jit(lambda p, x, v: jm.apply(
            {"params": p}, x, None, v, canvas_hw=CANVAS))(
                jp, jnp.asarray(tight), jnp.asarray(hw)),
        "tight_compute": jax.jit(lambda p, x, v: jm.apply(
            {"params": p}, x, None, v))(jp, jnp.asarray(compute),
                                        jnp.asarray(hw))}
    port = CenterMask(**SMALL, s2d_input=True, dtype=torch.float32).eval()
    load_jax_params(port, params)
    th = torch.from_numpy(hw)
    got = {"pad_back": port.inference(torch.from_numpy(tight), None, th,
                                      CANVAS),
           "tight_compute": port.inference(torch.from_numpy(compute), None,
                                           th)}
    return want, got, params, port, (tight, compute, th)


@pytest.mark.parametrize("mode", ["pad_back", "tight_compute"])
def test_serving_model_matches_jax(serving_pair, mode):
    want, got = serving_pair[0][mode], serving_pair[1][mode]
    valid = np.asarray(want.valid[0])
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    n = int(valid.sum())
    assert n > 3, "the parity test needs detections to be meaningful"

    def pair(field):
        return getattr(got, field)[0][:n].numpy(), \
            np.asarray(getattr(want, field)[0])[:n]

    np.testing.assert_array_equal(*pair("pred_classes"))
    np.testing.assert_allclose(*pair("locations"), atol=1e-3)
    np.testing.assert_allclose(*pair("scores"), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(*pair("pred_boxes"), rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(*pair("pred_masks"), atol=2e-3)
    np.testing.assert_allclose(*pair("mask_scores"), rtol=2e-3, atol=2e-3)


def test_serving_inputs_agree(serving_pair):
    """The full uint8 pack, the tight pack padded back, and the
    host-normalized f32 s2d input give equal outputs; inference_batched
    stacks B = 1 programs."""
    *_, port, (tight, _, th) = serving_pair
    from centermask2_tpu_torch.data import s2d_preprocess

    img = np.zeros((128, 160, 3), np.uint8)
    s2d_block = tight[0]  # recover the image from its pack
    rows = s2d_block.reshape(tight.shape[1], tight.shape[2], 4, 4, 3) \
        .transpose(0, 2, 1, 3, 4).reshape(tight.shape[1] * 4,
                                          tight.shape[2] * 4, 3)
    img[:90, :150] = rows[2:92, 2:152]
    a = port.inference(torch.from_numpy(tight), None, th, CANVAS)
    b = port.inference(torch.from_numpy(s2d_pack_u8(img[:90, :150], CANVAS)),
                       None, th)
    c = port.inference(torch.from_numpy(s2d_preprocess(img[:90, :150],
                                                       CANVAS[1])[:, :33]))
    batched = port.inference_batched(
        torch.from_numpy(np.concatenate([s2d_pack_u8(img[:90, :150],
                                                     CANVAS)] * 2)),
        None, torch.cat([th, th]))
    assert a.pred_keypoints is None and batched.pred_keypoints is None
    for f in a._fields[:7]:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
        assert torch.equal(getattr(batched, f),
                           torch.cat([getattr(a, f)] * 2)), f


def test_embedded_kernels_follow_new_weights(serving_pair):
    """After a second load_jax_params (and a load_state_dict) the s2d
    stem's embedded kernels follow the new weights: the outputs equal a
    fresh model's. The
    captured program (``tests/test_torch_captured.py::FakeGraphs``)
    reads the stem's folded kernels from its prepared weights: a second
    load refreshes them in place, with no recapture, and its replay
    equals a fresh model's program."""
    from test_torch_captured import FakeGraphs

    from centermask2_tpu_torch.export import CapturedInference

    _, got, params, port, (tight, _, th) = serving_pair
    other = _perturb(jax.tree.map(np.asarray, params),
                     np.random.RandomState(9))
    other["backbone"]["stem_1"]["conv"]["kernel"] = \
        other["backbone"]["stem_1"]["conv"]["kernel"] * 1.5
    load_jax_params(port, other)
    fresh = CenterMask(**SMALL, s2d_input=True, dtype=torch.float32).eval()
    load_jax_params(fresh, other)
    x = torch.from_numpy(tight)
    a = port.inference(x, None, th, CANVAS)
    b = fresh.inference(x, None, th, CANVAS)
    for f in a._fields[:7]:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert not torch.equal(a.scores, got["pad_back"].scores)
    load_jax_params(port, params)  # back, for the other tests
    again = port.inference(x, None, th, CANVAS)
    assert torch.equal(again.scores, got["pad_back"].scores)
    port.load_state_dict(fresh.state_dict())
    assert torch.equal(port.inference(x, None, th, CANVAS).scores, b.scores)
    load_jax_params(port, params)

    prog = CapturedInference(port, graphs=FakeGraphs())
    first = prog(x, None, th, CANVAS).scores.clone()
    stem = prog.weights.entries[(port.backbone, False)]
    ptrs = [t.data_ptr() for t in stem]
    load_jax_params(port, other)
    got = prog(x, None, th, CANVAS)
    assert len(prog) == 1
    assert prog.weights.entries[(port.backbone, False)] is stem
    assert [t.data_ptr() for t in stem] == ptrs
    want = CapturedInference(fresh, graphs=FakeGraphs())(x, None, th, CANVAS)
    for f in got._fields[:7]:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(got.scores, first)
    load_jax_params(port, params)


@pytest.mark.parametrize("nms_candidates", [120, 500])
def test_per_level_decode_matches_jax(nms_candidates):
    """nms_candidates > pre_nms_topk: each level's top 50, capped to 120
    (binding: 198 candidates) or not (500)."""
    from centermask2_tpu.models.fcos import outputs as jout
    from centermask2_tpu_torch.models.fcos import outputs as tout

    rng = np.random.RandomState(6)
    C, strides = 6, (8, 16, 32, 64, 128)
    shapes = [(-(-128 // s), -(-160 // s)) for s in strides]
    logits = [rng.randn(1, C, h, w).astype(np.float32) - 1.0
              for h, w in shapes]
    reg = [np.abs(rng.randn(1, 4, h, w)).astype(np.float32) * 3
           for h, w in shapes]
    ctr = [rng.randn(1, 1, h, w).astype(np.float32) for h, w in shapes]
    kw = dict(pre_nms_thresh=0.3, pre_nms_topk=50, nms_thresh=0.6,
              post_nms_topk=40, nms_candidates=nms_candidates)

    def hwc(x):  # (1, C, H, W) -> (H*W, C)
        return jnp.asarray(np.transpose(x[0], (1, 2, 0)).reshape(-1, x.shape[1]))

    want = jax.jit(lambda *a: jout.decode_single_image(*a, strides, **kw))(
        jout.compute_locations(shapes, strides), [hwc(x) for x in logits],
        [hwc(x) for x in reg], [hwc(x)[:, 0] for x in ctr])
    got = tout.decode_single_image(
        tout.compute_locations(shapes, strides, torch.device("cpu")),
        [torch.from_numpy(x) for x in logits],
        [torch.from_numpy(x) for x in reg],
        [torch.from_numpy(x) for x in ctr], strides, **kw)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert 10 < valid.sum() <= 40
    for f in ("pred_classes", "locations"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[valid],
                                      np.asarray(getattr(want, f))[valid])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.pred_boxes.numpy()[valid],
                               np.asarray(want.pred_boxes)[valid],
                               rtol=1e-6, atol=1e-5)


def test_paste_masks_matches_jax():
    from centermask2_tpu.ops.paste_masks import paste_masks as jpaste
    from centermask2_tpu_torch.ops import paste_masks

    rng = np.random.RandomState(8)
    masks = rng.rand(9, 28, 28).astype(np.float32)
    boxes = rng.rand(9, 4).astype(np.float32) * 50 - 8
    boxes[:, 2:] = boxes[:, :2] + rng.rand(9, 2).astype(np.float32) * 40
    boxes[0] = [3.0, 4.0, 3.0, 9.0]  # zero width
    want = np.asarray(jpaste(jnp.asarray(masks), jnp.asarray(boxes),
                             (40, 56), threshold=-1.0))
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                      (40, 56), threshold=-1.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    binary = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes),
                         (40, 56)).numpy()
    clear = np.abs(want - 0.5) > 1e-5
    np.testing.assert_array_equal(binary[clear], (want > 0.5)[clear])


def _get_leaf(tree, path):
    node = tree
    for p in path.split("/"):
        if p not in node:
            return None
        node = node[p]
    return node


def _synth_torch_sd(params, mapping, rng):
    """A reference-schema state_dict with every mapped leaf (the helper
    of tests/test_checkpoint.py)."""
    sd = {}
    for tkey, fpath, kind in mapping:
        if kind.startswith("conv"):
            leaf = _get_leaf(params, fpath + "/kernel")
            if leaf is None:
                continue
            kh, kw, i, o = leaf.shape
            sd[tkey + ".weight"] = rng.randn(o, i, kh, kw).astype(np.float32) * 0.1
            if _get_leaf(params, fpath + "/bias") is not None:
                sd[tkey + ".bias"] = rng.randn(o).astype(np.float32) * 0.1
        elif kind == "bn":
            leaf = _get_leaf(params, fpath + "/frozen_scale")
            if leaf is None:
                continue
            c = leaf.shape[0]
            sd[tkey + ".weight"] = rng.rand(c).astype(np.float32) + 0.5
            sd[tkey + ".bias"] = rng.randn(c).astype(np.float32) * 0.1
            sd[tkey + ".running_mean"] = rng.randn(c).astype(np.float32) * 0.1
            sd[tkey + ".running_var"] = rng.rand(c).astype(np.float32) + 0.5
        elif kind == "gn":
            c = _get_leaf(params, fpath + "/gn/scale").shape[0]
            sd[tkey + ".weight"] = rng.rand(c).astype(np.float32) + 0.5
            sd[tkey + ".bias"] = rng.randn(c).astype(np.float32) * 0.1
        elif kind in ("linear", "linear_chw"):
            i, o = _get_leaf(params, fpath + "/kernel").shape
            sd[tkey + ".weight"] = rng.randn(o, i).astype(np.float32) * 0.02
            sd[tkey + ".bias"] = rng.randn(o).astype(np.float32) * 0.1
        elif kind == "deconv":
            leaf = _get_leaf(params, fpath)
            if leaf is None:
                continue
            kh, kw, o, i = leaf.shape
            sd[tkey + ".weight"] = rng.randn(i, o, kh, kw).astype(np.float32) * 0.1
            sd[tkey + ".bias"] = rng.randn(o).astype(np.float32) * 0.1
        elif kind == "scalar":
            if _get_leaf(params, fpath + "/scale") is not None:
                sd[tkey + ".scale"] = np.ones(1, np.float32)
    sd["proposal_generator.fcos_head.cls_logits.bias"][:] = 0.0
    return sd


def test_convert_checkpoint_matches_jax():
    """A synthetic reference .pth state_dict of a narrow V-19-slim: the
    port's tree equals the JAX converter's, and the port model loaded
    from it serves what the JAX model built from it serves."""
    from centermask2_tpu.checkpoint import convert_torch as jconv
    from centermask2_tpu_torch.checkpoint import convert_torch as tconv

    cfg = dict(conv_body="V-19-slim-eSE", num_classes=4, fpn_out_channels=32,
               mask_conv_dim=16, post_nms_topk_test=10)
    jm = JaxCenterMask(**cfg, dtype=jnp.float32)
    img = (np.random.RandomState(3).rand(1, 64, 96, 3).astype(np.float32)
           * 255 - [103.53, 116.28, 123.675]).astype(np.float32)
    init = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(img))["params"])
    _, report = jconv.convert_checkpoint({}, conv_body="V-19-slim-eSE")
    sd = _synth_torch_sd(init, report["mapping"], np.random.RandomState(4))
    sd = {"model." + k: v for k, v in sd.items()}  # a wrapped checkpoint
    want, want_rep = jconv.convert_checkpoint(sd, conv_body="V-19-slim-eSE")
    got, got_rep = tconv.convert_checkpoint(sd, conv_body="V-19-slim-eSE")
    assert got_rep["unused_torch_keys"] == want_rep["unused_torch_keys"] == []
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_g.keys() == flat_w.keys()
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])
    merged_w, miss_w = jconv.merge_params(init, want)
    merged_g, miss_g = tconv.merge_params(init, got)
    assert miss_g == miss_w == []
    for a, b in zip(jax.tree.leaves(merged_g), jax.tree.leaves(merged_w)):
        np.testing.assert_array_equal(a, b)
    scale, shift = tconv.fold_frozen_bn(*(np.float32([2.0, 3.0]),) * 2,
                                        np.float32([1.0, 0.0]),
                                        np.float32([3.0, 0.0]))
    np.testing.assert_array_equal(
        scale, jconv.fold_frozen_bn(*(np.float32([2.0, 3.0]),) * 2,
                                    np.float32([1.0, 0.0]),
                                    np.float32([3.0, 0.0]))[0])

    out = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        jax.tree.map(jnp.asarray, merged_w), jnp.asarray(img))
    port = CenterMask(**cfg, dtype=torch.float32).eval()
    load_jax_params(port, got)
    res = port.inference(torch.from_numpy(img))
    valid = np.asarray(out.valid[0])
    np.testing.assert_array_equal(res.valid[0].numpy(), valid)
    n = int(valid.sum())
    assert n > 3
    np.testing.assert_allclose(res.scores[0][:n].numpy(),
                               np.asarray(out.scores[0])[:n], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res.pred_boxes[0][:n].numpy(),
                               np.asarray(out.pred_boxes[0])[:n], rtol=1e-3,
                               atol=2e-2)
    np.testing.assert_allclose(res.pred_masks[0][:n].numpy(),
                               np.asarray(out.pred_masks[0])[:n], atol=2e-3)
    # read as a ResNet's, the VoVNet keys are left unused by both
    want_r, want_rep = jconv.convert_checkpoint(sd, backbone="resnet")
    got_r, got_rep = tconv.convert_checkpoint(sd, backbone="resnet")
    assert got_rep["unused_torch_keys"] == want_rep["unused_torch_keys"]
    assert any("stem_1" in k for k in got_rep["unused_torch_keys"])
    assert "backbone" not in got_r and got_r.keys() == want_r.keys()
    # the keypoint head's convs and deconv convert as JAX converts them
    rng = np.random.RandomState(9)
    kp_sd = {f"roi_heads.keypoint_head.conv_fcn{k}.{leaf}":
             rng.randn(*shape).astype(np.float32)
             for k in (1, 2) for leaf, shape in (("weight", (8, 8, 3, 3)),
                                                 ("bias", (8,)))}
    kp_sd["roi_heads.keypoint_head.score_lowres.weight"] = \
        rng.randn(8, 17, 4, 4).astype(np.float32)
    kp_sd["roi_heads.keypoint_head.score_lowres.bias"] = \
        rng.randn(17).astype(np.float32)
    want_k, want_krep = jconv.convert_checkpoint(
        {**sd, **kp_sd}, conv_body="V-19-slim-eSE", keypoint_num_conv=2)
    got_k, got_krep = tconv.convert_checkpoint(
        {**sd, **kp_sd}, conv_body="V-19-slim-eSE", keypoint_num_conv=2)
    assert got_krep["unused_torch_keys"] == want_krep["unused_torch_keys"]
    jk, tk = want_k["roi_heads"]["keypoint_head"], \
        got_k["roi_heads"]["keypoint_head"]
    assert sorted(tk) == sorted(jk) == ["conv_fcn1", "conv_fcn2",
                                        "score_lowres_bias",
                                        "score_lowres_kernel"]
    assert tk["score_lowres_kernel"].shape == (4, 4, 17, 8)
    for name in ("score_lowres_kernel", "score_lowres_bias"):
        np.testing.assert_array_equal(tk[name], jk[name])
    np.testing.assert_array_equal(tk["conv_fcn2"]["kernel"],
                                  jk["conv_fcn2"]["kernel"])


def _serving_yaml_cfg():
    from pathlib import Path

    cfg = get_cfg()
    cfg.merge_from_file(str(Path(__file__).resolve().parent.parent
                            / "configs/centermask/zy_model_serving.yaml"))
    return cfg


def test_serving_yaml_builds_and_serves_on_cpu():
    """The shipped serving config at full width (V-39-eSE, 80 classes,
    FPN 256) on a 64x96 canvas: uint8 full and tight packs, with and
    without canvas_hw, and the per-level branch."""
    cfg = _serving_yaml_cfg()
    assert cfg.TPU.S2D_STEM_INPUT and cfg.MODEL.VOVNET.CONV_BODY == "V-39-eSE"
    model = build_centermask(cfg, device="cpu", seed=0)
    assert model.s2d_input and model.backbone.s2d_input
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    img = (np.random.RandomState(5).rand(60, 90, 3) * 255).astype(np.uint8)
    hw = torch.tensor([[60, 90]], dtype=torch.int32)
    full = torch.from_numpy(s2d_pack_u8(img, (64, 96)))
    tight = torch.from_numpy(s2d_pack_u8_tight(img, 96, multiple=8))
    a = model.inference(full, None, hw)
    b = model.inference(tight, None, hw, (64, 96))
    c = model.inference(full, None, hw, (64, 96))
    for f in a._fields[:7]:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(c, f)), f
    assert a.pred_masks.shape == (1, 50, 1, 28, 28) and int(a.valid.sum()) > 0
    model.decode_kwargs["nms_candidates"] = 5000  # the per-level branch
    d = model.inference(tight, None, hw, (64, 96))
    assert int(d.valid.sum()) > 0 and torch.isfinite(d.scores).all()


def test_s2d_on_a_dw_body_raises():
    cfg = get_cfg()
    cfg.TPU.S2D_STEM_INPUT = True
    cfg.MODEL.VOVNET.CONV_BODY = "V-19-slim-dw-eSE"
    with pytest.raises(ValueError, match="standard-conv"):
        build_centermask(cfg, device="cpu")
    with pytest.raises(ValueError, match="FrozenBN"):
        tvov.VoVNet("V-19-slim-eSE", norm="GN", s2d_input=True)
