"""Port parity for the person-keypoint slice: the KRCNN head, the heatmap
decode and loss, a tiny keypoint model's inference and loss, the
keypoint loaders, and the infer and train_net CLIs on the keypoint
yaml; each against the JAX package on the CPU in float32, inputs and
parameters drawn with numpy from a seed (``test_torch_backbones.py``'s
``numpy_params``).

Tolerances: the head's logits ``rtol = atol = 1e-4`` (f32 convolutions
summed in other orders); the bicubic resize 1e-6 (one (grid, S) matrix a
side against ``jax.image.resize``); decoded keypoints equal cells and
coordinates within 1e-4 relative on unimodal maps (ties between grid
cells cannot flip there); losses 1e-5 relative, gradients 1e-4 of each
tensor's largest value, as ``test_torch_train.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from test_torch_backbones import (CONFIGS, PIXEL_MEAN, _configs,  # noqa: E402
                                  numpy_params, run_both)

from centermask2_tpu.data import coco as jcoco  # noqa: E402
from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models import GroundTruth as JaxGroundTruth  # noqa: E402
from centermask2_tpu.models.roi import keypoint_head as jkp  # noqa: E402
from centermask2_tpu_torch import build_centermask  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import (  # noqa: E402
    load_jax_params, state_dict_from_jax)
from centermask2_tpu_torch.data import coco as tcoco  # noqa: E402
from centermask2_tpu_torch.models.meta import (  # noqa: E402
    CenterMask, GroundTruth)
from centermask2_tpu_torch.models.roi import keypoint_head as tkp  # noqa: E402

KEYPOINT_YAML = "centermask_V_39_eSE_FPN_keypoint_ms_3x.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def test_krcnn_head_matches_jax():
    """Two narrow convs, the k4/s2/p1 deconv (its (kh, kw, K, C) JAX
    kernel permuted into torch's (C, K, kh, kw) by ``load_jax_params``)
    and the bilinear 2x upsample: 14 -> 28 -> 56."""
    x = np.random.RandomState(0).randn(3, 8, 14, 14).astype(np.float32)
    jmod = jkp.KRCNNConvDeconvUpsampleHead(num_keypoints=5,
                                           conv_dims=(16, 16),
                                           dtype=jnp.float32)
    port = tkp.KRCNNConvDeconvUpsampleHead(8, 5, (16, 16))
    want, got, params = run_both(jmod, port, x)
    assert params["score_lowres_kernel"].shape == (4, 4, 5, 16)
    assert port.score_lowres.weight.shape == (16, 5, 4, 4)
    assert got.shape == want.shape == (3, 5, 56, 56)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bicubic_matrix_is_jax_resize():
    """``W @ map @ W.T`` with the (112, 56) Keys a = -0.5 matrix equals
    ``jax.image.resize(..., "bicubic")``, the border rows included (torch's
    bicubic differs there and inside)."""
    m = np.random.RandomState(1).randn(2, 3, 56, 56).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(m), (2, 3, 112, 112),
                                       method="bicubic"))
    w = tkp.bicubic_resize_matrix(56, 112)
    got = (w @ t(m) @ w.t()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert tkp.bicubic_resize_matrix(56, 112) is w  # built once


def _unimodal_maps(rng, R, K, S=56):
    """tests/test_ablations.py:266-274: one Gaussian bump a keypoint plus
    mild noise, NCHW."""
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    maps = np.empty((R, K, S, S), np.float32)
    peaks = rng.randint(4, S - 4, size=(R, K, 2))
    for r in range(R):
        for k in range(K):
            py, px = peaks[r, k]
            g = np.exp(-((yy - py) ** 2 + (xx - px) ** 2) / (2 * 3.0 ** 2))
            maps[r, k] = 8.0 * g + 0.3 * rng.randn(S, S)
    return maps


def test_heatmaps_to_keypoints_matches_jax():
    """The decode of unimodal maps over boxes of 14-260 px, one of them
    thinner than a pixel: the same argmax cells, coordinates, logits and
    probabilities; ``keypoint_rcnn_inference`` keeps x, y, prob."""
    rng = np.random.RandomState(3)
    R, K = 12, 17
    sizes = rng.uniform(14, 260, size=(R, 2)).astype(np.float32)
    x0y0 = rng.uniform(0, 60, size=(R, 2)).astype(np.float32)
    boxes = np.concatenate([x0y0, x0y0 + sizes], axis=1)
    boxes[0, 2] = boxes[0, 0] + 0.5  # max(width, 1)
    maps = _unimodal_maps(rng, R, K)
    want = np.asarray(jkp.heatmaps_to_keypoints(
        jnp.asarray(np.transpose(maps, (0, 2, 3, 1))), jnp.asarray(boxes)))
    got = tkp.heatmaps_to_keypoints(t(maps), t(boxes)).numpy()
    assert got.shape == want.shape == (R, K, 4)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    inf = tkp.keypoint_rcnn_inference(t(maps), t(boxes)).numpy()
    np.testing.assert_array_equal(inf, got[..., [0, 1, 3]])


def test_keypoints_to_heatmap_matches_jax():
    """Keypoints inside, outside, invisible, and exactly on the right and
    bottom box edges (the last bin, still valid)."""
    rng = np.random.RandomState(4)
    R, K, S = 6, 17, 56
    boxes = np.array([[10, 20, 70, 90], [0, 0, 33, 17], [5, 5, 6, 6],
                      [40, 10, 100, 120], [1, 1, 57, 57],
                      [30, 30, 30.5, 90]], np.float32)
    kp = np.zeros((R, K, 3), np.float32)
    kp[..., 0] = rng.uniform(-10, 120, (R, K))
    kp[..., 1] = rng.uniform(-10, 130, (R, K))
    kp[..., 2] = rng.randint(0, 3, (R, K))
    centre = (boxes[:, :2] + boxes[:, 2:]) / 2
    kp[:, 0] = np.stack([boxes[:, 2], centre[:, 1], np.full(R, 2)], 1)
    kp[:, 1] = np.stack([centre[:, 0], boxes[:, 3], np.full(R, 2)], 1)
    kp[:, 2] = np.stack([boxes[:, 2], boxes[:, 3], np.ones(R)], 1)
    want_i, want_v = (np.asarray(a) for a in jkp.keypoints_to_heatmap(
        jnp.asarray(kp), jnp.asarray(boxes), S))
    got_i, got_v = tkp.keypoints_to_heatmap(t(kp), t(boxes), S)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy()[want_v], want_i[want_v])
    assert got_v[:, :3].all() and (got_i[:, 2] == S * S - 1).all()
    assert 0 < int(want_v.sum()) < R * K


@pytest.mark.parametrize("normalizer", [None, 2 * 17 * 16 * 0.25])
def test_keypoint_rcnn_loss_matches_jax(normalizer):
    """The masked cross-entropy, by the visible count or a fixed
    normalizer (NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS), and its gradient."""
    rng = np.random.RandomState(5)
    R, K, S = 5, 17, 56
    logits = rng.randn(R, K, S, S).astype(np.float32)
    targets = rng.randint(0, S * S, (R, K)).astype(np.int32)
    valid = rng.rand(R, K) < 0.6

    def jloss(lg):
        return jkp.keypoint_rcnn_loss(jnp.transpose(lg, (0, 2, 3, 1)),
                                      jnp.asarray(targets),
                                      jnp.asarray(valid), normalizer)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    got = tkp.keypoint_rcnn_loss(x, t(targets), t(valid), normalizer)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad),
                               atol=1e-4 * float(np.abs(jgrad).max()))
    none = tkp.keypoint_rcnn_loss(x, t(targets), torch.zeros(R, K, dtype=bool),
                                  normalizer)
    assert float(none) == 0.0


# ---------------------------------------------------------- tiny model
TINY_KW = dict(conv_body="V-19-slim-eSE", num_classes=1, fpn_out_channels=256,
               mask_on=False, maskiou_on=False, keypoint_on=True,
               keypoint_conv_dims=(16, 16), pre_nms_topk_train=20,
               post_nms_topk_train=10, nms_candidates=20,
               pre_nms_topk_test=50, post_nms_topk_test=10,
               batch_size_per_image=16, max_fg_proposals=4)


def _kp_batch(B=2, G=2, K=17):
    rng = np.random.RandomState(6)
    images = rng.randn(B, 64, 64, 3).astype(np.float32) * 20
    boxes = np.zeros((B, G, 4), np.float32)
    kp = np.zeros((B, G, K, 3), np.float32)
    for i in range(B):
        for g in range(G):
            x0, y0 = 2.0 + 5.0 * i + 9.0 * g, 3.0 + 4.0 * g
            w, h = 18.0 + 3.0 * i, 24.0 + 2.0 * g
            boxes[i, g] = [x0, y0, x0 + w, y0 + h]
            kp[i, g, :, 0] = x0 + rng.rand(K) * w
            kp[i, g, :, 1] = y0 + rng.rand(K) * h
            kp[i, g, :, 2] = rng.randint(0, 3, K)
    return rng, images, boxes, kp


def test_tiny_keypoint_model_matches_jax():
    """A V-19-slim keypoint model (one class, masks off, FPN 256 as in
    ``test_torch_train.py``'s R-50 step, KRCNN convs 16) through
    ``load_jax_params(strict=True)``: ``inference``'s slots and
    ``pred_keypoints``, with zero masks and the proposal scores as mask
    scores; ``loss``'s FCOS and keypoint losses and every gradient, from
    JAX's sampler draws.

    The random model's maps are not unimodal: where two of its 112 x 112
    cells are within rounding of each other the argmax may take either
    (a few of 510 values here). So the probabilities (continuous in the
    maximum) are held to 1e-3 everywhere, x and y to 2e-2 px on 98% of
    the keypoints and to two grid cells of their box on all; the decode
    itself is held exactly on unimodal maps above. The bias of the
    deconv has a zero gradient (the softmax over each map's cells
    cancels a constant): its noise is held to 1e-6."""
    rng, images, boxes, kp = _kp_batch()
    B, G = boxes.shape[:2]
    jm = JaxCenterMask(**TINY_KW, dtype=jnp.float32)
    params = numpy_params(jm, rng, jnp.asarray(images[:1]))
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    port = CenterMask(**TINY_KW, dtype=torch.float32)
    load_jax_params(port, params)

    out = jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, jnp.asarray(images[:1]))
    got = port.inference(t(images[:1]))
    valid = np.asarray(out.valid[0])
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    n = int(valid.sum())
    assert n > 3
    for f, tol in (("scores", 2e-4), ("pred_boxes", 1e-3),
                   ("mask_scores", 2e-4)):
        np.testing.assert_allclose(getattr(got, f)[0][:n].numpy(),
                                   np.asarray(getattr(out, f)[0])[:n],
                                   rtol=tol, atol=1e-4, err_msg=f)
    assert not got.pred_masks.any()
    np.testing.assert_array_equal(got.mask_scores.numpy(), got.scores.numpy())
    gk = got.pred_keypoints[0][:n].numpy()
    wk = np.asarray(out.pred_keypoints[0])[:n]
    assert gk.shape == (n, 17, 3)
    np.testing.assert_allclose(gk[..., 2], wk[..., 2], rtol=1e-3, atol=1e-7)
    d = np.abs(gk[..., :2] - wk[..., :2])
    assert (d <= 2e-2).mean() >= 0.98
    b = np.asarray(out.pred_boxes[0])[:n]
    cell = np.maximum(b[:, 2:] - b[:, :2], 1.0) / 112  # (n, 2): x, y
    assert (d <= 2 * cell[:, None, :] + 2e-2).all()

    jgt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                         classes=jnp.zeros((B, G), jnp.int32),
                         valid=jnp.ones((B, G), bool),
                         mask_patches=jnp.zeros((B, G, 8, 8)),
                         keypoints=jnp.asarray(kp))
    key = jax.random.PRNGKey(1)

    def f(p):
        losses = jm.apply({"params": p}, jnp.asarray(images), jgt, key,
                          method=JaxCenterMask.loss)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    draws = np.stack([np.asarray(jax.random.uniform(k, (10 + G,)))
                      for k in jax.random.split(key, B)])
    gt = GroundTruth(t(boxes), torch.zeros((B, G), dtype=torch.int32),
                     torch.ones((B, G), dtype=torch.bool),
                     torch.zeros((B, G, 8, 8)), keypoints=t(kp))
    port.train()
    losses = port.loss(t(images), gt, draws=t(draws))
    assert set(losses) == set(want) == {"loss_fcos_cls", "loss_fcos_loc",
                                        "loss_fcos_ctr", "loss_keypoint"}
    for k in want:
        np.testing.assert_allclose(float(losses[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(losses["loss_keypoint"]) > 0
    sum(losses.values()).backward()
    named = dict(port.named_parameters())
    for key_, (path, g) in state_dict_from_jax(
            jax.tree.map(np.asarray, jgrads)).items():
        if path[-1].startswith("frozen_"):
            continue
        pg = named[key_].grad
        pg = torch.zeros_like(g) if pg is None else pg
        np.testing.assert_allclose(pg.numpy(), g.numpy(),
                                   atol=max(1e-4 * float(g.abs().max()),
                                            1e-6), err_msg=key_)
    assert named["roi_heads.keypoint_head.score_lowres.weight"].grad.abs() \
        .max() > 0


def test_keypoint_yaml_builds_at_full_width():
    """The keypoint yaml at full width: one class, no mask or MaskIoU
    head, the KRCNN head of 8 convs of 512 pooling p3-p5 at the ROI
    heads' sampling ratio; ``pred_keypoints`` (B, K, 17, 3) from a tiny
    canvas."""
    _, tcfg = _configs(KEYPOINT_YAML, [])
    model = build_centermask(tcfg, device="cpu")
    heads = model.roi_heads
    assert model.keypoint_on and not model.mask_on and heads.keypoint_on
    assert not hasattr(heads, "mask_head")
    assert heads.keypoint_head.conv_fcn8.weight.shape == (512, 512, 3, 3)
    assert heads.keypoint_head.score_lowres.weight.shape == (512, 17, 4, 4)
    assert heads.in_strides == (8, 16, 32) and heads.sampling_ratio == 2
    assert model.fcos_head.cls_logits.weight.shape[0] == 1


# ------------------------------------------------------------- loaders
def _kp_dataset(root, n_images=2, seed=0):
    """PNG images with person annotations carrying 17 keypoints (some
    not labeled, some invisible); image 3, if any, has none visible."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    for i in range(1, n_images + 1):
        h, w = (64, 80) if i % 2 else (80, 64)
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            root / "images" / f"{i}.png")
        images.append({"id": i, "file_name": f"{i}.png", "height": h,
                       "width": w})
        for j in range(2):
            bw, bh = 20 + rng.rand() * 20, 24 + rng.rand() * 20
            x0, y0 = rng.rand() * (w - bw - 1), rng.rand() * (h - bh - 1)
            kp = np.zeros((17, 3))
            kp[:, 0] = x0 + rng.rand(17) * bw
            kp[:, 1] = y0 + rng.rand(17) * bh
            kp[:, 2] = 0 if i == 3 else rng.randint(0, 3, 17)
            kp[kp[:, 2] == 0, :2] = 0
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": 1, "bbox": [x0, y0, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw,
                                           y0 + bh, x0, y0 + bh]],
                         "keypoints": [float(v) for v in kp.flatten()],
                         "num_keypoints": int((kp[:, 2] > 0).sum())})
    ann = root / "ann.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "person",
                        "keypoints": [f"k{k}" for k in range(17)],
                        "skeleton": []}]}))
    return str(ann), str(root / "images")


def test_keypoint_loaders_match_jax(tmp_path):
    """tests/test_coco_data.py:186's cases against the JAX loaders: one
    example with and without the flip (left and right members swapped,
    not-labeled keypoints zeroed), two epochs of ``train_batches`` with
    ``with_keypoints``, and the MIN_KEYPOINTS_PER_IMAGE filter."""
    ann, root = _kp_dataset(tmp_path, n_images=3)
    kw = dict(short_edge=48, pad_to=(96, 96), max_gt=4, patch_size=16,
              with_keypoints=True)
    for flip in (False, True):
        want = jcoco.load_train_example(jcoco.CocoDataset(ann, root), 1,
                                        hflip=flip, **kw)
        got = tcoco.load_train_example(tcoco.CocoDataset(ann, root), 1,
                                       hflip=flip, **kw)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tcoco.COCO_KEYPOINT_HFLIP_PAIRS == jcoco.COCO_KEYPOINT_HFLIP_PAIRS
    bkw = dict(min_sizes=(40, 48), max_size=72, pad_to=(96, 96), max_gt=4,
               patch_size=16, seed=2, epochs=2, with_keypoints=True)
    want = list(jcoco.train_batches(jcoco.CocoDataset(ann, root), 1, **bkw))
    got = list(tcoco.train_batches(tcoco.CocoDataset(ann, root), 1, **bkw))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert a["gt_keypoints"].shape == (1, 4, 17, 3)
        for k in tcoco.BATCH_KEYS + ("gt_keypoints",):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    dropped = []
    for lib in (jcoco, tcoco):
        ds = lib.CocoDataset(ann, root)
        dropped.append((lib.filter_images_with_few_keypoints(ds, 1),
                        list(ds.ids)))
    assert dropped[0] == dropped[1] == (1, [1, 2])


# ----------------------------------------------------------------- CLIs
CLI_OPTS = ["MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE",
            "MODEL.FPN.OUT_CHANNELS", "32",
            "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "[16, 16]",
            "TPU.FIXED_EDGE_SIZE", "64", "TPU.COMPUTE_DTYPE", "float32",
            "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TEST", "50",
            "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
            "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
            "TPU.MAX_FG_PROPOSALS", "8", "TPU.MAX_GT_INSTANCES", "4"]


def test_infer_cli_scores_keypoints(tmp_path):
    """``tools/infer`` on the keypoint yaml (narrowed): the keypoints task
    comes with KEYPOINT_ON, its records carry 17 keypoints, and the OKS
    metrics are written."""
    from centermask2_tpu_torch.tools import infer

    ann, root = _kp_dataset(tmp_path / "ds")
    out = tmp_path / "out"
    infer.main(["--device", "cpu", "--config-file",
                os.path.join(CONFIGS, KEYPOINT_YAML), "--ann", ann,
                "--image-root", root, "--output-dir", str(out), *CLI_OPTS,
                "INPUT.MIN_SIZE_TEST", "48", "INPUT.MAX_SIZE_TEST", "64",
                "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"])
    metrics = json.loads((out / "metrics.json").read_text())
    assert {"bbox", "segm", "keypoints", "box_proposals"} <= set(metrics)
    assert {"AP", "AP50", "AP75", "APm", "APl"} <= set(metrics["keypoints"])
    preds = json.loads((out / "coco_instances_results.json").read_text())
    assert preds and all(len(p["keypoints"]) == 51 for p in preds)


def test_train_net_cli_trains_keypoints(tmp_path):
    """``tools/train_net`` on a two-image keypoint set: two steps with
    ``loss_keypoint`` finite, a checkpoint (after tests/test_cli.py's
    dry run)."""
    from centermask2_tpu_torch.tools import train_net

    ann, root = _kp_dataset(tmp_path / "ds")
    out = tmp_path / "out"
    train_net.main(["--device", "cpu", "--config-file",
                    os.path.join(CONFIGS, KEYPOINT_YAML), "--ann", ann,
                    "--image-root", root, "--max-iter", "2",
                    "--log-every", "1", *CLI_OPTS,
                    "INPUT.MIN_SIZE_TRAIN", "(40, 48)",
                    "INPUT.MAX_SIZE_TRAIN", "64", "SOLVER.IMS_PER_BATCH", "2",
                    "SOLVER.CHECKPOINT_PERIOD", "2", "OUTPUT_DIR", str(out)])
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
             .splitlines()]
    assert len(lines) == 2
    for x in lines:
        assert {"loss_fcos_cls", "loss_keypoint", "total_loss"} <= set(x)
        assert "loss_mask" not in x
        assert all(np.isfinite(v) for v in x.values())
    assert sorted(os.listdir(out / "checkpoints")) == ["step_2"]


def test_keypoint_slots_reach_the_postprocess():
    """``pred_keypoints`` goes through the batched serving form and the
    eval loop's host copy; a model without the head leaves the slot None."""
    from centermask2_tpu_torch.evaluation.loop import _to_host

    _, tcfg = _configs(KEYPOINT_YAML, CLI_OPTS)
    model = build_centermask(tcfg, device="cpu")
    img = torch.from_numpy((np.random.RandomState(7).rand(2, 64, 64, 3)
                            * 255 - PIXEL_MEAN).astype(np.float32))
    out = model.inference_batched(img)
    assert out.pred_keypoints.shape == (2, 50, 17, 3)
    host, done = _to_host(out, cuda=False)
    assert done is None and "pred_keypoints" in host
    plain = build_centermask(_configs("zy_model_config.yaml", CLI_OPTS)[1],
                             device="cpu")
    got = plain.inference(img[:1])
    assert got.pred_keypoints is None
    assert "pred_keypoints" not in _to_host(got, cuda=False)[0]


def test_captured_programs_carry_the_keypoints(monkeypatch):
    """``CapturedInference`` of a keypoint model (rehearsed with
    ``test_torch_captured.py``'s ``FakeGraphs``): the replay's
    ``pred_keypoints`` slot equals the eager request's. The captured train
    step takes ``gt.keypoints`` among its static inputs: two steps (one
    warm-up, then the graph) on two batches equal the eager step's,
    ``loss_keypoint`` included."""
    from test_torch_captured import FakeGraphs, _state

    from centermask2_tpu_torch.export import CapturedInference
    from centermask2_tpu_torch.train import (make_optimizer,
                                             make_train_step, trainer)

    monkeypatch.setattr(trainer, "WARMUP_STEPS", 1)
    kw = dict(TINY_KW, fpn_out_channels=32)
    torch.manual_seed(0)
    model = CenterMask(**kw, dtype=torch.float32).eval()
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    rng, images, boxes, kp = _kp_batch()
    prog = CapturedInference(model, graphs=FakeGraphs())
    for i in range(2):
        x = t(images[i:i + 1])
        want = model.inference(x)
        got = prog(x)
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert len(prog) == 1 and got.pred_keypoints.shape == (1, 10, 17, 3)

    B, G = boxes.shape[:2]
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batches = [(t(images + 3.0 * i), GroundTruth(
        t(boxes + 2.0 * i), torch.zeros((B, G), dtype=torch.int32),
        torch.ones((B, G), dtype=torch.bool), torch.zeros((B, G, 8, 8)),
        keypoints=t(kp + np.float32([2.0 * i, 2.0 * i, 0.0]))))
        for i in range(2)]
    draws = [t(rng.rand(B, 10 + G).astype(np.float32)) for _ in range(2)]
    runs = []
    for capture in (True, False):
        model.load_state_dict(init)
        model.train()
        opt, sched = make_optimizer(model, 0.02, (2,))
        graphs = FakeGraphs(_state(model, opt, sched)) if capture else None
        step = make_train_step(model, opt, sched, capture=capture,
                               graphs=graphs)
        runs.append([{k: float(v) for k, v in step(x, gt, d).items()}
                     for (x, gt), d in zip(batches, draws)])
        if capture:
            assert step.static[5] is batches[1][1].keypoints  # capturing call
    assert runs[0] == runs[1]
    assert all(np.isfinite(m["loss_keypoint"]) for m in runs[0])
