"""Port parity for training: one whole step of ``CenterMask.loss`` and
its gradients against the JAX package on the CPU in float32, the s2d
stem's gradients, the loss's own draws, and the ``train_net`` CLI. The
pieces are held one by one in ``test_torch_losses.py``,
``test_torch_sampling.py`` and ``test_torch_optimizer.py``. The slow
tier mirrors the JAX package's overfit and bf16-vs-f32 step tests
(tests/test_train.py:572 and :690).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")

from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models import GroundTruth as JaxGroundTruth  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import (  # noqa: E402
    load_jax_params, state_dict_from_jax)
from centermask2_tpu_torch.models.meta import (  # noqa: E402
    CenterMask, GroundTruth)


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


def test_s2d_stem_gradients_equal_the_plain_stem():
    """With grad enabled the s2d stem is a differentiable function of
    the stem parameters: the loss and every gradient, the stem's
    included, equal the plain stem's (JAX pins the same,
    tests/test_train.py:258)."""
    from centermask2_tpu_torch.data.preprocess import stem_space_to_depth

    kw = dict(conv_body="V-19-slim-eSE", num_classes=3, fpn_out_channels=64,
              mask_conv_dim=8, maskiou_conv_dim=8, pre_nms_topk_train=20,
              post_nms_topk_train=10, nms_candidates=20,
              batch_size_per_image=16, max_fg_proposals=4,
              dtype=torch.float32)
    torch.manual_seed(0)
    plain = CenterMask(**kw)
    s2d = CenterMask(s2d_input=True, **kw)
    s2d.load_state_dict(plain.state_dict())
    for m in (plain, s2d):
        with torch.no_grad():
            m.fcos_head.cls_logits.bias.zero_()
    rng = np.random.RandomState(0)
    x = rng.randn(1, 64, 64, 3).astype(np.float32) * 20
    gt = GroundTruth(boxes=t(np.float32([[[8.0, 8.0, 40.0, 40.0]]])),
                     classes=torch.zeros((1, 1), dtype=torch.int32),
                     valid=torch.ones((1, 1), dtype=torch.bool),
                     mask_patches=torch.full((1, 1, 8, 8), 0.7))
    draws = t(rng.rand(1, 11).astype(np.float32))
    s2d.backbone.s2d_kernels()  # an inference cache must not leak in
    totals = []
    for m, im in ((plain, x), (s2d, stem_space_to_depth(x))):
        total = sum(m.loss(t(im), gt, draws=draws).values())
        total.backward()
        totals.append(float(total))
    np.testing.assert_allclose(totals[1], totals[0], rtol=1e-5)
    grads = dict(s2d.named_parameters())
    for n, p in plain.named_parameters():
        q = grads[n].grad
        if p.grad is None:
            assert q is None, n
            continue
        assert q is not None, f"{n}: no gradient through the s2d stem"
        np.testing.assert_allclose(q.numpy(), p.grad.numpy(),
                                   atol=1e-4 * float(p.grad.abs().max()),
                                   err_msg=n)
    assert s2d.backbone.stem_1.conv.weight.grad.abs().max() > 0


STEP_KW = dict(conv_body="V-19-slim-eSE", num_classes=4, fpn_out_channels=64,
               mask_conv_dim=16, maskiou_conv_dim=16, pre_nms_topk_train=20,
               post_nms_topk_train=10, nms_candidates=20,
               batch_size_per_image=16, max_fg_proposals=4)


def _step_batch(B=2, n_gt=2):
    """The gt of tests/test_train.py:398-420 (per-image varying boxes),
    with mask patches of continuous values: binary patches resampled at
    their own boxes land exactly on 0.5, where the >= 0.5 target flips
    with the last bit of the resampling sum (XLA's own jit and eager
    runs disagree there)."""
    rng = np.random.RandomState(3)
    images = rng.randn(B, 64, 64, 3).astype(np.float32) * 20
    boxes = np.zeros((B, n_gt, 4), np.float32)
    classes = np.zeros((B, n_gt), np.int32)
    for i in range(B):
        for g in range(n_gt):
            x0 = 2.0 + 3.0 * i + 7.0 * g
            y0 = 3.0 + 2.0 * ((i + g) % 4)
            boxes[i, g] = [x0, y0, x0 + 14.0 + 2.0 * i, y0 + 20.0 + 3.0 * g]
            classes[i, g] = (i + g) % 3
    patches = rng.rand(B, n_gt, 16, 16).astype(np.float32)
    return rng, images, boxes, classes, patches


def _perturbed_params(jm, images, rng):
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(images[:1]))

    def leaf(path, x):
        name = path[-1].key
        if name == "frozen_scale":
            return (1 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        if name in ("bias", "frozen_bias"):
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        return np.asarray(x, np.float32)

    params = jax.tree_util.tree_map_with_path(
        leaf, jax.tree.map(np.asarray, variables["params"]))
    # at the prior bias no random-weight score passes the train threshold
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    return params


def test_whole_train_step_matches_jax():
    """One step of CenterMask.loss at V-19-slim, 64x64, B = 2, narrow
    heads: every loss within 1e-5 relative, every trainable parameter's
    gradient within 1e-4 of its tensor's largest. JAX's ``frozen_*``
    leaves (FrozenBN, parameters whose updates optax zeroes) are buffers
    of the port and have no gradient to compare."""
    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    jm = JaxCenterMask(**STEP_KW, dtype=jnp.float32)
    params = _perturbed_params(jm, images, rng)
    jgt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                         classes=jnp.asarray(classes),
                         valid=jnp.ones((B, G), bool),
                         mask_patches=jnp.asarray(patches))
    key = jax.random.PRNGKey(1)

    def f(p):
        losses = jm.apply({"params": p}, jnp.asarray(images), jgt, key,
                          method=JaxCenterMask.loss)
        return sum(losses.values()), losses

    (_, want), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    draws = np.stack([np.asarray(jax.random.uniform(k, (10 + G,)))
                      for k in jax.random.split(key, B)])

    port = CenterMask(**STEP_KW, dtype=torch.float32)
    load_jax_params(port, params)
    gt = GroundTruth(t(boxes), t(classes), torch.ones((B, G), dtype=torch.bool),
                     t(patches))
    got = port.loss(t(images), gt, draws=t(draws))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    sum(got.values()).backward()
    named = dict(port.named_parameters())
    compared = 0
    for key_, (path, g) in state_dict_from_jax(
            jax.tree.map(np.asarray, jgrads)).items():
        if path[-1].startswith("frozen_"):
            assert key_ not in named
            continue
        pg = named[key_].grad
        pg = torch.zeros_like(g) if pg is None else pg
        np.testing.assert_allclose(pg.numpy(), g.numpy(),
                                   atol=1e-4 * float(g.abs().max()),
                                   err_msg=key_)
        compared += 1
    assert compared == len(named)


# FPN 256, the R-50 yaml's width: at 64 channels GroupNorm(32) normalizes
# pairs of values on the 1x1 P6 and P7 maps of a 64x64 canvas, whose
# backward turns f32 rounding into gradients a few percent apart
R50_KW = dict(STEP_KW, backbone_type="resnet", fpn_out_channels=256,
              fpn_in_features=("res3", "res4", "res5"),
              resnet_res2_out_channels=32, resnet_stem_out_channels=8,
              resnet_width_per_group=8)


def test_r50_train_step_with_freeze_at_2_matches_jax():
    """One f32 SGD step of a narrow ResNet-50 (RES2_OUT_CHANNELS 32,
    STEM_OUT_CHANNELS 8, WIDTH_PER_GROUP 8; FPN 256, the other heads of
    STEP_KW; parameters drawn as ``test_torch_backbones.py`` draws them) with
    FREEZE_AT 2, the R-50 yaml's value, against the JAX package's loss,
    gradient and optax chain: every loss within 1e-5 relative, every
    parameter's update within 1e-4 of its tensor's largest (the
    gradients' tolerance above) plus two f32 spacings of the parameter;
    the stem and res2, frozen in both, unchanged bit for bit."""
    from centermask2_tpu.train.optimizer import make_optimizer as jax_opt
    from test_torch_backbones import numpy_params

    from centermask2_tpu_torch.train import make_optimizer, make_train_step

    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    jm = JaxCenterMask(**R50_KW, dtype=jnp.float32)
    params = numpy_params(jm, rng, jnp.asarray(images[:1]))
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    jgt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                         classes=jnp.asarray(classes),
                         valid=jnp.ones((B, G), bool),
                         mask_patches=jnp.asarray(patches))
    key = jax.random.PRNGKey(1)

    def f(p):
        losses = jm.apply({"params": p}, jnp.asarray(images), jgt, key,
                          method=JaxCenterMask.loss)
        return sum(losses.values()), losses

    jp = jax.tree.map(jnp.asarray, params)
    (total, want), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    kw = dict(warmup_iters=0, warmup_factor=1.0, freeze_at=2)
    chain = jax_opt(0.02, (100,), **kw)
    updates, _ = chain.update(grads, chain.init(jp), jp)
    jnew = state_dict_from_jax(jax.tree.map(
        np.asarray, optax.apply_updates(jp, updates)))
    draws = np.stack([np.asarray(jax.random.uniform(k, (10 + G,)))
                      for k in jax.random.split(key, B)])

    port = CenterMask(**R50_KW, dtype=torch.float32)
    load_jax_params(port, params)
    init = {n: t.detach().clone() for n, t in port.state_dict().items()}
    opt, sched = make_optimizer(port, 0.02, (100,), **kw)
    gt = GroundTruth(t(boxes), t(classes), torch.ones((B, G), dtype=torch.bool),
                     t(patches))
    got = make_train_step(port, opt, sched, capture=False)(
        t(images), gt, t(draws))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["total_loss"]), float(total),
                               rtol=1e-5)
    after = port.state_dict()
    frozen = []
    for name, (path, value) in jnew.items():
        delta = (after[name] - init[name]).numpy()
        want_delta = value.numpy() - init[name].numpy()
        if name.startswith(("backbone.stem_conv1.", "backbone.res2_")):
            frozen.append(name)
            assert not np.abs(want_delta).max() > 0, name
            assert torch.equal(after[name], init[name]), name
            continue
        tol = 1e-4 * np.abs(want_delta).max() \
            + 2 * np.spacing(np.abs(value.numpy()))
        assert (np.abs(delta - want_delta) <= tol).all(), name
    # a conv weight and FrozenBN's two leaves for the stem, res2's nine
    # convs and its shortcut
    assert len(frozen) == 3 * (1 + 9 + 1)


@pytest.mark.parametrize("backbone,want", [
    ("resnet", ("stem_conv1.", "res2_")),
    ("mobilenet", ("features0_", "features1."))])
def test_freeze_at_2_freezes_the_stem_and_first_stage(backbone, want):
    """FREEZE_AT 2 takes exactly ResNet's stem and res2, and MobileNet's
    stem (``features0_*``) and first block (``features1``, not
    ``features10`` to ``features17``), as the JAX masks do."""
    from centermask2_tpu_torch.train.optimizer import param_groups

    kw = dict(R50_KW) if backbone == "resnet" else dict(
        STEP_KW, backbone_type="mobilenet",
        fpn_in_features=("res3", "res4", "res5"))
    model = CenterMask(**kw, dtype=torch.float32)
    param_groups(model, 1e-4, 0.0, freeze_at=2)
    frozen = {n[len("backbone."):] for n, p in model.named_parameters()
              if not p.requires_grad}
    assert frozen and all(n.startswith(want) for n in frozen)
    assert {n for n, _ in model.backbone.named_parameters()
            if n.startswith(want)} == frozen
    assert all(p.requires_grad for n, p in model.named_parameters()
               if not n.startswith("backbone."))


def test_loss_draws_from_a_generator():
    """Without ``draws`` the loss draws them from the generator: the same
    seed gives the same losses."""
    torch.manual_seed(0)
    port = CenterMask(**STEP_KW, dtype=torch.float32)
    with torch.no_grad():
        port.fcos_head.cls_logits.bias.zero_()
    _, images, boxes, classes, patches = _step_batch()
    gt = GroundTruth(t(boxes), t(classes), torch.ones(classes.shape,
                                                      dtype=torch.bool),
                     t(patches))
    with torch.no_grad():
        a, b = (port.loss(t(images), gt,
                          generator=torch.Generator().manual_seed(5))
                for _ in range(2))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


TINY_OPTS = [
    "MODEL.MASK_ON", "True", "MODEL.MASKIOU_ON", "True",
    "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE", "MODEL.FCOS.NUM_CLASSES", "2",
    "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
    "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8", "TPU.FIXED_EDGE_SIZE", "64",
    "INPUT.MIN_SIZE_TRAIN", "(40, 48)", "INPUT.MAX_SIZE_TRAIN", "64",
    "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
    "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "TPU.MAX_FG_PROPOSALS", "8",
    "TPU.MAX_GT_INSTANCES", "8", "TPU.COMPUTE_DTYPE", "float32",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
    "DATALOADER.NUM_WORKERS", "1"]


def test_train_net_cli_trains_checkpoints_and_resumes(tmp_path, capsys,
                                                      monkeypatch):
    """Two steps, a checkpoint, a resume to step 3. The loader is seeded
    with SEED alone, as the JAX CLI seeds it: the resumed run's first
    batch is the fresh run's first batch."""
    import json

    from test_torch_data import make_train_dataset

    from centermask2_tpu_torch.data import coco
    from centermask2_tpu_torch.tools import train_net

    firsts = []
    batches = coco.train_batches

    def recorded(*args, **kwargs):
        for i, b in enumerate(batches(*args, **kwargs)):
            if i == 0:
                firsts.append({k: v.copy() for k, v in b.items()})
            yield b

    monkeypatch.setattr(coco, "train_batches", recorded)
    ann, root = make_train_dataset(tmp_path / "ds")
    out = tmp_path / "out"
    common = ["--device", "cpu", "--ann", ann, "--image-root", root,
              "--log-every", "1", *TINY_OPTS, "OUTPUT_DIR", str(out)]
    train_net.main(["--max-iter", "2", *common])
    assert sorted(os.listdir(out / "checkpoints")) == ["step_2"]
    train_net.main(["--max-iter", "3", "--resume", str(out / "checkpoints"),
                    *common])
    assert sorted(os.listdir(out / "checkpoints")) == ["step_2", "step_3"]
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
             .splitlines()]
    assert [x["iteration"] for x in lines] == [0, 1, 2]
    for x in lines:
        assert {"loss_fcos_cls", "loss_mask", "loss_maskiou", "total_loss",
                "s_per_iter"} <= set(x)
        assert all(np.isfinite(v) for v in x.values())
    assert "resumed from" in capsys.readouterr().out
    from centermask2_tpu_torch.checkpoint.torch_io import load_checkpoint

    state = load_checkpoint(str(out / "checkpoints" / "step_3"))
    assert state["step"] == 3 and state["scheduler"]["last_epoch"] == 3
    assert len(firsts) == 2 and firsts[0].keys() == firsts[1].keys()
    for k, v in firsts[0].items():
        np.testing.assert_array_equal(firsts[1][k], v, err_msg=k)


def test_train_net_defaults_to_cuda(monkeypatch, tmp_path):
    from centermask2_tpu_torch.tools import train_net

    assert train_net.parse_args(["--ann", "a", "--image-root", "b"]).device \
        == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(["--ann", "a", "--image-root", "b", *TINY_OPTS,
                        "OUTPUT_DIR", str(tmp_path)])


@pytest.mark.slow
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_overfit_single_image_detects_object(dtype):
    """tests/test_train.py:572 on the port: one synthetic image, 300 steps
    at most, until the model re-detects its own object (score > 0.25,
    IoU > 0.5, mask > half the box)."""
    from centermask2_tpu_torch.train import make_optimizer, make_train_step

    torch.manual_seed(0)
    model = CenterMask(conv_body="V-19-slim-eSE", num_classes=4,
                       pre_nms_topk_test=50, post_nms_topk_test=10,
                       nms_candidates=50, pre_nms_topk_train=50,
                       post_nms_topk_train=20, batch_size_per_image=32,
                       max_fg_proposals=8, dtype=dtype)
    with torch.no_grad():
        model.fcos_head.bbox_pred.bias += 1.0  # revive the relu'd channels
    rng = np.random.RandomState(0)
    img = rng.randn(128, 128, 3).astype(np.float32) * 0.3 - 1.0
    gt_box = np.array([24.0, 40.0, 96.0, 104.0], np.float32)
    yy, xx = np.mgrid[0:64, 0:72].astype(np.float32)
    tex = np.stack([1.0 + xx / 36.0, 1.0 + yy / 32.0,
                    2.0 + np.sin(xx / 6.0) * 0.5], axis=-1)
    img[40:104, 24:96] = tex + rng.randn(64, 72, 3).astype(np.float32) * 0.1
    images = t(img[None])
    gt = GroundTruth(t(gt_box[None, None]), torch.ones((1, 1), dtype=torch.int32),
                     torch.ones((1, 1), dtype=torch.bool),
                     torch.ones((1, 1, 28, 28)))
    opt, sched = make_optimizer(model, 0.01, (100000,), warmup_iters=50,
                                clip_value=1.0, clip_type="norm")
    step = make_train_step(model, opt, sched)
    gen = torch.Generator().manual_seed(1)
    first = None
    ok = False
    for it in range(300):
        m = step(images, gt, generator=gen)
        first = float(m["total_loss"]) if first is None else first
        if it >= 49 and (it + 1) % 25 == 0:
            out = model.inference(images)
            scores = (out.scores[0] * out.valid[0]).numpy()
            k = int(scores.argmax())
            box = out.pred_boxes[0, k].numpy()
            ix0, iy0 = np.maximum(box[:2], gt_box[:2])
            ix1, iy1 = np.minimum(box[2:], gt_box[2:])
            inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
            union = np.prod(box[2:] - box[:2]) + np.prod(gt_box[2:]
                                                         - gt_box[:2]) - inter
            frac = float((out.pred_masks[0, k, 0] > 0.5).float().mean())
            if scores[k] > 0.25 and inter / union > 0.5 and frac > 0.5:
                ok = True
                break
    last = float(m["total_loss"])
    assert np.isfinite(last) and last < 0.6 * first, (first, last)
    assert ok, (scores[k], inter / union, frac)


@pytest.mark.slow
def test_train_step_bf16_drift_vs_f32():
    """tests/test_train.py:690 on the port: one identical step in f32 and
    bf16 gives close losses and parameter updates in the same
    direction."""
    from centermask2_tpu_torch.train import make_optimizer, make_train_step

    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    gt = GroundTruth(t(boxes), t(classes), torch.ones((B, G), dtype=torch.bool),
                     t((patches > 0.4).astype(np.float32)))
    draws = t(rng.rand(B, 10 + G).astype(np.float32))
    torch.manual_seed(0)
    state = CenterMask(**STEP_KW, dtype=torch.float32).state_dict()
    runs = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = CenterMask(**STEP_KW, dtype=dtype)
        model.load_state_dict(state)
        opt, sched = make_optimizer(model, 0.02, (100,), warmup_iters=0,
                                    warmup_factor=1.0)
        m = make_train_step(model, opt, sched)(t(images), gt, draws)
        delta = torch.cat([(p.detach() - state[n]).flatten()
                           for n, p in model.named_parameters()])
        runs[name] = ({k: float(v) for k, v in m.items()}, delta.double())
    (m32, d32), (m16, d16) = runs["f32"], runs["bf16"]
    for k in m32:
        assert np.isfinite(m16[k])
        assert abs(m16[k] - m32[k]) <= 0.05 * abs(m32[k]) + 0.02, (k, m32[k],
                                                                  m16[k])
    cos = float(d32 @ d16 / (d32.norm() * d16.norm()))
    assert cos > 0.9, cos
    assert 0.5 < float(d16.norm() / d32.norm()) < 2.0


def test_s2d_stem_backward_equals_the_plain_stem():
    """The stem alone, with grad enabled: the s2d stem's output and the
    gradients of the three stem convs equal the plain stem's (they were
    missing while the embedded kernels were built detached)."""
    from centermask2_tpu_torch.data.preprocess import stem_space_to_depth
    from centermask2_tpu_torch.models.backbones import VoVNet

    torch.manual_seed(1)
    plain = VoVNet("V-19-slim-eSE")
    s2d = VoVNet("V-19-slim-eSE", s2d_input=True)
    s2d.load_state_dict(plain.state_dict())
    x = np.random.RandomState(2).randn(2, 32, 40, 3).astype(np.float32)
    outs = []
    for m, im in ((plain, x), (s2d, stem_space_to_depth(x))):
        y = m.stem(t(im).permute(0, 3, 1, 2).contiguous())
        (y * y).sum().backward()
        outs.append(y.detach())
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-4)
    for name in ("stem_1", "stem_2", "stem_3"):
        a = getattr(plain, name).conv.weight.grad
        b = getattr(s2d, name).conv.weight.grad
        assert b is not None, f"{name}: no gradient through the s2d stem"
        np.testing.assert_allclose(b.numpy(), a.numpy(),
                                   atol=1e-4 * float(a.abs().max()))

