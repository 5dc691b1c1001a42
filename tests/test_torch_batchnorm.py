"""Port parity for BN, SyncBN and backbone recomputation: the port's
hand-written ``layers/blocks.py::BatchNorm`` against flax's
``nn.BatchNorm`` as the JAX package wraps it (``layers/blocks.py:159``),
a BN model's loss, gradients and updated running statistics against the
JAX model's with ``batch_stats`` mutable, the weights' ``batch_stats``
leaves, and ``TPU.REMAT_BACKBONE`` against the step without it. The
cross-rank half (SyncBN over two ranks) is ``test_torch_parallel.py``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.layers import blocks as J  # noqa: E402
from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models import GroundTruth as JaxGroundTruth  # noqa: E402
from centermask2_tpu_torch import layers as T  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import (  # noqa: E402
    load_jax_params, state_dict_from_jax)
from centermask2_tpu_torch.checkpoint.torch_io import (  # noqa: E402
    load_checkpoint, restore_train_state, save_checkpoint, train_state)
from centermask2_tpu_torch.models.meta import (  # noqa: E402
    CenterMask, GroundTruth)
from centermask2_tpu_torch.train import (  # noqa: E402
    make_optimizer, make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test processes on the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _bn_params(rng, c):
    return {"bn": {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
                   "bias": (0.1 * rng.randn(c)).astype(np.float32)}}


def _bn_stats(rng, c):
    return {"bn": {"mean": (0.3 * rng.randn(c)).astype(np.float32),
                   "var": (0.5 + rng.rand(c)).astype(np.float32)}}


@pytest.mark.parametrize("sync", [False, True], ids=["BN", "SyncBN"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_flax(training, dtype, sync):
    """Output, updated running statistics, output dtype (float32 under a
    bf16 input: flax promotes with its float32 parameters) and, in
    training, the gradients of the input, scale and bias. SyncBN in one
    process (no group) keeps its statistics local, as JAX outside a
    mapped axis does. Tolerance 1e-5 in f32; the bf16 input is the same
    bf16 values on both sides, so the f32 arithmetic agrees as closely."""
    rng = np.random.RandomState(0)
    C = 16
    x = (rng.randn(3, C, 5, 7) * 2 + 1).astype(np.float32)
    params, stats = _bn_params(rng, C), _bn_stats(rng, C)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jx = jnp.asarray(np.transpose(x, (0, 2, 3, 1))).astype(jdt)
    jmod = J.BatchNorm(C, axis_name="data" if sync else None)

    def f(p, xin):
        variables = {"params": p, "batch_stats": stats}
        if training:
            y, upd = jmod.apply(variables, xin, mutable=["batch_stats"])
            return y, upd["batch_stats"]
        return jmod.apply(variables, xin), stats

    if sync and training:  # the mapped axis of one device
        from jax.experimental.shard_map import shard_map
        from jax.sharding import Mesh, PartitionSpec as P
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        f = shard_map(f, mesh=mesh, in_specs=(P(), P("data")),
                      out_specs=(P("data"), P()), check_rep=False)
    want_y, want_stats = f(params, jx)

    mod = T.get_norm("SyncBN" if sync else "BN", C)
    load_jax_params(mod, params, batch_stats=stats)
    mod.train(training)
    xt = t(x).to(tdt).requires_grad_(True)
    y = mod(xt)
    assert y.dtype == torch.float32 and want_y.dtype == jnp.float32
    np.testing.assert_allclose(
        y.detach().numpy(), np.transpose(np.asarray(want_y), (0, 3, 1, 2)),
        rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(mod.bn, k).numpy(),
                                   np.asarray(want_stats["bn"][k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    if not training:
        return
    cot = rng.randn(*x.shape).astype(np.float32)
    (y * t(cot)).sum().backward()
    jcot = jnp.asarray(np.transpose(cot, (0, 2, 3, 1)))
    _, vjp = jax.vjp(lambda p, xin: f(p, xin)[0], params, jx)
    gp, gx = vjp(jcot)
    np.testing.assert_allclose(
        xt.grad.float().numpy(),
        np.transpose(np.asarray(gx, np.float32), (0, 3, 1, 2)),
        rtol=1e-4, atol=1e-4 if dtype == "float32" else 2e-2)
    np.testing.assert_allclose(mod.bn.weight.grad.numpy(),
                               np.asarray(gp["bn"]["scale"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mod.bn.bias.grad.numpy(),
                               np.asarray(gp["bn"]["bias"]),
                               rtol=1e-4, atol=1e-4)


def test_batch_stats_leaves_map_and_are_checked():
    """``bn/scale`` -> ``bn.weight``, the ``batch_stats`` ``bn/mean`` and
    ``bn/var`` -> the buffers; a running statistic outside a BatchNorm and
    a missing ``batch_stats`` are refused (strict)."""
    rng = np.random.RandomState(1)
    params = {"norm": _bn_params(rng, 4)}
    stats = {"norm": _bn_stats(rng, 4)}
    conv = {"conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32)}}
    got = state_dict_from_jax({**params, **conv}, batch_stats=stats)
    assert sorted(got) == ["conv.weight", "norm.bn.bias", "norm.bn.mean",
                           "norm.bn.var", "norm.bn.weight"]
    mod = T.ConvNormAct(2, 4, norm="BN")
    with pytest.raises(ValueError, match="no JAX leaf"):
        load_jax_params(mod, {**params, **conv})
    load_jax_params(mod, {**params, **conv}, batch_stats=stats)
    assert torch.equal(mod.norm.bn.var, t(stats["norm"]["bn"]["var"]))
    with pytest.raises(ValueError, match="outside"):
        state_dict_from_jax({"conv": {"mean": np.zeros(4, np.float32)}})


BN_KW = dict(conv_body="V-19-slim-eSE", num_classes=4, fpn_out_channels=64,
             mask_conv_dim=16, maskiou_conv_dim=16, pre_nms_topk_train=20,
             post_nms_topk_train=10, nms_candidates=20,
             batch_size_per_image=16, max_fg_proposals=4,
             backbone_norm="BN", mask_on=False, maskiou_on=False)


def _bn_batch(B=2, n_gt=2):
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


def _jax_bn_variables(jm, images, rng):
    """The JAX init's kernels (numpy draws of the same distribution leave
    some train-mode BN channels of this 64x64 net with a variance that
    E[x^2] - E[x]^2 cancels to rounding, whose gradient then differs
    between any two summation orders), with the norm parameters, the
    running statistics and the biases perturbed from ``rng``."""
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(images[:1]))

    def leaf(path, x):
        name = path[-1].key
        if name == "scale":
            return (1 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "mean":
            return (0.05 * rng.randn(*x.shape)).astype(np.float32)
        if name == "var":
            return (1 + 0.5 * rng.rand(*x.shape)).astype(np.float32)
        return np.asarray(x, np.float32)

    params = jax.tree_util.tree_map_with_path(
        leaf, jax.tree.map(np.asarray, variables["params"]))
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    stats = jax.tree_util.tree_map_with_path(
        leaf, jax.tree.map(np.asarray, variables["batch_stats"]))
    return params, stats


def test_bn_model_loss_gradients_and_stats_match_jax():
    """A V-19-slim model with MODEL.VOVNET.NORM BN: the JAX loss with
    ``batch_stats`` mutable (train-mode BN) against the port's loss in
    train mode: every loss within 1e-5 relative, every gradient within
    1e-4 of its tensor's largest, every updated running statistic within
    1e-5; then eval-mode inference from the updated statistics, slot by
    slot."""
    rng, images, boxes, classes, patches = _bn_batch()
    B, G = classes.shape
    jm = JaxCenterMask(**BN_KW, dtype=jnp.float32)
    params, stats = _jax_bn_variables(jm, images, rng)
    jgt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                         classes=jnp.asarray(classes),
                         valid=jnp.ones((B, G), bool),
                         mask_patches=jnp.asarray(patches))
    key = jax.random.PRNGKey(1)

    def f(p):
        losses, upd = jm.apply({"params": p, "batch_stats": stats},
                               jnp.asarray(images), jgt, key,
                               method=JaxCenterMask.loss,
                               mutable=["batch_stats"])
        return sum(losses.values()), (losses, upd["batch_stats"])

    (_, (want, want_stats)), jgrads = jax.jit(
        jax.value_and_grad(f, has_aux=True))(jax.tree.map(jnp.asarray,
                                                          params))
    port = CenterMask(**BN_KW, dtype=torch.float32)
    load_jax_params(port, params, batch_stats=stats)
    gt = GroundTruth(t(boxes), t(classes),
                     torch.ones((B, G), dtype=torch.bool), t(patches))
    port.train()
    got = port.loss(t(images), gt)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    sum(got.values()).backward()
    named = dict(port.named_parameters())
    for key_, (path, g) in state_dict_from_jax(
            jax.tree.map(np.asarray, jgrads)).items():
        np.testing.assert_allclose(named[key_].grad.numpy(), g.numpy(),
                                   atol=1e-4 * float(g.abs().max()),
                                   err_msg=key_)
    buffers = dict(port.named_buffers())
    n_stats = 0
    for key_, (_, v) in state_dict_from_jax(
            {}, batch_stats=jax.tree.map(np.asarray, want_stats)).items():
        np.testing.assert_allclose(buffers[key_].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=key_)
        n_stats += 1
    assert n_stats == 2 * sum(isinstance(m, T.BatchNorm)
                              for m in port.modules())

    port.eval()
    jout = jm.apply({"params": params, "batch_stats": want_stats},
                    jnp.asarray(images[:1]))
    out = port.inference(t(images[:1]))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    v = out.valid.numpy()
    np.testing.assert_allclose(out.scores.numpy()[v],
                               np.asarray(jout.scores)[v], rtol=1e-4,
                               atol=1e-5)


REMAT_KW = dict(conv_body="V-19-slim-eSE", num_classes=4,
                fpn_out_channels=64, mask_conv_dim=16, maskiou_conv_dim=16,
                pre_nms_topk_train=20, post_nms_topk_train=10,
                nms_candidates=20, batch_size_per_image=16,
                max_fg_proposals=4, dtype=torch.float32)


@pytest.mark.parametrize("norm", ["FrozenBN", "BN"])
def test_remat_backbone_same_gradients(norm):
    """TPU.REMAT_BACKBONE (``torch.utils.checkpoint`` over the backbone)
    keeps the loss and every gradient of the step without it (JAX
    ``tests/test_train.py:223``: loss to 1e-6, gradients at rtol 1e-5,
    atol 1e-6), and BN's running statistics move once: equal to the
    step's without recomputation; so does a train step of each, the
    parameters and statistics after it within 1e-5."""
    rng, images, boxes, classes, patches = _bn_batch()
    B, G = classes.shape
    gt = GroundTruth(t(boxes), t(classes),
                     torch.ones((B, G), dtype=torch.bool), t(patches))
    draws = t(rng.rand(B, 10 + G).astype(np.float32))
    torch.manual_seed(0)
    plain = CenterMask(backbone_norm=norm, **REMAT_KW)
    remat = CenterMask(backbone_norm=norm, remat_backbone=True, **REMAT_KW)
    remat.load_state_dict(plain.state_dict())
    fresh_state = {k: v.clone() for k, v in plain.state_dict().items()}
    runs = []
    for m in (plain, remat):
        with torch.no_grad():
            m.fcos_head.cls_logits.bias.zero_()
        m.train()
        total = sum(m.loss(t(images), gt, draws=draws).values())
        total.backward()
        runs.append(float(total))
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)
    grads = dict(remat.named_parameters())
    for n, p in plain.named_parameters():
        np.testing.assert_allclose(grads[n].grad.numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    bufs = dict(remat.named_buffers())
    for n, b in plain.named_buffers():
        assert torch.equal(bufs[n], b), n
    if norm == "BN":
        fresh = CenterMask(backbone_norm=norm, **REMAT_KW)
        moved = fresh.backbone.stem_1.norm.bn.mean
        assert not torch.equal(plain.backbone.stem_1.norm.bn.mean, moved)
    # the train step on eval-mode models: it trains BN through the
    # backward, where the recomputation runs
    for m in (plain, remat):
        m.load_state_dict(fresh_state)
        m.eval()
        opt, sched = make_optimizer(m, 0.01, (100,), warmup_iters=0)
        make_train_step(m, opt, sched, capture=False)(t(images), gt, draws)
        assert not m.training
    bufs = dict(remat.state_dict())
    for n, v in plain.state_dict().items():
        np.testing.assert_allclose(bufs[n].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_bn_train_state_round_trip(tmp_path):
    """The BN running statistics (the JAX TrainState's ``model_state``)
    are in the train state: two eager steps, a checkpoint, a restore into
    a fresh model, optimizer and schedule, and the next step equals the
    step of the run that was not stopped, statistics included."""
    rng, images, boxes, classes, patches = _bn_batch()
    B, G = classes.shape
    gt = GroundTruth(t(boxes), t(classes),
                     torch.ones((B, G), dtype=torch.bool), t(patches))
    draws = t(rng.rand(B, 10 + G).astype(np.float32))

    def trainer():
        torch.manual_seed(0)
        m = CenterMask(backbone_norm="BN", **REMAT_KW).eval()
        with torch.no_grad():
            m.fcos_head.cls_logits.bias.zero_()
        opt, sched = make_optimizer(m, 0.01, (100,), warmup_iters=0)
        return m, opt, sched, make_train_step(m, opt, sched, capture=False)

    m, opt, sched, step = trainer()
    for _ in range(2):
        step(t(images), gt, draws)
    path = save_checkpoint(str(tmp_path), train_state(m, opt, sched, 2), 2)
    want = {k: float(v) for k, v in step(t(images), gt, draws).items()}
    m2, opt2, sched2, step2 = trainer()
    assert restore_train_state(load_checkpoint(path), m2, opt2, sched2) == 2
    got = {k: float(v) for k, v in step2(t(images), gt, draws).items()}
    assert got == want
    b1, b2 = dict(m.named_buffers()), dict(m2.named_buffers())
    assert any(n.endswith("bn.var") for n in b1)
    for n in b1:
        assert torch.equal(b1[n], b2[n]), n
    assert not m.training and not m2.training  # the step puts the mode back
