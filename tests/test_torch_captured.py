"""The captured programs' buffer handling on the CPU, rehearsed with a
fake graph class (a CUDA graph records on capture and reruns its kernels
on replay; ``FakeGraphs`` runs the Python instead, and undoes the
capture's run): ``CapturedInference`` (one graph per input signature,
static outputs rewritten by the next replay), ``compile_inference``,
``evaluate_dataset`` with and without ``fn``, and the captured train
step: equal to the eager step bit for bit, near the step it replaced
(its clip by value, then ``torch.optim.SGD`` with ``LambdaLR``: losses
to 1e-6 relative, parameters to 1e-5 relative and 1e-6 absolute, the
optax test's tolerance) and to the JAX package's step with FREEZE_AT 2
and a global-norm clip that binds (losses 1e-5 relative; the two updates within
5e-4 of each tensor's largest: the gradients' 1e-4 of
tests/test_torch_train.py for the first, and the second's gradients are
taken at parameters the first left that far apart; plus two f32
spacings of the parameter), and a restore that writes into the tensors
the graph reads.
"""

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
optax = pytest.importorskip("optax")

from centermask2_tpu_torch.export import (CapturedInference,  # noqa: E402
                                          compile_inference)
from centermask2_tpu_torch.models.meta import CenterMask, GroundTruth  # noqa: E402
from centermask2_tpu_torch.ops import _kernels  # noqa: E402
from centermask2_tpu_torch.train import (CapturedTrainStep,  # noqa: E402
                                         make_optimizer, make_train_step,
                                         trainer)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeGraph:
    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        """Rerun the recorded function into the capture's outputs. A
        replay launches its kernels without the launch functions, so their
        counts are put back as they were."""
        self.replays += 1
        counts = _kernels.launch_counts()
        for o, n in zip(pytree.tree_leaves(self.out),
                        pytree.tree_leaves(self.fn())):
            if o is not None:  # an empty slot (pred_keypoints without
                o.copy_(n)  # the keypoint head)
        (_kernels.nms_launches, _kernels.roi_align_launches,
         _kernels.roi_align_backward_launches) = (
            counts["nms"], counts["roi_align"], counts["roi_align_backward"])


class FakeGraphs:
    """``CudaGraphs``' two methods on the CPU. A capture records without
    running, so ``capture`` runs ``fn`` for its outputs and then writes
    back every tensor of ``state()`` (parameters, momentum, the
    schedule's count) as it was."""

    def __init__(self, state=lambda: ()):
        self.state = state
        self.graphs = []

    def warm_up(self, fn, n):
        out = None
        for _ in range(n):
            out = fn()
        return out

    def capture(self, fn):
        saved = [t.detach().clone() for t in self.state()]
        out = fn()
        with torch.no_grad():
            for t, s in zip(self.state(), saved):
                t.copy_(s)
        self.graphs.append(FakeGraph(fn, out))
        return self.graphs[-1], out


SERVE = dict(conv_body="V-19-slim-eSE", num_classes=3, fpn_out_channels=32,
             mask_conv_dim=8, maskiou_conv_dim=8, post_nms_topk_test=6,
             pre_nms_topk_test=40, nms_candidates=40)


@pytest.fixture(scope="module")
def s2d_model():
    torch.manual_seed(0)
    m = CenterMask(**SERVE, s2d_input=True, dtype=torch.float32).eval()
    with torch.no_grad():
        m.fcos_head.cls_logits.bias.zero_()
    return m


def _u8(seed, h, w):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (1, h // 4 + 1, w // 4 + 1, 48)).astype(np.uint8))


def test_captured_inference_graph_per_signature(s2d_model):
    """Three signatures (a 32x64 tight pack padded back to 64x64, the
    same pack in tight compute, a 64x64 pack), three graphs; each call
    equals the eager request; a call returns the same static outputs,
    which the next replay of that graph rewrites."""
    graphs = FakeGraphs()
    prog = CapturedInference(s2d_model, graphs=graphs)
    hw = torch.tensor([[30, 61]], dtype=torch.int32)
    calls = [(_u8(1, 32, 64), hw, (64, 64)), (_u8(1, 32, 64), hw, None),
             (_u8(2, 64, 64), hw, None), (_u8(3, 32, 64), hw, (64, 64))]
    outs = []
    for x, h, canvas in calls:
        got = prog(x, None, h, canvas)
        want = s2d_model.inference(x, None, h, canvas)
        assert got.pred_keypoints is None and want.pred_keypoints is None
        assert all(torch.equal(a, b) for a, b in zip(got[:7], want[:7]))
        assert want.valid.any()
        outs.append((got, [t.clone() for t in got[:7]]))
    assert len(prog) == 3 and len(graphs.graphs) == 3
    assert [g.replays for g in graphs.graphs] == [2, 1, 1]
    # the fourth call replayed the first graph into the same buffers
    assert outs[3][0] is outs[0][0]
    assert not all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[3][1]))


def test_captured_inference_needs_cuda(s2d_model):
    with pytest.raises(ValueError, match="CUDA"):
        CapturedInference(s2d_model)


def test_compile_inference(s2d_model):
    prog, cost = compile_inference(s2d_model, (1, 17, 17, 48),
                                   input_dtype=torch.uint8,
                                   canvas_hw=(64, 64), graphs=FakeGraphs())
    assert len(prog) == 1 and cost["flops"] > 1e7


def test_eval_loop_with_and_without_fn(tmp_path):
    """``evaluate_dataset``'s default (eager on the CPU), ``fn=
    model.inference`` and ``fn=`` a captured program give the same
    predictions and metrics, in tight compute (one graph per canvas).
    Each request is postprocessed before the next: a fake replay rewrites
    its outputs on the host at once, where a CUDA replay is ordered
    behind the copy of the previous outputs."""
    from test_torch_evaluation import (LOOP, SMALL, _assert_metrics_equal,
                                       _png_dataset)

    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset

    ann = _png_dataset(tmp_path, np.random.RandomState(3))
    torch.manual_seed(1)
    model = CenterMask(**SMALL, dtype=torch.float32).eval()
    common = dict(ann=str(ann), image_root=str(tmp_path / "images"),
                  tight_compute=True, pipeline_depth=0, **LOOP)
    prog = CapturedInference(model, graphs=FakeGraphs())
    runs = [evaluate_dataset(model, fn=fn, **common)
            for fn in (None, model.inference, prog)]
    assert len(prog) == 3  # the three canvases of the three images
    (res, _, ev), *others = runs
    assert len(ev.predictions) > 3
    for r, _, e in others:
        assert e.predictions == ev.predictions
        _assert_metrics_equal(r, res)


# ------------------------------------------------------------ train step
def _state(model, opt, sched):
    return lambda: [*model.parameters(),
                    *(st["momentum_buffer"] for st in opt.state.values()),
                    sched.count]


def _tiny_trainer(params, **opt_kw):
    from test_torch_train import STEP_KW

    from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params

    model = CenterMask(**STEP_KW, dtype=torch.float32)
    load_jax_params(model, params)
    opt, sched = make_optimizer(model, 0.02, (2,), warmup_iters=1,
                                warmup_factor=0.5, **opt_kw)
    return model, opt, sched


@pytest.fixture
def one_warm_up(monkeypatch):
    """One eager step before the capture, so that two steps reach a
    replay (the JAX comparisons take two)."""
    monkeypatch.setattr(trainer, "WARMUP_STEPS", 1)


@pytest.fixture(scope="module")
def step_case():
    """Two batches, their draws, and perturbed JAX parameters."""
    from test_torch_train import STEP_KW, _perturbed_params, _step_batch

    from centermask2_tpu.models import CenterMask as JaxCenterMask

    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    jm = JaxCenterMask(**STEP_KW, dtype=jnp.float32)
    params = _perturbed_params(jm, images, rng)
    batches = []
    for i in range(2):
        shift = np.float32(2.0 * i)
        batches.append((images + 3.0 * i, boxes + shift, classes, patches))
    keys = [jax.random.PRNGKey(11 + i) for i in range(2)]
    draws = [np.stack([np.asarray(jax.random.uniform(k, (10 + G,)))
                       for k in jax.random.split(key, B)]) for key in keys]
    return jm, params, batches, keys, draws


def _port_batch(batch):
    images, boxes, classes, patches = batch
    B, G = classes.shape
    return torch.from_numpy(images.copy()), GroundTruth(
        torch.from_numpy(boxes.copy()), torch.from_numpy(classes.copy()),
        torch.ones((B, G), dtype=torch.bool), torch.from_numpy(patches.copy()))


def _run(step, batches, draws):
    return [{k: float(v) for k, v in step(*_port_batch(b),
                                          torch.from_numpy(d)).items()}
            for b, d in zip(batches, draws)]


def test_captured_step_equals_eager_and_the_sgd_step(step_case, one_warm_up):
    """Two steps through the captured step (one warm-up, then the graph)
    against the eager step (bit-equal: the same code); the eager step's
    first update against the step it replaced, ``torch.optim.SGD`` with a
    host-float rate from ``LambdaLR`` (a second step would compare
    gradients taken at parameters a few ulps apart)."""
    from centermask2_tpu_torch.train.optimizer import param_groups

    _, params, batches, _, draws = step_case
    runs = {}
    for name in ("eager", "captured"):
        model, opt, sched = _tiny_trainer(params, clip_value=1.0)
        graphs = FakeGraphs(_state(model, opt, sched))
        step = make_train_step(model, opt, sched, capture=name == "captured",
                               graphs=graphs)
        runs[name] = (_run(step, batches, draws),
                      {n: p.detach().clone()
                       for n, p in model.named_parameters()})
        if name == "captured":
            assert isinstance(step, CapturedTrainStep)
            assert [g.replays for g in graphs.graphs] == [1]
    assert runs["captured"][0] == runs["eager"][0]
    for n, p in runs["eager"][1].items():
        assert torch.equal(runs["captured"][1][n], p), n

    # the replaced step: its clip by value, then torch.optim.SGD
    model, opt, sched = _tiny_trainer(params, clip_value=1.0)
    first = _run(make_train_step(model, opt, sched, capture=False),
                 batches[:1], draws[:1])
    eager1 = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, _, _ = _tiny_trainer(params)
    opt = torch.optim.SGD(param_groups(model, 1e-4, 0.0, 0), lr=0.02,
                          momentum=0.9)
    # the rate of update c over the base rate: warm-up from 0.5 over one
    # update, 0.1 from update 2 on
    lam = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: (0.5 * (1 - min(c, 1)) + min(c, 1)) * 0.1 ** (c >= 2))
    sgd = []
    for b, d in zip(batches[:1], draws[:1]):
        opt.zero_grad(set_to_none=True)
        images, gt = _port_batch(b)
        losses = model.loss(images, gt, draws=torch.from_numpy(d))
        total = sum(losses.values())
        total.backward()
        for p in model.parameters():
            if p.grad is not None:
                p.grad.clamp_(-1.0, 1.0)
        opt.step()
        lam.step()
        sgd.append({**{k: float(v.detach()) for k, v in losses.items()},
                    "total_loss": float(total.detach())})
    assert first[0] == runs["eager"][0][0]
    for k in sgd[0]:
        np.testing.assert_allclose(first[0][k], sgd[0][k], rtol=1e-6,
                                   err_msg=k)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(eager1[n].numpy(),
                                   p.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_captured_step_matches_jax_with_frozen_leaves_in_the_clip(
        step_case, one_warm_up):
    """Two steps against the JAX package's jitted loss, gradient and optax
    chain with FREEZE_AT 2 and a global-norm clip that binds: the
    norm counts the FrozenBN leaves' and the frozen stages' gradients, as
    optax's does, and none of them moves. The second step is the captured
    one."""
    from centermask2_tpu.models import CenterMask as JaxCenterMask
    from centermask2_tpu.models import GroundTruth as JaxGroundTruth
    from centermask2_tpu.train.optimizer import make_optimizer as jax_opt
    from centermask2_tpu_torch.checkpoint.from_jax import state_dict_from_jax

    jm, params, batches, keys, draws = step_case

    def jloss(p, b, key):
        images, boxes, classes, patches = b
        gt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                            classes=jnp.asarray(classes),
                            valid=jnp.ones(classes.shape, bool),
                            mask_patches=jnp.asarray(patches))
        losses = jm.apply({"params": p}, jnp.asarray(images), gt, key,
                          method=JaxCenterMask.loss)
        return sum(losses.values()), losses

    grad_fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    jp = jax.tree.map(jnp.asarray, params)
    # a clip at half the first step's global norm binds without shrinking
    # the update to the parameters' last bits
    clip = 0.5 * float(optax.global_norm(grad_fn(jp, batches[0], keys[0])[1]))
    kw = dict(warmup_iters=1, warmup_factor=0.5, clip_value=clip,
              clip_type="norm", freeze_at=2)
    jchain = jax_opt(0.02, (2,), **kw)
    jstate = jchain.init(jp)
    want, norms = [], []
    for b, key in zip(batches, keys):
        (total, losses), g = grad_fn(jp, b, key)
        norms.append(float(optax.global_norm(g)))
        updates, jstate = jchain.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        want.append({**{k: float(v) for k, v in losses.items()},
                     "total_loss": float(total)})
    assert min(norms) > clip  # the clip binds

    model, opt, sched = _tiny_trainer(params, clip_value=clip,
                                      clip_type="norm", freeze_at=2)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    step = make_train_step(model, opt, sched, capture=True,
                           graphs=FakeGraphs(_state(model, opt, sched)))
    got = _run(step, batches, draws)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    after = model.state_dict()
    frozen = 0
    for name, (path, value) in state_dict_from_jax(
            jax.tree.map(np.asarray, jp)).items():
        delta = (after[name] - init[name]).numpy()
        want_delta = value.numpy() - init[name].numpy()
        if not np.abs(want_delta).max() > 0:
            frozen += 1
            assert not np.abs(delta).max() > 0, name
            continue
        # and two f32 spacings of the parameter, for the rounding of the
        # parameter the update lands in
        tol = 5e-4 * np.abs(want_delta).max() \
            + 2 * np.spacing(np.abs(value.numpy()))
        assert (np.abs(delta - want_delta) <= tol).all(), name
    assert frozen > 0 and len(opt.counted) > 0


def test_restore_writes_into_the_captured_tensors(step_case, tmp_path,
                                                  one_warm_up):
    """``restore_train_state`` on the objects of a captured step keeps
    every tensor the graph reads (parameters, momentum buffers, the
    schedule's count) and writes the checkpoint into them: the replay
    after it repeats the step after the save. A checkpoint in the earlier
    schema (``torch.optim.SGD`` and ``LambdaLR`` state) restores too."""
    from centermask2_tpu_torch.checkpoint.torch_io import (
        load_checkpoint, restore_train_state, save_checkpoint, train_state)
    from centermask2_tpu_torch.train.optimizer import param_groups

    _, params, batches, _, draws = step_case
    model, opt, sched = _tiny_trainer(params, clip_value=1.0)
    step = make_train_step(model, opt, sched, capture=True,
                           graphs=FakeGraphs(_state(model, opt, sched)))
    _run(step, batches, draws)  # warm-up, capture and replay
    path = save_checkpoint(str(tmp_path), train_state(model, opt, sched, 2),
                           2)
    live = [id(t) for t in _state(model, opt, sched)()]
    m3 = _run(step, batches[:1], draws[:1])
    p3 = [p.detach().clone() for p in model.parameters()]
    assert restore_train_state(load_checkpoint(path), model, opt, sched) == 2
    assert [id(t) for t in _state(model, opt, sched)()] == live
    assert sched.last_epoch == 2
    assert _run(step, batches[:1], draws[:1]) == m3
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), p3))

    # the earlier schema
    old, _, _ = _tiny_trainer(params)
    sgd = torch.optim.SGD(param_groups(old, 1e-4, 0.0, 0), lr=0.02,
                          momentum=0.9)
    lam = torch.optim.lr_scheduler.LambdaLR(sgd, lambda c: 1.0)
    images, gt = _port_batch(batches[0])
    sum(old.loss(images, gt, draws=torch.from_numpy(draws[0]))
        .values()).backward()
    sgd.step()
    lam.step()
    path = save_checkpoint(str(tmp_path), train_state(old, sgd, lam, 1), 1)
    model, opt, sched = _tiny_trainer(params)
    assert restore_train_state(load_checkpoint(path), model, opt, sched) == 1
    assert sched.last_epoch == 1
    bufs = [opt.state[p]["momentum_buffer"] for p in model.parameters()
            if p in opt.state]
    want = [sgd.state[p]["momentum_buffer"] for p in old.parameters()
            if p in sgd.state]
    assert len(bufs) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(bufs, want))


def test_captured_step_reads_the_capturing_call_s_tensors(step_case):
    """``WARMUP_STEPS`` eager steps, then the capture: the tensors of the
    capturing call are the graph's inputs (no second set of buffers).
    Called again with them, as ``train_loop`` calls it with its reused
    device buffers, the step copies nothing; called with other tensors,
    it copies them in, and without draws it draws into the captured
    call's draws from the generator. Each step equals the eager step on
    the same batch, draws and generator (bit for bit: the same code)."""
    _, params, batches, _, draws = step_case
    n = trainer.WARMUP_STEPS
    runs = {}
    for name in ("eager", "captured"):
        model, opt, sched = _tiny_trainer(params, clip_value=1.0)
        graphs = FakeGraphs(_state(model, opt, sched))
        step = make_train_step(model, opt, sched, capture=name == "captured",
                               graphs=graphs)
        gen = torch.Generator().manual_seed(5)
        fixed = _port_batch(batches[0])  # the buffers of the capturing call
        got = [step(*_port_batch(batches[i % 2]), torch.from_numpy(
            draws[i % 2])) for i in range(n)]
        got.append(step(*fixed, generator=gen))  # the capture
        if name == "captured":
            captured_draws = step.static[-1]
            assert step.static[0] is fixed[0]
            assert all(a is b for a, b in zip(step.static[1:-1], fixed[1]))
            assert step.calls == n and len(graphs.graphs) == 1
        got.append(step(*fixed, generator=gen))  # the same buffers
        other = _port_batch(batches[1])
        got.append(step(*other, generator=gen))  # copied into them
        if name == "captured":
            assert torch.equal(fixed[0], other[0])
            assert step.static[-1] is captured_draws
            assert [g.replays for g in graphs.graphs] == [3]
        runs[name] = ([{k: float(v) for k, v in m.items()} for m in got],
                      [p.detach().clone() for p in model.parameters()])
    assert runs["captured"][0] == runs["eager"][0]
    assert all(np.isfinite(v) for m in runs["eager"][0] for v in m.values())
    assert all(torch.equal(a, b) for a, b in zip(runs["captured"][1],
                                                 runs["eager"][1]))
