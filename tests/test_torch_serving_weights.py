"""The captured serving program's prepared weights
(``layers/prepared.py``) on the CPU, the graphs rehearsed by
``tests/test_torch_captured.py::FakeGraphs``.

The prepared path (weights cast once, FrozenBN folded into its conv)
against the plain chain, module by module: f32 within 1e-5 of the
output's largest value (the same sums, the scale applied to the weight
instead of the output); bf16 within ``BF16_TOL`` of the f32 output's
largest value, and no further from it than twice the plain bf16 chain
(which rounds more often). Then the captured program: weights loaded
after a capture reach the next replay in place, the ``state_dict`` keys
are unchanged, a grad-enabled loss never reads the store, and the
counters read the FrozenBN count of R-101 and V-39.
"""

import math

import numpy as np
import pytest
import torch

from centermask2_tpu_torch.export import CapturedInference
from centermask2_tpu_torch.layers import (Conv2d, ConvNormAct,
                                          ConvTranspose2d, FrozenBatchNorm,
                                          Linear, prepared, reset_parameters)
from centermask2_tpu_torch.layers.prepared import PreparedWeights
from centermask2_tpu_torch.models.backbones.fpn import FPN
from centermask2_tpu_torch.models.backbones.resnet import BottleneckBlock
from centermask2_tpu_torch.models.backbones.vovnet import OSAModule, VoVNet
from centermask2_tpu_torch.models.fcos.head import FCOSHead
from centermask2_tpu_torch.models.meta import CenterMask, GroundTruth
from centermask2_tpu_torch.models.roi.mask_head import \
    SpatialAttentionMaskHead
from centermask2_tpu_torch.ops import group_norm as gn_mod
from centermask2_tpu_torch.utils import tracing

from test_torch_captured import SERVE, FakeGraphs, _u8

BF16_TOL = 2.0 ** -5  # of the f32 output's largest value
F32_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other CPU test files of the port."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(module, seed: int):
    """Weights at a scale that keeps each layer's output near its
    input's, and FrozenBN statistics off their initial 1 and 0 (those
    would fold exactly); returns ``module``."""
    g = torch.Generator().manual_seed(seed)
    reset_parameters(module, g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / math.sqrt(fan_in))
            elif name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in module.modules():
            if isinstance(m, FrozenBatchNorm):
                n = m.frozen_scale.shape[0]
                m.frozen_scale.copy_(torch.rand(n, generator=g) + 0.5)
                m.frozen_bias.copy_(torch.randn(n, generator=g) * 0.1)
    return module


def _flat(out):
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in _flat(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _run(module, args, store=None):
    with torch.no_grad():
        if store is None:
            return _flat(module(*args))
        store.refresh()
        with store.serving():
            return _flat(module(*args))


def _maps(seed, shapes, channels_last=False):
    g = torch.Generator().manual_seed(seed)
    xs = [torch.randn(s, generator=g) for s in shapes]
    if channels_last:
        xs = [x.contiguous(memory_format=torch.channels_last) for x in xs]
    return xs


def _conv_norm_act(use_act):
    return lambda dt: ConvNormAct(8, 16, use_act=use_act, dtype=dt)


# name -> (the module in a compute dtype, its inputs, FrozenBNs folded)
CASES = {
    "conv": (lambda dt: Conv2d(8, 16, dtype=dt),
             lambda: _maps(1, [(2, 8, 9, 11)]), 0),
    "conv_channels_last": (lambda dt: Conv2d(8, 16, dtype=dt),
                           lambda: _maps(1, [(2, 8, 9, 11)], True), 0),
    "deconv": (lambda dt: ConvTranspose2d(8, 16, dtype=dt),
               lambda: _maps(8, [(2, 8, 7, 5)]), 0),
    "linear": (lambda dt: Linear(24, 10, dtype=dt),
               lambda: _maps(9, [(3, 24)]), 0),
    "conv_norm_act": (_conv_norm_act(True), lambda: _maps(1, [(2, 8, 9, 11)]),
                      1),
    "conv_norm_no_act": (_conv_norm_act(False),
                         lambda: _maps(1, [(2, 8, 9, 11)]), 1),
    "bottleneck_projection": (
        lambda dt: BottleneckBlock(16, 32, 8, stride=2, dtype=dt),
        lambda: _maps(2, [(1, 16, 12, 10)]), 4),
    "osa_ese": (lambda dt: OSAModule(16, 8, 24, 3, dtype=dt),
                lambda: _maps(3, [(1, 16, 10, 12)]), 4),
    "s2d_stem": (lambda dt: VoVNet("V-19-slim-eSE", s2d_input=True,
                                   out_features=("stage2",), dtype=dt),
                 lambda: _maps(4, [(1, 48, 9, 11)]), 3),
    "fpn": (lambda dt: FPN([16, 24, 32], [8, 16, 32], 16, dtype=dt),
            lambda: [_maps(5, [(1, 16, 16, 20), (1, 24, 8, 10),
                               (1, 32, 4, 5)])], 0),
    "mask_head": (lambda dt: SpatialAttentionMaskHead(16, 3, 8, dtype=dt),
                  lambda: _maps(7, [(3, 16, 14, 14)]), 0),
}


def _forward(name, module, args):
    if name == "s2d_stem":  # the stem alone, its output in ``forward``'s
        return lambda *a: module.stem(*a)
    return module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_prepared_module_equals_plain_chain(name, dtype):
    """Each module of the served path on its prepared weights against
    its plain chain (the module docstring's tolerances); a folded
    FrozenBN is never called. Each stored tensor is bit-equal to what the
    module's ``prepare_weights`` returns, in its strides, and owns its
    storage: none shares a parameter's or a buffer's, although the plain
    call's f32 casts are the parameters themselves. With no FrozenBN
    folded the prepared weights are the plain chain's casts, and the
    outputs equal the plain chain's bit for bit."""
    build, inputs, folded = CASES[name]
    args = [x.to(dtype) if isinstance(x, torch.Tensor) else
            [t.to(dtype) for t in x] for x in inputs()]
    m32 = _draw(build(torch.float32), 0)
    m = build(dtype)
    m.load_state_dict(m32.state_dict())
    store = PreparedWeights(m)
    norms = [0]
    hooks = [n.register_forward_hook(lambda *a: norms.__setitem__(
        0, norms[0] + 1)) for n in m.modules()
        if isinstance(n, FrozenBatchNorm)]
    got = _run(_forward(name, m, args), args, store)
    assert norms[0] == 0 and store.folded == folded
    want = _run(_forward(name, m, args), args)
    for h in hooks:
        h.remove()
    owned = {t.untyped_storage().data_ptr()
             for t in [*m.parameters(), *m.buffers()]}
    for (mod, fmt), entry in store.entries.items():
        with torch.no_grad():
            plain = mod.prepare_weights(fmt)
        for e, p in zip(entry, plain, strict=True):
            assert (e is None) == (p is None)
            if e is not None:
                assert torch.equal(e, p) and e.stride() == p.stride()
                assert e.untyped_storage().data_ptr() not in owned
    if not folded:
        for g_, w_ in zip(got, want, strict=True):
            assert torch.equal(g_, w_)
    ref = _run(_forward(name, m32, args), [a.float() if isinstance(
        a, torch.Tensor) else [t.float() for t in a] for a in args])
    for g_, w_, r_ in zip(got, want, ref, strict=True):
        assert g_.dtype == w_.dtype
        scale = float(r_.abs().max())
        if dtype == torch.float32:
            np.testing.assert_allclose(g_.numpy(), w_.numpy(), rtol=0,
                                       atol=F32_TOL * scale)
            continue
        e_prep = float((g_.float() - r_).abs().max())
        e_plain = float((w_.float() - r_).abs().max())
        assert e_prep <= BF16_TOL * scale, (e_prep, scale)
        assert e_prep <= 2 * e_plain + 1e-6 * scale, (e_prep, e_plain)


@pytest.fixture
def widen(monkeypatch):
    """The FCOS head's channels-last path on the CPU (the rule widened,
    as ``tests/test_torch_group_norm.py`` does)."""
    monkeypatch.setattr(gn_mod, "fused_path",
                        lambda x: not torch.is_grad_enabled())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_fcos_head_reads_channels_last_weights(widen, dtype):
    """The FCOS head on its channels-last path: every tower conv and
    predictor takes a channels-last prepared weight, made once per
    format; the head has no FrozenBN, so its prepared weights are the
    plain chain's casts and the outputs equal the plain head's bit for
    bit."""
    m32 = _draw(FCOSHead(num_classes=4, in_channels=32,
                         dtype=torch.float32), 6)
    m = FCOSHead(num_classes=4, in_channels=32, dtype=dtype)
    m.load_state_dict(m32.state_dict())
    shapes = [(1, 32, 16, 20), (1, 32, 8, 10), (1, 32, 4, 5), (1, 32, 2, 3),
              (1, 32, 1, 2)]
    xs = [x.to(dtype) for x in _maps(6, shapes)]
    store = PreparedWeights(m)
    got = _run(m, [xs], store)
    assert len(store.entries) == 8 + 3 and all(
        nhwc and e[0].is_contiguous(memory_format=torch.channels_last)
        and e[0].dtype == dtype for (_, nhwc), e in store.entries.items())
    assert store.folded == 0
    want = _run(m, [xs])
    for g_, w_ in zip(got, want, strict=True):
        assert g_.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(g_, w_)


def _served_model(seed=0):
    torch.manual_seed(seed)
    m = CenterMask(**SERVE, s2d_input=True, dtype=torch.float32).eval()
    _draw(m, seed)
    with torch.no_grad():
        m.fcos_head.cls_logits.bias.zero_()
    return m


def _request():
    return _u8(1, 64, 64), torch.tensor([[60, 61]], dtype=torch.int32)


def _prepared_sets():
    return tracing.counter("weights_prepared") or 0.0


def test_weights_loaded_after_capture_reach_the_next_replay():
    """A ``load_state_dict`` after the capture: the next call refreshes the
    prepared tensors in place (no new graph, the same storage) and
    replays outputs equal to a fresh program's on the new weights; the
    program prepared two sets of weights."""
    model = _served_model(0)
    other = _served_model(1).state_dict()
    x, hw = _request()
    n0 = _prepared_sets()
    prog = CapturedInference(model, graphs=FakeGraphs())
    first = prog(x, None, hw).scores.clone()
    ptrs = [t.data_ptr() for e in prog.weights.entries.values() for t in e
            if t is not None]
    model.load_state_dict(other)
    got = prog(x, None, hw)
    assert len(prog) == 1
    assert [t.data_ptr() for e in prog.weights.entries.values() for t in e
            if t is not None] == ptrs
    fresh = CapturedInference(_served_model(1), graphs=FakeGraphs())
    want = fresh(x, None, hw)
    for f, a, b in zip(got._fields, got, want):
        assert (a is None and b is None) or torch.equal(a, b), f
    assert not torch.equal(got.scores, first)
    assert _prepared_sets() - n0 == 3  # two for prog, one for fresh
    prog(x, None, hw)  # nothing moved since: no new set
    assert _prepared_sets() - n0 == 3


def test_state_dict_keys_unchanged_by_preparing():
    """The prepared tensors live in the program's store: the model's
    ``state_dict`` keys, parameters and buffers are those before."""
    model = _served_model(0)
    keys = list(model.state_dict())
    n_params = len(list(model.parameters()))
    n_bufs = len(list(model.buffers()))
    prog = CapturedInference(model, graphs=FakeGraphs())
    x, hw = _request()
    prog(x, None, hw)
    assert prog.weights.entries
    assert list(model.state_dict()) == keys
    assert len(list(model.parameters())) == n_params
    assert len(list(model.buffers())) == n_bufs


def test_grad_enabled_loss_never_reads_the_store():
    """``CenterMask.loss`` with autograd on, inside the store's context,
    runs the plain chain: no entry is made and every trained parameter
    gets a gradient, the s2d stem's among them (as
    ``tests/test_torch_train.py::test_s2d_stem_gradients_equal_the_plain_stem``
    checks against the plain stem)."""
    kw = dict(conv_body="V-19-slim-eSE", num_classes=3, fpn_out_channels=32,
              mask_conv_dim=8, maskiou_conv_dim=8, pre_nms_topk_train=20,
              post_nms_topk_train=10, nms_candidates=20,
              batch_size_per_image=16, max_fg_proposals=4,
              dtype=torch.float32)
    torch.manual_seed(0)
    model = CenterMask(s2d_input=True, **kw)
    _draw(model, 0)
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    from centermask2_tpu_torch.data.preprocess import stem_space_to_depth

    rng = np.random.RandomState(0)
    x = torch.from_numpy(stem_space_to_depth(
        rng.randn(1, 64, 64, 3).astype(np.float32) * 20))
    gt = GroundTruth(boxes=torch.tensor([[[8.0, 8.0, 40.0, 40.0]]]),
                     classes=torch.zeros((1, 1), dtype=torch.int32),
                     valid=torch.ones((1, 1), dtype=torch.bool),
                     mask_patches=torch.full((1, 1, 8, 8), 0.7))
    draws = torch.from_numpy(rng.rand(1, 11).astype(np.float32))
    store = PreparedWeights(model)
    store.refresh()
    with store.serving():
        assert prepared.active() is None  # autograd on
        total = sum(model.loss(x, gt, draws=draws).values())
    total.backward()
    assert not store.entries
    assert model.backbone.stem_1.conv.weight.grad.abs().max() > 0
    assert model.backbone.OSA5_1.concat.conv.weight.grad.abs().max() > 0
    assert model.fcos_head.cls_logits.weight.grad.abs().max() > 0


def _r101():
    return CenterMask(backbone_type="resnet", resnet_depth=101,
                      resnet_stem_out_channels=8, resnet_res2_out_channels=16,
                      resnet_width_per_group=4, fpn_in_features=(
                          "res3", "res4", "res5"), s2d_input=True,
                      num_classes=3, fpn_out_channels=32, mask_conv_dim=8,
                      maskiou_conv_dim=8, post_nms_topk_test=6,
                      pre_nms_topk_test=40, nms_candidates=40,
                      dtype=torch.float32).eval()


def _v39():
    return CenterMask(conv_body="V-39-eSE", s2d_input=True, num_classes=3,
                      fpn_out_channels=32, mask_conv_dim=8,
                      maskiou_conv_dim=8, post_nms_topk_test=6,
                      pre_nms_topk_test=40, nms_candidates=40,
                      dtype=torch.float32).eval()


@pytest.mark.parametrize("build,folded", [(_r101, 104), (_v39, 39)],
                         ids=["R-101", "V-39"])
def test_counters_read_the_trunks_frozen_bn_count(build, folded):
    """One request through a captured program: one set of weights
    prepared, every FrozenBN of the trunk folded (R-101: the stem, 99
    block convs and 4 shortcuts; V-39: the 3 stem convs in the s2d stem
    and 6 OSA blocks of 6), and a conv served from the store for every
    conv and linear the request runs; the process counters add the
    same. A second request prepares nothing."""
    model = build()
    names = ("weights_prepared", "prepared_convs", "folded_norms")
    before = {n: tracing.counter(n) or 0.0 for n in names}
    prog = CapturedInference(model, graphs=FakeGraphs())
    x, hw = _request()
    prog(x, None, hw)
    prog(x, None, hw)
    got = {n: (tracing.counter(n) or 0.0) - before[n] for n in names}
    assert prog.weights.folded == folded
    assert got == {"weights_prepared": 1.0,
                   "prepared_convs": float(prog.weights.convs),
                   "folded_norms": float(folded)}
    # the FPN (6 convs, P6 and P7), the head (8 tower convs and 3
    # predictors), the mask head (4 convs, attention, deconv, predictor)
    # and MaskIoU (4 convs, 3 linears) besides the trunk's
    assert prog.weights.convs == folded + 8 + 11 + 7 + 7
