"""The captured serving program's channels-last trunk and FPN and its
fused conv epilogues (``layers/prepared.py::channels_last``,
``ops/conv_bias_act.py``) on the CPU.

On the card the rule ``prepared.channels_last`` keeps the served
trunk's and FPN's maps channels-last; here it is widened to the CPU
(``widen``), so the same code runs on the CPU's convolutions, where
``conv_bias_act`` is its plain chain. The CPU's convolution, mean and
GroupNorm kernels sum in another order for a channels-last map than for
an NCHW one, so the bit-for-bit comparisons run them layout-blind
(``layout_blind``: each computes on the NCHW copy of its input and
returns its output in the input's layout): what is left to differ is
the layout's flow and the order of each fused epilogue's sums, which
must then match the NCHW chain's exactly.
"""

import pytest
import torch
import torch.nn.functional as F

from centermask2_tpu_torch.export import CapturedInference
from centermask2_tpu_torch.layers import blocks, prepared
from centermask2_tpu_torch.models.backbones import vovnet
from centermask2_tpu_torch.ops import conv_bias_act as cba
from centermask2_tpu_torch.utils import tracing

from test_torch_captured import FakeGraphs
from test_torch_serving_weights import _draw, _r101, _request, _v39

# the convs a served request runs through ``conv_bias_act``: R-101 its
# stem and the 3 convs of each of 33 bottlenecks (conv3 with its
# shortcut), not the 4 projections; V-39 the s2d stem's 4 calls and the
# 6 convs of each of 6 OSA modules
FUSED = {"R-101": 100, "V-39": 40}
BUILDS = {"R-101": _r101, "V-39": _v39}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def widen(monkeypatch):
    """The served path's channels-last rule widened to the CPU."""
    monkeypatch.setattr(prepared, "channels_last",
                        lambda x: prepared.active() is not None)


def _blind(fn):
    def run(x, *args, **kwargs):
        cl = prepared.is_channels_last(x)
        y = fn(*(a.clone(memory_format=torch.contiguous_format) if
                 isinstance(a, torch.Tensor) else a for a in (x, *args)),
               **kwargs)
        return y.contiguous(memory_format=torch.channels_last) if cl and \
            y.dim() == 4 else y
    return run


@pytest.fixture
def layout_blind(monkeypatch):
    for name in ("conv2d", "group_norm"):
        monkeypatch.setattr(F, name, _blind(getattr(F, name)))
    monkeypatch.setattr(torch.Tensor, "mean", _blind(torch.Tensor.mean))


def _model(name):
    model = BUILDS[name]()
    _draw(model, 0)
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    return model


def _served(model, x, hw):
    """One request through a captured program (fake graphs): its outputs,
    the trunk's and the FPN's maps by name, and the program."""
    maps = {}

    def keep(prefix):
        return lambda m, a, out: maps.update(
            {f"{prefix}/{k}": v.clone(memory_format=torch.preserve_format)
             for k, v in out.items()})

    hooks = [model.backbone.register_forward_hook(keep("backbone")),
             model.fpn.register_forward_hook(keep("fpn"))]
    try:
        prog = CapturedInference(model, graphs=FakeGraphs())
        out = prog(x, None, hw)
    finally:
        for h in hooks:
            h.remove()
    return out, maps, prog


@pytest.mark.parametrize("with_z", [False, True], ids=["no_z", "z"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_bias_act_oracle_is_the_chain(dtype, with_z):
    """Off CUDA ``conv_bias_act`` is its oracle, ``F.conv2d`` with the
    bias, then ``+ z``, then ReLU, bit for bit, in NCHW and channels-last
    maps, strided and grouped."""
    g = torch.Generator().manual_seed(0)
    for stride, padding, groups, cl in (((1, 1), (1, 1), 1, False),
                                        ((2, 2), (0, 0), 1, True),
                                        ((1, 1), (1, 1), 2, True)):
        x = torch.randn((2, 8, 9, 11), generator=g).to(dtype)
        w = torch.randn((6, 8 // groups, 3, 3), generator=g).to(dtype)
        b = torch.randn((6,), generator=g).to(dtype)
        if cl:
            x = x.contiguous(memory_format=torch.channels_last)
            w = w.contiguous(memory_format=torch.channels_last)
        y = F.conv2d(x, w, b, stride, padding, 1, groups)
        z = torch.randn(y.shape, generator=g).to(dtype) if with_z else None
        want = F.relu(y + z if with_z else y)
        for fn in (cba.conv_bias_act, cba.conv_bias_act_plain):
            got = fn(x, w, b, z, stride, padding, groups)
            assert got.dtype == dtype and torch.equal(got, want)
            assert got.stride() == want.stride()


@pytest.mark.parametrize("name", list(BUILDS))
def test_served_trunk_channels_last_bit_equal_to_nchw(name, widen,
                                                      layout_blind,
                                                      monkeypatch):
    """A request through the captured program, from the uint8 s2d pack,
    f32: with the rule widened, every trunk and FPN map is channels-last
    and every output and map bit-equal to the served NCHW chain's (the
    rule as on the CPU); outside the program the maps are NCHW; the
    program serves ``FUSED[name]`` convs through ``conv_bias_act``, its
    counter adding as many."""
    model = _model(name)
    x, hw = _request()
    before = tracing.counter("fused_convs") or 0.0
    out, maps, prog = _served(model, x, hw)
    assert prog.weights.fused == FUSED[name]
    assert (tracing.counter("fused_convs") or 0.0) - before == FUSED[name]
    assert maps and all(v.is_contiguous(memory_format=torch.channels_last)
                        for v in maps.values())
    monkeypatch.setattr(prepared, "channels_last", lambda x: False)
    out_nchw, maps_nchw, prog_nchw = _served(model, x, hw)
    assert prog_nchw.weights.fused == FUSED[name]
    assert maps_nchw.keys() == maps.keys()
    for k, v in maps_nchw.items():
        assert v.is_contiguous() and torch.equal(maps[k], v), k
    for f in out._fields:
        a, b = getattr(out, f), getattr(out_nchw, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert int(out.valid.sum()) > 0
    eager = []
    hooks = [m.register_forward_hook(lambda m, a, o: eager.extend(
        o.values())) for m in (model.backbone, model.fpn)]
    try:
        model.inference(x, None, hw)
    finally:
        for h in hooks:
            h.remove()
    assert len(eager) == len(maps) and all(v.is_contiguous() for v in eager)


@pytest.mark.parametrize("name", list(BUILDS))
def test_plain_chain_never_fuses(name, widen, monkeypatch):
    """Autograd on (a loss's forward inside the store's context) and the
    benchmark's FLOP count (one eager request outside it) never reach
    ``conv_bias_act``, and the FLOP count equals the served channels-last
    path's, which reaches it on every fused conv."""
    from benchmark.harness.flops import count_flops

    model = _model(name)
    x, hw = _request()
    served = CapturedInference(model, graphs=FakeGraphs())
    with served.prepared():
        flops_served = count_flops(model,
                                   lambda: model.inference(x, None, hw))

    def refuse(*a, **k):
        raise AssertionError("conv_bias_act on the plain chain")

    monkeypatch.setattr(blocks, "conv_bias_act", refuse)
    monkeypatch.setattr(vovnet, "conv_bias_act", refuse)
    assert count_flops(model, lambda: model.inference(x, None, hw)) \
        == flops_served > 0
    with served.prepared(), torch.enable_grad():
        assert prepared.active() is None
        feats = model.features(model._normalize_u8_s2d(x, hw))
        sum(v.float().sum() for v in feats.values()).backward()
    assert all(v.is_contiguous() for v in feats.values())
    with served.prepared():  # the served path does reach it
        with pytest.raises(AssertionError, match="plain chain"):
            model.inference(x, None, hw)
