"""Kernel 3's operator and the FCOS towers' layout, on the CPU.

``cm2::group_norm_relu`` (``ops/group_norm.py``): its CPU implementation,
the plain version, against the chain the tower ran before it
(``layers/blocks.py::GroupNorm``, then ReLU) in bf16 and f32, on NCHW and
channels-last maps of the tower's five level shapes at 1344x1344 and
800x1088; against JAX's GroupNorm and ReLU at ``test_torch_layers``'
tolerances; groups of one value; ``opcheck``. The rule (``fused_path``:
a CUDA map, autograd off) on fake CUDA tensors. The ``FCOSHead``'s fused path (the rule widened to the CPU:
channels-last towers over all levels, the operator a GN layer) against
its plain path, with its decode, and with
deformable towers, each call count as ``chip_smoke.fused_tower_norms``
expects it; ``check_layers``' dump of the fused head keyed as the plain
head's, the tower norms alone missing; training and the CPU launch no
kernel. The kernel itself
runs on the card only: ``chip_smoke.py::check_group_norm``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu import layers as J  # noqa: E402
from centermask2_tpu_torch import layers as T  # noqa: E402
from centermask2_tpu_torch.layers import GN_EPS  # noqa: E402
from centermask2_tpu_torch.models.fcos.head import FCOSHead  # noqa: E402
from centermask2_tpu_torch.models.fcos.outputs import decode_batch  # noqa: E402
from centermask2_tpu_torch.ops import _kernels  # noqa: E402
from centermask2_tpu_torch.ops import group_norm as gn_mod  # noqa: E402
from centermask2_tpu_torch.tools import check_layers  # noqa: E402

CL = torch.channels_last
# the FCOS tower's level shapes (FPN strides 8-128) of a request
TOWER_LEVELS = {
    "1344x1344": [(168, 168), (84, 84), (42, 42), (21, 21), (11, 11)],
    "800x1088": [(100, 136), (50, 68), (25, 34), (13, 17), (7, 9)],
}
# small maps of five levels, the last of one position
SMALL_LEVELS = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]


def _levels(rng, shapes, n, c, dtype, layout):
    """Conv-output-like maps: a per-channel offset of up to 3 standard
    deviations."""
    off = rng.randn(n, c, 1, 1) * 3.0
    xs = [torch.from_numpy((rng.randn(n, c, h, w) + off).astype(np.float32))
          .to(dtype) for h, w in shapes]
    return [x.contiguous(memory_format=layout) for x in xs]


def _affine(rng, c):
    return (torch.from_numpy(rng.randn(c).astype(np.float32)),
            torch.from_numpy(rng.randn(c).astype(np.float32)))


def _old_chain(x, weight, bias, groups=32):
    """The tower's norm before kernel 3: ``GroupNorm``, then ReLU."""
    norm = T.GroupNorm(x.shape[1], groups)
    with torch.no_grad():
        norm.gn.weight.copy_(weight)
        norm.gn.bias.copy_(bias)
        return torch.nn.functional.relu(norm(x))


def _assert_bf16_close(got, want):
    """Within one bf16 ulp of each value, and 1e-5."""
    g, w = got.float(), want.float()
    assert bool(((g - w).abs() <= 2.0 ** -7 * w.abs() + 1e-5).all())


@pytest.mark.parametrize("canvas", sorted(TOWER_LEVELS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [torch.contiguous_format, CL],
                         ids=["nchw", "nhwc"])
def test_plain_op_equals_the_tower_chain(canvas, dtype, layout):
    """The operator's CPU implementation on a tower layer's five levels
    (C = 256, 32 groups): equal to the old chain on NCHW maps; on
    channels-last maps (the CPU's channels-last group_norm sums in another
    order) within 1e-5 in f32 and one ulp in bf16; each output laid out
    as its input."""
    rng = np.random.RandomState(0)
    xs = _levels(rng, TOWER_LEVELS[canvas], 1, 256, dtype, layout)
    weight, bias = _affine(rng, 256)
    got = gn_mod.group_norm_relu_op(xs, weight, bias, 32, GN_EPS)
    for x, g in zip(xs, got):
        want = _old_chain(x.contiguous(), weight, bias)
        assert g.dtype == dtype and g.shape == x.shape
        assert g.stride() == x.stride()
        if layout == torch.contiguous_format:
            torch.testing.assert_close(g, want, rtol=0, atol=0)
        elif dtype == torch.float32:
            torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)
        else:
            _assert_bf16_close(g, want)


@pytest.mark.parametrize("layout", [torch.contiguous_format, CL],
                         ids=["nchw", "nhwc"])
def test_plain_op_matches_jax_group_norm_relu(layout):
    """Against JAX's GroupNorm and ReLU at the tolerance of
    ``test_torch_layers.py::test_group_norm`` (1e-4)."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 64, 5, 7) * 3 + 1).astype(np.float32)
    scale = rng.randn(64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    want = jax.nn.relu(J.GroupNorm(64).apply(
        {"params": {"gn": {"scale": scale, "bias": bias}}},
        jnp.asarray(np.transpose(x, (0, 2, 3, 1)))))
    got = gn_mod.group_norm_relu_op(
        [torch.from_numpy(x).contiguous(memory_format=layout)],
        torch.from_numpy(scale), torch.from_numpy(bias), 32, GN_EPS)[0]
    np.testing.assert_allclose(got.numpy(),
                               np.transpose(np.asarray(want), (0, 3, 1, 2)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", [torch.contiguous_format, CL],
                         ids=["nchw", "nhwc"])
def test_one_value_per_group_gives_relu_of_the_bias(batch, dtype, layout):
    """32 channels in 32 groups on 1x1 maps: each group is one value, so
    the output is relu(bias) exactly, as the old chain gives it."""
    rng = np.random.RandomState(10 + batch)
    xs = _levels(rng, [(1, 1), (1, 1)], batch, 32, dtype, layout)
    weight, bias = _affine(rng, 32)
    got = gn_mod.group_norm_relu_op(xs, weight, bias, 32, GN_EPS)
    want = torch.relu(bias).to(dtype)[None, :, None, None]
    for x, g in zip(xs, got):
        torch.testing.assert_close(g, want.expand_as(g), rtol=0, atol=0)
        torch.testing.assert_close(g, _old_chain(x, weight, bias), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("layout", [torch.contiguous_format, CL],
                         ids=["nchw", "nhwc"])
def test_opcheck(layout):
    rng = np.random.RandomState(1)
    xs = _levels(rng, SMALL_LEVELS, 2, 16, torch.float32, layout)
    weight, bias = _affine(rng, 16)
    torch.library.opcheck(gn_mod.group_norm_relu_op,
                          (xs, weight, bias, 8, GN_EPS))


@pytest.mark.parametrize("layout", [torch.contiguous_format, CL],
                         ids=["nchw", "nhwc"])
def test_fused_path_takes_cuda_maps_without_autograd(layout):
    """The rule on fake CUDA maps: a CUDA map with autograd off takes the
    fused path, whatever its strides; autograd on or a CPU map does
    not."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(1, 8, 4, 4, device="cuda", memory_format=layout)
        with torch.no_grad():
            assert gn_mod.fused_path(x)
        assert not gn_mod.fused_path(x)
    with torch.no_grad():
        assert not gn_mod.fused_path(
            torch.empty(1, 8, 4, 4, memory_format=layout))


def _random_head(dtype=torch.float32, **kw):
    """An FCOS head whose parameters are drawn at a scale that keeps each
    layer's output near its input's."""
    head = FCOSHead(num_classes=4, in_channels=64, dtype=dtype, **kw)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in head.named_parameters():
            if p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=g)
                        / np.sqrt(p[0].numel()))
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5
                        + (1.0 if name.endswith("gn.weight") else 0.0))
    return head


def _feats(rng, layout, dtype=torch.float32):
    return _levels(rng, SMALL_LEVELS, 2, 64, dtype, layout)


@pytest.fixture
def widen(monkeypatch):
    """``widen()``: the fused path's rule widened to the CPU (autograd
    off), and the head's calls of the operator counted into the list it
    returns."""
    calls = []
    op = gn_mod.group_norm_relu_op

    def counted(xs, *args):
        calls.append(len(xs))
        return op(xs, *args)

    def apply():
        monkeypatch.setattr(gn_mod, "fused_path",
                            lambda x: not torch.is_grad_enabled())
        monkeypatch.setattr(gn_mod, "group_norm_relu_op", counted)
        return calls

    return apply


def test_channels_last_head_matches_the_nchw_head(widen):
    """On the fused path the head moves the levels to channels-last and
    runs each GN tower layer as one call over the five levels (4 cls + 4
    bbox layers); it gives the plain head's logits, regression and
    centerness (1e-4: f32 convolutions summed in other orders through
    five layers), channels-last; the decode of both selects the same
    proposals."""
    head = _random_head()
    rng = np.random.RandomState(2)
    feats = _feats(rng, torch.contiguous_format)
    with torch.no_grad():
        want = head(feats)
        calls = widen()
        got = head(feats)
    assert calls == [5] * 8
    assert chip_smoke.fused_tower_norms(SimpleNamespace(fcos_head=head)) == 8
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            assert g.is_contiguous(memory_format=CL)
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    strides = [8, 16, 32, 64, 128]
    locs = [torch.zeros(h * w, 2) for h, w in SMALL_LEVELS]
    kw = dict(pre_nms_thresh=0.05, pre_nms_topk=50, nms_thresh=0.6,
              post_nms_topk=10, nms_candidates=50)
    a = decode_batch(locs, *want, strides, **kw)
    b = decode_batch(locs, *got, strides, **kw)
    assert torch.equal(a.valid, b.valid) and bool(a.valid.any())
    torch.testing.assert_close(b.scores, a.scores, rtol=1e-4, atol=1e-4)


def test_bf16_channels_last_head_matches_the_nchw_head(widen):
    """The same in bf16, each output within 2% of the NCHW head's
    largest: bf16 convolutions round at other places on the two
    layouts."""
    head = _random_head(torch.bfloat16)
    rng = np.random.RandomState(3)
    feats = _feats(rng, torch.contiguous_format, torch.bfloat16)
    with torch.no_grad():
        want = head(feats)
        calls = widen()
        got = head(feats)
    assert calls == [5] * 8
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            assert g.dtype == torch.bfloat16
            err = float((g.float() - w.float()).abs().max())
            assert err <= 0.02 * float(w.float().abs().max())


@pytest.mark.parametrize("share", [0, 1])
def test_deformable_towers_stay_correct(widen, share):
    """MODEL.FCOS.USE_DEFORMABLE on the fused path: the share and bbox
    towers' deformable convs write NCHW, moved to channels-last before
    the operator, so every GN layer takes it (2 cls, 2 bbox and the share
    tower's). The outputs equal the plain path's (1e-4)."""
    kw = dict(num_cls_convs=2, num_box_convs=2, num_share_convs=share,
              use_deformable=True)
    head = _random_head(**kw)
    rng = np.random.RandomState(4)
    feats = _feats(rng, torch.contiguous_format)
    with torch.no_grad():
        want = head(feats)
        calls = widen()
        got = head(feats)
    assert calls == [5] * (4 + share)
    assert chip_smoke.fused_tower_norms(
        SimpleNamespace(fcos_head=head)) == len(calls)
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


class _HeadModel(torch.nn.Module):
    """A model of the FCOS head alone, for ``check_layers``."""

    def __init__(self, head):
        super().__init__()
        self.fcos_head = head

    def inference(self, feats):
        return self.fcos_head(feats)


def test_layer_dump_of_the_fused_head_keys_as_the_plain_one(widen):
    """``check_layers.capture_layers`` of the head on the fused path (as on
    the card) keys each tower's outputs a call a level, as on the plain
    path and in JAX; the plain dump alone holds the tower norms' outputs,
    one a GN layer and level, and ``compare`` of the two exits 0."""
    head = _random_head()
    model = _HeadModel(head)
    feats = _feats(np.random.RandomState(6), torch.contiguous_format)
    plain = check_layers.capture_layers(model, feats)
    calls = widen()
    fused = check_layers.capture_layers(model, feats)
    assert calls == [5] * 8
    rows, only_plain, only_fused = check_layers.compare_layers(plain, fused)
    assert only_fused == []
    assert sorted(only_plain) == sorted(
        f"fcos_head/{t}_tower/norm{i}/__call__[{lvl}]"
        for t in ("cls", "bbox") for i in range(4) for lvl in range(5))
    for t in ("share", "cls", "bbox"):
        assert [k for k in fused if k.startswith(f"fcos_head/{t}_tower/_")
                ] == [f"fcos_head/{t}_tower/__call__[{lvl}]"
                      for lvl in range(5)]
    assert min(r[0] for r in rows) > 1 - 1e-5
    assert check_layers.print_comparison(rows, only_plain, only_fused,
                                         1 - 1e-5, 0) == 0


def test_training_and_the_cpu_launch_no_kernel(monkeypatch):
    """With autograd on (a training step's forward and backward) and on
    the CPU under no_grad the head never calls the operator, and kernel
    3's launch count stays 0; the training forward keeps NCHW."""
    calls = []
    monkeypatch.setattr(gn_mod, "group_norm_relu_op",
                        lambda *a: calls.append(a))
    _kernels.reset_launch_counts()
    head = _random_head()
    rng = np.random.RandomState(5)
    feats = _feats(rng, torch.contiguous_format)
    logits, reg, ctr = head(feats)
    sum(t.float().sum() for t in logits + reg + ctr).backward()
    assert all(t.is_contiguous() for t in logits + reg + ctr)
    assert head.cls_tower.conv0.weight.grad is not None
    with torch.no_grad():
        head(feats)
        head([f.contiguous(memory_format=CL) for f in feats])
    assert calls == []
    assert _kernels.launch_counts()["group_norm_relu"] == 0
