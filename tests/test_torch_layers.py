"""Port parity: each block of ``centermask2_tpu_torch/layers/blocks.py``
against its JAX module, on the CPU in float32.

Inputs and parameters are drawn from a seed with numpy, go through the
JAX module (NHWC) and the port (NCHW), and the outputs must agree within
RTOL/ATOL: both sides are float32 convolutions and reductions on the
CPU, which differ only in summation order.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu import layers as J  # noqa: E402
from centermask2_tpu_torch import layers as T  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402

RTOL, ATOL = 1e-5, 1e-5


def nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def nchw(y):
    return np.transpose(np.asarray(y), (0, 3, 1, 2))


def run_both(jmod, tmod, params, x):
    """Apply the JAX module to NHWC x and the port to NCHW x, the port
    loaded from the same parameter tree."""
    got_j = nchw(jmod.apply({"params": params}, nhwc(x)))
    load_jax_params(tmod, params)
    got_t = tmod(torch.from_numpy(x)).detach().numpy()
    return got_j, got_t


@pytest.mark.parametrize("stride,k,pad,groups", [
    (1, 3, 1, 1), (2, 3, 1, 1), (1, 1, 0, 1), (1, 3, 1, 8)])
def test_conv2d(stride, k, pad, groups):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 13, 11).astype(np.float32)  # odd sizes stress padding
    params = {"conv": {
        "kernel": rng.randn(k, k, 8 // groups, 16).astype(np.float32) * 0.1,
        "bias": rng.randn(16).astype(np.float32) * 0.1}}
    jmod = J.Conv2d(16, kernel_size=(k, k), strides=(stride, stride),
                    padding=(pad, pad), groups=groups, dtype=jnp.float32)
    tmod = T.Conv2d(8, 16, (k, k), (stride, stride), (pad, pad), groups)
    got_j = nchw(jmod.apply({"params": params}, nhwc(x)))
    load_jax_params(tmod, params["conv"])
    got_t = tmod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL, atol=ATOL)


def test_conv_transpose():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 7, 7).astype(np.float32)
    params = {"kernel": rng.randn(2, 2, 4, 6).astype(np.float32),
              "bias": rng.randn(4).astype(np.float32)}
    got_j, got_t = run_both(J.ConvTranspose2d(4, dtype=jnp.float32),
                            T.ConvTranspose2d(6, 4), params, x)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL, atol=ATOL)


def test_frozen_batchnorm():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 4, 6).astype(np.float32)
    params = {"frozen_scale": rng.randn(5).astype(np.float32),
              "frozen_bias": rng.randn(5).astype(np.float32)}
    got_j, got_t = run_both(J.FrozenBatchNorm(5), T.FrozenBatchNorm(5),
                            params, x)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL, atol=ATOL)


def test_group_norm():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 64, 5, 7) * 3 + 1).astype(np.float32)
    params = {"gn": {"scale": rng.randn(64).astype(np.float32),
                     "bias": rng.randn(64).astype(np.float32)}}
    got_j, got_t = run_both(J.GroupNorm(64), T.GroupNorm(64), params, x)
    np.testing.assert_allclose(got_t, got_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("batch", [1, 2])
def test_group_norm_one_value_per_group(batch):
    """32 channels in 32 groups on a 1x1 map: each group is one value,
    which JAX normalizes to exactly the bias (tolerance 0)."""
    rng = np.random.RandomState(10 + batch)
    x = rng.randn(batch, 32, 1, 1).astype(np.float32)
    params = {"gn": {"scale": rng.randn(32).astype(np.float32),
                     "bias": rng.randn(32).astype(np.float32)}}
    got_j, got_t = run_both(J.GroupNorm(32), T.GroupNorm(32), params, x)
    np.testing.assert_array_equal(got_t, got_j)
    np.testing.assert_array_equal(
        got_t, np.broadcast_to(params["gn"]["bias"][None, :, None, None],
                               x.shape))


def test_fpn_width_32_with_1x1_p7_matches_jax():
    """FPN at width 32 and the FCOS head's GN towers over all five
    levels of a 64x64 canvas, whose P6 and P7 are 1x1 (one value per GN
    group there). Tolerance 1e-4: f32 convolutions summed in other
    orders, through nine conv/GN layers."""
    from centermask2_tpu.models.backbones.fpn import FPN as JaxFPN
    from centermask2_tpu.models.fcos.head import FCOSHead as JaxHead
    from centermask2_tpu_torch.models.backbones.fpn import FPN
    from centermask2_tpu_torch.models.fcos.head import FCOSHead

    rng = np.random.RandomState(11)
    chans, strides = (16, 24, 40), (8, 16, 32)
    feats = [rng.randn(1, c, 64 // s, 64 // s).astype(np.float32)
             for c, s in zip(chans, strides)]
    jfpn = JaxFPN(in_strides=strides, out_channels=32, dtype=jnp.float32)
    jhead = JaxHead(num_classes=3, in_channels=32, dtype=jnp.float32)
    jfeats = [nhwc(f) for f in feats]
    fpn_params = jax.tree.map(np.asarray, jfpn.init(
        jax.random.PRNGKey(0), jfeats)["params"])
    levels = jfpn.apply({"params": fpn_params}, jfeats)
    jlevels = [levels[f"p{i}"] for i in range(3, 8)]
    assert jlevels[-1].shape[1:3] == (1, 1)
    head_params = jax.tree.map(np.asarray, jhead.init(
        jax.random.PRNGKey(1), jlevels)["params"])

    def perturb(p):  # move GN scale and every bias off its init
        return jax.tree.map(
            lambda v: (v + 0.3 * rng.randn(*v.shape)).astype(np.float32), p)

    head_params = perturb(head_params)
    want = jhead.apply({"params": head_params}, jlevels)

    fpn = FPN(chans, strides, out_channels=32)
    head = FCOSHead(num_classes=3, in_channels=32)
    load_jax_params(fpn, fpn_params)
    load_jax_params(head, head_params)
    with torch.no_grad():
        out = fpn([torch.from_numpy(f) for f in feats])
        got = head([out[f"p{i}"] for i in range(3, 8)])
    for got_l, want_l in zip(got, want):
        for g, w in zip(got_l, want_l):
            np.testing.assert_allclose(g.numpy(), nchw(w), rtol=1e-4,
                                       atol=1e-4)


def test_group_norm_keeps_bf16_activations():
    x = torch.randn(1, 32, 4, 4).bfloat16()
    assert T.GroupNorm(32)(x).dtype == torch.bfloat16


def test_get_norm():
    assert isinstance(T.get_norm("FrozenBN", 4), T.FrozenBatchNorm)
    assert isinstance(T.get_norm("GN", 32), T.GroupNorm)
    assert T.get_norm("", 4) is None
    bn, sync = T.get_norm("BN", 4), T.get_norm("SyncBN", 4)
    assert isinstance(bn, T.BatchNorm) and not bn.sync
    assert isinstance(sync, T.BatchNorm) and sync.sync
    with pytest.raises(ValueError):
        T.get_norm("LayerNorm", 4)


def test_hsigmoid():
    x = np.linspace(-5, 5, 41).astype(np.float32)
    np.testing.assert_allclose(T.hsigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(J.hsigmoid(jnp.asarray(x))),
                               rtol=0, atol=0)


def test_ese_module():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12, 5, 6).astype(np.float32)
    params = {"fc": {"kernel": rng.randn(1, 1, 12, 12).astype(np.float32),
                     "bias": rng.randn(12).astype(np.float32)}}
    got_j, got_t = run_both(J.eSEModule(12, dtype=jnp.float32),
                            T.eSEModule(12), params, x)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL, atol=ATOL)


def test_spatial_attention():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 8, 7, 7).astype(np.float32)
    params = {"conv": {"kernel": rng.randn(3, 3, 2, 1).astype(np.float32)}}
    got_j, got_t = run_both(J.SpatialAttention(dtype=jnp.float32),
                            T.SpatialAttention(), params, x)
    np.testing.assert_allclose(got_t, got_j, rtol=RTOL, atol=ATOL)


def test_scale():
    x = np.random.RandomState(7).randn(1, 4, 3, 3).astype(np.float32)
    got_j, got_t = run_both(J.Scale(), T.Scale(),
                            {"scale": np.array([1.7], np.float32)}, x)
    np.testing.assert_allclose(got_t, got_j, rtol=0, atol=0)


@pytest.mark.parametrize("h,w", [(13, 11), (16, 16), (25, 34), (3, 3)])
def test_max_pool2d_ceil(h, w):
    x = np.random.RandomState(8).randn(2, 3, h, w).astype(np.float32)
    got_j = nchw(J.max_pool2d_ceil(nhwc(x)))
    got_t = T.max_pool2d_ceil(torch.from_numpy(x)).numpy()
    assert got_t.shape == got_j.shape
    np.testing.assert_array_equal(got_t, got_j)


@pytest.mark.parametrize("norm,k,stride", [
    ("FrozenBN", 3, 1), ("FrozenBN", 3, 2), ("FrozenBN", 1, 1), ("GN", 3, 1),
    ("", 3, 1)])
def test_conv_norm_act(norm, k, stride):
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 10, 9).astype(np.float32)
    params = {"conv": {"kernel": rng.randn(k, k, 8, 32).astype(np.float32)
                       * 0.2}}
    if not norm:
        params["conv"]["bias"] = rng.randn(32).astype(np.float32)
    elif norm == "FrozenBN":
        params["norm"] = {"frozen_scale": rng.randn(32).astype(np.float32),
                          "frozen_bias": rng.randn(32).astype(np.float32)}
    else:
        params["norm"] = {"gn": {"scale": rng.randn(32).astype(np.float32),
                                 "bias": rng.randn(32).astype(np.float32)}}
    pad = (k // 2, k // 2)
    jmod = J.ConvNormAct(32, (k, k), (stride, stride), pad, norm=norm,
                         dtype=jnp.float32)
    tmod = T.ConvNormAct(8, 32, (k, k), (stride, stride), pad, norm=norm)
    got_j, got_t = run_both(jmod, tmod, params, x)
    np.testing.assert_allclose(got_t, got_j, rtol=1e-4, atol=1e-4)
