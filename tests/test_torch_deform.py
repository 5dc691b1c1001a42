"""Port parity for the deformable convolutions: ``ops/deform_conv.py``
(DCN v1 and v2, stride 1) forward and gradient, ``layers/deform.py``'s
block inside a V-19-slim trunk's DCN stages and inside the deformable
FCOS towers, a whole model with both and the adaptive ROIAlign buckets,
and the refusal of more than one deformable group; each against the JAX
package on the CPU in float32.

Parameters come from ``test_torch_backbones.py``'s ``numpy_params``,
which draws the offset convs' kernels too (JAX initializes them to
zero), so the offsets are far from zero and the bilinear taps fall
between pixels and outside the map. Tolerances: ``rtol = atol = 1e-4``
on features (f32 sums in other orders); gradients 1e-4 of each tensor's
largest value; whole models those of ``whole_model_parity``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from test_torch_backbones import (SMALL_OPTS, assert_close,  # noqa: E402
                                  assert_features_equal, image, nhwc,
                                  numpy_params, run_both, whole_model_parity)

from centermask2_tpu.layers.deform import (  # noqa: E402
    DeformConvBlock as JaxDeformConvBlock)
from centermask2_tpu.models.backbones import vovnet as jvov  # noqa: E402
from centermask2_tpu.models.fcos.head import FCOSHead as JaxFCOSHead  # noqa: E402
from centermask2_tpu.ops.deform_conv import deform_conv2d as jdeform  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402
from centermask2_tpu_torch.layers import DeformConvBlock  # noqa: E402
from centermask2_tpu_torch.models import backbones as T  # noqa: E402
from centermask2_tpu_torch.models.fcos.head import FCOSHead  # noqa: E402
from centermask2_tpu_torch.ops.deform_conv import deform_conv2d  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("modulated,dilation", [
    (False, 1), (True, 1), (True, 2)])
def test_deform_conv2d_matches_jax(modulated, dilation):
    """Offsets of a few pixels (taps between pixels and off the map), the
    DCN v2 mask, a bias and a dilated kernel: the output, and the
    gradients of the input, offsets, kernel and mask."""
    rng = np.random.RandomState(0)
    N, C, H, W, O = 2, 5, 9, 11, 7
    x = rng.randn(N, C, H, W).astype(np.float32)
    off = (1.5 * rng.randn(N, 18, H, W)).astype(np.float32)
    w = (rng.randn(O, C, 3, 3) / np.sqrt(9 * C)).astype(np.float32)
    mask = rng.rand(N, 9, H, W).astype(np.float32) if modulated else None
    bias = rng.randn(O).astype(np.float32)
    g = rng.randn(N, O, H, W).astype(np.float32)

    def jf(x_, off_, w_, m_):
        y = jdeform(jnp.transpose(x_, (0, 2, 3, 1)),
                    jnp.transpose(off_, (0, 2, 3, 1)),
                    jnp.transpose(w_, (2, 3, 1, 0)),
                    None if m_ is None else jnp.transpose(m_, (0, 2, 3, 1)),
                    jnp.asarray(bias), padding=dilation, dilation=dilation)
        return jnp.transpose(y, (0, 3, 1, 2))

    args = [jnp.asarray(a) if a is not None else None
            for a in (x, off, w, mask)]
    want, vjp = jax.vjp(jf, *args)
    wgrads = vjp(jnp.asarray(g))
    targs = [torch.from_numpy(a).requires_grad_(True) if a is not None
             else None for a in (x, off, w, mask)]
    got = deform_conv2d(*targs, bias=torch.from_numpy(bias),
                        padding=dilation, dilation=dilation)
    assert got.shape == (N, O, H, W)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    got.backward(torch.from_numpy(g))
    for name, a, wg in zip(("x", "offsets", "weight", "mask"), targs, wgrads):
        if a is None:
            continue
        wg = np.asarray(wg)
        np.testing.assert_allclose(a.grad.numpy(), wg, rtol=0,
                                   atol=1e-4 * float(np.abs(wg).max()),
                                   err_msg=name)


@pytest.mark.parametrize("modulated", [False, True])
def test_deform_conv_block_matches_jax(modulated):
    """The block: the f32 offset conv, the (off_x, off_y, mask) split of
    the modulated prediction re-stacked as (dy, dx), FrozenBN, relu."""
    x = np.random.RandomState(1).randn(2, 6, 10, 8).astype(np.float32)
    jmod = JaxDeformConvBlock(12, modulated=modulated, dtype=jnp.float32)
    port = DeformConvBlock(6, 12, modulated=modulated)
    want, got, params = run_both(jmod, port, x)
    assert params["conv_offset"]["kernel"].shape[-1] == \
        (27 if modulated else 18)
    assert_close(got, want)


def test_v19_slim_trunk_with_dcn_matches_jax():
    """The V-19-slim-eSE trunk with STAGE_WITH_DCN (False, False, True,
    True) and WITH_MODULATED_DCN: every layer of stages 4 and 5 a
    modulated deformable block."""
    feats = ("stage2", "stage3", "stage4", "stage5")
    dcn = (False, False, True, True)
    jmod = jvov.VoVNet(body="V-19-slim-eSE", out_features=feats,
                       stage_with_dcn=dcn, with_modulated_dcn=True,
                       dtype=jnp.float32)
    port = T.VoVNet("V-19-slim-eSE", out_features=feats, stage_with_dcn=dcn,
                    with_modulated_dcn=True)
    want, got, params = run_both(jmod, port, image())
    assert "conv_offset" in params["OSA4_1"]["layer0"]
    assert isinstance(port.OSA5_1.layer2, DeformConvBlock)
    assert not isinstance(port.OSA3_1.layer0, DeformConvBlock)
    assert_features_equal(want, got)


def test_deformable_fcos_head_matches_jax():
    """MODEL.FCOS.USE_DEFORMABLE: the share and bbox towers' convs are
    deformable blocks with a bias (no norm or relu of their own) before
    the tower's GN and relu; the cls tower stays regular."""
    rng = np.random.RandomState(2)
    feats = [rng.randn(1, 32, h, w).astype(np.float32)
             for h, w in ((8, 12), (4, 6))]
    kw = dict(num_classes=3, in_channels=32, num_cls_convs=2,
              num_box_convs=2, num_share_convs=1, num_levels=2,
              use_deformable=True)
    jmod = JaxFCOSHead(dtype=jnp.float32, **kw)
    port = FCOSHead(**kw)
    params = numpy_params(jmod, rng, [nhwc(f) for f in feats])
    assert "conv_offset" in params["bbox_tower"]["conv0"]
    assert "conv_offset" in params["share_tower"]["conv0"]
    assert "conv_offset" not in params["cls_tower"]["conv0"]
    want = jmod.apply({"params": params}, [nhwc(f) for f in feats])
    load_jax_params(port, params)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats])
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            assert_close(g.numpy(), np.transpose(np.asarray(w), (0, 3, 1, 2)))


def test_whole_model_with_dcn_and_adaptive_pool_matches_jax():
    """A V-19-slim model with modulated DCN in stages 4 and 5, the
    deformable FCOS towers and TPU.POOLER_SAMPLING_RATIO 0, against
    JAX's ``build_centermask`` of the same config."""
    port = whole_model_parity("zy_model_config.yaml", SMALL_OPTS + [
        "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE",
        "MODEL.VOVNET.STAGE_WITH_DCN", "(False, False, True, True)",
        "MODEL.VOVNET.WITH_MODULATED_DCN", "True",
        "MODEL.FCOS.USE_DEFORMABLE", "True",
        "TPU.POOLER_SAMPLING_RATIO", "0"])
    assert port.roi_heads.sampling_ratio == 0
    assert isinstance(port.fcos_head.bbox_tower.conv0, DeformConvBlock)


@pytest.mark.parametrize("modulated", [False, True])
def test_more_than_one_deformable_group_is_refused(modulated):
    """DEFORMABLE_GROUPS 2 cannot run in JAX (the 2 * 9 * G offset
    channels do not reshape into (..., 9, 2)); the port refuses it."""
    x = jnp.zeros((1, 8, 8, 4))
    jmod = JaxDeformConvBlock(4, modulated=modulated, deformable_groups=2,
                              dtype=jnp.float32)
    with pytest.raises(TypeError, match="reshape"):
        jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    with pytest.raises(NotImplementedError, match="DEFORMABLE_GROUPS=2"):
        DeformConvBlock(4, 4, modulated=modulated, deformable_groups=2)
    DeformConvBlock(4, 4, modulated=modulated, deformable_groups=1)
