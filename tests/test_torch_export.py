"""The port's registered operators and its fixed-shape export, on the CPU:
``torch.library.opcheck`` of ``cm2::nms_keep_sorted``, ``cm2::roi_align``
and ``cm2::roi_align_backward`` (schema, fake implementation, the
operators' aliasing rules); ``export/aot.py``'s artifacts, f32 and uint8
s2d (tight, padded back), reloaded and run against the port's eager
``inference`` (equal) and against the JAX package's ``export_serialized`` artifact on
the same weights (within the tolerances of tests/test_export.py:
scores 1e-5 relative and 1e-6 absolute, boxes 1e-5 and 1e-4; the other
heads 1e-5 absolute, mask scores 1e-5 relative too); the export CLI on a
tiny config. A V-19-slim at 64x64 in f32, weights perturbed off their
init (tests/test_torch_serving.py::_perturb).
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.data.preprocess import (  # noqa: E402
    s2d_pack_u8_tight, s2d_preprocess)
from centermask2_tpu.export import export_serialized as jax_export  # noqa: E402
from centermask2_tpu.export import load_serialized as jax_load  # noqa: E402
from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402
from centermask2_tpu_torch.export import (  # noqa: E402
    export_serialized, inference_flops, load_serialized)
from centermask2_tpu_torch.models.meta import CenterMask  # noqa: E402
from centermask2_tpu_torch.ops import nms as nms_mod  # noqa: E402
from centermask2_tpu_torch.ops import roi_align as roi_mod  # noqa: E402

# (rtol, atol) of the port's artifact against JAX's, per output head
JAX_TOL = {"scores": (1e-5, 1e-6), "pred_boxes": (1e-5, 1e-4),
           "mask_scores": (1e-5, 1e-5), "pred_masks": (0.0, 1e-5),
           "locations": (0.0, 0.0)}
TINY = dict(conv_body="V-19-slim-eSE", post_nms_topk_test=5,
            pre_nms_topk_test=20, nms_candidates=20)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- opcheck
def _roi_case():
    rng = np.random.RandomState(0)
    feats = [torch.from_numpy(rng.randn(2, 8, s, s).astype(np.float32))
             for s in (16, 8, 4)]
    boxes = torch.tensor([[1.0, 2.0, 40.0, 50.0], [10.0, 10.0, 20.0, 20.0],
                          [-5.0, 0.0, 128.0, 130.0]])
    bidx = torch.tensor([0, 1, 0], dtype=torch.int32)
    levels = torch.tensor([0, 1, 2], dtype=torch.int32)
    return feats, boxes, bidx, levels, [1 / 8, 1 / 16, 1 / 32]


def _opcheck_args(name):
    rng = np.random.RandomState(1)
    if name == "nms_keep_sorted":
        boxes = np.sort(rng.rand(2, 128, 4).astype(np.float32) * 50, axis=-1)
        return nms_mod.nms_keep_sorted_op, (
            torch.from_numpy(boxes), torch.from_numpy(rng.rand(2, 128) > 0.2),
            0.5)
    feats, boxes, bidx, levels, scales = _roi_case()
    if name == "roi_align":
        return roi_mod.roi_align_op, (feats, boxes, bidx, levels, scales, 7,
                                      2, True)
    shapes = [v for f in feats for v in f.shape]
    grad = torch.from_numpy(rng.randn(3, 8, 7, 7).astype(np.float32))
    return roi_mod.roi_align_backward_op, (
        grad, boxes, bidx, levels, shapes, torch.float32, scales, 7, 2, True)


@pytest.mark.parametrize("name", ["nms_keep_sorted", "roi_align",
                                  "roi_align_backward"])
def test_opcheck(name):
    op, args = _opcheck_args(name)
    assert str(op._opoverload).startswith(f"cm2.{name}")
    torch.library.opcheck(op, args)


# ----------------------------------------------------------------- export
@pytest.fixture(scope="module")
def models():
    """JAX and port models of one perturbed parameter tree, plain and
    s2d-input, and an input image."""
    from test_torch_serving import _perturb

    rng = np.random.RandomState(0)
    out = {}
    for s2d in (False, True):
        jm = JaxCenterMask(**TINY, dtype=jnp.float32, s2d_input=s2d)
        x0 = jnp.zeros((1, 17, 17, 48) if s2d else (1, 64, 64, 3))
        if "params" not in out:
            out["params"] = _perturb(jax.tree.map(np.asarray, jax.jit(
                jm.init)(jax.random.PRNGKey(0), x0)["params"]), rng)
        pm = CenterMask(**TINY, dtype=torch.float32, s2d_input=s2d)
        load_jax_params(pm, out["params"])
        out[s2d] = (jm, pm.eval())
    out["image"] = (np.random.RandomState(1).rand(40, 61, 3) * 255) \
        .astype(np.uint8)
    return out


def _assert_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or torch.equal(a, b), f


def _assert_near_jax(got, jout):
    """The port's outputs against JAX's artifact's (a positional tuple)."""
    names = got._fields
    jv = np.asarray(jout[names.index("valid")])
    np.testing.assert_array_equal(got.valid.numpy(), jv)
    assert jv.any()
    np.testing.assert_array_equal(
        got.pred_classes.numpy()[jv],
        np.asarray(jout[names.index("pred_classes")])[jv])
    for f, (rtol, atol) in JAX_TOL.items():
        np.testing.assert_allclose(getattr(got, f).numpy()[jv],
                                   np.asarray(jout[names.index(f)])[jv],
                                   rtol=rtol, atol=atol, err_msg=f)


def test_export_roundtrip_f32(models, tmp_path):
    jm, pm = models[False]
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32) * 20
    path = export_serialized(pm, (1, 64, 64, 3), str(tmp_path / "m.pt2"))
    assert os.path.getsize(path) > 1000
    got = load_serialized(path)(torch.from_numpy(x))
    _assert_equal(got, pm.inference(torch.from_numpy(x)))
    jpath = jax_export(jm, {"params": models["params"]}, (1, 64, 64, 3),
                       str(tmp_path / "m.jaxir"))
    _assert_near_jax(got, jax_load(jpath)(jnp.asarray(x)))


def test_export_roundtrip_serving_u8_tight(models, tmp_path):
    """The uint8 tight-pack program padded back to 64x64 (as
    tests/test_export.py::test_aot_roundtrip_serving_u8_tight builds
    JAX's): equal to the port's eager request and to its f32 s2d request
    of the same image, near JAX's artifact."""
    jm, pm = models[True]
    img = models["image"]
    xt = s2d_pack_u8_tight(img, 64, multiple=8)
    hw = np.asarray([[40, 61]], np.int32)
    path = export_serialized(pm, xt.shape, str(tmp_path / "s.pt2"),
                             input_dtype=torch.uint8, canvas_hw=(64, 64))
    args = (torch.from_numpy(xt), torch.from_numpy(hw))
    got = load_serialized(path)(*args)
    _assert_equal(got, pm.inference(args[0], None, args[1], (64, 64)))
    _assert_equal(got, pm.inference(torch.from_numpy(s2d_preprocess(img, 64))))
    jpath = jax_export(jm, {"params": models["params"]}, xt.shape,
                       str(tmp_path / "s.jaxir"), input_dtype=jnp.uint8,
                       canvas_hw=(64, 64))
    _assert_near_jax(got, jax_load(jpath)(jnp.asarray(xt), jnp.asarray(hw)))


def test_export_rejects_uint8_without_s2d(models, tmp_path):
    with pytest.raises(ValueError, match="s2d"):
        export_serialized(models[False][1], (1, 17, 17, 48),
                          str(tmp_path / "x.pt2"), input_dtype=torch.uint8)


def test_inference_flops_counts_the_convolutions(models):
    """FLOPs of one call: the same for the f32 program and the uint8 one
    of the same canvas (the normalization adds no product); a 2x canvas
    adds 3x the backbone's and the FCOS head's part and nothing to the
    fixed-size ROI heads' (50 ROIs of 14x14 at any canvas)."""
    pm = models[False][1]
    flops = [inference_flops(pm, (1, s, s, 3)) for s in (64, 128, 256)]
    # per-pixel part p and fixed part f: flops = f + p * (s / 64) ** 2
    p = (flops[2] - flops[1]) / 12
    assert p > 1e7 and flops[1] - flops[0] == pytest.approx(3 * p, rel=0.05)
    s2d = models[True][1]
    assert inference_flops(s2d, (1, 17, 17, 48)) == inference_flops(
        s2d, (1, 17, 17, 48), input_dtype=torch.uint8, canvas_hw=(64, 64))


def test_export_cli_on_the_cpu(tmp_path, capsys):
    """``tools/export_model.py --device cpu --serving-u8 --tight landscape``
    on a tiny serving config: the artifact runs, and the line names its
    size, input and GFLOPs."""
    from centermask2_tpu_torch.tools import export_model

    out = tmp_path / "serving.pt2"
    export_model.main([
        "--device", "cpu", "--config-file",
        "configs/centermask/zy_model_serving.yaml", "--out", str(out),
        "--serving-u8", "--tight", "landscape",
        "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE", "MODEL.FPN.OUT_CHANNELS",
        "32", "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
        "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8", "TPU.FIXED_EDGE_SIZE", "64",
        "INPUT.MIN_SIZE_TEST", "32", "INPUT.MAX_SIZE_TEST", "64",
        "TPU.COMPUTE_DTYPE", "float32"])
    line = capsys.readouterr().out
    assert "uint8 s2d input (1, 9, 17, 48) + valid_hw, canvas (64, 64)" in line
    assert "GFLOP" in line and " MB)" in line
    fn = load_serialized(str(out))
    x = torch.from_numpy(np.random.RandomState(3).randint(
        0, 256, (1, 9, 17, 48)).astype(np.uint8))
    res = fn(x, torch.tensor([[30, 61]], dtype=torch.int32))
    assert res.pred_masks.shape[:2] == res.valid.shape
    assert res.pred_keypoints is None
    assert all(torch.isfinite(t).all() for t in res[:7]
               if t.is_floating_point())
