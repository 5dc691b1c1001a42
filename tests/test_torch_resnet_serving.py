"""ResNet trunks served from the uint8 s2d pack (TPU.S2D_STEM_INPUT): the
pack normalized on the device (``CenterMask._normalize_u8_s2d``) and the
layout undone before the stem (``backbones/resnet.py::s2d_to_image``).

- R-50 and R-101 at full width, on a 128x128 deployment canvas, served
  from ``s2d_pack_u8`` over the 96x128 tight canvas, padded back and in
  tight compute, are bit-equal to the same model on
  ``single_preprocessing``'s f32 canvas (its top-left block in tight
  compute), in f32 and in bf16 (weights of the benchmark's recipe,
  ``benchmark/harness/weights.py``, which keep every layer at the scale
  of its input);
- the f32 canvas agrees with JAX's ``build_centermask`` at
  ``test_whole_slice_matches_jax``'s tolerances
  (``test_torch_backbones.py::whole_model_parity``), and the uint8 pack
  equals it on the same parameters;
- the uint8 pack agrees with the benchmark's plain reference
  (``benchmark/reference/model.py``) at the numbers that
  ``benchmark/harness/compare.py`` reads, to float32 rounding;
- a captured program (``FakeGraphs``) writes its six section stamps a
  replay, with the layout undone before the ``stem`` stamp;
- the R-50 yaml with the s2d input runs through ``tools/infer.py
  --tight-compute`` and ``tools/export_model.py --serving-u8``.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_backbones import (CONFIGS, R50_CLI_OPTS, _configs,  # noqa: E402
                                  whole_model_parity)

from centermask2_tpu_torch import build_centermask  # noqa: E402
from centermask2_tpu_torch.data.preprocess import (  # noqa: E402
    s2d_pack_u8, s2d_serving_canvas, single_preprocessing)

FIXED, SHORT = 128, 96
IMAGE_HW = (90, 120)  # the resized image: tight canvas 96x128
YAMLS = {50: "centermask_R_50_FPN_ms_3x.yaml",
         101: "centermask_R_101_FPN_ms_3x.yaml"}
OPTS = ["TPU.FIXED_EDGE_SIZE", str(FIXED), "MODEL.FCOS.POST_NMS_TOPK_TEST",
        "10"]
SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(seed=6):
    return np.random.RandomState(seed).randint(
        0, 256, (*IMAGE_HW, 3)).astype(np.uint8)


def _build(depth, dtype, s2d):
    _, cfg = _configs(YAMLS[depth], OPTS + [
        "TPU.COMPUTE_DTYPE", dtype, "TPU.S2D_STEM_INPUT", str(s2d)])
    return build_centermask(cfg, device="cpu")


def _recipe_weights(model):
    from benchmark.harness import weights

    return weights.make(weights.recipe(model), SEED, torch.device("cpu"))


def _requests(img):
    """(u8 pack, valid_hw, canvas_hw, the f32 canvas it equals): the tight
    pack padded back to the deployment canvas, then in tight compute."""
    tight = s2d_serving_canvas(*img.shape[:2], FIXED, SHORT)
    assert tight == (96, 128)
    pack = torch.from_numpy(s2d_pack_u8(img, tight))
    hw = torch.tensor([img.shape[:2]], dtype=torch.int32)
    canvas = torch.from_numpy(single_preprocessing(img, FIXED)[None])
    return [(pack, hw, (FIXED, FIXED), canvas),
            (pack, hw, None, canvas[:, :tight[0], :tight[1]].contiguous())]


def _assert_equal(got, want):
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("depth", [50, 101])
def test_u8_pack_is_bit_equal_to_the_f32_canvas(depth, dtype):
    plain, s2d = _build(depth, dtype, False), _build(depth, dtype, True)
    assert s2d.s2d_input and not plain.s2d_input
    w = _recipe_weights(plain)
    plain.load_state_dict(w, strict=True)
    s2d.load_state_dict(w, strict=True)
    for pack, hw, canvas_hw, canvas in _requests(_image()):
        want = plain.inference(canvas)
        got = s2d.inference(pack, None, hw, canvas_hw)
        assert int(want.valid.sum()) > 3
        _assert_equal(got, want)


@pytest.mark.parametrize("depth", [50, 101])
def test_f32_canvas_matches_jax_and_the_u8_pack(depth):
    """JAX's and the port's model on the f32 canvas at JAX parity's
    tolerances; the port's s2d twin on the uint8 pack, padded back,
    bit-equal to it."""
    img = _image()
    pack, hw, canvas_hw, canvas = _requests(img)[0]
    port = whole_model_parity(YAMLS[depth], OPTS + ["TPU.COMPUTE_DTYPE",
                                                    "float32"],
                              img=canvas.numpy())
    s2d = _build(depth, "float32", True)
    s2d.load_state_dict(port.state_dict(), strict=True)
    _assert_equal(s2d.inference(pack, None, hw, canvas_hw),
                  port.inference(canvas))


@pytest.mark.parametrize("depth", [50, 101])
def test_u8_pack_matches_the_reference(depth):
    """The benchmark's float32 reference on the seed's recipe weights: the
    same detections, and the teacher-forced numbers of the comparison at
    float32 rounding, padded back and in tight compute."""
    from benchmark.harness import compare
    from benchmark.harness.spec import program_cfg
    from benchmark.reference.model import Reference, exact_f32
    from benchmark.tests.helpers import TINY_LIMITS
    from benchmark.tools.make_config import plain

    from centermask2_tpu_torch.config import get_cfg

    s2d = _build(depth, "float32", True)
    w = _recipe_weights(s2d)
    s2d.load_state_dict(w, strict=True)
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(CONFIGS, YAMLS[depth]))
    cfg.merge_from_list(OPTS + ["TPU.COMPUTE_DTYPE", "float32",
                                "TPU.S2D_STEM_INPUT", "True"])
    conf = plain(cfg)
    assert program_cfg({"cfg": conf}) == cfg
    img = _image()
    with exact_f32(), torch.no_grad():
        ref = Reference(conf).load(w)
        for pack, hw, canvas_hw, canvas in _requests(img):
            out = s2d.inference(pack, None, hw, canvas_hw)
            served = {k: v for k, v in out._asdict().items()
                      if v is not None}
            hw_canvas = tuple(canvas.shape[1:3])
            g = compare.gaps(ref, served, torch.from_numpy(img), hw_canvas,
                             TINY_LIMITS)
            own = ref.serve(torch.from_numpy(img), hw_canvas)
            assert torch.equal(out.valid[0], own["valid"])
            assert int(own["valid"].sum()) > 3
            assert max(g["score_gap"], g["box_gap"], g["mask_gap"],
                       g["mask_score_gap"]) < 1e-4, g
            assert g["valid_gap"] == 0 and g["set_gap"] == 0
            assert g["judged"] > 0 and g["overlap"] <= 0.6


def test_captured_u8_program_stamps_after_the_unpack(monkeypatch):
    """A narrow R-50 u8 program through ``CapturedInference`` over fake
    graphs: one ring row of six stamps a replay, each call's layout undone
    before its ``stem`` stamp; the replays equal the eager requests."""
    from test_torch_backbones import RESNET_OPTS, SMALL_OPTS
    from test_torch_captured import FakeGraphs

    from centermask2_tpu_torch.export import CapturedInference
    from centermask2_tpu_torch.models.backbones import resnet
    from centermask2_tpu_torch.utils import tracing

    tracing.reset()
    _, cfg = _configs(YAMLS[50], SMALL_OPTS + RESNET_OPTS + [
        "TPU.FIXED_EDGE_SIZE", str(FIXED), "TPU.S2D_STEM_INPUT", "True"])
    model = build_centermask(cfg, device="cpu")
    model.load_state_dict(_recipe_weights(model), strict=True)
    order = []
    unpack, mark = resnet.s2d_to_image, tracing.mark

    def logged_unpack(x):
        order.append("unpack")
        return unpack(x)

    def logged_mark(name):
        order.append(name)
        mark(name)

    monkeypatch.setattr(resnet, "s2d_to_image", logged_unpack)
    monkeypatch.setattr(tracing, "mark", logged_mark)
    prog = CapturedInference(model, graphs=FakeGraphs())
    calls = 4
    try:
        for i in range(calls):
            pack, hw, canvas_hw, _ = _requests(_image(10 + i))[i % 2]
            got = prog(pack, None, hw, canvas_hw)
            want = model.inference(pack, None, hw, canvas_hw)
            _assert_equal(got, want)
        rows = prog.ring.read()
        assert len(rows) == calls and rows[:, 1:].shape[1] == 6
        assert rows[:, 0].tolist() == [0, 1, 0, 1]
        assert (np.diff(rows[:, 1:], axis=1) >= 0).all()
    finally:
        tracing.reset()
    stamps = ["start", "unpack", "stem", "backbone", "fpn_head", "decode",
              "roi"]
    assert len(order) % len(stamps) == 0 and order[:7] == stamps
    assert order == stamps * (len(order) // len(stamps))


@pytest.mark.parametrize("cli", ["infer", "export"])
def test_r50_s2d_yaml_through_the_serving_entry_points(cli, tmp_path,
                                                       capsys):
    """The R-50 yaml with TPU.S2D_STEM_INPUT (narrow, a 64 canvas): the
    infer CLI in tight compute writes its metrics; the export CLI's
    uint8 programs, padded back and in tight compute, equal the eager
    requests output for output."""
    import json

    from centermask2_tpu_torch.tools import export_model, infer

    yaml = os.path.join(CONFIGS, YAMLS[50])
    opts = [*R50_CLI_OPTS, "TPU.S2D_STEM_INPUT", "True",
            "INPUT.MIN_SIZE_TEST", "32", "INPUT.MAX_SIZE_TEST", "60",
            "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"]
    if cli == "infer":
        from test_torch_evaluation import _png_dataset

        (tmp_path / "val").mkdir()
        ann = _png_dataset(tmp_path / "val", np.random.RandomState(0))
        infer.main(["--device", "cpu", "--config-file", yaml, "--ann",
                    str(ann), "--image-root",
                    str(tmp_path / "val" / "images"), "--output-dir",
                    str(tmp_path / "out"), "--tight-compute", *opts])
        assert {"bbox", "segm"} <= set(json.loads(
            (tmp_path / "out" / "metrics.json").read_text()))
        return
    from centermask2_tpu_torch.export import load_serialized

    _, cfg = _configs(YAMLS[50], opts)
    model = build_centermask(cfg, device="cpu", seed=0)
    assert model.s2d_input
    img = np.random.RandomState(5).randint(0, 256, (30, 60, 3)) \
        .astype(np.uint8)
    pack = torch.from_numpy(s2d_pack_u8(img, (32, 64)))
    hw = torch.tensor([[30, 60]], dtype=torch.int32)
    for extra, canvas_hw in (([], (64, 64)), (["--tight-compute"], None)):
        out = tmp_path / f"m{len(extra)}.pt2"
        export_model.main(["--device", "cpu", "--config-file", yaml, "--out",
                           str(out), "--serving-u8", "--tight", "landscape",
                           *extra, *opts])
        canvas = (32, 64) if extra else (64, 64)
        assert (f"uint8 s2d input (1, 9, 17, 48) + valid_hw, canvas "
                f"{canvas}") in capsys.readouterr().out
        got, want = load_serialized(str(out))(pack, hw), model.inference(
            pack, None, hw, canvas_hw)
        assert want.valid.any()
        _assert_equal(got, want)
