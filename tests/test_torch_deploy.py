"""Port parity of the deployment toolchain against the JAX package's, on
the CPU: the bin contract (``data/bin_io.py``, byte for byte), the bin
CLIs (``tools/preprocess_to_bin.py`` byte-equal to the repository's
tool on a tiny COCO set; ``tools/postprocess_bins.py`` printing the JAX
tool's AP strings for the same synthesized dumps), ``parity_check`` and
``measure`` on a tiny f32 config (parameter counts and bytes equal to
``centermask2_tpu/utils/measures.py``'s), a JAX ``check_layers`` dump
against the port's of the same parameters (every layer above cosine
1 - 1e-5, by name), ``convert_weights`` on a reference-keyed ``.pth``
(full coverage) and ``infer`` taking the converted checkpoint
(records equal to those from the ``.pth``), ``visualize``, and the
native s2d packer bit-equal to the port's numpy pack and to the JAX
package's pass. Tiny models: V-19-slim, FPN 32, f32.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.data import bin_io as jbin  # noqa: E402
from centermask2_tpu.data import preprocess as jpre  # noqa: E402
from centermask2_tpu_torch.data import bin_io  # noqa: E402
from centermask2_tpu_torch.data import preprocess as tpre  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "configs/centermask/zy_model_config.yaml")
# a V-19-slim of few channels in f32, with the tools' narrowest canvas
TINY = ["MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE", "MODEL.FPN.OUT_CHANNELS",
        "32", "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
        "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8", "MODEL.FCOS.NUM_CLASSES", "4",
        "TPU.FIXED_EDGE_SIZE", "64", "MODEL.FCOS.PRE_NMS_TOPK_TEST", "20",
        "MODEL.FCOS.POST_NMS_TOPK_TEST", "5", "TPU.NMS_CANDIDATES", "20",
        "TPU.COMPUTE_DTYPE", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str):
    """The repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(tool, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [tool.__file__] + list(argv))
    tool.main()


@pytest.fixture(scope="module")
def tiny_coco(tmp_path_factory):
    """Two PIL images with one box each (tests/test_cli.py::tiny_coco)."""
    from PIL import Image, ImageDraw

    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    images, anns = [], []
    for i in range(2):
        w, h = 300, 260
        im = Image.new("RGB", (w, h), (30 + 60 * i, 90, 140))
        d = ImageDraw.Draw(im)
        x0, y0, bw, bh = 40 + 30 * i, 50, 120, 90
        d.rectangle([x0, y0, x0 + bw, y0 + bh], fill=(220, 60 + 80 * i, 40))
        im.save(root / "images" / f"{i:012d}.jpg")
        images.append({"id": i, "file_name": f"{i:012d}.jpg",
                       "width": w, "height": h})
        anns.append({
            "id": i + 1, "image_id": i, "category_id": 1,
            "bbox": [x0, y0, bw, bh], "area": bw * bh, "iscrowd": 0,
            "segmentation": [[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh,
                              x0, y0 + bh]]})
    with open(root / "ann.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "thing"}]}, f)
    return root


# ------------------------------------------------------------ bin contract
def _six(rng, n):
    return [rng.randn(n, 2).astype(np.float32),
            rng.rand(n).astype(np.float32),
            (rng.rand(n, 4) * 1300).astype(np.float32),
            rng.randint(0, 80, n).astype(np.int32),  # the model's int32
            rng.rand(n, 1, 28, 28).astype(np.float32),
            rng.rand(n).astype(np.float32)]


@pytest.mark.parametrize("n", [0, 1, 50])
def test_bin_files_byte_equal_to_jax(tmp_path, n):
    """Input and output bins: the port's files equal JAX's byte for byte,
    ``pred_classes`` widened to int64 in the file, and each reader reads
    the other's files back."""
    rng = np.random.RandomState(n)
    image = (rng.rand(64, 64, 3) * 255 - 110).astype(np.float32)
    for mod, d in ((bin_io, "t"), (jbin, "j")):
        (tmp_path / d).mkdir()
        mod.write_input_bin(image, str(tmp_path / d / "x.bin"))
        mod.write_output_bins(_six(np.random.RandomState(7), n),
                              str(tmp_path / d / "x"))
    for f in ["x.bin"] + [f"x_{i}.bin" for i in range(1, 7)]:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    assert (tmp_path / "t" / "x_4.bin").stat().st_size == 8 * n
    np.testing.assert_array_equal(
        bin_io.read_input_bin(str(tmp_path / "j" / "x.bin"), 64), image)
    ours = bin_io.read_output_bins(str(tmp_path / "j" / "x"))
    theirs = jbin.read_output_bins(str(tmp_path / "t" / "x"))
    for a, b, dt in zip(ours, theirs, bin_io.OUTPUT_DTYPES):
        assert a.dtype == b.dtype == dt
        np.testing.assert_array_equal(a, b)
    os.unlink(tmp_path / "t" / "x_3.bin")
    assert bin_io.read_output_bins(str(tmp_path / "t" / "x")) is None
    assert bin_io.bin_manifest(str(tmp_path / "t"), 64, 64) == \
        jbin.bin_manifest(str(tmp_path / "t"), 64, 64)
    with pytest.raises(ValueError, match="6 tensors"):
        bin_io.write_output_bins(_six(rng, n)[:5], str(tmp_path / "y"))


def test_preprocess_to_bin_byte_equal_to_jax_tool(tiny_coco, tmp_path,
                                                  monkeypatch):
    from centermask2_tpu_torch.tools import preprocess_to_bin

    args = ["--ann", str(tiny_coco / "ann.json"),
            "--image-root", str(tiny_coco / "images")]
    _run_jax_main(_jax_tool("preprocess_to_bin"),
                  args + ["--out", str(tmp_path / "j")], monkeypatch)
    preprocess_to_bin.main(args + ["--out", str(tmp_path / "t")])
    names = sorted(os.listdir(tmp_path / "t"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert names == ["000000000000.bin", "000000000001.bin", "bin_info.txt"]
    for f in names[:2]:
        data = (tmp_path / "t" / f).read_bytes()
        assert len(data) == 4 * 3 * 1344 * 1344
        assert data == (tmp_path / "j" / f).read_bytes(), f
    assert (tmp_path / "t" / "bin_info.txt").read_text() == \
        (tmp_path / "j" / "bin_info.txt").read_text().replace(
            str(tmp_path / "j"), str(tmp_path / "t"))


def test_postprocess_bins_prints_jax_ap_strings(tiny_coco, tmp_path,
                                                monkeypatch, capsys):
    """Dumps synthesized as tests/test_cli.py::test_bin_pipeline_cli
    makes them (a detection on each ground-truth box, in network
    coordinates, plus a stray one), one image's bins missing in a second
    directory: both tools print the same lines."""
    from centermask2_tpu_torch.tools import postprocess_bins

    ann = json.loads((tiny_coco / "ann.json").read_text())
    rng = np.random.RandomState(3)
    for d in ("all", "one_missing"):
        (tmp_path / d).mkdir()
    for im in ann["images"]:
        x, y, w, h = next(a for a in ann["annotations"]
                          if a["image_id"] == im["id"])["bbox"]
        scale = 800.0 / min(im["height"], im["width"])
        boxes = np.array([[x * scale, y * scale, (x + w) * scale,
                           (y + h) * scale], [10, 20, 300, 200]], np.float32)
        outs = [rng.rand(2, 2).astype(np.float32) * 800,
                np.array([0.9, 0.4], np.float32), boxes,
                np.array([0, 0], np.int32),
                (rng.rand(2, 1, 28, 28) > 0.3).astype(np.float32),
                np.array([0.8, 0.6], np.float32)]
        stem = os.path.splitext(im["file_name"])[0]
        for d in ("all", "one_missing"):
            if d == "all" or im["id"] == 0:
                bin_io.write_output_bins(outs, str(tmp_path / d / stem))
    jtool = _jax_tool("postprocess_bins")
    for d in ("all", "one_missing"):
        args = ["--ann", str(tiny_coco / "ann.json"),
                "--bin-dir", str(tmp_path / d)]
        _run_jax_main(jtool, args, monkeypatch)
        want = capsys.readouterr().out
        postprocess_bins.main(args)
        got = capsys.readouterr().out
        assert got == want
        assert "== bbox ==" in got and "== segm ==" in got
        assert ("1 images missing bins (skipped)" in got) == (
            d == "one_missing")
    ap = float(want.split("== bbox ==")[1].splitlines()[1]
               .split("AP=")[1].split(",")[0])
    assert ap > 0.0


# ------------------------------------------------------ parity and measure
def test_parity_check_and_measure_on_the_cpu(capsys):
    """The ladder at 64x64 passes; ``measure`` counts the parameters and
    their bytes as the JAX package counts its ``params`` collection, and
    its FLOPs of the whole inference equal ``inference_flops``."""
    from centermask2_tpu.config import get_cfg as jax_cfg
    from centermask2_tpu.models import build_centermask as jax_build
    from centermask2_tpu.utils.measures import count_params as jcount
    from centermask2_tpu.utils.measures import param_bytes as jbytes
    from centermask2_tpu_torch import build_centermask, get_cfg
    from centermask2_tpu_torch.export import inference_flops
    from centermask2_tpu_torch.tools import measure, parity_check

    assert parity_check.main(["--device", "cpu", "--config-file", CONFIG]
                             + TINY) == 0
    out = capsys.readouterr().out
    assert "PARITY OK" in out
    rows = out.splitlines()[1:8]
    assert [r.split()[0] for r in rows] == list(parity_check.OUTPUTS)

    measure.main(["--device", "cpu", "--config-file", CONFIG] + TINY)
    out = capsys.readouterr().out
    n, b = out.split("[")[1].split(" parameters, ")
    cfg = jax_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(TINY)
    jm = jax_build(cfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3))))
    assert int(n) == jcount(shapes["params"])
    assert int(b.split(" bytes]")[0]) == jbytes(shapes["params"])
    tcfg = get_cfg()
    tcfg.merge_from_file(CONFIG)
    tcfg.merge_from_list(TINY)
    flops = inference_flops(build_centermask(tcfg, device="cpu"),
                            (1, 64, 64, 3))
    assert f"full inference: {flops / 1e9:.1f} GFLOP [{flops}]" in out
    assert "peak device memory not measured on cpu" in out


# ------------------------------------------------------------ check_layers
def test_check_layers_jax_dump_compares_clean(tmp_path, capsys):
    """The JAX tool's dump (``capture_intermediates``, its
    ``flatten_intermediates``) and the port's CLI dump of the same
    parameters (through ``load_jax_params``, saved as a converted
    checkpoint and given to ``--weights``) compare clean by name:
    ``compare`` exits 0, every shared layer above 1 - 1e-5, and the keys
    of one dump only are the documented ones."""
    from centermask2_tpu.config import get_cfg as jax_cfg
    from centermask2_tpu.models import build_centermask as jax_build
    from centermask2_tpu_torch import build_centermask, get_cfg
    from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params
    from centermask2_tpu_torch.checkpoint.torch_io import save_checkpoint
    from centermask2_tpu_torch.tools import check_layers

    jtool = _jax_tool("check_layers")
    cfg = jax_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(TINY)
    jm = jax_build(cfg)
    x = jnp.asarray(np.random.RandomState(0).randn(1, 64, 64, 3)
                    .astype(np.float32) * 30)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x)
    _, state = jm.apply(variables, x, capture_intermediates=True,
                        mutable=["intermediates"])
    flat = jtool.flatten_intermediates(
        jax.tree.map(np.asarray, state["intermediates"]))
    flat = {k: v for k, v in flat.items()
            if v.dtype != object and v.dtype.kind in "fiub"}
    np.savez_compressed(tmp_path / "jax.npz", **flat)

    tcfg = get_cfg()
    tcfg.merge_from_file(CONFIG)
    tcfg.merge_from_list(TINY)
    port = build_centermask(tcfg, device="cpu")
    load_jax_params(port, jax.tree.map(np.asarray, variables["params"]))
    save_checkpoint(str(tmp_path / "ckpt"), {"model": port.state_dict(),
                                             "step": 0}, 0)
    assert check_layers.main(
        ["dump", "--out", str(tmp_path / "port.npz"), "--device", "cpu",
         "--weights", str(tmp_path / "ckpt"), "--config-file", CONFIG]
        + TINY) == 0
    capsys.readouterr()
    assert check_layers.main(["compare", str(tmp_path / "jax.npz"),
                              str(tmp_path / "port.npz"), "--show",
                              "1000"]) == 0
    out = capsys.readouterr().out
    n_cmp = int(out.split(" layers compared")[0])
    assert n_cmp > 200
    only = [ln.split(": ", 1)[1] for ln in out.splitlines()
            if ln.startswith("  only in")]
    assert only and all(
        "/ese/fc/__call__[0][" in k or "/gn/__call__[" in k for k in only)
    assert "0 layers below cosine threshold" in out
    for key in ("__call__[0][2]", "backbone/stem_1/conv/__call__[0]",
                "fpn/__call__[0]/p3", "fcos_head/__call__[0][0][4]",
                "fcos_head/cls_tower/conv0/__call__[4]",
                "roi_heads/__call__[0]/pred_masks"):
        assert f"  {key}" in out, key


def test_compare_flags_drift_and_shape(tmp_path, capsys):
    from centermask2_tpu_torch.tools import check_layers

    a = {"x/__call__[0]": np.ones((2, 3), np.float32),
         "y/__call__[0]": np.arange(4.0), "z/__call__[0]": np.ones(3)}
    b = dict(a, **{"y/__call__[0]": -np.arange(4.0),
                   "z/__call__[0]": np.ones(4)})
    np.savez(tmp_path / "a.npz", **a)
    np.savez(tmp_path / "b.npz", **b)
    assert check_layers.main(["compare", str(tmp_path / "a.npz"),
                              str(tmp_path / "b.npz")]) == 1
    out = capsys.readouterr().out
    assert "-1.000000" in out and "y/__call__[0] <-- DRIFT" in out
    assert "z/__call__[0] <-- DRIFT" in out
    assert "2 layers below cosine threshold" in out


def test_compare_fails_on_a_tower_output_of_one_dump(tmp_path, capsys):
    """A tower norm's output in one dump only (a dump on the card, where
    kernel 3 writes none) is counted apart and passes; an FCOS tower's
    output in one dump only fails the comparison."""
    from centermask2_tpu_torch.tools import check_layers

    one = np.ones((1, 2, 2, 4), np.float32)
    full = {"x/__call__[0]": one, "fcos_head/cls_tower/__call__[0]": one,
            "fcos_head/cls_tower/norm0/__call__[0]": one}
    card = {k: v for k, v in full.items() if "/norm0/" not in k}
    lost = {"x/__call__[0]": one}
    for name, d in (("full", full), ("card", card), ("lost", lost)):
        np.savez(tmp_path / f"{name}.npz", **d)
    assert check_layers.main(["compare", str(tmp_path / "full.npz"),
                              str(tmp_path / "card.npz")]) == 0
    out = capsys.readouterr().out
    assert "1 only in one dump (1 of them FCOS tower norms)" in out
    assert check_layers.main(["compare", str(tmp_path / "full.npz"),
                              str(tmp_path / "lost.npz")]) == 1
    out = capsys.readouterr().out
    assert "1 FCOS tower outputs in one dump only, e.g. " \
        "fcos_head/cls_tower/__call__[0]" in out
    assert "0 layers below cosine threshold" in out


# ------------------------------------------------ convert, infer, visualize
def test_convert_weights_and_infer_take_the_converted_file(
        tiny_coco, tmp_path, capsys):
    """The AP-parity drill in the port's terms, on synthetic data: a
    reference-keyed ``.pth`` (tests/test_cli.py::test_ap_parity_drill)
    converts with full coverage, and ``infer --weights`` gives the same
    records from the converted checkpoint as from the ``.pth``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_e2e_torch import _make_state_dict

    from centermask2_tpu_torch.tools import convert_weights, infer

    sd = _make_state_dict(np.random.RandomState(11), num_classes=1)
    pth = tmp_path / "drill.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}},
               str(pth))
    opts = ["MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE",
            "MODEL.FCOS.NUM_CLASSES", "1", "TPU.COMPUTE_DTYPE", "float32",
            "TPU.FIXED_EDGE_SIZE", "64", "INPUT.MIN_SIZE_TEST", "32",
            "INPUT.MAX_SIZE_TEST", "60", "TPU.NMS_CANDIDATES", "50",
            "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"]
    convert_weights.main(["--pth", str(pth), "--config-file", CONFIG,
                          "--out", str(tmp_path / "ckpt"), "--device",
                          "cpu"] + opts)
    out = capsys.readouterr().out
    assert "missing: 0" in out and "unused torch keys" not in out, out
    assert f"{len(sd)} torch keys" in out
    assert (tmp_path / "ckpt" / "step_0" / "state.pt").exists()
    records = {}
    for name, weights in (("pth", pth), ("converted", tmp_path / "ckpt")):
        infer.main(["--device", "cpu", "--config-file", CONFIG,
                    "--ann", str(tiny_coco / "ann.json"),
                    "--image-root", str(tiny_coco / "images"),
                    "--weights", str(weights), "--output-dir",
                    str(tmp_path / name)] + opts)
        records[name] = json.loads(
            (tmp_path / name / "coco_instances_results.json").read_text())
    assert records["pth"] and records["pth"] == records["converted"]


def test_visualize_writes_its_two_images(tiny_coco, tmp_path, capsys):
    from PIL import Image

    from centermask2_tpu_torch.tools import visualize

    out = tmp_path / "vis.png"
    visualize.main(["--device", "cpu", "--image",
                    str(tiny_coco / "images" / "000000000000.jpg"),
                    "--config-file", CONFIG, "--output", str(out),
                    "--score-thresh", "0.0"] + TINY + [
                        "TPU.FIXED_EDGE_SIZE", "128", "INPUT.MIN_SIZE_TEST",
                        "64", "INPUT.MAX_SIZE_TEST", "96",
                        "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"])
    line = capsys.readouterr().out
    padded = tmp_path / "vis_padded.png"
    assert f"wrote {out} with " in line and str(padded) in line
    assert Image.open(out).size == (300, 260)
    assert Image.open(padded).size == (128, 128)


# ------------------------------------------------------ native s2d packer
SHAPES = [(800, 1333), (1333, 800), (37, 61), (61, 37), (1, 1), (64, 64)]


@pytest.mark.parametrize("hw", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_native_pack_bit_equal_to_numpy_and_jax(hw):
    """``s2d_pack_u8`` (square and rectangular canvases, the tight canvas
    of each orientation, odd sizes) and ``s2d_preprocess`` (uint8 and
    float32 images) from the native pass: bit-equal to the port's numpy
    versions and to the JAX package's own pass."""
    h, w = hw
    rng = np.random.RandomState(h * 7 + w)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    fixed = 1344 if max(h, w) > 64 else 64
    cases = [
        (tpre.s2d_pack_u8, tpre.s2d_pack_u8_plain, jpre.s2d_pack_u8,
         (img, fixed)),
        (tpre.s2d_pack_u8, tpre.s2d_pack_u8_plain, jpre.s2d_pack_u8,
         (img, tpre.s2d_serving_canvas(h, w, fixed, min(800, fixed)))),
        (tpre.s2d_pack_u8_tight, None, jpre.s2d_pack_u8_tight, (img, fixed)),
        (tpre.s2d_pack_u8, tpre.s2d_pack_u8_plain, jpre.s2d_pack_u8,
         (img[:, :, :1].copy(), (fixed, fixed + 4))),
        (tpre.s2d_preprocess, tpre.s2d_preprocess_plain, jpre.s2d_preprocess,
         (img, fixed)),
        (tpre.s2d_preprocess, tpre.s2d_preprocess_plain, jpre.s2d_preprocess,
         (img.astype(np.float32) + rng.rand(h, w, 3).astype(np.float32),
          fixed))]
    for native, plain, theirs, args in cases:
        got = native(*args)
        want = theirs(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), native.__name__
        if plain is not None:
            assert got.tobytes() == plain(*args).tobytes()


def test_native_pack_refuses_what_jax_refuses():
    img = np.zeros((40, 40, 17), np.uint8)
    for fn in (tpre.s2d_pack_u8, tpre.s2d_pack_u8_plain):
        with pytest.raises(ValueError, match="C <= 16"):
            fn(img, 64)
        with pytest.raises(ValueError, match="divisible by 4"):
            fn(img[:, :, :3], (64, 62))
        with pytest.raises(ValueError, match="exceeds"):
            fn(img[:, :, :3], 32)
    with pytest.raises(ValueError, match="C <= 16"):
        tpre.s2d_preprocess(img, 64)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises: there is no fallback to numpy."""
    bad = tmp_path / "s2d.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tpre, "_S2D_SRC", bad)
    monkeypatch.setattr(tpre, "_S2D_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tpre.s2d_pack_u8(np.zeros((8, 8, 3), np.uint8), 64)


def test_chip_peak_flops_by_device_name(monkeypatch):
    """The H100's published dense bf16 peaks by ``get_device_name``; 0.0
    for the CPU and for a card the table does not know."""
    from centermask2_tpu_torch.utils import measures

    assert measures.chip_peak_flops("cpu") == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, peak in (("NVIDIA H100 80GB HBM3", 989e12),
                       ("NVIDIA H100 PCIe", 756e12),
                       ("NVIDIA A100-SXM4-80GB", 0.0)):
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda d=None, n=name: n)
        assert measures.chip_peak_flops() == peak
        assert measures.chip_peak_flops("cuda:0") == peak
