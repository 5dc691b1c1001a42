"""A CPU rehearsal of ``chip_smoke.py``'s ``[graphs]``, ``[serving]``,
``[eval]``, ``[export]`` and ``[train]`` phases at a tiny size: a narrow
V-19-slim model in f32 on canvases of 32-256 pixels, never the V-39.

As the smoke run's own rehearsal does, the ops route to ``_kernels``,
whose launches are replaced by the plain versions with the launch counts
kept (the ROIAlign backward included; kernel 2b's prepass check reads
the CPU oracle of its windows), and the CUDA-only calls
(synchronize, sync-debug mode, events, memory statistics, nvidia-smi)
are faked; the CUDA-graph timing runs only on the card (``timing``
off). The captured programs run through ``test_torch_captured.py``'s
``FakeGraphs`` (a replay reruns the Python with the launch counts put
back, as a graph's replay passes no launch function)."""

import numpy as np
import pytest
import torch

import chip_smoke
from centermask2_tpu_torch import get_cfg
from centermask2_tpu_torch.ops import _kernels
from centermask2_tpu_torch.ops import nms as nms_mod
from centermask2_tpu_torch.ops import roi_align as roi_mod
from centermask2_tpu_torch.ops.nms import greedy_keep_sorted_plain
from centermask2_tpu_torch.ops.roi_align import (multilevel_roi_align_plain,
                                                 roi_align_feature_grad_plain,
                                                 roi_tap_windows)

# the ops' own routes to the registered operators (the rehearsal fixture
# routes them to _kernels' functions instead)
OP_ROUTES = {(nms_mod, "_keep_sorted"): nms_mod._keep_sorted,
             (roi_mod, "_forward"): roi_mod._forward}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeEvent:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0

    def synchronize(self):
        pass


@pytest.fixture
def rehearsal(monkeypatch):
    def nms_plain(sboxes, svalid, thr):
        _kernels.nms_launches += 1
        return greedy_keep_sorted_plain(sboxes, svalid, thr)

    def roi_plain(*args):
        _kernels.roi_align_launches += 1
        return multilevel_roi_align_plain(*args)

    def roi_bwd_plain(*args):
        _kernels.roi_align_backward_launches += 1
        return roi_align_feature_grad_plain(*args)

    monkeypatch.setattr(_kernels, "nms_keep_sorted", nms_plain)
    monkeypatch.setattr(_kernels, "roi_align", roi_plain)
    monkeypatch.setattr(_kernels, "roi_align_backward", roi_bwd_plain)
    monkeypatch.setattr(_kernels, "roi_tap_windows", roi_tap_windows)
    monkeypatch.setattr(nms_mod, "_keep_sorted",
                        lambda b, v, t: _kernels.nms_keep_sorted(b, v, t))
    monkeypatch.setattr(
        roi_mod, "_forward",
        lambda f, b, i, lv, sc, o, s, aligned: _kernels.roi_align(
            f, b.float(), i.to(torch.int32), lv.to(torch.int32), sc, o, s,
            aligned))
    monkeypatch.setattr(
        roi_mod, "_backward",
        lambda g, b, i, lv, shapes, dt, sc, o, s, aligned:
        _kernels.roi_align_backward(g, b.float(), i.to(torch.int32),
                                    lv.to(torch.int32), shapes, dt, sc, o,
                                    s, aligned))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(chip_smoke, "card_line",
                        lambda: "CPU rehearsal, no card")
    _kernels.reset_launch_counts()
    yield
    _kernels.reset_launch_counts()


def _tiny_cfg(cfg):
    """``cfg`` narrowed to a V-19-slim of a few channels, in f32."""
    cfg.MODEL.VOVNET.CONV_BODY = "V-19-slim-eSE"
    cfg.MODEL.FCOS.NUM_CLASSES = 4
    cfg.MODEL.FPN.OUT_CHANNELS = 32
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 8
    cfg.MODEL.ROI_MASKIOU_HEAD.CONV_DIM = 8
    cfg.MODEL.FCOS.POST_NMS_TOPK_TEST = 10
    cfg.TPU.COMPUTE_DTYPE = "float32"
    return cfg


def test_serving_phase_rehearsal(rehearsal, capsys):
    model = chip_smoke.build_model(_tiny_cfg(chip_smoke.flagship_cfg()),
                                   "cpu")
    models = {"bfloat16": model, "float32": model}
    s2d_model, launches, per_level, errs = chip_smoke.serving(
        "cpu", models, _tiny_cfg(chip_smoke.serving_cfg()), fixed=64,
        short=32, shapes=((0, 60, 32), (1, 32, 60), (2, 32, 32)),
        timing=False)
    assert s2d_model.s2d_input
    # kernel 3 none on the CPU
    assert launches == {"nms": 6, "roi_align": 6, "group_norm_relu": 0}
    assert per_level == {"nms": 1, "roi_align": 1, "group_norm_relu": 0}
    assert errs == {"nms": 0, "roi_align": 0.0}
    out = capsys.readouterr().out
    assert "torch.equal to the host f32 s2d input" in out and ": True" in out
    assert "64x32 tight compute" in out and "32x32 tight compute" in out
    # each kernel held against its plain version on every request's inputs
    for what in ("f32 uint8 64x64 pad-back request",
                 "bf16 60x32 64x64 pad-back", "bf16 32x60 32x64 tight compute",
                 "bf16 32x32 32x32 tight compute", "per-level request 64x64"):
        assert f"nms {what}: N=" in out and "keep sets bit-equal" in out
        assert f"roi_align {what}: float" in out or \
            f"roi_align {what}: bfloat16" in out
    assert "f32 uint8 64x64 kernels vs plain scores" in out


def test_eval_phase_rehearsal(rehearsal, capsys):
    """Three runs eager on the CPU (the loop's default there, ``fn=
    model.inference``, the full pack), 4 launches each; tight compute and
    the pad-back tight pack through captured programs of 3 graphs (their
    3 canvases), the full pack through one of 1, 3 launches a graph (2
    warm-up requests and the capture); the timed runs over 12 images
    capture nothing more. Each request is postprocessed before the next
    (``pipeline_depth`` 0), since a fake replay rewrites its outputs on
    the host at once."""
    from test_torch_captured import FakeGraphs

    cfg = _tiny_cfg(chip_smoke.serving_cfg())
    model = chip_smoke.build_model(cfg, "cpu")
    shapes = ((128, 250), (250, 128), (128, 128), (128, 200))
    launches = chip_smoke.eval_phase(
        "cpu", model, fixed=256, min_size=128, max_size=250, shapes=shapes,
        sides=(20, 64, 110), timed_images=12, split_images=6,
        graphs=FakeGraphs(), pipeline_depth=0)
    assert launches == {"nms": 33, "roi_align": 33, "group_norm_relu": 0}
    out = capsys.readouterr().out
    assert "AP bbox 100.0000, segm 100.0000" in out
    assert ") of the default loop, the eager loop, the full pack and " \
        "their programs equal" in out and "eval: predictions (" in out
    for name, n in (("tight compute", 3), ("pad-back", 3), ("full pack", 1)):
        assert f"eval {name} program: {n} graphs (one a canvas met)" in out
    assert "every metric present and finite" in out
    assert "eval timed, captured, tight pack padded back: 12 images" in out
    assert "eval timed, eager, tight pack padded back: 12 images" in out
    assert "no capture in the window; captured and eager predictions " \
        "equal" in out
    split = [x for x in out.splitlines() if "eval host split" in x]
    assert len(split) == 1
    for part in ("evaluator", "postprocess", "preprocess", "request"):
        assert f" {part} " in split[0]


def test_graphs_phase_rehearsal(rehearsal, capsys):
    """``[graphs]`` at 64x64 and 96x64: per dtype and canvas, one launch
    of each kernel by the eager request, 3 at the first call (2 warm-up
    requests and the capture) and none at a replay; the replays equal the
    eager requests slot by slot; each call a row of the section ring with
    its canvas's program key; the plain chain's request beside the
    prepared one, held to it by the f32 gate, which refuses the prepared
    request with its fused convs' bias dropped."""
    from test_torch_captured import FakeGraphs

    cfg = _tiny_cfg(chip_smoke.flagship_cfg())
    model = chip_smoke.build_model(cfg, "cpu")
    own = {k: v.clone() for k, v in model.state_dict().items()}
    launches = chip_smoke.graphs_phase(
        "cpu", {"bfloat16": model, "float32": model}, cfg,
        canvases=((100, 64, 64), (103, 96, 64)), graphs=FakeGraphs())
    # the requests' drawn FrozenBN statistics are put back after them
    assert all(torch.equal(v, own[k]) for k, v in model.state_dict().items())
    # per dtype and canvas: 1 + 3, and the plain and prepared requests' 2
    assert launches == {"nms": 24, "roi_align": 24, "group_norm_relu": 0}
    out = capsys.readouterr().out
    for canvas in ("64x64", "96x64"):
        assert f"graph f32 {canvas} replay vs eager scores: max abs err " \
            "0.000e+00" in out
        assert f"graph f32 {canvas}: " in out
        assert out.count(f"graph f32 {canvas} plain chain: ") == 2
        assert out.count(f"graph f32 {canvas} control: the bias of the 19 "
                         "fused convs dropped, refused on ") == 2
    assert out.count(", gated at 1e-05\n") == 8
    assert out.count("kernels 1 and 2 launched once by the eager request, "
                     "3 times by the capture (2 warm-up requests + the "
                     "capture), not by a replay; the replay equals the eager "
                     "request slot by slot, every output bit-equal True") == 4
    assert out.count("graph f32: 2 graphs captured") == 2
    for key, canvas in enumerate(("64x64", "96x64")):  # the section ring
        assert out.count(f"{canvas} section ring: 3 ring rows for 3 calls, "
                         f"key {key}, stamps non-decreasing\n") == 2


def test_export_phase_rehearsal(rehearsal, capsys, monkeypatch):
    """``[export]`` on the CPU at 64x64: the two artifacts load and run,
    one launch of kernels 1 and 2 a call (the operators' CPU versions
    counted here as the kernels' launches), equal to the eager request.
    The ops call the registered operators, as they do on the card, so
    that the export traces them."""
    for (mod, name), fn in OP_ROUTES.items():
        monkeypatch.setattr(mod, name, fn)
    cfg = _tiny_cfg(chip_smoke.serving_cfg())
    s2d = chip_smoke.build_model(cfg, "cpu")
    nhwc = chip_smoke.build_model(_tiny_cfg(chip_smoke.flagship_cfg()), "cpu")

    def counted(plain, name):
        def call(*args):
            setattr(_kernels, name, getattr(_kernels, name) + 1)
            return plain(*args)
        return call

    monkeypatch.setattr(nms_mod, "greedy_keep_sorted_plain", counted(
        greedy_keep_sorted_plain, "nms_launches"))
    monkeypatch.setattr(roi_mod, "multilevel_roi_align_plain", counted(
        multilevel_roi_align_plain, "roi_align_launches"))
    launches = chip_smoke.export_phase("cpu", s2d, nhwc, fixed=64, short=32,
                                       image=(200, 32, 60))
    assert launches == {"nms": 2, "roi_align": 2, "group_norm_relu": 0}
    out = capsys.readouterr().out
    assert "uint8 s2d serving program, tight 32x64 padded back to 64x64: " \
        "input (1, 9, 17, 48) uint8" in out
    assert "f32-input 64x64 program: input (1, 64, 64, 3) float32" in out
    assert out.count("every output bit-equal to the eager request True") == 2


def test_train_phase_rehearsal(rehearsal, capsys):
    """``[train]`` at 64x64 with a narrow f32 model: the CLI's loop through
    the captured step (one launch of each kernel in each of its 3 warm-up
    steps and at the capture, none at a replay) and the eager one (one a
    step), the kernels held on captured inputs, the kernel step against
    the plain step, the captured f32 step against the eager one, the
    overfit, the checkpoint round trip into new objects and into the
    captured step's own."""
    from test_torch_captured import FakeGraphs, _state

    cfg = _tiny_cfg(chip_smoke.flagship_cfg())
    cfg.merge_from_list([
        "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
        "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "TPU.MAX_FG_PROPOSALS", "8", "TPU.MAX_GT_INSTANCES", "8"])
    launches, errs, row = chip_smoke.train_phase(
        "cpu", cfg, fixed=64, batch=2, n_gt=3, warmup=1, timed=2,
        overfit=6, sides=(8, 40), roi_rc=(24, 8), timing=False,
        graphs=lambda m, o, s: FakeGraphs(_state(m, o, s)))
    # the captured loop (3 warm-up steps, the capture, 2 replays): 4; the
    # eager loop of 3 steps: 3; the captured overfit of 6 steps: 4
    assert launches == {"nms": 11, "roi_align": 11, "roi_align_backward": 11,
                        "group_norm_relu": 0}
    assert errs == {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    assert row is None
    out = capsys.readouterr().out
    assert "captured: one launch of nms, roi_align and roi_align_backward " \
        "in each of the 3 eager warm-up steps and at the capture" in out
    for what in ("bf16 train step", "f32 train step"):
        assert f"nms {what}: N=" in out and "keep sets bit-equal" in out
        assert f"roi_align_backward {what}: float32" in out
    # kernel 2b's synthetic cases, each in both dtypes: launched twice,
    # bit-equal, its windows equal to the oracle's
    bwd = [line for line in out.splitlines()
           if "roi_align_backward synthetic" in line]
    assert len(bwd) == 2 * len(chip_smoke.ROI_BWD_CASES)
    assert all("two launches bit-equal; prepass windows equal to the CPU "
               "oracle's" in line for line in bwd)
    for what in ("P5 ROIs, levels [2]: bfloat16",
                 "none ROIs, levels []: float32 R=0 C=8",
                 "outside ROIs", "(0 nonempty)", "stacked ROIs, levels [0]",
                 "float32 R=24 C=200 o=7 s=2", "bfloat16 R=24 C=200 o=14 s=1",
                 "float32 R=24 C=8 o=5 s=3"):
        assert what in out
    assert "(a replay) under sync-debug mode 'error', inputs on the " \
        "device: no host sync" in out
    assert "f32 train step captured vs eager: the capture and 1 replay(s) " \
        "after 3 eager warm-up steps, each from the eager run's state " \
        "before it: losses and all" in out and "bit-equal;" in out
    assert "f32 train step, kernels vs plain: " in out
    assert "largest difference between the two kernel runs 0.0e+00" in out
    assert "checkpoint round trip on the card" in out
    assert "restored into the captured step's own tensors" in out


def test_train_batch_format():
    """The synthetic batch has ``train_batches``' keys, shapes and types,
    boxes of the asked sizes inside the valid image, and patches of the
    three shapes."""
    from centermask2_tpu_torch.data.coco import BATCH_KEYS

    b = chip_smoke.make_train_batch(1, 2, 256, 20, 100, sides=(16, 200))
    assert set(b) == set(BATCH_KEYS)
    assert b["image"].shape == (2, 256, 256, 3) and \
        b["image"].dtype == np.float32
    assert b["gt_boxes"].shape == (2, 100, 4)
    assert b["gt_mask_patches"].shape == (2, 100, 112, 112)
    assert b["gt_valid"].sum(axis=1).tolist() == [20, 20]
    v = b["gt_boxes"][b["gt_valid"]]
    wh = v[:, 2:] - v[:, :2]
    assert wh.min() >= 16 - 1e-3 and wh.max() <= 200 + 1e-3
    h, w = b["image_size"][:, 0], b["image_size"][:, 1]
    for i in range(2):
        bx = b["gt_boxes"][i][b["gt_valid"][i]]
        assert (bx[:, 2] <= w[i]).all() and (bx[:, 3] <= h[i]).all()
    fill = b["gt_mask_patches"][b["gt_valid"]].mean(axis=(1, 2))
    assert 0.2 < fill.min() and fill.max() < 1.0


def test_eval_dataset_covers_every_area_range(tmp_path):
    from centermask2_tpu_torch.evaluation import COCOGt

    ann = chip_smoke.make_coco_dataset(str(tmp_path))
    gt = COCOGt.from_json(ann)
    areas = [a["area"] for a in gt.dataset["annotations"]
             if not a["iscrowd"]]
    assert min(areas) < 32 ** 2 and max(areas) > 96 ** 2
    assert any(32 ** 2 <= a <= 96 ** 2 for a in areas)
    assert sum(a["iscrowd"] for a in gt.dataset["annotations"]) == 1
    assert len(gt.imgs) == 8
    canvases = {chip_smoke.serving_inputs(np.zeros((h, w, 3), np.uint8),
                                          1344, 800, "cpu")[2]
                for h, w in chip_smoke.EVAL_SHAPES}
    assert canvases == {(800, 1344), (1344, 800), (800, 800)}
    assert get_cfg().TPU.FIXED_EDGE_SIZE == chip_smoke.FIXED


@pytest.mark.parametrize("name", sorted(chip_smoke.BACKBONES))
def test_backbone_configs_are_their_yamls(name):
    """``[backbones]`` builds its configs in Python (the card's machine may
    have no yaml package): each equals its yaml merged over the
    defaults."""
    import os

    build, yaml_name = chip_smoke.BACKBONES[name]
    want = get_cfg()
    want.merge_from_file(os.path.join(chip_smoke.REPO, "configs",
                                      "centermask", yaml_name))
    assert build() == want


def _tiny_backbone_cfg(cfg):
    """A ``[backbones]`` config at narrow heads (the ResNets also at narrow
    trunks of their full depth), in f32, with the training capacities of
    the ``[train]`` rehearsal."""
    cfg.merge_from_list([
        "MODEL.FCOS.NUM_CLASSES", "4", "MODEL.FPN.OUT_CHANNELS", "32",
        "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
        "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8",
        "MODEL.FCOS.POST_NMS_TOPK_TEST", "10", "TPU.COMPUTE_DTYPE", "float32",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
        "MODEL.RESNETS.WIDTH_PER_GROUP", "8",
        "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
        "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "TPU.MAX_FG_PROPOSALS", "8", "TPU.MAX_GT_INSTANCES", "8"])
    return cfg


def test_backbones_phase_rehearsal(rehearsal, capsys):
    """``[backbones]`` on the CPU at 64x64 and 96x64: R-50's requests
    eagerly and captured at both canvases (one launch of kernels 1 and 2
    an eager request, 3 at a capture, none at a replay; the replay equal
    to the eager request; the kernels held on its inputs), its f32 request
    at the first canvas, the eval entry point over 3 images (one graph),
    its training captured and eager with the frozen stages unchanged and
    the f32 step against the plain versions; one request each of R-101,
    MobileNetV2 and the two depthwise VoVNets; R-50 and R-101 from the
    uint8 pack, at its own canvas and at its tight canvas, bit-equal to
    the f32 host path. Each request's gate refuses the prepared request
    with its fused convs' bias dropped (MobileNetV2 fuses none)."""
    from test_torch_captured import FakeGraphs, _state

    cfgs = {n: _tiny_backbone_cfg(build())
            for n, (build, _) in chip_smoke.BACKBONES.items()}
    launches, errs = chip_smoke.backbones_phase(
        "cpu", cfgs, canvases=((100, 64, 64), (103, 96, 64)),
        train=dict(fixed=64, batch=2, n_gt=3, warmup=1, timed=2,
                   sides=(8, 40)),
        eval_kw=dict(fixed=256, min_size=128, max_size=250,
                     shapes=((128, 250), (250, 128), (128, 128)),
                     sides=(20, 64, 110), pipeline_depth=0),
        graphs=FakeGraphs(),
        train_graphs=lambda m, o, s: FakeGraphs(_state(m, o, s)),
        timing=False,
        u8_kw=dict(requests=((110, 64, 64, (64, 64)), (111, 60, 90, None)),
                   fixed=96, short=64))
    # R-50: 2 canvases x (1 + 3 + 2) + the f32 request's 6 + eval 3 + 3 +
    # train 4 (captured) + 3 (eager); the other four backbones 6 each (a
    # request's 1 + 3, and the plain and prepared requests' 2); R-50 and
    # R-101 from the uint8 pack: 2 requests x (1 eager + 3 + 3, the two
    # programs' captures) each; kernel 3 none on the CPU
    assert launches == {"nms": 83, "roi_align": 83, "roi_align_backward": 7,
                        "group_norm_relu": 0}
    assert errs == {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    out = capsys.readouterr().out
    for what in ("R-50 f32 64x64", "R-50 f32 96x64",
                 "R-50, TF32 off, f32 64x64", "R-101 f32 64x64",
                 "MobileNetV2 f32 64x64", "V-19-dw-eSE f32 64x64",
                 "V-19-slim-dw-eSE f32 64x64"):
        assert f"  {what}: " in out and f"{what} replay vs eager scores" in out
        assert f"  {what} plain chain: " in out
        assert f"  {what} control: " + (
            "no conv fused" if "MobileNet" in what else "the bias of the ") \
            in out
        assert f"{what[:-6]}: 1 graphs captured" in out or \
            f"{what[:-6]}: 2 graphs captured" in out
    assert out.count("every output bit-equal True") == 7
    assert "nms R-50 f32 64x64 request: N=" in out
    assert "eval captured: 3 images" in out and "eval eager: 3 images" in out
    assert "eval padded program: 1 graphs" in out
    assert ") of the captured and the eager loop equal" in out
    for what in ("captured", "eager"):
        assert f"R-50 {what} train step, " in out
    assert "stem_conv1 and res2 parameters bit-equal after the steps" in out
    assert "f32 train step, kernels vs plain: " in out
    for name in ("R-50", "R-101"):
        for what in ("uint8 64x64 at 64x64", "uint8 60x90 at 64x96"):
            assert f"  {name} f32 {what}: 10 valid of 10; the replay " \
                "bit-equal to its eager request and to the f32 host path's " \
                "replay over the normalized" in out


def test_prepared_phase_rehearsal(rehearsal, capsys):
    """``[prepared]`` on the CPU at 64x64 and 96x64 with the served
    models narrowed (a V-19-slim from the serving yaml, R-101 at narrow
    widths from the uint8 pack), f32 in both arms: each replay bit-equal
    to the eager request on the prepared weights, the trunk, FPN and head
    against the plain chain, weights loaded after the capture reaching
    the next replay, and the counters (V-19-slim folds 19 FrozenBNs and
    fuses 20 convs, R-101 104 and 100)."""
    from test_torch_captured import FakeGraphs

    r101 = _tiny_backbone_cfg(chip_smoke.resnet_cfg(101))
    r101.TPU.S2D_STEM_INPUT = True
    cfgs = {"V-39": _tiny_cfg(chip_smoke.serving_cfg()), "R-101": r101}
    launches = chip_smoke.prepared_phase(
        "cpu", cfgs, requests=((120, 64, 64), (121, 96, 64)),
        graphs=FakeGraphs(), fused={"V-39": 20, "R-101": 100})
    # 2 models x 2 arms x 2 requests x (3 at the capture + the prepared
    # and the plain eager request); kernel 3 none on the CPU
    assert launches == {"nms": 40, "roi_align": 40, "group_norm_relu": 0}
    out = capsys.readouterr().out
    for name in ("V-39", "R-101"):
        for arm in ("f32", "bf16"):
            for canvas in ("64x64", "96x64"):
                assert f"  {name} {arm} uint8 {canvas}: 10 valid of 10; " \
                    "the replay bit-equal to the eager request on the " \
                    "prepared weights; decodes alike" in out
    assert "V-39 bf16 uint8 64x64: weights loaded after the capture " \
        "reach the next replay" in out
    assert "  V-39 f32: 2 graphs; weights_prepared +1, " in out
    assert "  V-39 bf16: 2 graphs; weights_prepared +3, " in out
    assert out.count("folded_norms 19, fused_convs 20; process counters") \
        == 2
    assert out.count("folded_norms 104, fused_convs 100; process "
                     "counters") == 2


def test_keypoint_config_is_its_yaml():
    """``[keypoints]`` builds the keypoint yaml's config in Python, as
    ``[backbones]`` does its own: equal to the yaml merged over the
    defaults."""
    import os

    want = get_cfg()
    want.merge_from_file(os.path.join(chip_smoke.REPO, "configs",
                                      "centermask", chip_smoke.KEYPOINT_YAML))
    assert chip_smoke.keypoint_cfg() == want
    assert want.MODEL.KEYPOINT_ON and not want.MODEL.MASK_ON
    assert chip_smoke.adaptive_cfg().TPU.POOLER_SAMPLING_RATIO == 0
    dcn = chip_smoke.dcn_cfg()
    assert dcn.MODEL.FCOS.USE_DEFORMABLE and dcn.MODEL.VOVNET.WITH_MODULATED_DCN


def test_keypoints_phase_rehearsal(rehearsal, capsys):
    """``[keypoints]`` on the CPU at 64x64 and 96x64 with narrow models in
    f32: the keypoint model's requests eagerly and captured (launches, the
    replay equal to the eager request with ``pred_keypoints``, the kernels
    held on its inputs), its eval over 3 images with the OKS task and the
    ground truth at AP 100, its training captured and eager and the f32
    step against the plain versions; the adaptive flagship's request (3
    launches of kernel 2 eager, 9 at the capture) and its f32 step (3 of
    kernels 2 and 2b, each held); the DCN flagship's request. Each
    request's gate refuses the prepared request with its fused convs'
    bias dropped."""
    from test_torch_captured import FakeGraphs, _state

    def narrow(cfg):
        cfg = _tiny_backbone_cfg(cfg)
        cfg.MODEL.VOVNET.CONV_BODY = "V-19-slim-eSE"
        cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = [16, 16]
        return cfg

    cfgs = {"keypoint": narrow(chip_smoke.keypoint_cfg()),
            "adaptive": narrow(chip_smoke.adaptive_cfg()),
            "dcn": narrow(chip_smoke.dcn_cfg())}
    cfgs["keypoint"].MODEL.FCOS.NUM_CLASSES = 1
    launches, errs = chip_smoke.keypoints_phase(
        "cpu", cfgs, canvases=((100, 64, 64), (103, 96, 64)),
        train=dict(fixed=64, batch=2, n_gt=3, warmup=1, timed=2,
                   sides=(8, 40)),
        eval_kw=dict(fixed=256, min_size=128, max_size=250,
                     shapes=((128, 250), (250, 128), (128, 128)),
                     sides=(30, 60, 100), pipeline_depth=0),
        adaptive=dict(fixed=64, batch=2, n_gt=3, sides=(8, 60)),
        graphs=FakeGraphs(),
        train_graphs=lambda m, o, s: FakeGraphs(_state(m, o, s)),
        timing=False)
    # keypoint: 2 canvases x (1 + 3 + 2) + eval 3 + 3 + train 4 + 3;
    # adaptive: (1 + 3 + 2) x 3 of kernel 2 and the step's 1 / 3 / 3; DCN:
    # 1 + 3 + 2 (each + 2: the plain and prepared requests); kernel 3
    # none on the CPU
    assert launches == {"nms": 6 + 6 + 6 + 7 + 6 + 1 + 6,
                        "roi_align": 12 + 6 + 7 + 18 + 3 + 6,
                        "roi_align_backward": 7 + 3, "group_norm_relu": 0}
    assert errs == {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    out = capsys.readouterr().out
    for what in ("keypoint V-39 f32 64x64", "keypoint V-39 f32 96x64",
                 "adaptive V-39 f32 64x64", "DCN V-39 f32 64x64"):
        assert f"  {what}: " in out and f"  {what} plain chain: " in out
        assert f"  {what} control: the bias of the " in out
        assert f"{what} replay vs eager pred_keypoints" in out or \
            "keypoint" not in what
    assert out.count("every output bit-equal True") == 4
    assert "kernel 1 launched once and kernel 2 3 times by the eager " \
        "request, 3 and 9 times by the capture" in out
    for s in (1, 2, 4):
        assert f"roi_align adaptive V-39 f32 64x64 request, s={s}:" in out
        assert f"roi_align_backward adaptive f32 step, s={s}" in out
    assert "person-keypoint ground truth fed back: AP bbox 100.0000, " \
        "keypoints (OKS) 100.0000" in out
    assert "keypoints AP" in out and "eval captured: 3 images" in out
    assert ") of the captured and the eager loop equal" in out
    for what in ("captured", "eager"):
        assert f"keypoint V-39 {what} train step, " in out
    assert "loss_keypoint" in out
    assert "f32 train step, roi_heads.keypoint_head.score_lowres.bias: " \
        "zero in exact arithmetic" in out
    assert "f32 train step, kernels vs plain: " in out


def test_parallel_phase_rehearsal(rehearsal, capsys, monkeypatch):
    """``[parallel]``'s first part at 64x64 with a narrow f32 model, the
    process group of one over gloo (the card's is NCCL; the fakes stand
    for the CUDA graphs, which a gloo group refuses, so the rehearsal lets
    it through): the data-parallel captured step beside the one-process
    one, the f32 steps bit-equal to them, the kernels on an eager
    data-parallel step's inputs, the SyncBN, BN and remat variants, and
    ``make_dp_inference`` against ``inference_batched``. The gloo ranks
    of the second part run only on the card."""
    from test_torch_captured import FakeGraphs, _state

    from centermask2_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "is_gloo", lambda group: False)
    cfg = _tiny_cfg(chip_smoke.flagship_cfg())
    cfg.merge_from_list([
        "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
        "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "TPU.MAX_FG_PROPOSALS", "8", "TPU.MAX_GT_INSTANCES", "8"])
    launches, errs = chip_smoke.parallel_phase(
        torch.device("cpu"), cfg, batch=2, fixed=64, n_gt=3, timed=1,
        sides=(8, 40), dp_images=((400, 64, 64), (401, 64, 64)),
        ranks=False, timing=False,
        graphs=lambda m, o, s: FakeGraphs(_state(m, o, s)))
    # five captured loops of 3 warm-up steps, the capture and a replay: 4
    # launches each; two eager requests
    assert launches == {"nms": 22, "roi_align": 22, "roi_align_backward": 20,
                        "group_norm_relu": 0}
    assert errs == {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    out = capsys.readouterr().out
    assert "captured with the process group of one against the " \
        "one-process captured step, each from the one-process run's " \
        "state before it: the capture and 2 replays, losses and all" in out
    for what in ("SyncBN", "BN", "TPU.REMAT_BACKBONE"):
        assert f"data-parallel captured, {what}: losses finite" in out
    assert "nms data-parallel f32 step: N=" in out
    assert "against inference_batched: equal slot by slot, bit-equal " \
        "True" in out
    from centermask2_tpu_torch.parallel import process_count

    assert process_count() == 1  # the group was left


def test_cfg_opts_rebuild_the_config():
    """``cfg_opts`` gives the CLIs of ``[deploy]`` the flagship and the
    serving config as KEY VALUE overrides of the defaults, read back equal
    with no yaml."""
    for cfg in (chip_smoke.flagship_cfg(), chip_smoke.serving_cfg(),
                _tiny_cfg(chip_smoke.flagship_cfg())):
        again = get_cfg()
        again.merge_from_list(chip_smoke.cfg_opts(cfg))
        assert again == cfg


def test_deploy_phase_rehearsal(rehearsal, capsys, monkeypatch):
    """``[deploy]`` on the CPU at a 256x256 canvas: the ops call the
    registered operators (so that the parity ladder's export traces
    them), whose CPU versions reach ``_kernels``' counted plain versions;
    one launch of kernels 1 and 2 for each of the 3 images of the bin
    pipeline, 2 for the ladder's rungs, 1 for the layer dump and 1 for
    the dump CLI, 1 for ``measure`` (the FLOP count; the memory run is
    the card's only) and 2 x 6 for the host split's two runs."""
    for (mod, name), fn in OP_ROUTES.items():
        monkeypatch.setattr(mod, name, fn)
    monkeypatch.setattr(nms_mod, "greedy_keep_sorted_plain",
                        lambda b, v, t: _kernels.nms_keep_sorted(b, v, t))
    monkeypatch.setattr(roi_mod, "multilevel_roi_align_plain",
                        lambda *a: _kernels.roi_align(*a))
    cfgs = [_tiny_cfg(chip_smoke.flagship_cfg()),
            _tiny_cfg(chip_smoke.serving_cfg())]
    for cfg in cfgs:
        cfg.merge_from_list(["TPU.FIXED_EDGE_SIZE", 256,
                             "INPUT.MIN_SIZE_TEST", 128,
                             "INPUT.MAX_SIZE_TEST", 250])
    launches, errs = chip_smoke.deploy_phase(
        "cpu", *cfgs, shapes=((128, 250), (250, 128), (128, 128)),
        sides=(20, 64, 110), split_images=6)
    assert launches == {"nms": 3 + 2 + 1 + 1 + 1 + 12, "roi_align": 20,
                        "group_norm_relu": 0}
    assert errs == {"nms": 0, "roi_align": 0.0}
    out = capsys.readouterr().out
    assert "bins in: preprocess_to_bin wrote 3 files of 786432 bytes" in out
    assert "each read back equals preprocess_for_model's input bit for " \
        "bit" in out
    assert "every number equal to a COCOEvaluator fed the outputs in " \
        "memory" in out
    assert "reports 1 missing, returns normally" in out
    assert "PARITY OK" in out and "| PARITY OK" in out
    assert "layers, card against CPU: " in out
    assert "0 layers below cosine threshold" in out
    assert "equal to inference_flops" in out
    assert "AP 100.0000" in out and "IoU 100.0000" in out
    assert "the 6 packs bit-equal" in out
