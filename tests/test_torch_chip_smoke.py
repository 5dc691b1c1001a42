"""A CPU rehearsal of ``chip_smoke.py``'s ``[serving]``, ``[eval]`` and
``[train]`` phases at a tiny size: a narrow V-19-slim model in f32 on
canvases of 32-256 pixels, never the V-39.

As the smoke run's own rehearsal does, the ops route to ``_kernels``,
whose launches are replaced by the plain versions with the launch counts
kept (the ROIAlign backward included), and the CUDA-only calls
(synchronize, sync-debug mode, events, memory statistics, nvidia-smi)
are faked; the CUDA-graph timing runs only on the card (``timing``
off)."""

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
                                                 roi_align_feature_grad_plain)


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
    assert launches == {"nms": 6, "roi_align": 6}
    assert per_level == {"nms": 1, "roi_align": 1}
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
    cfg = _tiny_cfg(chip_smoke.serving_cfg())
    model = chip_smoke.build_model(cfg, "cpu")
    shapes = ((128, 250), (250, 128), (128, 128), (128, 200))
    launches = chip_smoke.eval_phase("cpu", model, fixed=256, min_size=128,
                                     max_size=250, shapes=shapes,
                                     sides=(20, 64, 110))
    assert launches == {"nms": 12, "roi_align": 12}
    out = capsys.readouterr().out
    assert "AP bbox 100.0000, segm 100.0000" in out
    assert "tight and full pack predictions equal" in out
    assert "every metric present and finite" in out


def test_train_phase_rehearsal(rehearsal, capsys):
    """``[train]`` at 64x64 with a narrow f32 model: the CLI's loop with
    one launch of each kernel per step, the kernels held on captured
    inputs, the kernel step against the plain step, the overfit, the
    checkpoint round trip."""
    cfg = _tiny_cfg(chip_smoke.flagship_cfg())
    cfg.merge_from_list([
        "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
        "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
        "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "TPU.MAX_FG_PROPOSALS", "8", "TPU.MAX_GT_INSTANCES", "8"])
    launches, errs, row = chip_smoke.train_phase(
        "cpu", cfg, fixed=64, batch=2, n_gt=3, warmup=1, timed=2,
        overfit=6, sides=(8, 40), roi_rc=(24, 8), timing=False)
    # 3 loop steps, then 6 overfit steps
    assert launches == {"nms": 9, "roi_align": 9, "roi_align_backward": 9}
    assert errs == {"nms": 0, "roi_align": 0.0, "roi_align_backward": 0.0}
    assert row is None
    out = capsys.readouterr().out
    assert "one launch of nms, roi_align and roi_align_backward per step" in out
    for what in ("bf16 train step", "f32 train step"):
        assert f"nms {what}: N=" in out and "keep sets bit-equal" in out
        assert f"roi_align_backward {what}: float32" in out
    assert "roi_align_backward synthetic P5 ROIs, levels [2]: bfloat16" in out
    assert "no host sync in the step" in out
    assert "f32 train step, kernels vs plain: " in out
    assert "checkpoint round trip on the card" in out


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
