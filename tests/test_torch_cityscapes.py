"""Port parity of the Cityscapes evaluation: the port's instance AP
scorer, pixel-level semantic scorer and both evaluators against the JAX
package's on the cases of tests/test_evaluation.py's Cityscapes tests.
The numbers must be equal (``==``, NaN where JAX's is NaN): the port runs
its own copy of the same numpy code. The scorers run on arrays with no
PIL; the evaluators write and read PNGs with it.
"""

import math

import numpy as np
import pytest

from centermask2_tpu.evaluation import cityscapes_eval as jeval
from centermask2_tpu.evaluation import cityscapes_scoring as jscore
from centermask2_tpu.evaluation import cityscapes_semseg as jsem
from centermask2_tpu_torch.evaluation import (CityscapesInstanceEvaluator,
                                              CityscapesSemSegEvaluator)
from centermask2_tpu_torch.evaluation import cityscapes_scoring as tscore
from centermask2_tpu_torch.evaluation import cityscapes_semseg as tsem


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == v, (k, got[k], v)


def _gt_map():
    """tests/test_evaluation.py::_cs_gt_map: two cars, a person, a void
    strip, a tiny car (< 100 px) and a car crowd region."""
    g = np.zeros((64, 64), np.int64)
    g[4:20, 4:20] = 26000
    g[30:50, 30:50] = 26001
    g[4:20, 40:60] = 24000
    g[55:58, 4:7] = 26002
    g[55:64, 40:60] = 26
    return g


def _instance_case(name):
    g = _gt_map()
    m = lambda i: g == i  # noqa: E731
    perfect = [(m(26000), 26, 0.9), (m(26001), 26, 0.8),
               (m(24000), 24, 0.95)]
    stray = np.zeros_like(g, dtype=bool)
    stray[24:28, 4:20] = True
    if name == "perfect":
        return [g], [perfect]
    if name == "missed_car":
        return [g], [[perfect[0], perfect[2]]]
    if name == "class_without_gt":
        return [g], [perfect + [(stray, 31, 0.99)]]
    void_fp = np.zeros_like(g, dtype=bool)
    void_fp[0:3, 25:35] = True
    ignored = perfect + [(void_fp, 26, 0.99), (m(26), 26, 0.99),
                         (m(26002), 26, 0.99)]
    if name == "ignore_regions":
        return [g], [ignored]
    g2 = g.copy()
    g2[24:28, 4:20] = 7  # road: evaluated, so the stray box counts
    if name == "false_positive":
        return [g2], [ignored + [(stray, 26, 0.99)]]
    if name == "two_images":
        rng = np.random.RandomState(4)
        noisy = [(mask ^ (rng.rand(*g.shape) < 0.02), lab, s)
                 for mask, lab, s in perfect]
        return [g, g2], [noisy, ignored + [(stray, 26, 0.99)]]
    raise KeyError(name)


@pytest.mark.parametrize("case", ["perfect", "missed_car", "class_without_gt",
                                  "ignore_regions", "false_positive",
                                  "two_images"])
def test_score_instances_equals_jax(case):
    gts, preds = _instance_case(case)
    got = tscore.score_instances(gts, preds)
    _same(got, jscore.score_instances(gts, preds))
    if case == "perfect":
        assert got["AP"] == pytest.approx(100.0)
    if case == "missed_car":
        assert got["AP-car"] == pytest.approx(50.0)
    if case == "class_without_gt":
        assert math.isnan(got["AP-train"])


def _semseg_case(name):
    if name == "hand_iou":
        gt = np.full((20, 30), 7, np.uint8)
        gt[:, 15:] = 11
        pred = gt.copy()
        pred[:10, 15:] = 7
        return [(pred, gt)], None
    if name == "perfect":
        gt = np.full((20, 30), 7, np.uint8)
        gt[:, 15:] = 11
        return [(gt.copy(), gt)], None
    if name == "void_gt":
        gt = np.full((10, 10), 7, np.uint8)
        gt[:, :5] = 0
        return [(np.full((10, 10), 7, np.uint8), gt)], None
    if name == "category_pool":
        return [(np.full((10, 10), 11, np.uint8),
                 np.full((10, 10), 12, np.uint8))], None
    gt = np.full((40, 40), 7, np.uint8)
    inst = np.full((40, 40), 7, np.int64)
    gt[:30, :30] = 24
    inst[:30, :30] = 24000
    gt[:10, 30:40] = 24
    inst[:10, 30:40] = 24001
    pred = np.full((40, 40), 7, np.uint8)
    pred[:30, :30] = 24
    if name == "iiou_fp":
        pred[35:40, :20] = 24
    elif name == "random":
        rng = np.random.RandomState(9)
        labels = np.array([0, 7, 8, 11, 24, 26, 33], np.uint8)
        pred = labels[rng.randint(0, len(labels), (40, 40))]
    return [(pred, gt)], [(pred, inst)]


@pytest.mark.parametrize("case", ["perfect", "hand_iou", "void_gt",
                                  "category_pool", "iiou", "iiou_fp",
                                  "random"])
def test_score_semseg_equals_jax(case):
    pairs, inst = _semseg_case(case)
    got = tsem.score_semseg(pairs, inst)
    _same(got, jsem.score_semseg(pairs, inst))
    if case == "perfect":
        assert got["IoU"] == pytest.approx(100.0)


def test_instance_evaluator_files_and_score_equal_jax(tmp_path):
    """Both evaluators write the same files (mask_scores as confidences,
    out-of-vocabulary classes skipped) and score them against a gt
    instanceIds png with the same numbers."""
    from PIL import Image

    g = _gt_map()
    gt_dir = tmp_path / "gt" / "city"
    gt_dir.mkdir(parents=True)
    Image.fromarray(g.astype(np.uint16)).save(
        gt_dir / "city_000000_000019_gtFine_instanceIds.png")
    outputs = {"pred_classes": np.array([2, 2, 0, 99]),
               "mask_scores": np.array([0.9, 0.8, 0.95, 0.5]),
               "scores": np.array([0.1, 0.1, 0.1, 0.1]),
               "pred_masks": np.stack([g == 26000, g == 26001, g == 24000,
                                       g == 26000])}
    res = {}
    for name, cls in (("port", CityscapesInstanceEvaluator),
                      ("jax", jeval.CityscapesInstanceEvaluator)):
        ev = cls(str(tmp_path / name))
        ev.process("city_000000_000019_leftImg8bit.png", outputs)
        assert ev.evaluate()["num_images"] == 1
        res[name] = ev.evaluate(str(tmp_path / "gt"))
    txt = "city_000000_000019_leftImg8bit_pred.txt"
    lines = (tmp_path / "port" / txt).read_text()
    assert lines == (tmp_path / "jax" / txt).read_text()
    assert len(lines.splitlines()) == 3 and " 26 0.900000" in lines
    for png in sorted((tmp_path / "jax").glob("*.png")):
        assert (tmp_path / "port" / png.name).read_bytes() == \
            png.read_bytes()
    _same(res["port"], res["jax"])
    assert res["port"]["AP"] == pytest.approx(100.0)


def test_semseg_evaluator_equals_jax(tmp_path):
    from PIL import Image

    gt_dir = tmp_path / "gtFine" / "val" / "city"
    gt_dir.mkdir(parents=True)
    gt = np.full((16, 16), 7, np.uint8)
    gt[8:, :] = 23
    gt[4:8, 4:12] = 26
    Image.fromarray(gt).save(gt_dir / "city_000000_000019_gtFine_labelIds.png")
    sem = np.zeros((16, 16), np.int64)
    sem[8:, :] = 10
    sem[4:8, 4:10] = 13
    res = {}
    for name, cls in (("port", CityscapesSemSegEvaluator),
                      ("jax", jeval.CityscapesSemSegEvaluator)):
        ev = cls(str(tmp_path / name))
        ev.process("city_000000_000019_leftImg8bit.png", sem)
        res[name] = ev.evaluate(str(tmp_path / "gtFine" / "val"))
    png = "city_000000_000019_leftImg8bit_pred.png"
    assert (tmp_path / "port" / png).read_bytes() == \
        (tmp_path / "jax" / png).read_bytes()
    _same(res["port"], res["jax"])
    assert res["port"]["IoU-sky"] == pytest.approx(100.0)
