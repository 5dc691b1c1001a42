"""Port parity of evaluation: ``centermask2_tpu_torch.evaluation`` (RLE
ops, the COCO evaluator, the dataset loop) and the port's CLI, against
``centermask2_tpu.evaluation`` on data drawn from a numpy seed.

RLE results and evaluator metrics must be equal (``==``, NaN where both
are NaN): the port runs its own copy of the same C++ and numpy code. The
eval loop runs the narrow V-19-slim model of tests/test_torch_model.py
on the CPU against the JAX loop, with the tolerances of
``test_whole_slice_matches_jax`` on the predictions.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from centermask2_tpu.evaluation import COCOEvaluator as JaxEvaluator
from centermask2_tpu.evaluation import COCOGt as JaxGt
from centermask2_tpu.evaluation import rle as jrle
from centermask2_tpu_torch.evaluation import COCOEvaluator, COCOGt, rle

REPO = Path(__file__).resolve().parent.parent


def _masks(rng, n, h, w):
    out = np.zeros((n, h, w), bool)
    for i in range(n):
        y0, x0 = rng.randint(0, h - 2), rng.randint(0, w - 2)
        y1, x1 = rng.randint(y0 + 1, h), rng.randint(x0 + 1, w)
        out[i, y0:y1, x0:x1] = True
        out[i] ^= rng.rand(h, w) < 0.05
    return out


def _same_rle(a, b):
    return (a.h, a.w) == (b.h, b.w) and np.array_equal(a.counts, b.counts)


def test_rle_ops_equal():
    rng = np.random.RandomState(0)
    ms = _masks(rng, 6, 37, 53)
    ours = [rle.encode(m) for m in ms]
    theirs = [jrle.encode(m) for m in ms]
    for a, b, m in zip(ours, theirs, ms):
        assert _same_rle(a, b)
        np.testing.assert_array_equal(rle.decode(a), m)
        assert rle.area(a) == jrle.area(b) == int(m.sum())
        s = rle.to_string(a)
        assert s == jrle.to_string(b)
        assert _same_rle(rle.from_string(s, a.h, a.w), a)
        assert rle.to_coco(a) == jrle.to_coco(b)
        assert _same_rle(rle.from_coco(jrle.to_coco(b)), a)
        assert _same_rle(rle.from_coco({"size": [a.h, a.w],
                                        "counts": a.counts.tolist()}), a)
    crowd = [0, 1, 0, 0, 1, 0]
    np.testing.assert_array_equal(rle.iou(ours[:3], ours, crowd),
                                  jrle.iou(theirs[:3], theirs, crowd))
    for inter in (False, True):
        assert _same_rle(rle.merge(ours, inter), jrle.merge(theirs, inter))
    boxes = rng.rand(5, 4) * 40
    np.testing.assert_array_equal(rle.bbox_iou(boxes, boxes[::-1], crowd[:5]),
                                  jrle.bbox_iou(boxes, boxes[::-1], crowd[:5]))
    polys = [(rng.rand(k, 2) * [50, 35]).ravel().tolist() for k in (3, 5, 8)]
    assert _same_rle(rle.polygons_to_rle(polys, 37, 53),
                     jrle.polygons_to_rle(polys, 37, 53))
    assert _same_rle(rle.polygons_to_rle(polys[:1], 37, 53),
                     jrle.polygons_to_rle(polys[:1], 37, 53))


def test_rle_build_is_atomic_and_shared(tmp_path):
    """Concurrent first uses from several processes build one library
    under a lock; every process loads a whole file."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from centermask2_tpu_torch.evaluation import rle; "
            "rle._BUILD_ROOT = __import__('pathlib').Path(%r); "
            "import numpy as np; m = np.eye(9, dtype=bool); "
            "assert (rle.decode(rle.encode(m)) == m).all(); print('ok')"
            % (str(REPO), str(tmp_path)))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    libs = list(tmp_path.rglob("*.so"))
    assert len(libs) == 1, libs
    assert not list(tmp_path.rglob("*.so.*"))


def test_rle_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "maskapi.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rle, "_SRC", bad)
    monkeypatch.setattr(rle, "_BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rle._lib()


def _random_coco(rng, n_img=6, cats=(1, 3, 7)):
    images, anns = [], []
    aid = 1
    for i in range(1, n_img + 1):
        h, w = rng.randint(60, 120), rng.randint(60, 120)
        images.append({"id": i, "height": h, "width": w,
                       "file_name": f"{i}.png"})
        for _ in range(rng.randint(1, 6)):
            x0, y0 = rng.rand() * (w - 20), rng.rand() * (h - 20)
            bw, bh = 4 + rng.rand() * (w - x0 - 4), 4 + rng.rand() * (h - y0 - 4)
            poly = [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]
            anns.append({"id": aid, "image_id": i,
                         "category_id": int(rng.choice(cats)),
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "iscrowd": int(rng.rand() < 0.1),
                         "segmentation": [poly]})
            aid += 1
    return {"images": images, "annotations": anns,
            "categories": [{"id": c, "name": f"c{c}"} for c in cats]}


def _random_outputs(rng, h, w, n):
    boxes = rng.rand(n, 4).astype(np.float32) * [w, h, w, h]
    boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 2)
    return {"pred_boxes": boxes, "scores": rng.rand(n).astype(np.float32),
            "pred_classes": rng.randint(0, 4, n).astype(np.int32),
            "mask_scores": rng.rand(n).astype(np.float32),
            "pred_masks": _masks(rng, n, h, w)}


def _assert_metrics_equal(got, want):
    assert sorted(got) == sorted(want)
    for task in want:
        assert sorted(got[task]) == sorted(want[task]), task
        for k, v in want[task].items():
            g = got[task][k]
            assert (math.isnan(g) and math.isnan(v)) or g == v, (task, k, g, v)


def test_evaluator_equal_on_random_detections():
    rng = np.random.RandomState(4)
    data = _random_coco(rng)
    cmap = {0: 1, 1: 3, 2: 7}  # class 3 has no category: dropped
    ours = COCOEvaluator(COCOGt(data), category_id_map=cmap)
    theirs = JaxEvaluator(JaxGt(data), category_id_map=cmap)
    for im in data["images"]:
        out = _random_outputs(rng, im["height"], im["width"], 12)
        ours.process(im["id"], out)
        theirs.process(im["id"], out)
    assert ours.predictions == theirs.predictions
    got, want = ours.evaluate(), theirs.evaluate()
    got["box_proposals"] = ours.evaluate_proposals()
    want["box_proposals"] = theirs.evaluate_proposals()
    _assert_metrics_equal(got, want)
    assert 0.0 < got["bbox"]["AP50"] < 100.0


def test_evaluator_ground_truth_scores_100():
    rng = np.random.RandomState(5)
    data = _random_coco(rng)
    gt = COCOGt(data)
    cat_to_cls = {1: 0, 3: 1, 7: 2}
    ev = COCOEvaluator(gt, category_id_map={v: k for k, v in
                                            cat_to_cls.items()})
    for im in data["images"]:
        anns = [a for a in gt.img_to_anns[im["id"]] if not a["iscrowd"]]
        if not anns:
            continue
        xywh = np.array([a["bbox"] for a in anns], np.float64)
        ev.process(im["id"], {
            "pred_boxes": np.concatenate([xywh[:, :2], xywh[:, :2]
                                          + xywh[:, 2:]], 1),
            "scores": np.ones(len(anns)), "mask_scores": np.ones(len(anns)),
            "pred_classes": np.array([cat_to_cls[a["category_id"]]
                                      for a in anns]),
            "pred_masks": np.stack([rle.decode(gt.ann_rle(a))
                                    for a in anns])})
    res = ev.evaluate()
    assert res["bbox"]["AP"] == pytest.approx(100.0)
    assert res["segm"]["AP"] == pytest.approx(100.0)


def _png_dataset(root: Path, rng):
    from PIL import Image

    (root / "images").mkdir()
    images, anns = [], []
    for i, (w, h) in enumerate([(120, 80), (70, 110), (90, 90)], 1):
        arr = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / "images" / f"{i:012d}.png")
        images.append({"id": i, "file_name": f"{i:012d}.png", "width": w,
                       "height": h})
        anns.append({"id": i, "image_id": i, "category_id": 1 + i % 2,
                     "bbox": [10, 10, 40, 30], "area": 1200, "iscrowd": 0,
                     "segmentation": [[10, 10, 50, 10, 50, 40, 10, 40]]})
    ann = root / "ann.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}))
    return ann


# a narrow s2d model on canvases of 64 (images resized to short 32, max 60)
SMALL = dict(conv_body="V-19-slim-eSE", num_classes=2, fpn_out_channels=32,
             mask_conv_dim=8, maskiou_conv_dim=8, post_nms_topk_test=8,
             pre_nms_thresh_test=0.0, s2d_input=True)
LOOP = dict(fixed_size=64, min_size=32, max_size=60, progress_every=0)


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import torch

    from centermask2_tpu.evaluation.loop import evaluate_dataset as jax_eval
    from centermask2_tpu.models import CenterMask as JaxCenterMask
    from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params
    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
    from centermask2_tpu_torch.models.meta import CenterMask

    root = tmp_path_factory.mktemp("coco")
    ann = _png_dataset(root, np.random.RandomState(3))
    jm = JaxCenterMask(**SMALL, dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 17, 17, 48), jnp.float32))
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.asarray(x) + (0.05 * rng.randn(*x.shape) if
                      p[-1].key in ("bias", "frozen_bias") else 0.0)
                      ).astype(np.float32),
        variables["params"])
    common = dict(ann=str(ann), image_root=str(root / "images"), **LOOP)
    want = jax_eval(jm, {"params": params}, **common)
    port = CenterMask(**SMALL, dtype=torch.float32).eval()
    load_jax_params(port, params)
    got = evaluate_dataset(port, **common)
    full = evaluate_dataset(port, tight=False, **common)
    return root, ann, want, got, full


def test_eval_loop_matches_jax(loop_runs):
    _, _, (_, _, jev), (res, avg_ms, ev), _ = loop_runs
    assert avg_ms > 0 and "box_proposals" in res
    assert len(ev.predictions) == len(jev.predictions) > 3
    for p, q in zip(ev.predictions, jev.predictions):
        assert (p["image_id"], p["category_id"]) == \
            (q["image_id"], q["category_id"])
        np.testing.assert_allclose(p["bbox"], q["bbox"], rtol=1e-3, atol=2e-2)
        np.testing.assert_allclose(p["score"], q["score"], rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(p["mask_score"], q["mask_score"],
                                   rtol=2e-3, atol=2e-3)
        pm = rle.decode(rle.from_coco(p["segmentation"]))
        qm = rle.decode(rle.from_coco(q["segmentation"]))
        # a pasted pixel flips only where the soft mask sits at 0.5
        assert (pm != qm).mean() < 0.01


def test_eval_loop_tight_equals_full(loop_runs):
    *_, (_, _, ev_tight), (_, _, ev_full) = loop_runs
    assert ev_tight.predictions == ev_full.predictions
    assert len(ev_tight.predictions) > 0


def test_cli_writes_results(loop_runs, tmp_path):
    root, ann, *_ = loop_runs
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "centermask2_tpu_torch.tools.infer",
         "--device", "cpu", "--config-file",
         str(REPO / "configs/centermask/zy_model_serving.yaml"),
         "--ann", str(ann), "--image-root", str(root / "images"),
         "--output-dir", str(out), "--tight-compute",
         "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE",
         "MODEL.FCOS.NUM_CLASSES", "2", "MODEL.FPN.OUT_CHANNELS", "32",
         "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
         "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8", "TPU.FIXED_EDGE_SIZE", "64",
         "INPUT.MIN_SIZE_TEST", "32", "INPUT.MAX_SIZE_TEST", "60",
         "MODEL.FCOS.INFERENCE_TH_TEST", "0.0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    metrics = json.loads((out / "metrics.json").read_text())
    assert {"bbox", "segm", "box_proposals"} <= set(metrics)
    preds = json.loads((out / "coco_instances_results.json").read_text())
    assert preds and {"bbox", "segmentation", "mask_score"} <= set(preds[0])
    assert "copypaste: Task: bbox" in res.stdout
