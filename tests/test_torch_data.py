"""Port parity of the host data pipeline: ``centermask2_tpu_torch.data``
against ``centermask2_tpu.data`` on inputs drawn from a numpy seed.

Every comparison is exact (``np.array_equal`` or ``==``): the port's
preprocessing, bucketing and postprocessing are numpy copies of the JAX
package's. The JAX s2d functions may take their native C++ path, which
the JAX package holds bit-equal to its numpy path.
"""

import importlib
import json
import threading

import numpy as np
import pytest

from centermask2_tpu.data import bucketing as jbk
from centermask2_tpu.data import coco as jcoco
from centermask2_tpu.data import preprocess as jpre
from centermask2_tpu_torch.data import bucketing as tbk
from centermask2_tpu_torch.data import coco as tcoco
from centermask2_tpu_torch.data import preprocess as tpre
from centermask2_tpu_torch.data.prefetch import prefetch

# the packages export a function named ``postprocess`` over the module
jpost = importlib.import_module("centermask2_tpu.data.postprocess")
tpost = importlib.import_module("centermask2_tpu_torch.data.postprocess")

SHAPES = [(50, 61), (61, 50), (64, 64), (33, 90), (480, 640), (427, 640)]


def _img(rng, h, w, dtype=np.uint8):
    return (rng.rand(h, w, 3) * 255).astype(dtype)


@pytest.mark.parametrize("h,w", SHAPES)
def test_resize_and_scale_equal(h, w):
    for short, max_size in ((800, 1333), (32, 60), (64, 64)):
        assert tpre.compute_resize_shape(h, w, short, max_size) == \
            jpre.compute_resize_shape(h, w, short, max_size)
        assert tpre.postprocess_scale(h, w, short, max_size) == \
            jpre.postprocess_scale(h, w, short, max_size)
    img = _img(np.random.RandomState(h * 1000 + w), h, w)
    np.testing.assert_array_equal(tpre.resize_shortest_edge(img, 32, 60),
                                  jpre.resize_shortest_edge(img, 32, 60))


def test_resize_identity_needs_no_pil(monkeypatch):
    """An image already at its resized shape is returned as it is,
    before PIL is imported (the card's machine may have no PIL)."""
    import builtins

    real = builtins.__import__

    def guarded(name, *a, **k):
        if name.split(".")[0] == "PIL":
            raise ImportError("PIL blocked")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guarded)
    img = _img(np.random.RandomState(0), 800, 1333)
    assert tpre.resize_shortest_edge(img) is img


@pytest.mark.parametrize("fixed", [64, 96])
def test_s2d_packs_equal(fixed):
    rng = np.random.RandomState(fixed)
    for h, w in ((50, 61), (61, 50), (fixed, fixed), (17, 9)):
        img = _img(rng, h, w)
        np.testing.assert_array_equal(tpre.single_preprocessing(img, fixed),
                                      jpre.single_preprocessing(img, fixed))
        np.testing.assert_array_equal(tpre.s2d_preprocess(img, fixed),
                                      jpre.s2d_preprocess(img, fixed))
        fimg = img.astype(np.float32)
        np.testing.assert_array_equal(tpre.s2d_preprocess(fimg, fixed),
                                      jpre.s2d_preprocess(fimg, fixed))
        np.testing.assert_array_equal(tpre.s2d_pack_u8(img, fixed),
                                      jpre.s2d_pack_u8(img, fixed))
        rect = (fixed, fixed + 32)
        np.testing.assert_array_equal(tpre.s2d_pack_u8(img, rect),
                                      jpre.s2d_pack_u8(img, rect))
        for mult in (8, 32):
            np.testing.assert_array_equal(
                tpre.s2d_pack_u8_tight(img, fixed, mult),
                jpre.s2d_pack_u8_tight(img, fixed, mult))
        batch = rng.randn(2, fixed, fixed + 4, 3).astype(np.float32)
        np.testing.assert_array_equal(tpre.stem_space_to_depth(batch),
                                      jpre.stem_space_to_depth(batch))
    with pytest.raises(ValueError):
        tpre.s2d_pack_u8(_img(rng, fixed + 1, 8), fixed)
    with pytest.raises(ValueError):
        tpre.s2d_pack_u8(_img(rng, 8, 8), (fixed, 66))


def test_serving_canvas_equal():
    for h in (100, 799, 800, 801, 1333):
        for w in (100, 800, 1100, 1333):
            for fixed in (1344, (800, 1344), (1344, 1024)):
                for short in (800, 640, 100):
                    assert tpre.s2d_serving_canvas(h, w, fixed, short) == \
                        jpre.s2d_serving_canvas(h, w, fixed, short)


@pytest.mark.parametrize("s2d,u8,tight", [
    (False, False, False), (True, False, False), (True, True, False),
    (True, True, True)])
def test_preprocess_for_model_equal(tmp_path, s2d, u8, tight):
    from PIL import Image

    rng = np.random.RandomState(7)
    path = tmp_path / "im.png"
    Image.fromarray(_img(rng, 70, 110)).save(path)
    want = jpre.preprocess_for_model(str(path), 64, 32, 60, s2d=s2d, u8=u8,
                                     tight=tight)
    got = tpre.preprocess_for_model(str(path), 64, 32, 60, s2d=s2d, u8=u8,
                                    tight=tight)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    # a caller without PIL reads arrays through ``read_image``
    arr = tpre.read_image_bgr(str(path))
    fed = tpre.preprocess_for_model("any", 64, 32, 60, s2d=s2d, u8=u8,
                                    tight=tight, read_image=lambda p: arr)
    np.testing.assert_array_equal(fed["input"], want["input"])


def test_bucketing_equal():
    rng = np.random.RandomState(3)
    sizes = [tuple(int(v) for v in rng.randint(200, 1400, 2))
             for _ in range(40)]
    items = list(range(len(sizes)))
    assert tbk.group_by_bucket(items, sizes, (640, 1024, 1344), 800, 1333) \
        == jbk.group_by_bucket(items, sizes, (640, 1024, 1344), 800, 1333)
    groups = tbk.group_by_serving_canvas(items, sizes, 1344, 800, 1333)
    assert groups == jbk.group_by_serving_canvas(items, sizes, 1344, 800,
                                                 1333)
    assert len(groups) <= 4
    for bs in (1, 3, 8):
        assert list(tbk.batches_from_groups(groups, bs)) == \
            list(jbk.batches_from_groups(groups, bs))
    for h, w in sizes[:10]:
        assert tbk.pick_bucket(h, w, (640, 1024)) == \
            jbk.pick_bucket(h, w, (640, 1024))


def _raw_outputs(rng, n, m=28):
    boxes = rng.rand(n, 4).astype(np.float32) * 700
    boxes[:, 2:] = boxes[:, :2] + rng.rand(n, 2).astype(np.float32) * 400
    boxes[0] = [50.0, 50.0, 50.0, 90.0]  # empty after scaling
    boxes[1] = [-20.0, 700.0, 1400.0, 900.0]  # clipped
    return (rng.rand(n, 2).astype(np.float32) * 800,
            rng.rand(n).astype(np.float32),
            boxes,
            rng.randint(0, 80, n).astype(np.int32),
            rng.rand(n, 1, m, m).astype(np.float32),
            rng.rand(n).astype(np.float32))


@pytest.mark.parametrize("hw", [(480, 640), (640, 427), (500, 500)])
def test_postprocess_equal(hw):
    rng = np.random.RandomState(hw[0])
    raw = _raw_outputs(rng, 60)
    want = jpost.detector_postprocess(jpost.single_wrap_outputs(raw), *hw)
    got = tpost.detector_postprocess(tpost.single_wrap_outputs(raw), *hw)
    assert sorted(got) == sorted(want)
    assert len(got["pred_boxes"]) < 50  # truncated, then the empty dropped
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert tpost.postprocess([tpost.single_wrap_outputs(raw)], [hw[0]],
                             [hw[1]])[0]["pred_masks"].sum() == \
        want["pred_masks"].sum()


def test_paste_masks_np_equal():
    rng = np.random.RandomState(11)
    masks = rng.rand(12, 28, 28).astype(np.float32)
    boxes = rng.rand(12, 4).astype(np.float32) * 60 - 10
    boxes[:, 2:] = boxes[:, :2] + rng.rand(12, 2).astype(np.float32) * 50
    for thr in (0.5, 0.3):
        np.testing.assert_array_equal(
            tpost.paste_masks_np(masks, boxes, (64, 80), thr),
            jpost.paste_masks_np(masks, boxes, (64, 80), thr))


def test_prefetch_keeps_order_and_raises():
    assert list(prefetch(iter(range(100)), depth=3)) == list(range(100))

    def boom():
        yield 1
        yield 2
        raise KeyError("producer failed")

    got = []
    with pytest.raises(KeyError, match="producer failed"):
        for x in prefetch(boom(), depth=1):
            got.append(x)
    assert got == [1, 2]


def test_prefetch_stops_producer_when_closed():
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield i
            i += 1

    g = prefetch(endless(), depth=2)
    assert next(g) == 0
    assert started.wait(5)
    n_threads = threading.active_count()
    g.close()
    for t in threading.enumerate():
        if t.name == "batch-prefetch":
            t.join(timeout=5)
            assert not t.is_alive()
    assert threading.active_count() <= n_threads


def test_coco_dataset_fields_equal(tmp_path):
    ann = {
        "images": [{"id": i, "file_name": f"{i}.png", "width": 60 + i,
                    "height": 50} for i in (3, 1, 2)],
        "annotations": [
            {"id": 1, "image_id": 1, "category_id": 7, "bbox": [1, 2, 3, 4],
             "area": 12, "iscrowd": 0},
            {"id": 2, "image_id": 1, "category_id": 3, "bbox": [1, 2, 3, 4],
             "area": 12, "iscrowd": 1},
            {"id": 3, "image_id": 3, "category_id": 3, "bbox": [5, 5, 9, 9],
             "area": 81, "iscrowd": 0}],
        "categories": [{"id": 7, "name": "a"}, {"id": 3, "name": "b"}],
    }
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(ann))
    for filter_empty in (True, False):
        want = jcoco.CocoDataset(str(path), "root", filter_empty)
        got = tcoco.CocoDataset(str(path), "root", filter_empty)
        assert got.ids == want.ids and len(got) == len(want)
        assert got.imgs == want.imgs
        assert got.cat_to_contiguous == want.cat_to_contiguous
        assert got.contiguous_to_cat == want.contiguous_to_cat
        assert dict(got.img_to_anns) == dict(want.img_to_anns)
        assert [got.image_path(i) for i in got.ids] == \
            [want.image_path(i) for i in want.ids]
