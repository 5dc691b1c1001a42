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


# ------------------------------------------------------------- training
def make_train_dataset(root, seed: int = 0):
    """A synthetic COCO training set: PNG images of both orientations
    and, per image, three polygon instances (a rectangle, a triangle, a
    hexagon) over three categories, one degenerate box, one crowd
    region. Returns (annotation json path, image root)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    root.mkdir(parents=True, exist_ok=True)
    images, anns = [], []
    shapes = [(60, 80), (80, 60), (64, 64), (50, 70), (70, 50), (58, 90)]
    for i, (h, w) in enumerate(shapes, 1):
        Image.fromarray(_img(rng, h, w)).save(root / f"{i}.png")
        images.append({"id": i, "file_name": f"{i}.png", "height": h,
                       "width": w})
        for j, pts in enumerate(([(0, 0), (1, 0), (1, 1), (0, 1)],
                                 [(0, 1), (0.5, 0), (1, 1)],
                                 [(0.25, 0), (0.75, 0), (1, 0.5),
                                  (0.75, 1), (0.25, 1), (0, 0.5)])):
            bw, bh = 8 + rng.rand(2) * 24
            x0, y0 = rng.rand() * (w - bw - 1), rng.rand() * (h - bh - 1)
            poly = [float(v) for px, py in pts
                    for v in (x0 + px * bw, y0 + py * bh)]
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": (1, 3, 7)[j],
                         "bbox": [x0, y0, bw, bh], "area": bw * bh,
                         "iscrowd": 0, "segmentation": [poly]})
    anns.append({"id": len(anns) + 1, "image_id": 1, "category_id": 1,
                 "bbox": [5.0, 5.0, 0.0, 4.0], "area": 0.0, "iscrowd": 0,
                 "segmentation": []})  # zero width: skipped
    anns.append({"id": len(anns) + 1, "image_id": 2, "category_id": 3,
                 "bbox": [0.0, 0.0, 20.0, 20.0], "area": 400.0,
                 "iscrowd": 1, "segmentation": []})
    ann = root / "ann.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": c, "name": f"c{c}"} for c in (1, 3, 7)]}))
    return str(ann), str(root)


@pytest.mark.parametrize("tight_pad,sampling,workers", [
    (False, "choice", 0), (True, "range", 2)])
def test_train_batches_equal(tmp_path, tight_pad, sampling, workers):
    """``train_batches`` equals the JAX loader batch for batch over two
    epochs at one seed: multi-scale draws, flips, tight canvases,
    rasterized mask patches."""
    ann, root = make_train_dataset(tmp_path / "ds")
    kw = dict(min_sizes=(40, 48, 56), max_size=72, pad_to=(96, 96),
              max_gt=4, patch_size=28, seed=3, epochs=2, sampling=sampling,
              workers=workers, tight_pad=tight_pad)
    want = list(jcoco.train_batches(jcoco.CocoDataset(ann, root), 2, **kw))
    got = list(tcoco.train_batches(tcoco.CocoDataset(ann, root), 2, **kw))
    assert len(got) == len(want) == 6
    canvases = set()
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert a["image_ids"] == b["image_ids"]
        for k in tcoco.BATCH_KEYS:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        canvases.add(a["image"].shape[1:3])
        assert a["gt_mask_patches"][a["gt_valid"]].max() == 1.0
    assert len(canvases) > 1 if tight_pad else canvases == {(96, 96)}


def test_train_example_reads_through_read_image(tmp_path):
    """``load_train_example`` reads each image through ``read_image``
    (path -> BGR array), the default being the PIL reader."""
    from centermask2_tpu_torch.data.preprocess import read_image_bgr

    ann, root = make_train_dataset(tmp_path / "ds")
    ds = tcoco.CocoDataset(ann, root)
    arrays = {}

    def reader(path):
        arrays[path] = read_image_bgr(path)
        return arrays[path]

    kw = dict(short_edge=48, max_size=72, pad_to=(96, 96), max_gt=4,
              patch_size=28, hflip=True)
    a = tcoco.load_train_example(ds, 2, read_image=reader, **kw)
    b = tcoco.load_train_example(ds, 2, **kw)
    assert list(arrays) == [ds.image_path(2)]
    for k in tcoco.BATCH_KEYS:
        np.testing.assert_array_equal(a[k], b[k])


def test_rasterizers_equal():
    rng = np.random.RandomState(4)
    polys = [list(rng.rand(12) * 40), list(rng.rand(8) * 40 + 5)]
    np.testing.assert_array_equal(tcoco.rasterize_polygons(polys, 48, 50),
                                  jcoco.rasterize_polygons(polys, 48, 50))
    box = np.array([3.5, 2.0, 41.0, 37.5], np.float32)
    np.testing.assert_array_equal(
        tcoco.mask_patch_from_polygons(polys, box, 28),
        jcoco.mask_patch_from_polygons(polys, box, 28))
