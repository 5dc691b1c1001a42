"""Port parity: ``centermask2_tpu_torch/ops/nms.py`` against the JAX NMS.

The port's plain greedy core (the CPU path of kernel 1) must give keep
sets bit-equal to both JAX ``nms_keep_mask`` (the XLA tiled fixpoint) and
the Pallas kernel ``nms_pallas.greedy_keep_sorted`` run in interpret
mode: same f32 IoU arithmetic, same stable score order, exact greedy.
Cases mirror tests/test_ops.py (across tiles, sparse, invalid rows,
batched) and tests/test_tpu_nms.py (n = 500/1000/2000), plus ties,
duplicates, zero-area boxes (union 0), disjoint boxes that are all kept,
and a suppression chain (box i suppresses only i+1) across every 64-box
word: the cases chip_smoke.py holds the CUDA kernel to this oracle on.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.ops import nms as jnms  # noqa: E402
from centermask2_tpu.ops.nms_pallas import greedy_keep_sorted  # noqa: E402
from centermask2_tpu_torch.ops import _kernels  # noqa: E402
from centermask2_tpu_torch.ops import nms as tnms  # noqa: E402


def make_case(kind: str, n: int, seed: int):
    """(boxes, scores, classes, valid) numpy arrays of one image."""
    rng = np.random.RandomState(seed)
    if kind == "sparse":
        boxes = rng.rand(n, 4).astype(np.float32) * 400
        boxes[:, 2:] = boxes[:, :2] + 4 + boxes[:, 2:] * 0.05
    elif kind == "all_kept":  # disjoint boxes on a grid: nothing suppressed
        side = int(np.ceil(np.sqrt(n)))
        xy = np.stack([np.arange(n) % side, np.arange(n) // side], 1) * 20.0
        boxes = np.concatenate([xy, xy + 10.0], 1).astype(np.float32)
    elif kind == "chain":  # box i overlaps i+1 (IoU 2/3) but not i+2 (3/7)
        x = np.arange(n, dtype=np.float32) * 2.0
        boxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)],
                         1).astype(np.float32)
    else:  # clustered: long suppression chains across tiles
        obj = rng.rand(40, 2) * 1000.0
        pick = rng.randint(0, 40, n)
        centers = obj[pick] + rng.randn(n, 2) * 12
        sizes = 30 + rng.rand(n, 2) * 120
        boxes = np.concatenate([centers, centers + sizes], 1).astype(np.float32)
    classes = rng.randint(0, 80, n).astype(np.int32)
    scores = rng.rand(n).astype(np.float32)
    valid = np.ones(n, bool)
    if kind == "invalid":
        valid = rng.rand(n) > 0.3
        scores[~valid] = 2.0  # invalid rows must lose even with top scores
    if kind == "chain":  # sorted order is index order: the chain crosses
        scores = np.linspace(1.0, 0.1, n).astype(np.float32)  # every word
    if kind == "ties":
        scores = (np.round(scores * 6) / 6).astype(np.float32)
    if kind == "degenerate":
        dup = rng.choice(n, n // 8, replace=False)
        boxes[dup] = boxes[(dup + 1) % n]
        zero = rng.choice(n, n // 8, replace=False)
        boxes[zero, 2:] = boxes[zero, :2]  # zero area
        boxes[zero[: len(zero) // 2]] = 5.0  # identical points: union 0
    return boxes, scores, classes, valid


def pallas_keep(boxes, scores, valid, thr, tile=128):
    """Sort/pad as nms_keep_mask does, run the Pallas greedy core in
    interpret mode, scatter back (tests/test_ops.py::_pallas_keep)."""
    boxes, scores, valid = map(jnp.asarray, (boxes, scores, valid))
    n = boxes.shape[0]
    order = jnp.argsort(-jnp.where(valid, scores, -jnp.inf))
    sboxes = jnp.take(boxes, order, axis=0)
    svalid = jnp.take(valid, order)
    pad = (-n) % tile
    sboxes = jnp.concatenate([sboxes, jnp.zeros((pad, 4), sboxes.dtype)])
    svalid = jnp.concatenate([svalid, jnp.zeros((pad,), bool)])
    keep_sorted = greedy_keep_sorted(sboxes, svalid, float(thr), tile=tile,
                                     interpret=True)
    return np.asarray(jnp.zeros((n,), bool).at[order].set(keep_sorted[:n]))


def port_keep(boxes, scores, valid, thr):
    return tnms.nms_keep_mask(torch.from_numpy(boxes)[None],
                              torch.from_numpy(scores)[None],
                              torch.from_numpy(valid)[None], thr)[0].numpy()


@pytest.mark.parametrize("n", [500, 1000, 2000])
@pytest.mark.parametrize("kind", ["clustered", "sparse", "invalid", "ties",
                                  "degenerate", "all_kept", "chain"])
def test_keep_mask_matches_jax(kind, n):
    boxes, scores, _, valid = make_case(kind, n, seed=n)
    thr = 0.6
    got = port_keep(boxes, scores, valid, thr)
    xla = np.asarray(jnms.nms_keep_mask(jnp.asarray(boxes),
                                        jnp.asarray(scores),
                                        jnp.asarray(valid), thr))
    np.testing.assert_array_equal(got, xla)
    assert got.sum() > 0 and not got[~valid].any()
    if kind == "all_kept":
        assert got.all()
    if kind == "chain":  # greedy keeps every other box
        np.testing.assert_array_equal(got, np.arange(n) % 2 == 0)


@pytest.mark.parametrize("n", [500, 1000, 2000])
def test_keep_mask_matches_pallas_interpret(n):
    boxes, scores, _, valid = make_case("invalid", n, seed=7 * n)
    for thr in (0.4, 0.6):
        got = port_keep(boxes, scores, valid, thr)
        np.testing.assert_array_equal(
            got, pallas_keep(boxes, scores, valid, thr), err_msg=f"thr={thr}")


def test_batched_keep_mask_matches_per_image():
    cases = [make_case("clustered", 700, seed=s) for s in (1, 2, 3)]
    boxes, scores, classes, valid = (
        torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(4))
    got = tnms.batched_nms(boxes, scores, classes, valid, 0.5).numpy()
    for b, (bx, sc, cl, va) in enumerate(cases):
        want = np.asarray(jnms.batched_nms(jnp.asarray(bx), jnp.asarray(sc),
                                           jnp.asarray(cl), jnp.asarray(va),
                                           0.5))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("n,max_out", [(1000, 50), (40, 10), (30, 50)])
def test_nms_select_matches_jax(n, max_out):
    boxes, scores, classes, valid = make_case("ties", n, seed=n + max_out)
    idx, ok = tnms.nms_select(torch.from_numpy(boxes)[None],
                              torch.from_numpy(scores)[None],
                              torch.from_numpy(classes)[None],
                              torch.from_numpy(valid)[None], 0.6, max_out)
    jidx, jok = jnms.nms_select(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(classes), jnp.asarray(valid),
                                0.6, max_out)
    idx, ok = idx[0].numpy(), ok[0].numpy()
    np.testing.assert_array_equal(ok, np.asarray(jok))
    # descending scores; ties in input order, as lax.top_k orders them
    np.testing.assert_array_equal(idx[ok], np.asarray(jidx)[np.asarray(jok)])
    assert np.all(np.diff(scores[idx[ok]]) <= 0)


def test_classwise_suppression():
    boxes = torch.tensor([[[0, 0, 10, 10], [0, 0, 10, 10]]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8]])
    valid = torch.ones(1, 2, dtype=torch.bool)
    keep = tnms.batched_nms(boxes, scores, torch.tensor([[0, 1]]), valid, 0.5)
    assert keep.tolist() == [[True, True]]
    keep = tnms.batched_nms(boxes, scores, torch.tensor([[1, 1]]), valid, 0.5)
    assert keep.tolist() == [[True, False]]


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA launch function never runs the plain version itself."""
    sboxes = torch.zeros(1, 128, 4)
    svalid = torch.ones(1, 128, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.nms_keep_sorted(sboxes, svalid, 0.5)


def test_masked_topk_matches_jax():
    from centermask2_tpu.ops import masked_topk as jax_masked_topk
    from centermask2_tpu_torch.ops import masked_topk

    rng = np.random.RandomState(9)
    scores = rng.rand(300).astype(np.float32)
    mask = rng.rand(300) > 0.8
    for k in (10, 100):  # fewer and more slots than unmasked entries
        idx, ok, vals = masked_topk(torch.from_numpy(scores),
                                    torch.from_numpy(mask), k)
        jidx, jok, jvals = jax_masked_topk(jnp.asarray(scores),
                                           jnp.asarray(mask), k)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(idx.numpy()[ok.numpy()],
                                      np.asarray(jidx)[np.asarray(jok)])
