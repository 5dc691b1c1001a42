"""Port parity of ROI training's proposal side and of the ROIAlign
gradient against the JAX package, on the CPU in float32: detectron2
matching, the sampler with JAX's own uniform draws (``jax.random.uniform``
of each key of ``jax.random.split(rng, B)``, handed to the port as
``draws``), the tie order of the fg pick and of the sampler, and the
plain ROIAlign VJP against ``jax.vjp``.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_match_proposals_d2_interval_semantics():
    """tests/test_train.py:199 on the port: thresholds [0.3, 0.7] with
    labels [0, -1, 1]; the default single threshold."""
    from centermask2_tpu_torch.models.roi import match_proposals

    gt = torch.tensor([[[0.0, 0.0, 10.0, 10.0]]])
    gt_valid = torch.ones((1, 1), dtype=torch.bool)
    props = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [0.0, 0.0, 10.0, 5.0],
                           [8.0, 8.0, 18.0, 18.0]]])
    idx, labels = match_proposals(gt, gt_valid, props, (0.3, 0.7),
                                  (0, -1, 1))
    assert labels.tolist() == [[1, -1, 0]]
    assert idx.tolist() == [[0, 0, 0]]
    _, labels1 = match_proposals(gt, gt_valid, props)
    assert labels1.tolist() == [[1, 1, 0]]


def _proposals(rng, B, K, G):
    gt = np.zeros((B, G, 4), np.float32)
    for b in range(B):
        xy = rng.rand(G, 2) * 60
        gt[b] = np.concatenate([xy, xy + 10 + rng.rand(G, 2) * 30], 1)
    pick = rng.randint(0, G, (B, K))
    props = np.take_along_axis(gt, pick[..., None], 1) + \
        rng.randn(B, K, 4).astype(np.float32) * 4
    props[:, ::5] = gt[:, :1]  # exact copies: equal IoUs with the gt
    return gt, props.astype(np.float32)


def test_sampler_matches_jax_with_its_draws():
    """label_and_sample_proposals with JAX's uniform draws: more
    foreground than the positive quota, and then more foreground rows
    than the fg pick's capacity (F = 4): the rows equal JAX's, ties taken
    in JAX's order."""
    from centermask2_tpu.models.roi import heads as jh
    from centermask2_tpu.ops import masked_topk as jmt
    from centermask2_tpu_torch.models.roi import label_and_sample_proposals
    from centermask2_tpu_torch.ops import masked_topk

    rng = np.random.RandomState(4)
    B, K, G, S, F = 2, 40, 5, 32, 4
    gt, props = _proposals(rng, B, K, G)
    pvalid = rng.rand(B, K) > 0.1
    gvalid = np.ones((B, G), bool)
    gvalid[1, 3:] = False
    classes = rng.randint(0, 6, (B, G)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    keys = jax.random.split(key, B)
    draws = np.stack([np.asarray(jax.random.uniform(k, (K + G,)))
                      for k in keys])
    got = label_and_sample_proposals(
        t(draws), t(props), t(pvalid), t(gt), t(classes), t(gvalid), 6, S,
        0.5)
    fg_t = got.valid & (got.gt_classes != 6)
    idx_t, val_t, _ = masked_topk(fg_t.float(), fg_t, F)
    for b in range(B):
        want = jh.label_and_sample_proposals(
            keys[b], jnp.asarray(props[b]), jnp.asarray(pvalid[b]),
            jnp.asarray(gt[b]), jnp.asarray(classes[b]),
            jnp.asarray(gvalid[b]), 6, S, 0.5)
        for f in ("valid", "gt_classes", "gt_indices", "boxes"):
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        fg = want.valid & (want.gt_classes != 6)
        assert int(fg.sum()) == S // 2 > F  # quota met, more than F
        idx_j, val_j, _ = jmt(fg.astype(jnp.float32), fg, F)
        np.testing.assert_array_equal(idx_t[b].numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(val_t[b].numpy(), np.asarray(val_j))


def test_masked_topk_takes_ties_lowest_index_first():
    """The fg pick ranks 0/1 values: with more ones than k, the k lowest
    indices of the ones, then the lowest of the zeros, as lax.top_k."""
    from centermask2_tpu.ops import masked_topk as jmt
    from centermask2_tpu_torch.ops import masked_topk

    rng = np.random.RandomState(5)
    mask = rng.rand(3, 512) > 0.3
    for k in (4, 128, 500):
        idx, valid, vals = masked_topk(t(mask).float(), t(mask), k)
        for b in range(3):
            ji, jv, jvals = jmt(jnp.asarray(mask[b], jnp.float32),
                                jnp.asarray(mask[b]), k)
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
            np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jv))


def test_subsample_breaks_equal_priorities_by_index():
    """``3 + r`` rounds distinct draws to one f32: the sampler must keep
    the lower index first, as lax.top_k does."""
    from centermask2_tpu.models.roi.heads import subsample_proposals as js
    from centermask2_tpu_torch.models.roi import subsample_proposals

    P = 64
    r = np.full(P, 0.25, np.float32)
    r[::2] += np.float32(2 ** -26)  # distinct, but 3 + r rounds alike
    assert len(set((np.float32(3) + r).tolist())) == 1
    fg = np.zeros(P, bool)
    fg[::3] = True
    bg = ~fg
    idx, is_fg, valid = subsample_proposals(t(r[None]), t(fg[None]),
                                            t(bg[None]), 16, 0.25)

    class FixedKey:  # stand-in: jax.random.uniform is replaced below
        pass

    real = jax.random.uniform
    try:
        jax.random.uniform = lambda key, shape: jnp.asarray(r)
        ji, jf, jv = js(FixedKey(), jnp.asarray(fg), jnp.asarray(bg), 16,
                        0.25)
    finally:
        jax.random.uniform = real
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ji))
    np.testing.assert_array_equal(is_fg[0].numpy(), np.asarray(jf))
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))


def test_roi_align_plain_vjp_matches_jax():
    """The CPU backward (JAX's separable VJP, in NCHW) against jax.vjp of
    multilevel_roi_align, 1e-5 relative; boxes get no gradient."""
    from centermask2_tpu.ops.roi_align import multilevel_roi_align as jra
    from centermask2_tpu_torch.ops.roi_align import multilevel_roi_align

    rng = np.random.RandomState(8)
    N, C = 2, 6
    shapes = [(16, 20), (8, 10), (4, 5)]
    feats = [rng.randn(N, C, h, w).astype(np.float32) for h, w in shapes]
    R = 24
    xy = rng.rand(R, 2) * [160, 128]
    wh = 2 + rng.rand(R, 2) * 80
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[:3, 0] = -15.0  # across the border
    boxes[3] = [170.0, 140.0, 200.0, 160.0]  # outside
    bidx = rng.randint(0, N, R).astype(np.int32)
    levels = rng.randint(0, 3, R).astype(np.int32)
    g = rng.randn(R, C, 7, 7).astype(np.float32)
    scales = (1 / 8, 1 / 16, 1 / 32)

    def jf(*fs):
        return jra(list(fs), jnp.asarray(boxes), jnp.asarray(bidx),
                   jnp.asarray(levels), scales, 7, 2, True)

    jfeats = [jnp.asarray(np.transpose(f, (0, 2, 3, 1))) for f in feats]
    out, vjp = jax.vjp(jf, *jfeats)
    want = vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))
    xs = [t(f).requires_grad_(True) for f in feats]
    bx = t(boxes).requires_grad_(True)
    got = multilevel_roi_align(xs, bx, t(bidx), t(levels), scales, 7, 2)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.transpose(np.asarray(out), (0, 3, 1, 2)),
                               atol=1e-5)
    (got * t(g)).sum().backward()
    for x, w in zip(xs, want):
        w = np.transpose(np.asarray(w), (0, 3, 1, 2))
        np.testing.assert_allclose(x.grad.numpy(), w,
                                   atol=1e-5 * np.abs(w).max())
    assert bx.grad is None
