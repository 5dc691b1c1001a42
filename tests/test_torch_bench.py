"""The port's measuring tools on the CPU (``centermask2_tpu_torch/tools/
bench.py``, ``bench_train.py``, ``bench_stages.py``,
``bench_train_stages.py``, ``profile_model.py``, ``roofline_bound.py`` and
``utils/trace_sections.py``), at a tiny size (V-19-slim, FPN 32, 64x64,
f32: ``tests/test_torch_train.py::TINY_OPTS``) with one intra-op thread.

- Each tool, run with ``--device cpu`` by ``chip_smoke.py``'s ``[bench]``
  phase (``bench_phase``, rehearsed here), gives its JSON line or tables
  with the JAX tool's keys (read from the JAX tool's source; the renamed
  ones as the port's docstrings list them), the device metrics null.
- The stage functions on weights from ``load_jax_params`` equal JAX's
  ``CenterMask.features``, ``_fcos_raw``, ``decode_batch`` and ``apply``,
  and the train arms' losses JAX's ``CenterMask.loss``, within the
  tolerances of ``test_torch_model.py`` and ``test_torch_train.py``.
- ``section_of`` on the port path of every JAX name-stack path of the
  flagship's and the keypoint model's inference and loss gradient equals
  ``centermask2_tpu/utils/trace_sections.section_of``; every port module
  with parameters runs in a named section; ops of the backward take their
  forward op's path.
- ``roofline_bound``'s bound of a convolution and of elementwise ops
  equals the hand count.
- Without CUDA and without ``--device cpu`` each tool raises (``bench``
  prints its error line and exits 1).
"""

import contextlib
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models import GroundTruth as JaxGroundTruth  # noqa: E402
from centermask2_tpu.models.fcos import decode_batch as jax_decode_batch  # noqa: E402
from centermask2_tpu.utils import trace_sections as jax_sections  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params  # noqa: E402
from centermask2_tpu_torch.models.meta import CenterMask, GroundTruth  # noqa: E402
from centermask2_tpu_torch.tools import (bench, bench_stages,  # noqa: E402
                                         bench_train, bench_train_stages,
                                         profile_model, roofline_bound)
from centermask2_tpu_torch.utils import measures, trace_sections  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY_OPTS = [
    "MODEL.MASK_ON", "True", "MODEL.MASKIOU_ON", "True",
    "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE", "MODEL.FCOS.NUM_CLASSES", "2",
    "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
    "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8", "TPU.FIXED_EDGE_SIZE", "64",
    "TPU.NMS_CANDIDATES", "50", "MODEL.FCOS.PRE_NMS_TOPK_TRAIN", "50",
    "MODEL.FCOS.POST_NMS_TOPK_TRAIN", "20",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32", "TPU.MAX_FG_PROPOSALS", "8",
    "TPU.MAX_GT_INSTANCES", "8", "TPU.COMPUTE_DTYPE", "float32"]
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test processes on
    the machine's cores, where torch's default pool of a thread per core
    in each of them spends its time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """``chip_smoke.py``'s ``[bench]`` phase rehearsed on the CPU at the
    tiny size: each tool run once in process, its result and output by
    name, the phase's log, its launch counts and the two traces."""
    import chip_smoke

    root = tmp_path_factory.mktemp("traces")
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "card_line", lambda: "CPU rehearsal, no card")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            counts, out = chip_smoke.bench_phase(
                "cpu", opts=TINY_OPTS, edge=64, train_edge=64, batch=2,
                profile_runs=1, trace_dir=str(root))
    finally:
        mp.undo()
    return {**out, "counts": counts, "log": buf.getvalue(),
            "traces": (root / "request", root / "train")}


def _jax_keys(tool: str):
    """The JSON keys the JAX tool writes: its first dict's literal keys
    and every ``name["key"]`` assignment, from its source."""
    src = (REPO / tool).read_text()
    name = "result" if tool == "bench.py" else "out"
    first = re.search(rf"{name} = \{{(.*?)\n    \}}", src, re.S).group(1)
    keys = set(re.findall(r'^\s*"(\w+)":', first, re.M))
    keys |= set(re.findall(rf'{name}\["(\w+)"\]', src))
    return keys


RENAMED = {"nms_pallas_equal": "nms_kernel_equal",
           "nms_pallas_keep_count": "nms_kernel_keep_count"}


def test_bench_line_has_the_jax_keys(outputs):
    rc, text = outputs["bench"]
    assert rc == 0
    line = json.loads(text.strip().splitlines()[-1])
    want = {RENAMED.get(k, k) for k in _jax_keys("bench.py")}
    # square_{edge}_* only where the square is not the primary canvas
    want = {k for k in want if not k.startswith("square_")}
    assert {"value", "mfu", "sustained_images_per_sec",
            "nms_kernel_equal"} <= want
    assert want <= set(line), want - set(line)
    for k in ("value", "vs_baseline", "window_spread", "mfu",
              "achieved_tflops", "sustained_images_per_sec",
              "batched_images_per_sec", "sustained_tight_images_per_sec",
              "device_resident_images_per_sec", "link_mb_per_sec",
              "nms_kernel_equal"):
        assert line[k] is None, k
    for k in ("host_preprocess_ms", "host_pack_u8_ms",
              "transfer_mb_per_image", "model_tflops"):
        assert line[k] > 0, k
    assert set(line["rehearsal_ms"]) >= {"value", "sustained_ms_per_image"}
    assert line["canvas"] == [64, 64] and line["device"] == {
        "platform": "cpu"}


def test_bench_train_line_has_the_jax_keys(outputs):
    rc, text = outputs["bench_train"]
    assert rc == 0
    line = json.loads(text.strip().splitlines()[-1])
    want = _jax_keys("tools/bench_train.py")
    assert {"value", "imgs_per_sec", "window_spread", "step_tflops",
            "mfu"} <= want
    assert want | {"peak_memory_gib", "device"} <= set(line)
    assert line["value"] is None and line["mfu"] is None
    assert line["step_tflops"] > 0 and line["rehearsal_ms"]["value"] > 0
    assert (line["edge"], line["batch"]) == ("64", 2)


def test_stage_tables(outputs):
    rows, text = outputs["bench_stages"]
    for label in ("backbone+fpn:", "+fcos head:", "+decode(topk+nms):",
                  "full pipeline:", "[extra] nms_select:"):
        assert label in text
    assert re.search(r"stage +ms +GFLOP +TFLOP/s +%peak", text)
    assert [r["name"] for r in rows["stages"]] == list(bench_stages.LABELS)
    gflop = [r["flops"] for r in rows["stages"]]
    assert all(b >= a > 0 for a, b in zip(gflop, gflop[1:]))
    rows, text = outputs["bench_train_stages"]
    assert set(rows["stages"]) == {"loss-fwd", "loss-fwd+bwd", "full-step",
                                   "fcos-only fwd+bwd"}
    assert "increments: backward" in text and "ROI branch" in text
    st = rows["stages"]
    assert st["loss-fwd+bwd"]["gflop"] > 2 * st["loss-fwd"]["gflop"]
    assert st["fcos-only fwd+bwd"]["gflop"] < st["loss-fwd+bwd"]["gflop"]


def test_profile_model_tables_and_records(outputs):
    for what in ("profile_model", "profile_model --train"):
        summary, text = outputs[what]
        for head in ("ms/run", "section rollup:", "kernel (module path)"):
            assert head in text
        line = json.loads(text.strip().splitlines()[-1])
        assert line["attributed_share"] == summary["attributed_share"] > 0.9
        assert line["replay_device_ms"] is None  # no card
    trace, train_trace = outputs["traces"]
    for d in (trace, train_trace):
        assert {"trace.json", "ops.jsonl", "meta.json"} <= {
            p.name for p in d.iterdir()}
    ops = [json.loads(x) for x in (train_trace / "ops.jsonl").read_text()
           .splitlines()]
    assert [r["i"] for r in ops] == list(range(len(ops)))
    convs = [r for r in ops if r["op"] == "aten.convolution.default"]
    assert convs and all(r["flops"] > 0 and r["bytes"] > 0 for r in convs)
    bwd = {r["path"] for r in ops if r["op"].startswith("cm2.roi_align_back")}
    assert bwd == {"transpose/CenterMask.loss/roi_heads.mask_forward_train/"
                   "roi_heads.pool"}
    sections = outputs["profile_model --train"][0]["sections"]
    assert {"backbone", "backbone [bwd]", "fcos_head [bwd]", "optimizer",
            "roi+mask+maskiou [bwd]", "losses/assign"} <= set(sections)


def test_roofline_table(outputs):
    table, text = outputs["roofline_bound"]
    assert "per section (ms):" in text and "worst headroom ops" in text
    assert table["sections"] and table["total_ms"] > 0
    for s in table["sections"].values():  # sums of per-op maxima
        assert max(s["flop_ms"], s["hbm_ms"]) <= s["bound_ms"] * (1 + 1e-12)
        assert s["bound_ms"] <= (s["flop_ms"] + s["hbm_ms"]) * (1 + 1e-12)


# ------------------------------------------------------- parity with JAX
PIXEL_MEAN = np.asarray([103.53, 116.28, 123.675], np.float32)
# one conv a tower and a head: the parity holds module by module in the
# JAX comparisons of test_torch_model.py; here it is the stages' cut
HEADS = dict(num_cls_convs=1, num_box_convs=1, mask_num_conv=1,
             maskiou_num_conv=1)
SMALL = dict(conv_body="V-19-slim-eSE", num_classes=5, fpn_out_channels=64,
             mask_conv_dim=16, maskiou_conv_dim=16, post_nms_topk_test=15,
             **HEADS)


def test_stage_functions_match_jax():
    """``bench_stages.stage_fns`` of the port on JAX's parameters against
    JAX's ``features``, ``_fcos_raw``, ``decode_batch`` and ``apply``
    (tests/test_torch_model.py's model, canvas and tolerances; the
    parameters drawn as tests/test_torch_backbones.py draws them)."""
    from test_torch_backbones import numpy_params

    rng = np.random.RandomState(0)
    img = rng.rand(1, 128, 160, 3).astype(np.float32) * 255.0 - PIXEL_MEAN
    jm = JaxCenterMask(**SMALL, dtype=jnp.float32)
    x = jnp.asarray(img)
    params = numpy_params(jm, rng, x)
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0  # real candidates
    v = {"params": jax.tree.map(jnp.asarray, params)}

    def jstages(v, x):
        feats = jm.apply(v, x, method=JaxCenterMask.features)
        locs, logits, reg, ctr = jm.apply(v, feats,
                                          method=JaxCenterMask._fcos_raw)
        props = jax_decode_batch(
            locs, logits, reg, ctr, jm.fpn_strides,
            pre_nms_thresh=jm.pre_nms_thresh_test,
            pre_nms_topk=jm.pre_nms_topk_test, nms_thresh=jm.nms_thresh,
            post_nms_topk=jm.post_nms_topk_test,
            nms_candidates=jm.nms_candidates)
        return feats, (logits, reg, ctr), props, jm.apply(v, x)

    feats, head, props, out = jax.jit(jstages)(v, x)
    port = CenterMask(**SMALL, dtype=torch.float32).eval()
    load_jax_params(port, params)
    fns = bench_stages.stage_fns(port)
    xt = torch.from_numpy(img)
    got_feats = fns["backbone+fpn"](xt)
    assert set(got_feats) == set(feats)
    for k, f in feats.items():
        np.testing.assert_allclose(
            got_feats[k].permute(0, 2, 3, 1).numpy(), np.asarray(f),
            rtol=1e-3, atol=1e-3 * float(np.abs(np.asarray(f)).max()),
            err_msg=k)
    _, *got_head = fns["fcos head"](xt)
    for gs, js in zip(got_head, head):
        for g, j in zip(gs, js):
            np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                       np.asarray(j), rtol=1e-3, atol=2e-3)
    got = fns["decode"](xt)
    valid = np.asarray(props.valid[0])
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    assert valid.sum() > 3
    np.testing.assert_array_equal(got.pred_classes[0].numpy()[valid],
                                  np.asarray(props.pred_classes[0])[valid])
    np.testing.assert_allclose(got.scores[0].numpy(),
                               np.asarray(props.scores[0]), rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.pred_boxes[0].numpy()[valid],
                               np.asarray(props.pred_boxes[0])[valid],
                               rtol=1e-3, atol=2e-2)
    full = fns["roi+mask+maskiou"](xt)
    n = int(np.asarray(out.valid[0]).sum())
    np.testing.assert_array_equal(full.valid[0].numpy(),
                                  np.asarray(out.valid[0]))
    np.testing.assert_allclose(full.scores[0][:n].numpy(),
                               np.asarray(out.scores[0])[:n], rtol=2e-4,
                               atol=1e-5)
    np.testing.assert_allclose(full.pred_masks[0][:n].numpy(),
                               np.asarray(out.pred_masks[0])[:n], atol=2e-3)
    np.testing.assert_allclose(full.mask_scores[0][:n].numpy(),
                               np.asarray(out.mask_scores[0])[:n],
                               rtol=2e-3, atol=2e-3)


def test_train_arms_losses_match_jax():
    """Each arm of ``bench_train_stages`` (loss forward, forward and
    backward, the eager full step, the FCOS-only model's forward and
    backward) returns JAX's summed ``CenterMask.loss`` on the same
    parameters and sampler draws (tests/test_torch_train.py's batch and
    tolerance; the parameters drawn as tests/test_torch_backbones.py
    draws them)."""
    from test_torch_backbones import numpy_params
    from test_torch_train import STEP_KW, _step_batch

    from centermask2_tpu_torch.train import make_optimizer

    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    key = jax.random.PRNGKey(1)
    jgt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                         classes=jnp.asarray(classes),
                         valid=jnp.ones((B, G), bool),
                         mask_patches=jnp.asarray(patches))
    draws = np.stack([np.asarray(jax.random.uniform(k, (10 + G,)))
                      for k in jax.random.split(key, B)])
    gt = GroundTruth(torch.from_numpy(boxes), torch.from_numpy(classes),
                     torch.ones((B, G), dtype=torch.bool),
                     torch.from_numpy(patches))
    jm = JaxCenterMask(**STEP_KW, **HEADS, dtype=jnp.float32)
    params = numpy_params(jm, rng, jnp.asarray(images[:1]))
    # at the prior bias no random-weight score passes the train threshold
    params["fcos_head"]["cls_logits"]["bias"][:] = 0.0
    losses = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(images), jgt, key,
        method=JaxCenterMask.loss))(jax.tree.map(jnp.asarray, params))
    # the FCOS-only model: the same parameters but the mask and MaskIoU
    # heads', whose losses its sum lacks
    want = {mask: float(sum(np.float64(v) for k, v in losses.items()
                            if mask or k.startswith("loss_fcos")))
            for mask in (True, False)}
    models = {}
    for mask in (True, False):
        models[mask] = CenterMask(**STEP_KW, **HEADS, mask_on=mask,
                                  maskiou_on=mask,
                                  dtype=torch.float32).train()
        roi = {k: v for k, v in params["roi_heads"].items()
               if mask or k not in ("mask_head", "maskiou_head")}
        load_jax_params(models[mask], {**params, "roi_heads": roi})
    opt, sched = make_optimizer(models[True], 0.01, (100,))
    arms = bench_train_stages.train_arms(models[True], opt, sched,
                                         models[False], gt,
                                         torch.from_numpy(draws))
    assert [n for n, _ in arms] == ["loss-fwd", "loss-fwd+bwd", "full-step",
                                    "fcos-only fwd+bwd"]
    x = torch.from_numpy(images)
    for name, fn in arms:  # the full step reports the losses before SGD
        np.testing.assert_allclose(
            float(fn(x)), want[name != "fcos-only fwd+bwd"], rtol=1e-5,
            err_msg=name)


# -------------------------------------------------------------- sections
def _jax_name_stacks(jm, x, gt):
    """Every name-stack path of the JAX model's inference and of the
    gradient of its summed loss (``jax.make_jaxpr``: traced, not run)."""
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x[:1])
    v = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), v)

    def grad(p):
        return sum(jm.apply({"params": p}, x, gt, jax.random.PRNGKey(1),
                            method=JaxCenterMask.loss).values())

    stacks = set()

    def walk(jaxpr):
        for e in jaxpr.eqns:
            stacks.add(str(e.source_info.name_stack))
            for sub in jax.core.jaxprs_in_params(e.params):
                walk(sub)

    walk(jax.make_jaxpr(lambda v: jm.apply(v, x[:1]))(v).jaxpr)
    walk(jax.make_jaxpr(jax.grad(grad))(v["params"]).jaxpr)
    return stacks


def port_path(jax_path: str) -> str:
    """The path the port records for an op of a JAX name-stack path: the
    same scopes (the port mirrors the JAX module names and scopes the
    same methods), without the top module's own ``CenterMask`` scope,
    transforms unwrapped (``jvp(X)`` -> ``X``), einsum and ``vmap``
    scopes dropped (the port has none), and a backward path (JAX's
    ``transpose(jvp(...))``) behind ``transpose/``."""
    parts = []
    for c in jax_path.split("/"):
        while re.fullmatch(r"\w+\(.*\)", c) and not c.startswith("vmap"):
            c = c[c.index("(") + 1:-1]
        if c and c != "CenterMask" and "->" not in c and \
                not c.startswith("vmap"):
            parts.append(c)
    return ("transpose/" if jax_path.startswith("transpose(") else "") + \
        "/".join(parts)


def test_port_path_mapping():
    assert port_path("transpose(jvp(CenterMask.loss))/CenterMask.features/"
                     "backbone") == "transpose/CenterMask.loss/" \
        "CenterMask.features/backbone"
    assert port_path("CenterMask/CenterMask.inference/roi_heads/"
                     "rhwc,rc->rhw") == "CenterMask.inference/roi_heads"
    assert port_path("jvp(CenterMask.loss)/CenterMask._decode/vmap()") == \
        "CenterMask.loss/CenterMask._decode"


@pytest.mark.parametrize("kind", ["flagship", "keypoint"])
def test_sections_of_jax_paths(kind):
    """The port's ``section_of`` on the port path of each JAX path equals
    JAX's ``section_of`` on the JAX path, every named section met."""
    B, G = 2, 2
    x = jnp.zeros((B, 64, 64, 3))
    common = dict(conv_body="V-19-slim-eSE", fpn_out_channels=32,
                  pre_nms_topk_test=20, post_nms_topk_test=5,
                  nms_candidates=20, pre_nms_topk_train=20,
                  post_nms_topk_train=10, batch_size_per_image=16,
                  max_fg_proposals=4, **HEADS)
    if kind == "flagship":
        jm = JaxCenterMask(**common, num_classes=5, mask_conv_dim=8,
                           maskiou_conv_dim=8, mask_on=True, maskiou_on=True)
        kp = None
    else:
        jm = JaxCenterMask(**common, num_classes=1, mask_on=False,
                           maskiou_on=False, keypoint_on=True,
                           keypoint_conv_dims=(8, 8))
        kp = jnp.ones((B, G, 17, 3))
    gt = JaxGroundTruth(boxes=jnp.tile(jnp.asarray([4.0, 4.0, 30.0, 40.0]),
                                       (B, G, 1)),
                        classes=jnp.zeros((B, G), jnp.int32),
                        valid=jnp.ones((B, G), bool),
                        mask_patches=jnp.zeros((B, G, 16, 16)), keypoints=kp)
    stacks = _jax_name_stacks(jm, x, gt)
    met = set()
    for p in sorted(stacks):
        want = jax_sections.section_of(p)
        assert trace_sections.section_of(port_path(p)) == want, (
            p, port_path(p))
        met.add(want)
    assert {"backbone", "fpn", "fcos_head", "decode+nms",
            "roi+mask+maskiou", "losses/assign", "backbone [bwd]",
            "roi+mask+maskiou [bwd]"} <= met
    assert [n for n, _ in trace_sections.SECTIONS] == \
        [n for n, _ in jax_sections.SECTIONS]


def _tiny_port(keypoint: bool):
    kw = dict(conv_body="V-19-slim-eSE", fpn_out_channels=32,
              pre_nms_topk_train=20, post_nms_topk_train=10,
              nms_candidates=20, batch_size_per_image=16,
              max_fg_proposals=4, dtype=torch.float32)
    if keypoint:
        return CenterMask(**kw, num_classes=1, mask_on=False,
                          maskiou_on=False, keypoint_on=True,
                          keypoint_conv_dims=(8, 8))
    return CenterMask(**kw, num_classes=4, mask_conv_dim=8,
                      maskiou_conv_dim=8)


@pytest.mark.parametrize("keypoint", [False, True])
def test_every_port_module_falls_in_a_named_section(keypoint):
    """Every module with parameters of the flagship and the keypoint
    model runs in a named section, in inference and in a train step (the
    scope stack of ``profile_model.Scopes`` read by a hook of each
    module), and every recorded op of the step but autograd's own
    bookkeeping has a named section."""
    from test_torch_keypoints import _kp_batch

    from centermask2_tpu_torch.train import make_optimizer, make_train_step
    from centermask2_tpu_torch.utils.trace_sections import section_of

    torch.manual_seed(0)
    model = _tiny_port(keypoint)
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.fill_(-1.0)
    opt, sched = make_optimizer(model, 0.01, (100,))
    _, images, boxes, kps = _kp_batch()
    B, G = boxes.shape[:2]
    gt = GroundTruth(torch.from_numpy(boxes),
                     torch.zeros((B, G), dtype=torch.int32),
                     torch.ones((B, G), dtype=torch.bool),
                     torch.rand(B, G, 16, 16),
                     torch.from_numpy(kps) if keypoint else None)
    x = torch.from_numpy(images)
    scopes = profile_model.Scopes(model, opt)
    seen = {}
    for q, m in model.named_modules():
        if q:
            m.register_forward_hook(
                lambda m, a, o, q=q: seen.setdefault(q, set()).add(
                    section_of("/".join(scopes.stack))))
    model.eval()
    profile_model.record_ops(lambda: model.inference(x[:1]), scopes)
    step = make_train_step(model, opt, sched, capture=False)
    records = profile_model.record_ops(lambda: step(x, gt), scopes)
    # a module whose parameters its parent reads (the eSE's fc, the
    # GroupNorm under a norm wrapper) runs in its nearest called ancestor
    owners = {}
    for q, m in model.named_modules():
        if list(m.parameters(recurse=False)):
            run = q
            while run not in seen:
                assert "." in run, q
                run = run.rsplit(".", 1)[0]
            owners[q] = seen[run]
    assert owners and not {q: s for q, s in owners.items()
                           if "(unattributed)" in s}
    bwd = [r for r in records if r["bwd"]]
    assert bwd and all(r["path"].startswith("transpose/") for r in bwd)
    named = [r for r in records if section_of(r["path"]) != "(unattributed)"]
    loose = {r["op"] for r in records if r not in named}
    assert loose <= {"aten.detach.default", "aten.ones_like.default",
                     "aten.rand.generator", "aten.rand.default",
                     "aten.stack.default", "aten.unbind.int",
                     "aten.add.Tensor", "aten.clone.default",
                     "aten.add_.Tensor", "aten.empty.memory_format",
                     "aten.uniform_.default", "aten.view.default",
                     "aten._to_copy.default", "aten.lift_fresh.default"}, \
        loose
    assert scopes.stack == [] and not scopes.handles


# --------------------------------------------------------------- bounds
def test_roofline_bound_of_a_convolution_and_elementwise_ops():
    """``op_counts`` and ``op_bound`` against the hand count: a bf16 and
    an f32 3x3 convolution (TF32 off and on), a broadcast add, a copy
    into an existing tensor (not read) and a gather."""
    peaks = measures.peaks_of(H100)
    scopes = profile_model.Scopes(torch.nn.Identity())

    def rec(fn):
        records = profile_model.record_ops(fn, scopes)
        assert len(records) == 1, [r["op"] for r in records]
        return records[0]

    N, C, O, Hh, W, k = 2, 8, 16, 12, 10, 3
    for dtype, tf32 in ((torch.bfloat16, False), (torch.float32, False),
                        (torch.float32, True)):
        x = torch.randn(N, C, Hh, W, dtype=dtype)
        w = torch.randn(O, C, k, k, dtype=dtype)
        b = torch.randn(O, dtype=dtype)
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            r = rec(lambda: torch.ops.aten.convolution(
                x, w, b, [1, 1], [1, 1], [1, 1], False, [0, 0], 1))
        finally:
            torch.backends.cudnn.allow_tf32 = saved
        elt = x.element_size()
        flops = 2 * N * O * Hh * W * C * k * k
        nbytes = (x.numel() + w.numel() + b.numel() + N * O * Hh * W) * elt
        assert (r["flops"], r["bytes"]) == (flops, nbytes)
        peak = {torch.bfloat16: 989e12}.get(dtype, 495e12 if tf32 else 67e12)
        want = max(flops / peak, nbytes / 3.35e12) * 1e3
        assert roofline_bound.op_bound(r, peaks)[2] == pytest.approx(
            want, rel=1e-12)
    a, c = torch.randn(1000, 1), torch.randn(1, 500)
    r = rec(lambda: a + c)
    assert (r["flops"], r["bytes"]) == (0, (1000 + 500 + 1000 * 500) * 4)
    assert roofline_bound.op_bound(r, peaks) == pytest.approx(
        (0.0, r["bytes"] / 3.35e12 * 1e3, r["bytes"] / 3.35e12 * 1e3))
    dst, src = torch.empty(300, 7), torch.randn(300, 7)
    assert rec(lambda: dst.copy_(src))["bytes"] == 2 * 300 * 7 * 4
    big, idx = torch.randn(4000, 64), torch.arange(0, 4000, 100)
    assert rec(lambda: big.index_select(0, idx))["bytes"] == \
        2 * 40 * 64 * 4 + 40 * 8


def test_peaks_by_card_name():
    p = measures.peaks_of(H100)
    assert p == (989e12, 495e12, 67e12, 3.35e12)
    assert p.flops(torch.bfloat16) == p.flops(torch.float16) == 989e12
    assert p.flops(torch.float32, tf32=True) == 495e12
    assert p.flops(torch.float32) == 67e12
    assert measures.peaks_of("NVIDIA H100 PCIe").bf16 == 756e12
    assert measures.peaks_of("NVIDIA A100-SXM4-80GB") is None
    assert measures.chip_peaks("cpu") is None


def test_roofline_needs_peaks_for_a_cpu_trace(outputs):
    trace, _ = outputs["traces"]
    with pytest.raises(ValueError, match="--peak-tflops"):
        roofline_bound.main([str(trace)])


# ---------------------------------------------------------- no card
@pytest.mark.parametrize("tool", [bench_train, bench_stages,
                                  bench_train_stages, profile_model])
def test_tools_raise_without_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(TINY_OPTS)


def test_bench_exits_1_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(TINY_OPTS) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] is None and "no CUDA device" in line["error"]


def test_bench_exits_1_on_a_failed_section(monkeypatch, capsys):
    """A section that raises (here the NMS check) makes bench print the
    error line and exit 1, where bench.py would print ``[warn]``."""
    def broken(*a, **k):
        raise RuntimeError("nms failed")

    monkeypatch.setattr(bench, "nms_boxes", broken)
    monkeypatch.setenv("BENCH_EDGE", "64")
    assert bench.main(["--device", "cpu", *TINY_OPTS]) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "nms failed" in line["error"] and "sustained_ms_per_image" \
        not in line


# ------------------------------------------------------------ chip_smoke
def test_bench_phase_rehearsal(outputs):
    """``chip_smoke.bench_phase`` on the CPU: every tool runs, its line
    parses with the device values null, the arms' medians logged (the
    host clock's order is not held), the profiles place kernels 1, 2 and
    2b (their ops' names) in their sections; no kernel launches (the
    plain versions run on the CPU)."""
    assert outputs["counts"] == {"nms": 0, "roi_align": 0,
                                 "roi_align_backward": 0,
                                 "group_norm_relu": 0}
    for what in ("bench: None ms", "bench_train: None ms",
                 "bench_stages: the arms' medians (host clock)",
                 "bench_train_stages, the ROI branch",
                 "profile_model: ", "profile_model --train: ",
                 "roi_align_backward in roi+mask+maskiou [bwd]"):
        assert what in outputs["log"], what
