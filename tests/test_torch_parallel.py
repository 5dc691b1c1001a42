"""Port parity for data parallelism: the two-rank port over
``torch.distributed`` (gloo, on the CPU) against the JAX package's
two-device ``shard_map`` programs, and against the port in one process.

Each two-rank case spawns a pair of plain Python processes (the pattern
of tests/test_distributed.py: a free port, the ``CM2_*`` environment, a
timeout) that import ``torch`` and the port only, which an import blocker
in each child enforces; the JAX side runs in the pytest process on
``jax.devices()[:2]`` of the 8 virtual CPU devices. Sizes are those of
``test_torch_train.py``: V-19-slim, 64x64 canvases, f32, small decode
sizes, gt boxes whose geometry varies from image to image, so the FCOS
normalizer sums differ from rank to rank.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from centermask2_tpu.models import CenterMask as JaxCenterMask  # noqa: E402
from centermask2_tpu.models import GroundTruth as JaxGroundTruth  # noqa: E402
from centermask2_tpu_torch.checkpoint.from_jax import (  # noqa: E402
    state_dict_from_jax)
from centermask2_tpu_torch.models.meta import (  # noqa: E402
    CenterMask, GroundTruth)
from centermask2_tpu_torch.parallel import (  # noqa: E402
    init_distributed, local_rows, shard_batch, shutdown)
from centermask2_tpu_torch.train import (  # noqa: E402
    make_optimizer, make_train_step)
from test_torch_train import STEP_KW, _perturbed_params, _step_batch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test processes on the
    machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CHILD_PRELUDE = """
import importlib.abc, os, sys, json
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "centermask2_tpu"):
            raise ImportError("the port's ranks import no JAX: " + name)
sys.meta_path.insert(0, _Block())
import numpy as np
import torch
torch.set_num_threads(1)
OUT = os.environ["OUT"]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))
"""


def _spawn_pair(script: str, tmp_path, timeout: int = 300):
    """Run ``script`` as ranks 0 and 1 of a gloo group (``CM2_*``
    environment, ``OUT`` = ``tmp_path``); returns their outputs."""
    port = _free_port()
    path = tmp_path / "child.py"
    path.write_text(CHILD_PRELUDE + textwrap.dedent(script))
    procs = []
    for rank in range(2):
        env = dict(os.environ, CM2_COORDINATOR=f"127.0.0.1:{port}",
                   CM2_NUM_PROCESSES="2", CM2_PROCESS_ID=str(rank),
                   OUT=str(tmp_path), PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(path)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=timeout)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for rank, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


TRAIN_CHILD = """
from centermask2_tpu_torch.models.meta import CenterMask, GroundTruth
from centermask2_tpu_torch.parallel import init_distributed, process_index
from centermask2_tpu_torch.train import make_optimizer, make_train_step
from centermask2_tpu_torch.utils.comm import world_group

assert init_distributed(device="cpu")
rank = process_index()
cfg = json.load(open(os.path.join(OUT, "cfg.json")))
model = CenterMask(**cfg["kw"], dtype=torch.float32).eval()
model.load_state_dict(torch.load(os.path.join(OUT, "state.pt")))
opt, sched = make_optimizer(model, 0.02, (100,), warmup_iters=0,
                            warmup_factor=1.0, **cfg["opt"])
step = make_train_step(model, opt, sched, capture=False,
                       group=world_group())
b = np.load(os.path.join(OUT, "batch.npz"))
r = slice(rank, rank + 1)
gt = GroundTruth(t(b["boxes"][r]), t(b["classes"][r]),
                 torch.ones(b["classes"][r].shape, dtype=torch.bool),
                 t(b["patches"][r]))
m = step(t(b["images"][r]), gt, t(b["draws"][r]) if "draws" in b else None)
torch.save({"metrics": {k: float(v) for k, v in m.items()},
            "state": model.state_dict()},
           os.path.join(OUT, f"rank{rank}.pt"))
print("rank", rank, "ok")
"""

SYNC_KW = dict(STEP_KW, backbone_norm="SyncBN", mask_on=False,
               maskiou_on=False)


def _jax_dp_step(jm, variables, images, jgt, opt_kw):
    """JAX's two-device shard_map step (tests/test_train.py:423-441) from
    ``variables``; returns (new state, metrics)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from centermask2_tpu.parallel import make_mesh, shard_batch as jshard
    from centermask2_tpu.train import (create_train_state,
                                       make_optimizer as jopt,
                                       make_train_step as jstep)

    opt = jopt(0.02, (100,), warmup_iters=0, warmup_factor=1.0,
               params_example={"params": variables["params"]}, **opt_kw)
    state = create_train_state(jax.tree.map(jnp.asarray, variables), opt)
    mesh = make_mesh(jax.devices()[:2])
    state = jax.device_put(state, NamedSharding(mesh, P()))
    im, g = jshard((jnp.asarray(images), jgt), mesh)
    new_state, metrics = jstep(jm, opt, mesh=mesh)(
        state, im, g, jax.random.PRNGKey(1))
    return new_state, jax.tree.map(float, metrics)


@pytest.mark.parametrize("norm", ["FrozenBN", "SyncBN"])
def test_dp_train_step_matches_jax_shard_map(norm, tmp_path):
    """One two-rank gloo step (B = 1 a rank) against JAX's two-device
    ``shard_map`` step on the same global batch of 2. FrozenBN: the mask
    and MaskIoU branches on, clipping by global norm at 0.1 (binding), so
    the ``counted`` frozen leaves' averaged gradients enter the norm;
    SyncBN: the configuration of JAX's SyncBN parity test
    (tests/test_train.py:487, the mask branch off), the updated running
    statistics compared too. Losses within 1e-5 + 1e-4 relative;
    parameter deltas at rtol 5e-3 and atol 2e-7 (JAX's own
    multi-process bound, tests/test_distributed.py:163), atol 1e-4 with
    SyncBN (its cross-replica moments, tests/test_train.py:515); running
    statistics at rtol 1e-4, atol 1e-6. After the step both ranks'
    parameters and buffers are bit-equal."""
    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    if norm == "FrozenBN":
        kw, opt_kw = STEP_KW, dict(clip_value=0.1, clip_type="norm")
        jm = JaxCenterMask(**kw, dtype=jnp.float32)
        variables = {"params": _perturbed_params(jm, images, rng)}
        atol = 2e-7
    else:
        from test_torch_batchnorm import _jax_bn_variables

        kw, opt_kw = SYNC_KW, {}
        jm = JaxCenterMask(**kw, dtype=jnp.float32)
        params, stats = _jax_bn_variables(jm, images, rng)
        variables = {"params": params, "batch_stats": stats}
        atol = 1e-4
    before = {k: v for k, (_, v) in state_dict_from_jax(
        variables["params"], batch_stats=variables.get("batch_stats")
    ).items()}
    (tmp_path / "cfg.json").write_text(json.dumps({"kw": kw, "opt": opt_kw}))
    torch.save(before, tmp_path / "state.pt")
    batch = dict(images=images, boxes=boxes, classes=classes,
                 patches=patches)
    if jm.mask_on:
        # every replica splits the same key over its B = 1 rows
        key = jax.random.split(jax.random.PRNGKey(1), 1)[0]
        d = np.asarray(jax.random.uniform(key, (10 + G,)))
        batch["draws"] = np.stack([d, d])
    np.savez(tmp_path / "batch.npz", **batch)
    _spawn_pair(TRAIN_CHILD, tmp_path)

    jgt = JaxGroundTruth(boxes=jnp.asarray(boxes),
                         classes=jnp.asarray(classes),
                         valid=jnp.ones((B, G), bool),
                         mask_patches=jnp.asarray(patches))
    new_state, want = _jax_dp_step(jm, variables, images, jgt, opt_kw)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    got = ranks[0]["metrics"]
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 + 1e-4 * abs(want[k]), (
            k, got[k], want[k])
    stats_new = (new_state.model_state or {}).get("batch_stats")
    after = state_dict_from_jax(
        jax.tree.map(np.asarray, new_state.params["params"]),
        batch_stats=jax.tree.map(np.asarray, stats_new)
        if stats_new else None)
    assert set(after) == set(ranks[0]["state"])
    moved = 0
    for k, (path, v) in after.items():
        mine = ranks[0]["state"][k]
        if path[-1] in ("mean", "var"):
            np.testing.assert_allclose(mine.numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
            continue
        dj = (v - before[k]).numpy()
        np.testing.assert_allclose((mine - before[k]).numpy(), dj,
                                   rtol=5e-3, atol=atol, err_msg=k)
        moved += int(np.abs(dj).max() > 0)
    assert moved > 50


def test_world_of_one_group_step_is_the_plain_step():
    """With a process group of one (gloo, in this process) the
    data-parallel step equals the step without a group bit for bit: the
    all-reduce of one rank and the division by 1 are exact. BN, so that
    the averaged running statistics are in the buffer; and
    ``capture=True`` with a gloo group raises."""
    rng, images, boxes, classes, patches = _step_batch()
    B, G = classes.shape
    gt = GroundTruth(t(boxes), t(classes),
                     torch.ones((B, G), dtype=torch.bool), t(patches))
    draws = t(rng.rand(B, 10 + G).astype(np.float32))
    runs = []
    assert init_distributed(f"127.0.0.1:{_free_port()}", 1, 0,
                            device="cpu")
    try:
        from centermask2_tpu_torch.utils.comm import world_group

        for group in (None, world_group()):
            torch.manual_seed(0)
            m = CenterMask(backbone_norm="BN", **STEP_KW,
                           dtype=torch.float32).eval()
            with torch.no_grad():
                m.fcos_head.cls_logits.bias.zero_()
            opt, sched = make_optimizer(m, 0.02, (100,), warmup_iters=0,
                                        clip_value=1.0, clip_type="norm")
            step = make_train_step(m, opt, sched, capture=False, group=group)
            metrics = [step(t(images), gt, draws) for _ in range(2)]
            runs.append((metrics, m.state_dict()))
            if group is not None:
                with pytest.raises(ValueError, match="gloo"):
                    make_train_step(m, opt, sched, capture=True, group=group)
    finally:
        shutdown()
    (m0, s0), (m1, s1) = runs
    for a, b in zip(m0, m1):
        assert {k: float(v) for k, v in a.items()} == \
            {k: float(v) for k, v in b.items()}
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k


INFER_CHILD = """
from centermask2_tpu_torch.models.meta import CenterMask
from centermask2_tpu_torch.parallel import (init_distributed,
                                            make_dp_inference, process_index)

assert init_distributed(device="cpu")
cfg = json.load(open(os.path.join(OUT, "cfg.json")))
model = CenterMask(**cfg["kw"], dtype=torch.float32).eval()
model.load_state_dict(torch.load(os.path.join(OUT, "state.pt")))
images = t(np.load(os.path.join(OUT, "images.npy")))
out = make_dp_inference(model)(images)
torch.save({k: v for k, v in out._asdict().items() if v is not None},
           os.path.join(OUT, f"out{process_index()}.pt"))
"""

DP_KW = dict(conv_body="V-19-slim-eSE", num_classes=5, fpn_out_channels=64,
             mask_conv_dim=16, maskiou_conv_dim=16, post_nms_topk_test=15)


def test_dp_inference_matches_batched_and_jax(tmp_path):
    """``make_dp_inference`` over two ranks on a batch of 4 (two images a
    rank): both ranks return the global batch, equal to
    ``inference_batched`` on the whole batch in one process, and to JAX's
    ``make_dp_inference`` on two devices slot by slot (the tolerances of
    ``test_torch_model.py::test_whole_slice_matches_jax``)."""
    from test_torch_model import PIXEL_MEAN, _perturb

    from centermask2_tpu.parallel import (default_image_sizes,
                                          make_dp_inference, make_mesh,
                                          replicate, shard_batch as jshard)
    from centermask2_tpu_torch.checkpoint.from_jax import load_jax_params

    rng = np.random.RandomState(0)
    images = rng.rand(4, 64, 64, 3).astype(np.float32) * 255 - PIXEL_MEAN
    jm = JaxCenterMask(**DP_KW, dtype=jnp.float32)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(images[:1]))
    params = _perturb(jax.tree.map(np.asarray, variables["params"]), rng)
    port = CenterMask(**DP_KW, dtype=torch.float32).eval()
    load_jax_params(port, params)
    (tmp_path / "cfg.json").write_text(json.dumps({"kw": DP_KW}))
    torch.save(port.state_dict(), tmp_path / "state.pt")
    np.save(tmp_path / "images.npy", images)
    _spawn_pair(INFER_CHILD, tmp_path)

    want = port.inference_batched(t(images))
    outs = [torch.load(tmp_path / f"out{r}.pt") for r in range(2)]
    for out in outs:
        assert set(out) == {k for k, v in want._asdict().items()
                            if v is not None}
        for k, v in out.items():
            assert torch.equal(v, getattr(want, k)), k

    mesh = make_mesh(jax.devices()[:2])
    jimages = jnp.asarray(images)
    jout = make_dp_inference(jm, mesh)(
        replicate({"params": params}, mesh),
        *jshard((jimages, default_image_sizes(jm, jimages)), mesh))
    got = outs[0]
    valid = np.asarray(jout.valid)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() > 8
    np.testing.assert_array_equal(got["pred_classes"].numpy()[valid],
                                  np.asarray(jout.pred_classes)[valid])
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(jout.scores),
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(got["pred_boxes"].numpy()[valid],
                               np.asarray(jout.pred_boxes)[valid],
                               rtol=1e-3, atol=2e-2)
    np.testing.assert_allclose(got["pred_masks"].numpy()[valid],
                               np.asarray(jout.pred_masks)[valid], atol=2e-3)


EVAL_CHILD = """
from centermask2_tpu_torch.evaluation.loop import evaluate_dataset
from centermask2_tpu_torch.models.meta import CenterMask
from centermask2_tpu_torch.parallel import init_distributed, process_index

assert init_distributed(device="cpu")
cfg = json.load(open(os.path.join(OUT, "cfg.json")))
model = CenterMask(**cfg["kw"], dtype=torch.float32).eval()
model.load_state_dict(torch.load(os.path.join(OUT, "state.pt")))
results, _, ev = evaluate_dataset(model, distributed=True, **cfg["loop"])
with open(os.path.join(OUT, f"eval{process_index()}.json"), "w") as f:
    json.dump({"results": results, "predictions": ev.predictions,
               "proposals": sorted(ev.proposals)}, f)
"""


def test_distributed_evaluate_matches_one_process(tmp_path):
    """``evaluate_dataset(distributed=True)`` over two ranks, each on its
    strided share of 3 images: rank 0 gets the single process's
    predictions (as a set), proposals and metrics; rank 1 gets no
    metrics."""
    from test_torch_evaluation import LOOP, SMALL, _png_dataset

    from centermask2_tpu_torch.evaluation.loop import evaluate_dataset

    (tmp_path / "ds").mkdir()
    ann = _png_dataset(tmp_path / "ds", np.random.RandomState(3))
    # a random model whose detections survive the postprocess on all
    # three images (at seed 0 none does on image 2, rank 1's share)
    torch.manual_seed(2)
    model = CenterMask(**SMALL, dtype=torch.float32).eval()
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    loop = dict(ann=str(ann), image_root=str(tmp_path / "ds" / "images"),
                **LOOP)
    (tmp_path / "cfg.json").write_text(json.dumps({"kw": SMALL,
                                                   "loop": loop}))
    torch.save(model.state_dict(), tmp_path / "state.pt")
    _spawn_pair(EVAL_CHILD, tmp_path)
    want, _, ev = evaluate_dataset(model, **loop)
    got = [json.loads((tmp_path / f"eval{r}.json").read_text())
           for r in range(2)]
    assert got[1]["results"] == {}

    def key(p):
        return p["image_id"], -p["score"], p["category_id"]

    preds = json.loads(json.dumps(ev.predictions))
    assert {p["image_id"] for p in preds} == {1, 2, 3}  # both ranks' shares
    assert sorted(got[0]["predictions"], key=key) == sorted(preds, key=key)
    assert got[0]["proposals"] == sorted(ev.proposals)
    assert json.loads(json.dumps(want)) == got[0]["results"]


def test_infer_cli_data_parallel_equals_the_plain_cli(tmp_path):
    """``tools/infer.py --data-parallel --batch-size 2`` in a world of one
    (size buckets of the 64 canvas, uint8 s2d packs) writes the
    predictions and metrics of the CLI without it; a batch of 1 is
    refused."""
    from test_torch_evaluation import _png_dataset

    from centermask2_tpu_torch.tools import infer

    (tmp_path / "ds").mkdir()
    ann = _png_dataset(tmp_path / "ds", np.random.RandomState(3))
    common = ["--device", "cpu", "--config-file",
              os.path.join(REPO, "configs/centermask/zy_model_serving.yaml"),
              "--ann", str(ann), "--image-root", str(tmp_path / "ds/images")]
    opts = ["MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE",
            "MODEL.FCOS.NUM_CLASSES", "2", "MODEL.FPN.OUT_CHANNELS", "32",
            "MODEL.ROI_MASK_HEAD.CONV_DIM", "8",
            "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", "8", "TPU.FIXED_EDGE_SIZE",
            "64", "TPU.SIZE_BUCKETS", "(64,)", "INPUT.MIN_SIZE_TEST", "32",
            "INPUT.MAX_SIZE_TEST", "60", "MODEL.FCOS.INFERENCE_TH_TEST",
            "0.0"]
    runs = {}
    for name, extra in (("plain", []),
                        ("dp", ["--data-parallel", "--batch-size", "2"])):
        out = tmp_path / name
        infer.main([*common, "--output-dir", str(out), *extra, *opts])
        runs[name] = (json.loads((out / "coco_instances_results.json")
                                 .read_text()),
                      json.loads((out / "metrics.json").read_text()))
    assert len(runs["plain"][0]) > 3
    assert runs["dp"] == runs["plain"]
    with pytest.raises(SystemExit, match="batch-size"):
        infer.main([*common, "--output-dir", str(tmp_path / "x"),
                    "--data-parallel", *opts])


TRAIN_NET_CHILD = """
from centermask2_tpu_torch.tools import train_net

train_net.main(json.load(open(os.path.join(OUT, "argv.json"))))
print("rank", os.environ["CM2_PROCESS_ID"], "done")
"""


def test_train_net_two_ranks_checkpoint_on_rank_0(tmp_path):
    """``tools/train_net.py`` as two gloo ranks (IMS_PER_BATCH 2, one
    image a rank): both train two steps; rank 0 alone prints, writes
    ``metrics.jsonl`` (one line a logged step) and the checkpoint, whose
    parameters are finite."""
    from test_torch_data import make_train_dataset
    from test_torch_train import TINY_OPTS

    ann, root = make_train_dataset(tmp_path / "ds")
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--ann", ann, "--image-root", root,
            "--max-iter", "2", "--log-every", "1", *TINY_OPTS,
            "OUTPUT_DIR", str(out)]
    (tmp_path / "argv.json").write_text(json.dumps(argv))
    outs = _spawn_pair(TRAIN_NET_CHILD, tmp_path)
    assert "saved" in outs[0] and "iter 2/2" in outs[0]
    assert "saved" not in outs[1] and "iter" not in outs[1]
    assert "rank 1 done" in outs[1]
    assert sorted(os.listdir(out / "checkpoints")) == ["step_2"]
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["iteration"] for x in lines] == [0, 1]
    from centermask2_tpu_torch.checkpoint.torch_io import load_checkpoint

    state = load_checkpoint(str(out / "checkpoints" / "step_2"))
    assert state["step"] == 2
    assert all(torch.isfinite(v).all() for v in state["model"].values()
               if v.is_floating_point())


def test_train_batches_split_over_ranks(tmp_path):
    """``train_batches`` with a world of one is today's loader; over two
    ranks each global batch's rows are disjoint and together are the
    world-of-one batch, canvas included (tight pads too)."""
    from test_torch_data import make_train_dataset

    from centermask2_tpu_torch.data import coco

    ann, root = make_train_dataset(tmp_path / "ds")
    ds = coco.CocoDataset(ann, root)
    for tight in (False, True):
        kw = dict(min_sizes=(40, 48, 56), max_size=72, pad_to=(96, 96),
                  max_gt=4, patch_size=28, seed=3, epochs=2,
                  tight_pad=tight)
        whole = list(coco.train_batches(ds, 2, **kw))
        assert len(whole) == 6
        one = list(coco.train_batches(ds, 2, rank=0, world=1, **kw))
        parts = [list(coco.train_batches(ds, 2, rank=r, world=2, **kw))
                 for r in range(2)]
        for w, o, a, b in zip(whole, one, *parts):
            assert a["image_ids"] + b["image_ids"] == w["image_ids"] \
                == o["image_ids"]
            assert not set(a["image_ids"]) & set(b["image_ids"])
            for k in coco.BATCH_KEYS:
                np.testing.assert_array_equal(o[k], w[k], err_msg=k)
                np.testing.assert_array_equal(
                    np.concatenate([a[k], b[k]]), w[k], err_msg=k)
    with pytest.raises(ValueError, match="split"):
        next(coco.train_batches(ds, 3, rank=0, world=2, **kw))


def test_process_group_helpers_in_one_process(monkeypatch):
    """Without the ``CM2_*`` environment ``init_distributed`` joins
    nothing and every helper is the one-process identity; with it, a
    ``cuda`` device on a machine without one raises (no fallback to the
    CPU); ``shard_batch`` takes a rank's rows of named tuples, dicts and
    None, and refuses a batch the ranks do not divide."""
    from centermask2_tpu_torch.parallel import (all_gather_objects,
                                                barrier, is_main_process,
                                                process_count,
                                                process_subset, replicate)

    for k in ("CM2_COORDINATOR", "CM2_NUM_PROCESSES", "CM2_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() is False
    assert process_count() == 1 and is_main_process()
    obj = {"a": [1, 2]}
    assert all_gather_objects(obj)[0] is obj
    assert list(process_subset([1, 2, 3])) == [1, 2, 3]
    barrier()
    m = torch.nn.Linear(2, 2)
    assert replicate(m) is m
    gt = GroundTruth(torch.zeros(4, 2, 4), torch.zeros(4, 2),
                     torch.ones(4, 2, dtype=torch.bool), torch.zeros(4, 2, 3, 3))
    assert shard_batch(gt).boxes.shape == (4, 2, 4)
    assert local_rows(4) == slice(0, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("CM2_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("CM2_NUM_PROCESSES", "2")
    monkeypatch.setenv("CM2_PROCESS_ID", "0")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed(device="cuda")


def test_shard_batch_rows_of_a_rank(monkeypatch):
    """Rank r of W holds rows [r * B/W, (r + 1) * B/W) (the JAX global
    device order is process-major), and None passes through."""
    from centermask2_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "world_group", lambda: "g")
    monkeypatch.setattr(mesh, "world_size", lambda g: 2)
    monkeypatch.setattr(mesh, "rank", lambda g: 1)
    batch = {"x": torch.arange(8).reshape(4, 2), "y": None,
             "z": (np.arange(4),)}
    got = shard_batch(batch)
    assert got["x"].tolist() == [[4, 5], [6, 7]] and got["y"] is None
    assert got["z"][0].tolist() == [2, 3]
    with pytest.raises(ValueError, match="split"):
        local_rows(3)
