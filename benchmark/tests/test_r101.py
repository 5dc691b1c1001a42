"""The configuration ``centermask-r101`` and its cell ``r101.serve.closed``,
as the benchmark's harness sees them, on the CPU: the configuration file
is upstream's yaml with its overrides, resolved; the cell reports what
the V-39 closed cell reports, under limits for every number compared;
the weights' recipe covers the whole ``state_dict`` of the full-size
R-101 with ``TPU.S2D_STEM_INPUT``, the reference builds it and loads
those weights with ``strict=True``; a tiny ResNet with the s2d input
runs a rehearsed closed cell end to end, ``correct`` included, read by
the closed cell's per-layer readers."""

import json

import pytest
import torch

from benchmark.harness import compare, weights
from benchmark.harness.spec import Spec, program_cfg
from benchmark.tests.helpers import (REPO, TINY_LIMITS, checkout, run,
                                     tiny_cfg)

CELL = "r101.serve.closed"


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spec():
    return Spec(REPO)


@pytest.fixture(scope="module")
def conf(spec):
    return spec.config(spec.cell(CELL)["config"])


def test_the_configuration_is_the_yaml_with_its_overrides(conf):
    """``tools/make_config.py`` over the yaml and the overrides the file
    names gives the file's ``cfg``: nothing in it was set by hand."""
    import sys

    sys.path.insert(0, str(REPO / "benchmark" / "tools"))
    from make_config import plain

    from centermask2_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / conf["yaml"].split(":")[0]))
    cfg.merge_from_list([str(v) if not isinstance(v, list) else str(tuple(v))
                         for v in conf["overrides"]])
    assert plain(cfg) == conf["cfg"]
    assert conf["reduced"] == []
    assert conf["cfg"]["MODEL"]["RESNETS"]["DEPTH"] == 101
    assert conf["cfg"]["TPU"]["S2D_STEM_INPUT"] is True
    assert conf["cfg"]["TPU"]["COMPUTE_DTYPE"] == "bfloat16"


def test_the_cell_reports_what_the_v39_closed_cell_reports(spec):
    cell = spec.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "centermask-r101", "serve.closed4.tight", 1)
    for kind in ("end_to_end", "per_layer"):
        assert [m["name"] for m in spec.metrics(CELL, kind)] == [
            m["name"] for m in spec.metrics("v39.serve.closed", kind)]
    limits = spec.limits(cell["config"], "serve")
    assert set(limits) == set(compare.NUMBERS)


@pytest.fixture(scope="module")
def model(conf):
    from centermask2_tpu_torch.models.meta import build_centermask

    return build_centermask(program_cfg(conf), device="cpu")


def test_the_recipe_covers_the_state_dict(model):
    assert model.s2d_input and model.backbone.s2d_input
    entries = weights.recipe(model)
    assert [e.name for e in entries] == list(model.state_dict())
    assert sum(1 for n in model.state_dict() if n.startswith("backbone.res4_")
               and n.endswith(".conv1.conv.weight")) == 23


def test_the_reference_loads_the_weights(conf, model):
    from benchmark.reference.model import Reference

    w = weights.make(weights.recipe(model), 2 ** 31 + 101,
                     torch.device("cpu"))
    ref = Reference(conf["cfg"]).load(w)
    assert set(ref.state_dict()) == set(w)


def _with_cell(root):
    """The checkout with ``tiny-r50-s2d`` (a tiny ResNet with the s2d
    input) under the closed tight-compute traffic, as files and entries
    only; the cell reports what ``tiny.closed`` reports."""
    cfg = tiny_cfg("resnet")
    cfg["TPU"]["S2D_STEM_INPUT"] = True
    b = root / "benchmark"
    (b / "configs/tiny-r50-s2d.json").write_text(json.dumps({"cfg": cfg}))
    (b / "limits/tiny-r50-s2d.serve.json").write_text(json.dumps(
        {"limits": TINY_LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-r50-s2d", "source": "test",
                             "file": "benchmark/configs/tiny-r50-s2d.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.r50.closed",
                               "config": "tiny-r50-s2d",
                               "traffic": "tiny.closed", "chips": 1,
                               "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.closed" in m.get("workloads", ()):
            m["workloads"].append("tiny.r50.closed")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_tiny_resnet_closed_cell_end_to_end(tmp_path, capsys):
    root = _with_cell(checkout(tmp_path))
    res = run(root, "tiny.r50.closed", capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"setup_s", "serve_images_per_s"}
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    traced = run(root, "tiny.r50.closed", capsys, trace=1)
    m = traced["metrics"]
    # the CPU serves the eager program: no ring, no peaks
    assert {"host_ms.closed", "replay_ms.closed", "idle.closed"} <= set(m)
    assert not {"stem_ms.closed", "backbone_ms.closed", "mfu.closed"} & \
        set(m)
    assert traced["correct"] is True
