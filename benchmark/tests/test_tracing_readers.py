"""The readers of the program's own records (its section stamps, host
spans and set-up counters, ``centermask2_tpu_torch/utils/tracing.py``)
on the CPU: nothing to read, a program without the module, records made
by hand, and a traced rehearsal of a cell."""

import json
import sys

import numpy as np
import pytest

from benchmark.harness.spec import Spec
from benchmark.tests.helpers import REPO, checkout, run
from centermask2_tpu_torch.utils import tracing

B = json.loads((REPO / "BENCHMARK.json").read_text())
SECTIONS = ("stem", "backbone", "fpn_head", "decode", "roi")
SECTION_METRICS = [f"{s}_ms.{c}" for s in SECTIONS for c in ("open",
                                                             "closed")]
SPAN_METRICS = ["pack_ms.open", "to_host_ms.open"]
COUNTERS = ["capture_s", "model_build_s"]
READERS = SECTION_METRICS + SPAN_METRICS + COUNTERS


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def reader(name):
    return Spec(REPO).reader(name)


def test_every_reader_is_declared():
    declared = {m["name"]: m for m in B["per_layer"]}
    for name in READERS:
        m = declared[name]
        assert m["unit"] == ("s" if name in COUNTERS else "ms")
        assert m["source"] == ("device_trace" if name in SECTION_METRICS
                               else "host_clock")


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    assert reader(name)(None) is None


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_the_module(name, monkeypatch):
    """The parent commit's program has no ``utils/tracing.py``: the
    reader returns None and does not raise."""
    monkeypatch.setitem(sys.modules, "centermask2_tpu_torch.utils.tracing",
                        None)
    monkeypatch.delattr(sys.modules["centermask2_tpu_torch.utils"],
                        "tracing")
    assert reader(name)(None) is None


def test_records_made_by_hand():
    ring = tracing.Ring("cpu")
    for key in (0, 1, 0):
        with tracing.armed(ring, key):
            for s in tracing.STAMPS:
                tracing.mark(s)
    rows = ring.read()
    ms = np.diff(rows[:, 1:], axis=1).mean(axis=0) * 1e-6
    for i, s in enumerate(SECTIONS):
        for cell in ("open", "closed"):
            assert reader(f"{s}_ms.{cell}")(None) == pytest.approx(ms[i])
    tracing.enable()
    for name in ("pack", "to_host"):
        for _ in range(3):
            with tracing.span(name):
                pass
    for name in SPAN_METRICS:
        got = reader(name)(None)
        assert got is not None and 0 <= got < 100
    tracing.count("capture_s", 1.5)
    tracing.count("capture_s", 2.0)
    tracing.count("model_build_s", 0.25)
    assert reader("capture_s")(None) == 3.5
    assert reader("model_build_s")(None) == 0.25


def test_a_traced_rehearsal(tmp_path, capsys):
    """On the CPU the served program is the eager ``model.inference``: no
    ring and no capture, but the model is built and the traced slice's
    profiler records the host spans."""
    root = checkout(tmp_path)
    res = run(root, "tiny.open", capsys, trace=1)
    m = res["metrics"]
    assert not set(SECTION_METRICS) & set(m) and "capture_s" not in m
    assert {"pack_ms.open", "to_host_ms.open", "model_build_s"} <= set(m)
    assert m["pack_ms.open"]["value"] + m["to_host_ms.open"]["value"] < \
        m["host_ms.open"]["value"]
    assert m["model_build_s"]["value"] > 0
