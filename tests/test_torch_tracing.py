"""The port's tracing module (``centermask2_tpu_torch/utils/tracing.py``)
on the CPU: host spans off by default, nested when on, recorded under a
``torch.profiler`` session on the clock of its chrome trace; the section
ring of ``CapturedInference`` over ``test_torch_captured.py``'s fake
graphs (a replay reruns the Python, whose stamps then take the host's
clock: the CPU version of ``csrc/stamp.cu``); the set-up counters.
"""

import json
import threading
from contextlib import nullcontext

import numpy as np
import pytest
import torch

from centermask2_tpu_torch.config import get_cfg
from centermask2_tpu_torch.data.preprocess import s2d_pack_u8
from centermask2_tpu_torch.evaluation.loop import _to_host
from centermask2_tpu_torch.export import CapturedInference
from centermask2_tpu_torch.models.meta import (CenterMask, InferenceOutputs,
                                               build_centermask)
from centermask2_tpu_torch.utils import tracing
from centermask2_tpu_torch.utils.trace_sections import REPLAY_SECTIONS
from test_torch_captured import SERVE, FakeGraphs, _u8


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = CenterMask(**SERVE, s2d_input=True, dtype=torch.float32).eval()
    with torch.no_grad():
        m.fcos_head.cls_logits.bias.zero_()
    return m


HW = torch.tensor([[30, 61]], dtype=torch.int32)
# (pack, canvas): a 32x64 tight pack padded back to 64x64, then a 64x64
# pack: two programs, keys 0 and 1
CALLS = [((1, 32, 64), (64, 64)), ((2, 64, 64), None)]


def _calls(prog, n):
    """``n`` requests alternating over ``CALLS``; their program keys."""
    keys = []
    for i in range(n):
        (seed, h, w), canvas = CALLS[i % 2]
        prog(_u8(seed + i, h, w), None, HW, canvas)
        keys.append(i % 2)
    return keys


# --- host spans ------------------------------------------------------------

def test_off_by_default_a_span_records_nothing(monkeypatch):
    def no_range(name):
        raise AssertionError(f"range {name} opened with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    ctx = tracing.span("pack")
    assert ctx is tracing.span("to_host")  # the shared null
    assert isinstance(ctx, nullcontext)
    with tracing.span("pack"):
        with tracing.span("to_host"):
            pass
    assert tracing.spans() == []
    assert tracing.span_median_ms("pack") is None


@pytest.mark.parametrize("threaded", [False, True])
def test_spans_are_recorded_in_order_while_on(threaded):
    """Spans nest and close in order, on this thread or on another one
    (``evaluation/loop.py`` packs on a prefetch thread); nothing after
    ``enable(False)``."""
    def nested():
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass

    tracing.enable()
    if threaded:
        t = threading.Thread(target=nested)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    else:
        nested()
    with tracing.span("after"):
        pass
    tracing.enable(False)
    with tracing.span("off"):
        pass
    got = tracing.spans()
    assert [s.name for s in got] == ["inner", "outer", "after"]  # by end
    inner, outer, after = got
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.end_ns <= after.start_ns <= after.end_ns
    assert tracing.spans("outer") == [outer]


def _pack():
    img = np.random.RandomState(0).randint(0, 256, (60, 90, 3)).astype(
        np.uint8)
    s2d_pack_u8(img, 128)


def _copy_out():
    _to_host(InferenceOutputs(*[torch.zeros(2)] * 7, pred_keypoints=None),
             cuda=False)


@pytest.mark.parametrize("name,call", [("pack", _pack),
                                       ("to_host", _copy_out)])
def test_a_profiler_session_records_the_programs_spans(tmp_path, name,
                                                       call):
    """Without ``enable()``: the program's span is recorded while a CPU
    profiler records, inside a ``cm2:<name>`` range that starts within
    200 us of its recorded start on the chrome trace's clock (``ts`` plus
    ``baseTimeNanoseconds``). The first range of a process pays a
    one-time set-up of the profiler's op, so it is warmed up first."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("warm-up"):
        pass
    for _ in range(3):
        call()
    prof.stop()
    call()  # the session over: recorded no more
    got = tracing.spans(name)
    assert len(got) == 3 and tracing.spans() == got
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    ranges = sorted(e for e in ((float(e["ts"]), float(e["dur"]))
                                for e in trace["traceEvents"]
                                if e.get("name") == f"cm2:{name}"))
    assert len(ranges) == 3
    for (ts, dur), s in zip(ranges, got):
        start = ts * 1e3 + base
        assert abs(s.start_ns - start) < 200e3, (s.start_ns - start) / 1e3
        assert s.end_ns <= start + dur * 1e3 + 200e3
    assert tracing.span_median_ms(name) == pytest.approx(
        float(np.median([(s.end_ns - s.start_ns) * 1e-6 for s in got])))


# --- the section ring -------------------------------------------------------

def test_a_mark_unarmed_or_on_another_thread_stamps_nothing():
    ring = tracing.Ring("cpu")
    tracing.mark("start")
    with tracing.armed(ring, 5):
        t = threading.Thread(target=lambda: [tracing.mark(s) for s in
                                             tracing.STAMPS])
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    assert int(ring.cursor) == 0 and tracing.replay_sections() is None


def test_one_row_a_replay_with_six_stamps_and_its_key(model):
    prog = CapturedInference(model, graphs=FakeGraphs())
    keys = _calls(prog, 5)
    rows = prog.ring.read()
    assert len(rows) == 5 and int(prog.ring.cursor) == 5
    assert rows[:, 0].tolist() == keys
    stamps = rows[:, 1:]
    assert stamps.shape[1] == len(tracing.STAMPS) == 6
    assert (np.diff(stamps, axis=1) >= 0).all()
    assert (np.diff(stamps[:, 0]) > 0).all()  # in call order
    assert tracing.replay_sections()["key"].tolist() == keys


def test_the_sections_sum_to_the_rows_span(model):
    prog = CapturedInference(model, graphs=FakeGraphs())
    _calls(prog, 4)
    rows = prog.ring.read()
    got = tracing.replay_sections()
    total = sum(got[s] for s in REPLAY_SECTIONS)
    np.testing.assert_allclose(total, (rows[:, -1] - rows[:, 1]) * 1e-6,
                               rtol=1e-12, atol=1e-9)
    assert all((got[s] >= 0).all() for s in REPLAY_SECTIONS)
    assert tracing.section_mean_ms("decode") == pytest.approx(
        float(np.mean(got["decode"])))


@pytest.mark.parametrize("calls", [3, 7])
def test_a_wrapped_ring_keeps_the_newest_rows(model, monkeypatch, calls):
    monkeypatch.setattr(tracing, "RING_ROWS", 3)
    prog = CapturedInference(model, graphs=FakeGraphs())
    keys = _calls(prog, calls)
    rows = prog.ring.read()
    assert prog.ring.rows == 3 and int(prog.ring.cursor) == calls
    assert rows[:, 0].tolist() == keys[-3:]
    assert (np.diff(rows[:, 1]) > 0).all()  # oldest first


def test_sections_off_records_no_row_and_serves_the_same(model,
                                                         monkeypatch):
    """A program captured with ``tracing.armed`` a null context (its
    stamps unarmed: the graph holds none) writes no row and serves the
    same outputs as the stamped one."""
    on = CapturedInference(model, graphs=FakeGraphs())
    x = _u8(4, 32, 64)
    got_on = on(x, None, HW, (64, 64))
    monkeypatch.setattr(tracing, "armed", lambda ring, key: nullcontext())
    off = CapturedInference(model, graphs=FakeGraphs())
    got_off = off(x, None, HW, (64, 64))
    assert int(on.ring.cursor) == 1 and int(off.ring.cursor) == 0
    assert all(torch.equal(a, b) for a, b in zip(got_on[:7], got_off[:7]))
    assert tracing.replay_sections() is None  # off's ring, the newest


def test_the_ring_outlives_its_program(model):
    prog = CapturedInference(model, graphs=FakeGraphs())
    _calls(prog, 2)
    del prog
    assert len(tracing.replay_sections()["key"]) == 2


# --- set-up counters --------------------------------------------------------

def test_capture_s_counts_every_capture(model):
    assert tracing.counter("capture_s") is None
    progs = [CapturedInference(model, graphs=FakeGraphs())
             for _ in range(2)]
    for prog in progs:
        _calls(prog, 2)
    assert all(p.capture_s > 0 for p in progs)
    assert tracing.counter("capture_s") == pytest.approx(
        sum(p.capture_s for p in progs), rel=1e-12)


def test_model_build_s_counts_each_build():
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE",
                         "MODEL.FPN.OUT_CHANNELS", "32",
                         "TPU.COMPUTE_DTYPE", "float32"])
    build_centermask(cfg, device="cpu")
    first = tracing.counter("model_build_s")
    build_centermask(cfg, device="cpu")
    assert 0 < first < tracing.counter("model_build_s")
