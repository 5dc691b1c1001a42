"""Runs of the harness on the CPU (the look for a card skipped), with
cells, traffic mixes and a metric that a test adds as files only."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.tests.helpers import BENCH, REPO, checkout, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def root(tmp_path):
    return checkout(tmp_path)


@pytest.mark.parametrize("cell", ["tiny.open", "tiny.r50", "tiny.closed"])
def test_result_line(root, cell, capsys):
    res = run(root, cell, capsys)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    want = {"setup_s", "serve_images_per_s" if cell == "tiny.closed"
            else "serve_p95_ms"}
    assert set(res["metrics"]) == want
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"


def test_traced_run_reads_the_files_metrics(root, capsys):
    """A per-layer metric added as a file and an entry is read."""
    (root / "benchmark/metrics/requests.tiny.py").write_text(
        "def read(rec):\n    return float(rec.attempted)\n")
    (root / "benchmark/metrics/never.tiny.py").write_text(
        "def read(rec):\n    return None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("requests.tiny", "never.tiny"):
        bench["per_layer"].append({
            "name": name, "unit": "n", "better": "higher",
            "source": "program_counter", "layer": "test",
            "moves": "serve_p95_ms", "workloads": ["tiny.open"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run(root, "tiny.open", capsys, trace=1)
    m = res["metrics"]
    assert m["requests.tiny"]["value"] == res["attempted"]
    assert "never.tiny" not in m  # a reader that finds nothing
    # the CPU run has no peaks and no device trace: no device metric
    assert "mfu.open" not in m and "nms_roofline.open" not in m
    assert {"host_ms.open", "replay_ms.open", "idle.open"} <= set(m)
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


ECHO_RUNNER = """
import time
from types import SimpleNamespace

from benchmark.harness.main import Outcome


def run(r):
    steps = int(r.traffic["steps"])
    setup_s = time.perf_counter() - r.t_start
    rec = SimpleNamespace(setup_s=setup_s, attempted=steps, failed=0,
                          steps=steps, seconds=r.seconds)
    return Outcome(rec, {"echo_gap": float(r.traffic["gap"])}, 0)
"""


@pytest.mark.parametrize("gap,correct", [(0.0, True), (2.0, False)])
def test_a_runner_added_as_files(root, capsys, gap, correct):
    """Another runner (a training loop, say) comes as files and entries
    only: the runner, a traffic file that names it, its limits, an
    end-to-end metric and the cell."""
    b = root / "benchmark"
    (b / "runners/echo.py").write_text(ECHO_RUNNER)
    (b / "traffic/tiny.echo.json").write_text(json.dumps(
        {"runner": "echo", "steps": 12, "gap": gap}))
    (b / "limits/tiny-vovnet.echo.json").write_text(json.dumps(
        {"limits": {"echo_gap": 1.0}}))
    (b / "metrics/echo_steps_per_s.py").write_text(
        "def read(rec):\n    return rec.steps / rec.seconds\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.echo", "config": "tiny-vovnet",
                               "traffic": "tiny.echo", "chips": 1,
                               "why": "t"})
    bench["end_to_end"].append({"name": "echo_steps_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = run(root, "tiny.echo", capsys, seconds=2.0)
    assert res["correct"] is correct and res["attempted"] == 12
    assert res["metrics"]["echo_steps_per_s"]["value"] == 6.0
    assert set(res["metrics"]) == {"echo_steps_per_s", "setup_s"}
    assert res["checks"] == {"echo_gap": {"value": gap, "limit": 1.0}}


def test_a_runner_without_its_file_is_refused(root):
    from benchmark.harness.spec import Spec

    with pytest.raises(FileNotFoundError):
        Spec(root).runner("train")


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the run exits non-zero and prints nothing,
    also from a directory that holds only BENCHMARK.json and the
    benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (REPO, tmp_path):
        res = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "v39.serve.open", "--seed", str(2 ** 31 + 3), "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            env=dict(os.environ, BENCH_RUN="1"), timeout=300)
        assert res.returncode != 0
        assert res.stdout.strip() == ""
