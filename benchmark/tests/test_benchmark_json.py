"""BENCHMARK.json against the contract's shape, and every file it names
present under the benchmark directory."""

import json
import re

import pytest

from benchmark.tests.helpers import BENCH, REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level():
    assert set(B) == KEYS
    assert B["paths"] == ["benchmark"] and B["command"][1] == "benchmark/run.py"
    assert 1 <= B["run_seconds"] <= 51
    assert (2 + 14 * 24) * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_and_cells():
    used = {w["config"] for w in B["workloads"]}
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["why"])
        assert one_line(c["source"]) and c["name"] in used
        conf = json.loads((REPO / c["file"]).read_text())
        assert {"cfg", "reduced", "source"} <= set(conf)
        assert conf["reduced"] == c["reduced"]
        assert conf["source"] == c["source"]
    pairs = set()
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and one_line(w["why"])
        assert w["chips"] in (1, 4)
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        runner = traffic["runner"]
        assert (BENCH / "runners" / f"{runner}.py").is_file()
        limits = json.loads((BENCH / "limits" / f"{w['config']}.{runner}"
                             ".json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(B["workloads"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    cells = {w["name"] for w in B["workloads"]}
    allowed = {"name", "unit", "better", "source", "workloads"} | (
        {"bound"} if kind == "end_to_end" else {"layer", "moves"})
    for m in B[kind]:
        assert set(m) <= allowed and NAME.match(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert one_line(m["layer"])
            moved = [e for e in B["end_to_end"] if e["name"] == m["moves"]]
            assert moved and set(m["workloads"]) <= set(
                moved[0].get("workloads", cells))


def test_every_cell_reports_enough():
    for w in B["workloads"]:
        e2e = [m["name"] for m in B["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        layer = [m["name"] for m in B["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
