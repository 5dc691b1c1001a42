"""On the card, at each cell's own size and load: the program passes the
committed limits, and the control (the reference in float8 in the
program's place) and a top-k that leaves out the highest detections
(``tools/faults.py``) fail them, on three seeds. The other decode
faults are not seen on every seed at the cells' size (PERF.md).

    python3 -m pytest benchmark/tests -q -m card
"""

import json
import sys

import pytest

from benchmark.harness.main import judge
from benchmark.tests.helpers import REPO

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]
sys.path.insert(0, str(REPO / "benchmark" / "tools"))


def _limits(cell):
    from benchmark.harness.spec import Spec

    spec = Spec(REPO)
    w = spec.cell(cell)
    return spec.limits(w["config"], spec.traffic(w["traffic"])["runner"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    from readings import readings

    limits = _limits(cell)
    for row in readings(cell, 2.0, SEEDS):
        assert row["sample"] > 0
        assert judge(row["program"], limits)[0], row
        assert not judge(row["control"], limits)[0], row


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["shifted_topk"])
def test_wrong_detections_fail(card, cell, fault):
    from readings import readings

    limits = _limits(cell)
    for row in readings(cell, 2.0, SEEDS, fault=fault):
        assert row["program"]["set_gap"] > 0, row
        assert not judge(row["program"], limits)[0], row
