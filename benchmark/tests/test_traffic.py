"""The traffic generator: deterministic per seed, and every seed the same
work in another order."""

import collections
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import traffic as tr

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def mixes():
    return sorted(p.stem for p in TRAFFIC.glob("*.json"))


@pytest.mark.parametrize("name", mixes())
def test_same_seed_same_requests(name):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    a = tr.schedule(t, 3_000_000_019, 10.0)
    b = tr.schedule(t, 3_000_000_019, 10.0)
    assert a == b
    ia, ib = tr.images(t, 3_000_000_019), tr.images(t, 3_000_000_019)
    assert ia.keys() == ib.keys()
    assert all(np.array_equal(ia[k], ib[k]) for k in ia)


@pytest.mark.parametrize("name", mixes())
def test_seeds_share_the_work(name):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    a = tr.schedule(t, 11, 10.0)
    b = tr.schedule(t, 2 ** 31 + 5, 10.0)
    assert a != b
    assert collections.Counter(r.hw for r in a) == \
        collections.Counter(r.hw for r in b)
    if t["arrivals"]["kind"] != "closed":
        # one schedule of arrivals for every seed
        assert [r.due_s for r in a] == [r.due_s for r in b]
        assert len(a) == round(t["arrivals"]["rate_per_s"] * 10.0)
        assert all(0.0 <= r.due_s < 10.0 for r in a)
        t["arrivals"]["order"] += 1
        assert [r.due_s for r in tr.schedule(t, 11, 10.0)] != \
            [r.due_s for r in a]


def test_shares_and_sizes():
    t = json.loads((TRAFFIC / "serve.open.v39.json").read_text())
    assert tr.counts([0.5, 0.3, 0.2], 7) == [4, 2, 1]
    assert sum(tr.counts([s for *_, s in t["sizes"]["sources"]], 601)) == 601
    # COCO's 640x480 resizes to 800x1067 (detectron2's rounding)
    assert tr.resize_shape(480, 640, 800, 1333) == (800, 1067)
    assert tr.resize_shape(360, 640, 800, 1333) == (750, 1333)


def test_unknown_arrivals_are_refused():
    t = json.loads((TRAFFIC / "serve.open.v39.json").read_text())
    t["arrivals"] = {"kind": "on_off", "rate_per_s": 40.0, "on_s": 1.0,
                     "off_s": 1.0, "order": 0}
    with pytest.raises(ValueError):
        tr.schedule(t, 1, 1.0)
