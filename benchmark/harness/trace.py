"""The traced slice of a window, read from the profiler's trace.

``torch.profiler`` (CUPTI) records the device's kernels, copies and
sets, and the benchmark's own host ranges (``bench:<step>``, from
``torch.profiler.record_function``), on one clock. The slice gives:

- ``busy_s``: the union of the device's operations;
- ``kernels``: {kernel name: (count, seconds)};
- ``device_ops``: the ten operations that took most time;
- ``idle_gaps``: the ten longest gaps between device operations, each
  named by the host step under way when it began (``none`` when the
  host was inside no step of the benchmark's).

The profiler can miss some of a graph replay's kernels; a reader
averages over the kernel rows found, never over the replays sent.
"""

from __future__ import annotations

import bisect
import gzip
import json
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


class Summary(NamedTuple):
    busy_s: float
    window_s: float
    kernels: Dict[str, Tuple[int, float]]
    device_ops: List[List]
    idle_gaps: List[List]


def _events(path: Path) -> List[Dict]:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def summarize(path: Path) -> Summary:
    """The slice's numbers; its window runs from the first of the
    benchmark's host steps to the end of the last, and device operations
    are clipped to it."""
    dev, host = [], []
    for e in _events(path):
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e.get("dur", 0.0)), e["name"],
                        cat))
        elif cat == "user_annotation" and e["name"].startswith("bench:"):
            host.append((float(e["ts"]), float(e.get("dur", 0.0)),
                         e["name"][len("bench:"):]))
    host.sort()
    if not host:
        return Summary(0.0, 0.0, {}, [], [])
    t0 = host[0][0]
    t1 = max(ts + dur for ts, dur, _ in host)
    dev = sorted((max(ts, t0), min(ts + dur, t1) - max(ts, t0), name, cat)
                 for ts, dur, name, cat in dev if ts < t1 and ts + dur > t0)
    kernels: Dict[str, List[float]] = {}
    by_name: Dict[str, float] = {}
    for ts, dur, name, cat in dev:
        by_name[name] = by_name.get(name, 0.0) + dur
        if cat == "kernel":
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += dur * 1e-6
    # union of the device's intervals, and the gaps between them
    busy = 0.0
    gaps = []
    cur_s = cur_e = None
    for ts, dur, _, _ in dev:
        if cur_e is None or ts > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((ts - cur_e, cur_e))
            cur_s, cur_e = ts, ts + dur
        else:
            cur_e = max(cur_e, ts + dur)
    if cur_e is not None:
        busy += cur_e - cur_s
    starts = [h[0] for h in host]

    def host_step(t: float) -> str:
        # the latest-starting step that contains t
        k = bisect.bisect_right(starts, t)
        for ts, dur, name in reversed(host[max(0, k - 64):k]):
            if ts <= t <= ts + dur:
                return name
        return "none"

    gaps.sort(reverse=True)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(
        busy_s=busy * 1e-6, window_s=(t1 - t0) * 1e-6,
        kernels={k: (int(v[0]), float(v[1])) for k, v in kernels.items()},
        device_ops=[[name, us * 1e-6] for name, us in ops],
        idle_gaps=[[host_step(t), g * 1e-6] for g, t in gaps[:TOP]])
