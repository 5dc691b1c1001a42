"""One run of one cell: the runner its traffic names, the comparison
with the reference, and the result line (``benchmark/README.md``).

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The traffic file names its runner (``<benchmark dir>/runners/<name>.py``),
which makes the cell's set-up, window and comparison and returns what
the metrics' readers read, with the numbers compared. With ``--trace 0``
the line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, the device's busy and window seconds of the traced
slice, and the breakdown: each metric read by its own file under
``<benchmark dir>/metrics/``. The numbers compared with the reference
and their limits (``<benchmark dir>/limits/<config>.<runner>.json``) are
the last lines on standard error and the last key of the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

BANNED = ("jax", "jaxlib", "flax", "centermask2_tpu")


class RunError(Exception):
    """A run that ends without a result line."""


class Run(NamedTuple):
    """What a runner is given."""

    seed: int
    seconds: float
    trace: bool
    dev: object  # torch.device
    cell: Dict
    conf: Dict  # the configuration file
    traffic: Dict  # the traffic file
    limits: Dict[str, float]
    t_start: float  # process start, on time.perf_counter
    program: Optional[Callable]  # the tests' faults: wraps the model


class Outcome(NamedTuple):
    """What a runner returns. ``record`` carries ``setup_s``,
    ``attempted``, ``failed``, in a traced run ``trace``
    (``trace.Summary``), and whatever its metrics' readers read."""

    record: object
    numbers: Dict[str, float]  # compared with ``Run.limits``
    memory_peak_bytes: int


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]): correct when every limit has
    its number and none lies above it (or is NaN)."""
    rows = [(k, float(numbers.get(k, math.inf)), float(lim))
            for k, lim in limits.items()]
    extra = sorted(set(numbers) - set(limits))
    if extra:
        raise RunError(f"numbers with no limit: {extra}")
    return bool(rows) and all(v <= lim for _, v, lim in rows), rows


def device_info(dev, chips: int, peak: int) -> Dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips, "memory_peak_bytes": peak}


def run(args, root: Path, t_start: float, rehearse: bool = False,
        program: Optional[Callable] = None) -> Dict:
    """The result line of one run. ``rehearse``: on the CPU, without the
    look for a card (the benchmark's own tests); ``program``: wraps the
    model in the runner's place of the program (the tests' faults)."""
    import torch

    from .spec import Spec

    spec = Spec(root)
    cell = spec.cell(args.workload)
    if not rehearse:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell needs {cell['chips']}")
        torch.set_num_threads(2)  # few host threads (benchmark/run.py)
    dev = torch.device("cuda", 0) if not rehearse else torch.device("cpu")
    traffic = spec.traffic(cell["traffic"])
    runner = spec.runner(traffic["runner"])
    limits = spec.limits(cell["config"], traffic["runner"])
    out = runner.run(Run(int(args.seed), float(args.seconds),
                         bool(args.trace), dev, cell,
                         spec.config(cell["config"]), traffic, limits,
                         t_start, program))
    rec = out.record
    correct, rows = judge(out.numbers, limits)

    metrics = {}
    kind = "per_layer" if args.trace else "end_to_end"
    for m in spec.metrics(cell["name"], kind):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = device_info(dev, int(cell["chips"]), out.memory_peak_bytes)
    result = {"correct": bool(correct), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics,
              "device": device}
    if args.trace:
        device["busy_s"] = float(rec.trace.busy_s)
        device["window_s"] = float(rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    result["_rows"] = rows
    found = banned_modules()
    if found:
        raise RunError(f"modules of JAX or the JAX package loaded: {found}")
    return result


def main(argv=None, root: Optional[Path] = None,
         t_start: Optional[float] = None, rehearse: bool = False,
         program: Optional[Callable] = None) -> int:
    args = parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root) if root is not None else Path.cwd()
    try:
        result = run(args, root, t_start, rehearse, program)
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    rows = result.pop("_rows")
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
