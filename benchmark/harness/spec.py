"""What a run reads: ``BENCHMARK.json`` at the root of the checkout, and
the files the benchmark finds there by name.

- a cell: an entry of ``workloads``;
- a configuration: the ``file`` of its ``configs`` entry, a JSON object
  with the program's whole configuration under ``cfg``;
- a traffic mix: ``<benchmark dir>/traffic/<name>.json``, which names
  its runner under ``runner``;
- a runner: ``<benchmark dir>/runners/<name>.py``, a module with
  ``run(main.Run)`` that returns a ``main.Outcome``;
- the limits of the correctness check of a configuration under a
  runner: ``<benchmark dir>/limits/<config>.<runner>.json``;
- a metric, end-to-end or per-layer: ``<benchmark dir>/metrics/<name>.py``,
  a module with ``read(record)`` that returns a number or None.

The benchmark directory is the first of ``paths``. Adding any of these
takes new files and entries only.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional


def load_module(path: Path, prefix: str):
    """The module in the file ``path``, under a name of its own."""
    name = prefix + re.sub(r"\W", "_", path.stem)
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or not path.is_file():
        raise FileNotFoundError(f"{path}: no such module")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def program_cfg(conf: Dict):
    """The program's configuration: its defaults, then every key the
    configuration file holds, set as it is there (a key the program
    lacks raises)."""
    from centermask2_tpu_torch.config import get_cfg

    def assign(node, values: Dict) -> None:
        for k, v in values.items():
            if k not in node:
                raise KeyError(f"configuration key {k!r}: not the program's")
            if isinstance(v, dict):
                assign(node[k], v)
            else:
                node[k] = tuple(v) if isinstance(node[k], tuple) else v

    cfg = get_cfg()
    assign(cfg, conf["cfg"])
    return cfg


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise FileNotFoundError(f"{path}: no BENCHMARK.json")
        self.bench = json.loads(path.read_text())
        self.dir = self.root / self.bench["paths"][0]

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def runner(self, name: str):
        return load_module(self.dir / "runners" / f"{name}.py",
                           "bench_runner_")

    def limits(self, config: str, runner: str) -> Dict[str, float]:
        return json.loads((self.dir / "limits" / f"{config}.{runner}.json")
                          .read_text())["limits"]

    def metrics(self, cell: str, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it under ``workloads``, and those with no such list."""
        return [m for m in self.bench[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable[[object], Optional[float]]:
        return load_module(self.dir / "metrics" / f"{metric}.py",
                           "bench_metric_").read
