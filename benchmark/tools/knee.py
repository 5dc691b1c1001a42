"""The sweep that finds a cell's knee on the card: the cell's program
served in one process at each of a list of open-loop rates, and once as
a closed loop of ``--in-flight`` requests (its capacity); and the cell's
own arrivals under other ``order`` keys, to see where its own order's
tail lies among them.

    python3 benchmark/tools/knee.py --workload v39.serve.open \\
        --seconds 10 --rates 50 60 70 80 --in-flight 4 --seed 7 \\
        [--orders 0 1 2 3]

Each rate keeps the cell's arrivals but for the rate (its ``order``
among them). Prints one JSON line a run: the requests sent, the p50, p95
and p99 of their latency from due to done, the p95 of how late they were
sent, and the rate they completed at. The knee is the highest rate whose
p95 does not grow with the window, below the closed loop's capacity.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
os.environ["OMP_NUM_THREADS"] = "2"  # as benchmark/run.py


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--in-flight", type=int, default=0)
    p.add_argument("--orders", type=int, nargs="*", default=[])
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    import torch

    torch.set_num_threads(2)  # as a run of the benchmark
    from benchmark.harness.serve import Sampler, Server
    from benchmark.harness.spec import Spec, program_cfg

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    server = Server(program_cfg(conf), traffic, args.seed,
                    torch.device("cuda"))
    server.warm_up()
    arrivals = traffic["arrivals"]
    runs = [dict(arrivals, rate_per_s=float(r)) for r in args.rates]
    runs += [dict(arrivals, order=int(k)) for k in args.orders]
    if args.in_flight:
        runs.append({"kind": "closed", "in_flight": args.in_flight})
    for arr in runs:
        t = copy.deepcopy(traffic)
        t["arrivals"] = arr
        server.traffic = t
        rec = server.window(args.seconds, Sampler(1, args.seed))
        q = lambda a, pc: float(np.percentile(a, pc)) if len(a) else None
        print(json.dumps({
            "arrivals": t["arrivals"], "sent": rec.attempted,
            "p50_ms": q(rec.lat_ms, 50), "p95_ms": q(rec.lat_ms, 95),
            "p99_ms": q(rec.lat_ms, 99),
            "late_p95_ms": q(rec.lateness_ms, 95),
            "host_ms": q(rec.host_ms, 50),
            "replay_ms": float(np.mean(rec.replay_ms)),
            "completed_per_s": rec.completed / rec.window_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
