"""The readings that a cell's limits are set from, on the card: for each
seed, the numbers of the comparison (``benchmark/harness/compare.py``)
for the program and for the control, the reference computed in float8
e4m3 put in the program's place, read against the float32 reference on
the same sampled requests.

    python3 benchmark/tools/readings.py --workload v39.serve.open \\
        --seconds 3 --seeds 1 2 3 ... [--fault NAME] [--out readings.jsonl]

``--fault``: the program with a fault of ``tools/faults.py`` planted in
its decode, in place of the sound program (the control is then left
out). Each row also gives ``judged``: the fewest candidates that
``set_gap`` held to a decision in a sampled request.

One process builds the program once and, for each seed, loads the
seed's weights into it (the captured graphs read them in place), makes
the seed's images and serves a short window at the cell's own load; the
sample is compared after it. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def readings(workload: str, seconds: float, seeds, control: bool = True,
             root: str = ROOT, fault: str = None, dev=None):
    """Yield one row a seed: {"seed", "requests", "sample", "program",
    "control"} with the widest numbers of each side."""
    import torch

    from centermask2_tpu_torch.export import CapturedInference

    from benchmark.harness import compare, traffic as traffic_mod, weights
    from benchmark.harness.serve import Sampler, Server
    from benchmark.harness.spec import Spec, program_cfg
    from benchmark.reference.model import Reference, exact_f32
    from faults import FAULTS

    spec = Spec(root)
    cell = spec.cell(workload)
    conf = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["config"], traffic["runner"])
    cfg = program_cfg(conf)
    dev = torch.device("cuda", 0) if dev is None else dev
    capture = CapturedInference if dev.type == "cuda" else (
        lambda m: m.inference)
    program = None if fault is None else (
        lambda model: FAULTS[fault](model, capture))
    control = control and fault is None
    server = Server(cfg, traffic, seeds[0], dev, program=program)
    server.warm_up()
    entries = server.entries
    for seed in seeds:
        t0 = time.perf_counter()
        server.seed = seed
        w = weights.make(entries, seed, dev)
        server.model.load_state_dict(w, strict=True)
        server.images = traffic_mod.images(traffic, seed)
        server.warm_up(calls=1)
        sampler = Sampler(int(traffic["sample"]), seed)
        rec = server.window(seconds, sampler)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        row = {"seed": seed, "requests": rec.attempted, "sample": 0}
        with exact_f32(), torch.no_grad():
            ref = Reference(conf["cfg"]).to(dev).load(w)
            ref8 = None if not control else Reference(
                conf["cfg"], "fp8").to(dev).load(w)
            prog, ctrl = [], []
            for i, outputs in sorted(sampler.sample().items()):
                r = server.requests[i]
                img = compare.image_tensor(server.images[(r.hw, r.variant)],
                                           dev)
                canvas = server.feed.compute_canvas(r.hw)
                prog.append(compare.gaps(ref, outputs, img, canvas, limits))
                if ref8 is not None:
                    ctrl.append(compare.gaps(ref, compare.batch_of_one(
                        ref8.serve(img, canvas)), img, canvas, limits))
            row["sample"] = len(prog)
            row["program"] = compare.widest(prog)
            row["judged"] = min(g["judged"] for g in prog)
            if ctrl:
                row["control"] = compare.widest(ctrl)
        del ref, ref8, w
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        row["s"] = time.perf_counter() - t0
        yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--no-control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    out = open(args.out, "a") if args.out else None
    for row in readings(args.workload, args.seconds, args.seeds,
                        not args.no_control, fault=args.fault):
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
