"""Per-op attainable bound of a profiled run (the port's counterpart of
the repository's ``tools/roofline_bound.py``).

    python -m centermask2_tpu_torch.tools.profile_model --trace-dir DIR ...
    python -m centermask2_tpu_torch.tools.roofline_bound DIR [--runs N] \\
        [--top 20] [--peak-tflops T] [--peak-gbps G]

Reads the per-op record that ``tools/profile_model.py`` writes under
``DIR`` (``ops.jsonl``: each aten op's module path, FLOPs, bytes, dtype,
TF32 flag and CUDA kernels with their microseconds; ``meta.json``: the
card and the runs) and computes, for every op that launched a kernel,

    bound_ms = max(flops / peak_flops(dtype), bytes / peak_hbm)

beside its measured kernel time (all its kernels: cuDNN's transposes
around a convolution are listed under the convolution). The FLOPs follow
``FlopCounterMode``'s formulas, as ``utils/measures.py::count_flops``
counts them; the bytes count each input read once and each output
written once. The FLOP peak is the one of the op's type: bf16 for bf16
and fp16, TF32 for float32 where TF32 was allowed for the op, else
float32 outside the tensor cores. The peaks are the card's published
ones, by its name (``utils/measures.py::peaks_of``); ``--peak-tflops``
(one rate for every type) and ``--peak-gbps`` override them, and a trace
of a CPU rehearsal, which names no card, needs both.

Prints the device total against the summed bounds, the per-section table
(actual, bound, flop bound, HBM bound, efficiency;
``utils/trace_sections.py``) and the ops with the most headroom, then
one JSON line of the per-section numbers.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict
from typing import Dict, List

from ..utils.measures import Peaks, peaks_of
from ..utils.trace_sections import section_of
from .profile_model import short_name


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("trace_dir")
    p.add_argument("--runs", type=int, default=0,
                   help="calls inside the trace window (default: the "
                        "record's)")
    p.add_argument("--top", type=int, default=20,
                   help="worst headroom ops to list")
    p.add_argument("--peak-tflops", type=float, default=None)
    p.add_argument("--peak-gbps", type=float, default=None)
    return p.parse_args(argv)


def load_trace(trace_dir: str):
    """(meta, records) written by ``tools/profile_model.py``."""
    with open(os.path.join(trace_dir, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(trace_dir, "ops.jsonl")) as f:
        records = [json.loads(line) for line in f if line.strip()]
    return meta, records


def trace_peaks(meta: Dict, peak_tflops=None, peak_gbps=None) -> Peaks:
    """The peaks of the card that made the trace, with the overrides."""
    name = meta.get("device", {}).get("name", "")
    peaks = peaks_of(name) if name else None
    if peaks is None and (peak_tflops is None or peak_gbps is None):
        raise ValueError(f"no published peaks for {name or 'a CPU trace'}: "
                         "pass --peak-tflops and --peak-gbps")
    if peaks is None:
        peaks = Peaks(0.0, 0.0, 0.0, 0.0)
    if peak_tflops is not None:
        t = peak_tflops * 1e12
        peaks = peaks._replace(bf16=t, tf32=t, f32=t)
    if peak_gbps is not None:
        peaks = peaks._replace(hbm_bytes_s=peak_gbps * 1e9)
    return peaks


def op_bound(rec: Dict, peaks: Peaks):
    """(flop ms, HBM ms, bound ms) of one op record."""
    import torch

    dtype = getattr(torch, rec.get("dtype") or "float32", torch.float32)
    if not isinstance(dtype, torch.dtype):
        dtype = torch.float32
    flop_ms = rec["flops"] / peaks.flops(dtype, rec.get("tf32", False)) \
        * 1e3 if rec["flops"] else 0.0
    hbm_ms = rec["bytes"] / peaks.hbm_bytes_s * 1e3
    return flop_ms, hbm_ms, max(flop_ms, hbm_ms)


def bound_rows(records: List[Dict], peaks: Peaks, runs: int) -> List[Dict]:
    """One row per op that launched a kernel, ms a run."""
    rows = []
    for r in records:
        if not r["kernels"]:
            continue
        flop_ms, hbm_ms, bound = op_bound(r, peaks)
        rows.append({"op": r["op"], "path": r["path"],
                     "section": section_of(r["path"]),
                     "ms": sum(us for _, us in r["kernels"]) / 1e3 / runs,
                     "flop_ms": flop_ms / runs, "hbm_ms": hbm_ms / runs,
                     "bound_ms": bound / runs,
                     "kernels": [k for k, _ in r["kernels"]]})
    return rows


def run(args) -> Dict:
    meta, records = load_trace(args.trace_dir)
    runs = args.runs or meta["runs"]
    peaks = trace_peaks(meta, args.peak_tflops, args.peak_gbps)
    rows = bound_rows(records, peaks, runs)
    total = sum(r["ms"] for r in rows)
    total_bound = sum(r["bound_ms"] for r in rows)
    print(f"{meta.get('clock', 'device')} total: {total:.3f} ms   "
          f"attainable bound: {total_bound:.3f} ms   headroom: "
          f"{total - total_bound:.3f} ms "
          f"({(total - total_bound) / total * 100 if total else 0:.0f}%)")
    print(f"(peaks: bf16 {peaks.bf16 / 1e12:g}, TF32 {peaks.tf32 / 1e12:g}, "
          f"f32 {peaks.f32 / 1e12:g} TFLOP/s, HBM "
          f"{peaks.hbm_bytes_s / 1e9:g} GB/s; "
          f"{meta.get('device', {}).get('name', 'no card')} "
          f"{meta.get('device', {}).get('power_limit', '')})")

    sec = defaultdict(lambda: [0.0, 0.0, 0.0, 0.0])
    for r in rows:
        s = sec[r["section"]]
        s[0] += r["ms"]
        s[1] += r["bound_ms"]
        s[2] += r["flop_ms"]
        s[3] += r["hbm_ms"]
    print("\nper section (ms):")
    print(f"{'section':>24} {'actual':>8} {'bound':>8} {'flop':>7} "
          f"{'hbm':>7} {'eff%':>5}")
    sections = {}
    for k, (ms, bound, flop, hbm) in sorted(sec.items(),
                                            key=lambda kv: -kv[1][0]):
        sections[k] = {"actual_ms": ms, "bound_ms": bound, "flop_ms": flop,
                       "hbm_ms": hbm}
        print(f"{k:>24} {ms:8.3f} {bound:8.3f} {flop:7.3f} {hbm:7.3f} "
              f"{bound / ms * 100 if ms else 0:5.0f}")

    print(f"\nworst headroom ops (actual - bound, top {args.top}):")
    print(f"{'ms':>7} {'bound':>7} {'flop%':>5} {'hbm%':>5}  op, path, "
          "kernels")
    worst = sorted(rows, key=lambda r: -(r["ms"] - r["bound_ms"]))[:args.top]
    for r in worst:
        ms = r["ms"]
        print(f"{ms:7.3f} {r['bound_ms']:7.3f} "
              f"{r['flop_ms'] / ms * 100 if ms else 0:5.0f} "
              f"{r['hbm_ms'] / ms * 100 if ms else 0:5.0f}  {r['op'][:36]} "
              f"{r['path'][-70:]}")
        print(f"{'':>28}" + ", ".join(sorted({short_name(k)
                                              for k in r["kernels"]}))[:90])
    out = {"tool": "roofline_bound", "total_ms": total,
           "bound_ms": total_bound, "sections": sections,
           "worst": [{k: r[k] for k in ("op", "path", "ms", "bound_ms")}
                     for r in worst]}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> Dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
