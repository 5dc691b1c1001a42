"""A checkout of the benchmark with a tiny configuration added as files
only, for runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
# float32 on both sides on the CPU: the program's plain paths agree with
# the reference to rounding (about 1e-6); the detections' count exactly;
# NMS keeps no two boxes of a class above its 0.6
TINY_LIMITS = {"score_gap": 1e-4, "box_gap": 1e-4, "mask_gap": 1e-4,
               "mask_score_gap": 1e-4, "valid_gap": 0.0, "set_gap": 0.0,
               "overlap": 0.61}

TINY_OPTS = {
    "vovnet": ["configs/centermask/zy_model_serving.yaml",
               "MODEL.VOVNET.CONV_BODY", "V-19-slim-eSE"],
    "resnet": ["configs/centermask/centermask_R_50_FPN_ms_3x.yaml"],
}
SMALL = ["MODEL.FPN.OUT_CHANNELS", 64, "TPU.FIXED_EDGE_SIZE", 128,
         "TPU.NMS_CANDIDATES", 200, "MODEL.FCOS.PRE_NMS_TOPK_TEST", 200,
         "MODEL.FCOS.POST_NMS_TOPK_TEST", 20, "MODEL.ROI_MASK_HEAD.CONV_DIM",
         32, "MODEL.ROI_MASKIOU_HEAD.CONV_DIM", 32, "TPU.COMPUTE_DTYPE",
         "float32"]
SOURCES = [[48, 64, 0.5], [64, 48, 0.3], [64, 64, 0.2]]


def tiny_cfg(kind: str) -> dict:
    sys.path.insert(0, str(REPO / "benchmark" / "tools"))
    from make_config import plain

    from centermask2_tpu_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_file(str(REPO / TINY_OPTS[kind][0]))
    cfg.merge_from_list(TINY_OPTS[kind][1:] + [str(v) for v in SMALL])
    return plain(cfg)


def traffic(arrivals: dict, canvas: str) -> dict:
    return {"runner": "serve", "arrivals": arrivals, "canvas": canvas,
            "sizes": {"short": 64, "max": 100, "sources": SOURCES},
            "variants": 2, "sample": 3}


def checkout(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files and
    runners, with the tiny cells ``tiny.open`` (VoVNet, s2d) and ``tiny.r50`` (ResNet, f32
    host path) and ``tiny.closed`` added as files and entries only."""
    root = Path(tmp)
    for sub in ("configs", "traffic", "metrics", "limits", "runners"):
        shutil.copytree(BENCH / sub, root / "benchmark" / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, kind in (("tiny-vovnet", "vovnet"), ("tiny-r50", "resnet")):
        (root / "benchmark/configs" / f"{name}.json").write_text(json.dumps(
            {"cfg": tiny_cfg(kind)}))
        (root / "benchmark/limits" / f"{name}.serve.json").write_text(
            json.dumps({"limits": TINY_LIMITS}))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": [], "why": "test"})
    for name, arr, canvas in (
            ("tiny.open", {"kind": "poisson", "rate_per_s": 30.0,
                           "order": 0},
             "pad_to_deploy"),
            ("tiny.closed", {"kind": "closed", "in_flight": 2},
             "tight_compute")):
        (root / "benchmark/traffic" / f"{name}.json").write_text(
            json.dumps(traffic(arr, canvas)))
    cells = [("tiny.open", "tiny-vovnet", "tiny.open"),
             ("tiny.r50", "tiny-r50", "tiny.open"),
             ("tiny.closed", "tiny-vovnet", "tiny.closed")]
    for name, config, mix in cells:
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            suffix = "closed" if ("closed" in m["name"] or m["name"]
                                  == "serve_images_per_s") else "open"
            m["workloads"] += [c for c, _, _ in cells
                               if (c == "tiny.closed") == (suffix ==
                                                           "closed")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run(root: Path, cell: str, capsys, trace: int = 0, seconds: float = 1.5,
        seed: int = 3_000_000_007, program=None) -> dict:
    """A rehearsal on the CPU: the result line, parsed."""
    from benchmark.harness.main import main

    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], root=root,
              rehearse=True, program=program)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out
    return json.loads(out[-1])
