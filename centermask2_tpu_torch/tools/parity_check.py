"""Three-way parity ladder of the deployment chain (the counterpart of the
repository's ``tools/parity_check.py``, the reference's ``tester.py``
analog).

    python -m centermask2_tpu_torch.tools.parity_check \\
        --config-file configs/centermask/zy_model_config.yaml \\
        [--image img.jpg] [--weights model.pth|converted_dir] \\
        [--device cpu] [KEY VALUE ...]

The reference proves its deployment chain by running one input through
three stacks and comparing them (tester.py:78-134). The port's rungs:

  direct   - ``model.inference`` on the device,
  exported - ``export/aot.py::export_serialized`` to a ``.pt2`` file,
             then ``load_serialized``, run on the same input,
  bins     - the six-tensor outputs of ``direct`` written to ``.bin``
             files and read back with the reference's dtype and shape
             contract (``data/bin_io.py``; ``pred_classes`` widened to
             int64 there).

Prints the cosine similarity and the mean absolute error of every output
for direct | exported and direct | bins, and ``PARITY OK`` when every
cosine is above 1 - 1e-5 (run_shell.py:22), else ``PARITY FAIL``; the
exit code follows. The input is ``--image`` through the host pipeline,
or noise (``RandomState(0)``, x30) over the ``TPU.FIXED_EDGE_SIZE``
canvas. Runs on the GPU unless ``--device cpu``; without ``--weights``
the weights are random, from seed 0.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Tuple

import numpy as np

THRESHOLD = 1 - 1e-5
OUTPUTS = ("locations", "mask_scores", "pred_boxes", "pred_classes",
           "pred_masks", "scores", "valid")


def cos_sim(a, b) -> float:
    a = np.asarray(a).reshape(-1).astype(np.float64)
    b = np.asarray(b).reshape(-1).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 and nb == 0:
        return 1.0
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


def mae(a, b) -> float:
    return float(np.abs(np.asarray(a).astype(np.float64)
                        - np.asarray(b).astype(np.float64)).mean())


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default=None)
    p.add_argument("--image", default=None, help="optional real image")
    p.add_argument("--weights", default=None,
                   help="a reference-schema .pth checkpoint or a converted "
                        "checkpoint directory (tools/convert_weights.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def model_input(model, cfg, image=None, seed: int = 0):
    """The network input on the model's device: ``image`` through
    ``preprocess_for_model`` (in the model's s2d layout when it takes
    one), or noise from ``seed`` over the fixed canvas."""
    import torch

    from ..data.preprocess import preprocess_for_model, stem_space_to_depth

    fixed = cfg.TPU.FIXED_EDGE_SIZE
    if image:
        x = preprocess_for_model(image, fixed, cfg.INPUT.MIN_SIZE_TEST,
                                 cfg.INPUT.MAX_SIZE_TEST,
                                 s2d=model.s2d_input)["input"]
    else:
        x = np.random.RandomState(seed).randn(
            1, fixed, fixed, 3).astype(np.float32) * 30
        if model.s2d_input:
            x = stem_space_to_depth(x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        next(model.parameters()).device)


def ladder(model, x) -> Tuple[List[tuple], bool]:
    """Run the three rungs on ``x``; returns the rows (output, cos and
    mae direct | exported, cos and mae direct | bins) and whether every
    cosine passes."""
    import torch

    from ..data import bin_io
    from ..export import export_serialized, load_serialized

    with torch.no_grad():
        direct = {k: v.cpu().numpy()
                  for k, v in model.inference(x)._asdict().items()
                  if v is not None}
    with tempfile.TemporaryDirectory() as d:
        path = export_serialized(model, tuple(x.shape),
                                 os.path.join(d, "model.pt2"))
        exported = {k: v.cpu().numpy()
                    for k, v in load_serialized(path)(x)._asdict().items()
                    if v is not None}
    six = [direct[n][0] for n in bin_io.OUTPUT_NAMES]
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "img")
        bin_io.write_output_bins(six, prefix)
        bins = dict(zip(bin_io.OUTPUT_NAMES, bin_io.read_output_bins(prefix)))
    rows, ok = [], True
    for n in OUTPUTS:
        c1, m1 = cos_sim(direct[n], exported[n]), mae(direct[n], exported[n])
        if n in bins:
            a = direct[n][0]
            b = bins[n].reshape(a.shape)
            c2, m2 = cos_sim(a, b), mae(a, b)
        else:
            c2, m2 = 1.0, 0.0
        rows.append((n, c1, m1, c2, m2))
        ok &= c1 > THRESHOLD and c2 > THRESHOLD
    return rows, ok


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..checkpoint.weights import load_weights
    from ..config import get_cfg
    from ..models.meta import build_centermask

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = build_centermask(cfg, device=args.device, seed=0)
    if args.weights:
        load_weights(model, cfg, args.weights)
    rows, ok = ladder(model, model_input(model, cfg, args.image))
    print(f"{'output':<14}{'cos(direct,export)':>20}{'mae':>12}"
          f"{'cos(direct,bins)':>20}{'mae':>12}")
    for n, c1, m1, c2, m2 in rows:
        print(f"{n:<14}{c1:>20.6f}{m1:>12.2e}{c2:>20.6f}{m2:>12.2e}")
    print("PARITY OK" if ok else "PARITY FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
