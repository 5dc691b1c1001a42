"""Model statistics: parameters, FLOPs and peak device memory (the
counterpart of the repository's ``tools/measure.py``).

    python -m centermask2_tpu_torch.tools.measure \\
        --config-file configs/centermask/zy_model_config.yaml \\
        [--edge 1344] [--weights model.pth|converted_dir] [--device cpu] \\
        [KEY VALUE ...]

Prints the parameters and their bytes as the JAX package counts them
(``utils/measures.py``), then for the backbone with the FPN and for the
whole inference at an ``--edge`` square canvas (default
``TPU.FIXED_EDGE_SIZE``): the FLOPs of one call (``FlopCounterMode``:
convolutions and matrix products, not XLA's cost analysis) and, on the
GPU, the device memory the call allocates at its peak. Runs on the GPU
unless ``--device cpu``; without ``--weights`` the weights are random,
from seed 0.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default=None)
    p.add_argument("--edge", type=int, default=0)
    p.add_argument("--weights", default=None,
                   help="a reference-schema .pth checkpoint or a converted "
                        "checkpoint directory (tools/convert_weights.py)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from ..checkpoint.weights import load_weights
    from ..config import get_cfg
    from ..models.meta import build_centermask
    from ..utils.measures import count_params, measure_model, param_bytes

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    edge = args.edge or cfg.TPU.FIXED_EDGE_SIZE
    model = build_centermask(cfg, device=args.device, seed=0)
    if args.weights:
        load_weights(model, cfg, args.weights)
    dev = next(model.parameters()).device
    shape = ((1, edge // 4 + 1, edge // 4 + 1, 48) if model.s2d_input
             else (1, edge, edge, 3))
    x = torch.zeros(shape, device=dev)

    n = count_params(model)
    print(f"config: {cfg.MODEL.VOVNET.CONV_BODY} @ {edge}x{edge}")
    print(f"params: {n / 1e6:.2f} M ({param_bytes(model) / 1e6:.1f} MB fp32)"
          f" [{n} parameters, {param_bytes(model)} bytes]")
    for name, fn in (("backbone+fpn", model.features),
                     ("full inference", model.inference)):
        st = measure_model(model, fn, x)
        line = f"{name}: {st['flops'] / 1e9:.1f} GFLOP [{int(st['flops'])}]"
        if "peak_bytes" in st:
            line += f", {st['peak_bytes'] / 1e6:.0f} MB peak device memory"
        else:
            line += f", peak device memory not measured on {dev}"
        print(line)


if __name__ == "__main__":
    main()
