"""Fixed-shape export with the port (the counterpart of the repository's
``tools/export_model.py`` and of the reference's
``convert_model_into_onnx.py``).

    python -m centermask2_tpu_torch.tools.export_model \\
        --config-file configs/centermask/zy_model_serving.yaml \\
        --out centermask2.pt2 [--weights model.pth|converted_dir] [--batch 1] \\
        [--serving-u8 [--tight {landscape,portrait} [--tight-compute]]] \\
        [--device cpu] [KEY VALUE ...]

Exports ``model.inference`` at one input shape with the weights inside
(``export/aot.py::export_serialized``): by default the f32 program over
the full ``TPU.FIXED_EDGE_SIZE`` canvas (in the s2d layout for an
s2d-input model), ``callable(images)``; with ``--serving-u8`` the raw
uint8 s2d serving program ``callable(images_u8, valid_hw)``, over the
full square or, with ``--tight``, over the tight canvas of one
orientation, padded back to the square on the device unless
``--tight-compute`` runs it at the tight canvas. ``load_serialized``
runs the artifact without the model definition. Prints the artifact's
size, the input shape and the GFLOPs of one call. Runs on the GPU unless
``--device cpu``; without ``--weights`` the weights are random, from
seed 0.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default=None)
    p.add_argument("--weights", default=None,
                   help="a reference-schema .pth checkpoint or a converted "
                        "checkpoint directory (tools/convert_weights.py)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--serving-u8", action="store_true",
                   help="export the raw-uint8 s2d serving program "
                        "callable(images_u8, valid_hw); needs "
                        "TPU.S2D_STEM_INPUT True")
    p.add_argument("--tight", choices=["landscape", "portrait"], default=None,
                   help="with --serving-u8: the tight quantized canvas of "
                        "this orientation instead of the full square")
    p.add_argument("--tight-compute", action="store_true",
                   help="with --tight: the program runs at the tight canvas "
                        "(no pad-back to the square)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from ..checkpoint.weights import load_weights
    from ..config import get_cfg
    from ..data.preprocess import s2d_serving_canvas
    from ..export import export_serialized, inference_flops
    from ..models.meta import build_centermask

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = build_centermask(cfg, device=args.device, seed=0)
    if args.weights:
        load_weights(model, cfg, args.weights)
    fixed = cfg.TPU.FIXED_EDGE_SIZE

    dtype, canvas = torch.float32, None
    if (args.tight or args.tight_compute) and not args.serving_u8:
        raise SystemExit("--tight and --tight-compute shape the uint8 s2d "
                         "serving program: they need --serving-u8")
    if args.serving_u8:
        if not model.s2d_input:
            raise SystemExit("--serving-u8 requires TPU.S2D_STEM_INPUT True")
        if args.tight_compute and not args.tight:
            raise SystemExit("--tight-compute requires --tight (an "
                             "orientation to pick the canvas)")
        short = cfg.INPUT.MIN_SIZE_TEST
        ch = cw = fixed
        if args.tight == "landscape":
            ch, cw = s2d_serving_canvas(short, fixed, fixed, short)
        elif args.tight == "portrait":
            cw, ch = s2d_serving_canvas(short, fixed, fixed, short)
        shape = (args.batch, ch // 4 + 1, cw // 4 + 1, 48)
        dtype = torch.uint8
        canvas = None if args.tight_compute else (fixed, fixed)
        what = (f"uint8 s2d input {shape} + valid_hw, canvas "
                f"{(ch, cw) if args.tight_compute else (fixed, fixed)}")
    elif model.s2d_input:
        shape = (args.batch, fixed // 4 + 1, fixed // 4 + 1, 48)
        what = f"f32 s2d input {shape}"
    else:
        shape = (args.batch, fixed, fixed, 3)
        what = f"f32 input {shape}"

    path = export_serialized(model, shape, args.out, input_dtype=dtype,
                             canvas_hw=canvas)
    flops = inference_flops(model, shape, input_dtype=dtype, canvas_hw=canvas)
    dev = next(model.parameters()).device
    print(f"exported {path} ({os.path.getsize(path) / 1e6:.1f} MB), {what}, "
          f"{flops / 1e9:.1f} GFLOP a call, on {dev}")


if __name__ == "__main__":
    main()
