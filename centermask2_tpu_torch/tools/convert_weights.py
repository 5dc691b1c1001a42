"""Convert a reference detectron2 ``.pth`` checkpoint into the port's
checkpoint (the counterpart of the repository's
``tools/convert_weights.py``).

    python -m centermask2_tpu_torch.tools.convert_weights \\
        --pth centermask2-V-39-eSE-FPN-ms-3x.pth \\
        --config-file configs/centermask/zy_model_config.yaml \\
        --out ckpt/v39 [--device cpu] [KEY VALUE ...]

Converts every tensor of the checkpoint (``checkpoint/convert_torch.py``,
the JAX package's layout), overlays the converted leaves on the model's
initial state (shapes checked) and reports the coverage as the JAX tool
does (the reference's check_keys, deploy_utils.py:31-43): the model's
parameters, the checkpoint's keys, filled and missing parameters, and
the torch keys left unused. A complete conversion prints ``missing: 0``
and no unused keys. The result is saved through
``checkpoint/torch_io.py`` (``OUT/step_0/state.pt``); ``--weights OUT``
loads it in the port's CLIs. The JAX tool writes an orbax directory,
which needs JAX; this one writes ``torch.save`` files. The model is built
on the GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pth", required=True)
    p.add_argument("--config-file", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    from ..checkpoint.from_jax import params_entries, state_dict_from_jax
    from ..checkpoint.torch_io import save_checkpoint
    from ..checkpoint.weights import convert_pth
    from ..config import get_cfg
    from ..models.meta import build_centermask

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = build_centermask(cfg, device=args.device, seed=0)

    tree, report, n_keys = convert_pth(cfg, args.pth)
    converted = state_dict_from_jax(tree)
    params = params_entries(model)
    missing = sorted(k for k in params if k not in converted)
    state = model.state_dict()
    for k, (path, t) in converted.items():
        if k not in state:
            continue
        if t.shape != state[k].shape:
            raise ValueError(f"shape mismatch at {'/'.join(path)}: ckpt "
                             f"{tuple(t.shape)} vs model "
                             f"{tuple(state[k].shape)}")
        state[k] = t
    model.load_state_dict(state, strict=True)

    n_total = len(params)
    print(f"{n_total} model params, {n_keys} torch keys")
    print(f"filled: {n_total - len(missing)}, missing: {len(missing)}")
    if missing:
        print("missing params:", missing[:30])
    unused = [k for k in report["unused_torch_keys"]
              if not k.endswith("num_batches_tracked")
              and "pixel_" not in k and "anchor" not in k]
    if unused:
        print(f"unused torch keys ({len(unused)}):", unused[:30])
    save_checkpoint(args.out, {"model": model.state_dict(), "step": 0}, 0)
    print(f"saved to {args.out}")


if __name__ == "__main__":
    main()
