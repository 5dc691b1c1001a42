"""Per-layer activation dump and comparison (the counterpart of the
repository's ``tools/check_layers.py``, the reference's
``check_layers_outputs.py`` / ``run_shell.py`` analog).

    # dump
    python -m centermask2_tpu_torch.tools.check_layers dump --out a.npz \\
        [--config-file ...] [--image img.jpg] [--seed 0] [--filter name] \\
        [--list 10] [--weights model.pth|converted_dir] [--device cpu] \\
        [KEY VALUE ...]
    # compare two dumps (the port's, the JAX tool's, or one of each)
    python -m centermask2_tpu_torch.tools.check_layers compare a.npz b.npz \\
        [--threshold 0.99999] [--show 20]

``dump`` runs ``model.inference`` once with a forward hook on every
submodule, the counterpart of flax's ``capture_intermediates``, and
saves every output to an ``.npz`` under the key the JAX tool writes for
the same module, so a dump of each stack compares by name: the flax
module path (the port's module names are the JAX package's, the tree
``checkpoint/from_jax.py`` maps), then ``__call__[i]`` for the i-th call
of the module (the FCOS head's modules, shared over the levels, are
called once a level; the port's towers, called once over the list of
levels, are keyed as JAX's, a call a level), then the output's
structure (``[j]`` into a tuple or list, ``/key`` into a dict). 4-D activations are stored NHWC, as JAX
computes them; the root's ``__call__[0][j]`` are the model's outputs.
``--filter`` keeps the modules whose own name contains the string (the
root then drops out, as in JAX). JAX keys with no counterpart in the
port's dump: ``.../ese/fc/__call__[0][0|1]`` (flax records the eSE
gate's kernel and bias there: that module returns its parameters);
``.../gn/__call__[i]`` and ``.../bn/__call__[i]``, flax's GroupNorm and
BatchNorm inside the norm wrappers, whose outputs are the wrappers' own
(the port's wrappers hold those parameters and are hooked themselves).
The port's dump alone holds the keypoint head's deconv
(``.../score_lowres/__call__[i]``), which JAX computes on the head with
no module of its own. A dump on the GPU lacks the towers' GroupNorms
(``.../cls_tower/norm<i>/__call__[l]``): there kernel 3 computes a tower
layer's GroupNorm and ReLU in one pass (``models/fcos/head.py``) and
writes no norm output. The file is written uncompressed.

``compare`` sorts the layers both dumps hold by cosine similarity, flags
``<-- DRIFT`` below ``--threshold`` and exits 1 if any layer is below it,
or if an FCOS tower's output is in one dump only; a layer whose shapes
differ scores 0. The keys of only one dump are counted (the tower norms
among them apart) and the first ``--show`` listed. ``dump`` runs on the GPU unless
``--device cpu``; without ``--weights`` the weights are random, from seed
0.
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from .parity_check import cos_sim

# port modules where flax records parameters, not an activation
NOT_ACTIVATIONS = ("ese.fc",)
# an FCOS tower's output at one level, and its GroupNorms' (none on the
# GPU, where kernel 3 fuses them with their ReLU)
TOWER_OUTPUT = re.compile(r"(.+/)?\w+_tower/__call__\[\d+\]")
TOWER_NORM = re.compile(r"(.+/)?\w+_tower/norm\d+/__call__\[\d+\]")


def flatten_intermediates(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The JAX tool's flattening: dicts by ``/key``, tuples and lists by
    ``[i]``; ``None`` leaves dropped."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_intermediates(v, f"{prefix}/{k}" if prefix
                                             else k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flatten_intermediates(v, f"{prefix}[{i}]"))
    elif tree is not None:
        out[prefix] = tree
    return out


def _to_host(x):
    """A module's output as numpy in the JAX layout (4-D NCHW -> NHWC;
    bf16 as f32), keeping its tuples, lists and dicts."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x.cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_to_host(v) for v in x)
    return None


def capture_layers(model, x, name_filter: Optional[str] = None
                   ) -> Dict[str, np.ndarray]:
    """Run ``model.inference(x)`` once and return every hooked output
    under its JAX key (module docstring)."""
    import torch

    from ..models.fcos.head import Tower

    calls: Dict[str, list] = {}

    def hook_for(name):
        def hook(module, args, output):
            outs = calls.setdefault(name, [])
            if isinstance(module, Tower):  # one call over the levels
                outs.extend(_to_host(o) for o in output)
            else:
                outs.append(_to_host(output))
        return hook

    handles = [
        module.register_forward_hook(hook_for(name))
        for name, module in model.named_modules()
        if name and not name.endswith(NOT_ACTIVATIONS)
        and (name_filter is None or name_filter in name.rsplit(".", 1)[-1])]
    try:
        with torch.no_grad():
            out = model.inference(x)
    finally:
        for h in handles:
            h.remove()
    if name_filter is None:
        calls[""] = [_to_host(tuple(out))]
    tree: dict = {}
    for name, outs in calls.items():
        node = tree
        for part in name.split(".") if name else ():
            node = node.setdefault(part, {})
        node["__call__"] = tuple(outs)
    return flatten_intermediates(tree)


def compare_layers(a: Mapping[str, np.ndarray], b: Mapping[str, np.ndarray]
                   ) -> Tuple[List[tuple], List[str], List[str]]:
    """(rows (cos, mae, key) of the keys both hold, worst first; keys only
    in ``a``; keys only in ``b``)."""
    rows = []
    for k in sorted(set(a) & set(b)):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.shape != y.shape:
            rows.append((0.0, np.inf, k))
            continue
        m = float(np.abs(x.astype(np.float64) - y.astype(np.float64)).mean())
        rows.append((cos_sim(x, y), m, k))
    rows.sort()
    return rows, sorted(set(a) - set(b)), sorted(set(b) - set(a))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("--config-file", default=None)
    d.add_argument("--image", default=None)
    d.add_argument("--out", required=True)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--filter", default=None, help="substring of module name")
    d.add_argument("--list", type=int, default=10)
    d.add_argument("--weights", default=None,
                   help="a reference-schema .pth checkpoint or a converted "
                        "checkpoint directory (tools/convert_weights.py)")
    d.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--threshold", type=float, default=1 - 1e-5)
    c.add_argument("--show", type=int, default=20)
    return p.parse_known_args(argv)


def cmd_dump(args, opts) -> int:
    from ..checkpoint.weights import load_weights
    from ..config import get_cfg
    from ..models.meta import build_centermask
    from .parity_check import model_input

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if opts:
        cfg.merge_from_list(opts)
    model = build_centermask(cfg, device=args.device, seed=0)
    if args.weights:
        load_weights(model, cfg, args.weights)
    flat = capture_layers(model, model_input(model, cfg, args.image,
                                             args.seed), args.filter)
    flat = {k: v for k, v in flat.items() if v.dtype.kind in "fiub"}
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} activations to {args.out}")
    for k in sorted(flat)[: args.list or 10]:
        print(f"  {k}: {flat[k].shape}")
    return 0


def print_comparison(rows, only_a, only_b, threshold: float,
                     show: int) -> int:
    """Print ``compare_layers``' result; returns the layers below
    ``threshold`` and the FCOS tower outputs of one dump only."""
    norms = sum(1 for k in only_a + only_b if TOWER_NORM.fullmatch(k))
    print(f"{len(rows)} layers compared, {len(only_a) + len(only_b)} only "
          f"in one dump ({norms} of them FCOS tower norms)")
    for which, keys in (("a", only_a), ("b", only_b)):
        for k in keys[:show]:
            print(f"  only in {which}: {k}")
    towers = [k for k in only_a + only_b if TOWER_OUTPUT.fullmatch(k)]
    if towers:
        print(f"{len(towers)} FCOS tower outputs in one dump only, e.g. "
              f"{towers[0]}")
    print(f"{'cos_sim':>10} {'mae':>12}  layer")
    for c, m, k in rows[:show]:
        flag = " <-- DRIFT" if c < threshold else ""
        print(f"{c:>10.6f} {m:>12.3e}  {k}{flag}")
    n_bad = sum(1 for c, _, _ in rows if c < threshold)
    print(f"{n_bad} layers below cosine threshold {threshold}")
    return n_bad + len(towers)


def cmd_compare(args, _) -> int:
    with np.load(args.a) as fa, np.load(args.b) as fb:
        a = {k: fa[k] for k in fa.files}
        b = {k: fb[k] for k in fb.files}
    n_bad = print_comparison(*compare_layers(a, b),
                             args.threshold, args.show)
    return 1 if n_bad else 0


def main(argv=None) -> int:
    args, opts = parse_args(argv)
    if args.cmd == "dump":
        return cmd_dump(args, opts)
    return cmd_compare(args, opts)


if __name__ == "__main__":
    sys.exit(main())
