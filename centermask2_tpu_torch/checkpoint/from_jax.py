"""JAX parameter tree -> the port's ``state_dict``.

Takes the JAX package's parameters as a nested dict of numpy arrays
(``jax.tree.map(np.asarray, variables["params"])``) and returns the
port's state_dict, inverting the transforms of the JAX package's
``checkpoint/convert_torch.py``:

- conv   (kh, kw, I, O) -> (O, I, kh, kw)
- deconv (kh, kw, O, I) -> (I, O, kh, kw)   (the same axis permutation)
- linear (I, O)         -> (O, I)
- ``maskiou_fc1``: JAX flattens the (7, 7, C) activation H,W,C-major and
  the port (C, 7, 7) C-major, so the weight columns are permuted.

Module paths map one to one (the port mirrors the JAX module names);
only leaf names change: ``kernel`` -> ``weight``, a GroupNorm's
``gn/scale`` -> ``gn.weight``, a BatchNorm's ``bn/scale`` -> ``bn.weight``,
and the keypoint head's deconv, whose JAX leaves sit on the head
(``score_lowres_kernel``, ``score_lowres_bias``), becomes its module
``score_lowres`` (``weight``, ``bias``). A BN or SyncBN model's running
statistics come from flax's ``batch_stats`` collection (``.../bn/mean``,
``.../bn/var``), which ``load_jax_params`` takes beside the parameters;
MobileNetV2's FrozenBN modules, also named ``bn...``, hold
``frozen_scale``/``frozen_bias`` leaves and map as every FrozenBN does.
This module imports nothing of JAX: it reads plain arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _leaf(path: Tuple[str, ...], v: np.ndarray,
          maskiou_resolution: int) -> Tuple[str, np.ndarray]:
    *mod, name = path
    if name in ("score_lowres_kernel", "score_lowres_bias"):
        mod, name = [*mod, "score_lowres"], name[len("score_lowres_"):]
    if name == "kernel":
        if v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif v.ndim == 2:
            v = v.T
            if mod and mod[-1] == "maskiou_fc1":
                r = maskiou_resolution
                c = v.shape[1] // (r * r)
                v = v.reshape(v.shape[0], r, r, c).transpose(0, 3, 1, 2) \
                    .reshape(v.shape[0], -1)
        else:
            raise ValueError(f"{'/'.join(path)}: kernel of rank {v.ndim}")
        name = "weight"
    elif name == "scale" and mod and mod[-1] in ("gn", "bn"):
        name = "weight"
    elif name in ("mean", "var") and not (mod and mod[-1] == "bn"):
        raise ValueError(f"{'/'.join(path)}: running statistic outside "
                         "a BatchNorm")
    elif name not in ("bias", "scale", "frozen_scale", "frozen_bias",
                      "mean", "var"):
        raise ValueError(f"{'/'.join(path)}: unknown JAX leaf {name!r}")
    return ".".join([*mod, name]), np.ascontiguousarray(v, dtype=np.float32)


def state_dict_from_jax(params: Mapping[str, Any],
                        maskiou_resolution: int = 7,
                        batch_stats: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, Tuple[Tuple[str, ...], torch.Tensor]]:
    """Port key -> (JAX path, tensor) for every JAX leaf of ``params``
    and of ``batch_stats`` (flax's collection of the same name, or None).
    """
    leaves = _flatten(params)
    if batch_stats:
        for path, v in _flatten(batch_stats).items():
            if path[-1] not in ("mean", "var"):
                raise ValueError(f"{'/'.join(path)}: unknown batch_stats "
                                 "leaf")
            leaves[path] = v
    out = {}
    for path, v in leaves.items():
        key, arr = _leaf(path, v, maskiou_resolution)
        out[key] = (path, torch.tensor(arr))
    return out


def load_jax_params(model: nn.Module, params: Mapping[str, Any],
                    maskiou_resolution: int = 7,
                    batch_stats: Optional[Mapping[str, Any]] = None) -> None:
    """Load JAX parameters (and, for a BN or SyncBN model, flax's
    ``batch_stats``) into ``model`` with ``strict=True``. Raises if any
    JAX leaf has no place in the model (naming the leaf), if a model
    entry gets no JAX leaf, or if a shape differs."""
    converted = state_dict_from_jax(params, maskiou_resolution, batch_stats)
    own = model.state_dict()
    unused = sorted("/".join(p) for k, (p, _) in converted.items()
                    if k not in own)
    missing = sorted(k for k in own if k not in converted)
    if unused or missing:
        raise ValueError(f"JAX leaves not used by the port: {unused}; port "
                         f"entries with no JAX leaf: {missing}")
    bad = [f"{'/'.join(p)}: {tuple(t.shape)} vs {tuple(own[k].shape)}"
           for k, (p, t) in converted.items() if t.shape != own[k].shape]
    if bad:
        raise ValueError(f"shape mismatches: {bad}")
    model.load_state_dict({k: t for k, (_, t) in converted.items()},
                          strict=True)
