"""Weights for the port's CLIs: a reference ``.pth`` or a converted
checkpoint.

``--weights`` of ``tools/infer.py``, ``export_model.py``,
``parity_check.py``, ``check_layers.py``, ``measure.py`` and
``visualize.py`` names either the released detectron2 ``.pth``
(converted here leaf by leaf, ``convert_torch.py``, then loaded through
``from_jax.py``), or a directory written by ``tools/convert_weights.py``
or by training: ``checkpoint/torch_io.py``'s ``step_N`` directories (the
newest is taken) or one ``step_N`` directory, whose ``model`` state_dict
loads with ``strict=True``. The JAX package's CLIs take a ``.pth`` or a
converted orbax directory in the same place.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

from torch import nn


def convert_pth(cfg, path: str) -> Tuple[Dict[str, Any], Dict[str, List[str]],
                                         int]:
    """A reference ``.pth`` -> (JAX-layout parameter tree, the
    converter's report, the number of torch keys), for the model
    ``cfg`` describes."""
    from ..models.meta import backbone_type
    from .convert_torch import convert_checkpoint, load_torch_checkpoint

    sd = load_torch_checkpoint(path)
    tree, report = convert_checkpoint(
        sd, conv_body=cfg.MODEL.VOVNET.CONV_BODY,
        backbone=backbone_type(cfg), resnet_depth=cfg.MODEL.RESNETS.DEPTH,
        fcos_norm=cfg.MODEL.FCOS.NORM, top_levels=cfg.MODEL.FCOS.TOP_LEVELS,
        num_cls_convs=cfg.MODEL.FCOS.NUM_CLS_CONVS,
        num_box_convs=cfg.MODEL.FCOS.NUM_BOX_CONVS,
        num_share_convs=cfg.MODEL.FCOS.NUM_SHARE_CONVS,
        num_levels=len(cfg.MODEL.FCOS.IN_FEATURES),
        mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
        maskiou_num_conv=cfg.MODEL.ROI_MASKIOU_HEAD.NUM_CONV,
        keypoint_num_conv=len(cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS))
    return tree, report, len(sd)


def load_weights(model: nn.Module, cfg, path: str) -> None:
    """Load ``path`` into ``model``: a converted checkpoint directory
    (``strict=True``), or a reference ``.pth`` (converted, then loaded
    with ``strict=True`` by ``load_jax_params``)."""
    from .from_jax import load_jax_params
    from .torch_io import latest_checkpoint, load_checkpoint

    if os.path.isdir(path):
        state = load_checkpoint(latest_checkpoint(path) or path,
                                map_location=next(model.parameters()).device)
        model.load_state_dict(state["model"], strict=True)
        return
    tree, report, _ = convert_pth(cfg, path)
    if report["unused_torch_keys"]:
        print(f"[warn] {len(report['unused_torch_keys'])} checkpoint keys "
              f"unused, e.g. {report['unused_torch_keys'][:5]}")
    load_jax_params(model, tree)
