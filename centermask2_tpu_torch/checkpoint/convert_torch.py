"""Reference ``.pth`` -> JAX-named parameter tree (the port's own copy of
``centermask2_tpu/checkpoint/convert_torch.py``).

Maps the reference checkpoint key schema (detectron2 GeneralizedRCNN with
VoVNet, ResNet or MobileNetV2/FPN/FCOS/CenterROIHeads submodules; names
from reference vovnet.py:110-236, mobilenet.py:22-116, detectron2's
resnet.py, fcos.py:185-220, sam.py:56-97, maskiou_head.py:76-105)
onto the JAX package's parameter tree of numpy arrays, which
``checkpoint/from_jax.py::load_jax_params`` then loads into the port:

    sd = load_torch_checkpoint("centermask2-V-39-eSE-FPN-ms-3x.pth")
    tree, report = convert_checkpoint(sd, conv_body="V-39-eSE")
    load_jax_params(model, tree)

(``backbone="resnet"`` with ``resnet_depth``, or ``backbone="mobilenet"``,
for the other families.)

Weight transforms:
- conv     (O, I, kh, kw)  -> (kh, kw, I, O)
- deconv   (I, O, kh, kw)  -> (kh, kw, O, I)
- linear   (O, I)          -> (I, O)
- FrozenBN (w, b, mean, var) -> frozen_scale = w/sqrt(var+eps),
                                frozen_bias  = b - mean*frozen_scale
- maskiou_fc1: torch flattens (C, 7, 7) C-major, the JAX tree (7, 7, C);
  the weight columns are permuted accordingly.

Missing and unused keys are reported, not fatal (the check_keys contract
of deploy_utils.py:31-43). The keypoint head's convs and deconv are
converted (``convert_keypoint_head``). As in the JAX converter, FPN norms
and the deformable convs' offsets are not converted.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ..models.backbones.mobilenet import INVERTED_RESIDUAL_SETTING
from ..models.backbones.resnet import RESNET_STAGE_BLOCKS
from ..models.backbones.vovnet import STAGE_SPECS

BN_EPS = 1e-5


def _conv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _deconv(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def fold_frozen_bn(weight, bias, mean, var, eps: float = BN_EPS):
    scale = weight / np.sqrt(var + eps)
    return scale.astype(np.float32), (bias - mean * scale).astype(np.float32)


class Converter:
    """Accumulates (tree path -> array) assignments from torch keys."""

    def __init__(self, state_dict: Dict[str, np.ndarray]):
        self.sd = {k: np.asarray(v) for k, v in state_dict.items()}
        self.used: set = set()
        self.out: Dict[Tuple[str, ...], np.ndarray] = {}
        # every attempted (torch_key, tree_path, kind) mapping, present or not
        self.mapping: List[Tuple[str, str, str]] = []

    def has(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def put(self, path: str, value: np.ndarray) -> None:
        self.out[tuple(path.split("/"))] = value.astype(np.float32)

    # -- composite helpers --------------------------------------------------
    def conv(self, tkey: str, fpath: str, bias: bool = True) -> bool:
        self.mapping.append((tkey, fpath, "conv" + ("_bias" if bias else "")))
        if not self.has(tkey + ".weight"):
            return False
        self.put(fpath + "/kernel", _conv(self.take(tkey + ".weight")))
        if bias and self.has(tkey + ".bias"):
            self.put(fpath + "/bias", self.take(tkey + ".bias"))
        return True

    def frozen_bn(self, tkey: str, fpath: str) -> bool:
        self.mapping.append((tkey, fpath, "bn"))
        if not self.has(tkey + ".weight"):
            return False
        scale, shift = fold_frozen_bn(
            self.take(tkey + ".weight"), self.take(tkey + ".bias"),
            self.take(tkey + ".running_mean"), self.take(tkey + ".running_var"))
        self.put(fpath + "/frozen_scale", scale)
        self.put(fpath + "/frozen_bias", shift)
        return True

    def group_norm(self, tkey: str, fpath: str) -> bool:
        self.mapping.append((tkey, fpath, "gn"))
        if not self.has(tkey + ".weight"):
            return False
        self.put(fpath + "/gn/scale", self.take(tkey + ".weight"))
        self.put(fpath + "/gn/bias", self.take(tkey + ".bias"))
        return True

    def linear(self, tkey: str, fpath: str) -> bool:
        self.mapping.append((tkey, fpath, "linear"))
        if not self.has(tkey + ".weight"):
            return False
        self.put(fpath + "/kernel", _linear(self.take(tkey + ".weight")))
        if self.has(tkey + ".bias"):
            self.put(fpath + "/bias", self.take(tkey + ".bias"))
        return True

    def deconv(self, tkey: str, fpath_kernel: str, fpath_bias: str) -> bool:
        self.mapping.append((tkey, fpath_kernel, "deconv"))
        if not self.has(tkey + ".weight"):
            return False
        self.put(fpath_kernel, _deconv(self.take(tkey + ".weight")))
        if self.has(tkey + ".bias"):
            self.put(fpath_bias, self.take(tkey + ".bias"))
        return True

    def nest(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {}
        for path, v in self.out.items():
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = v
        return tree

    def report(self) -> Dict[str, Any]:
        unused = sorted(set(self.sd.keys()) - self.used)
        return {"unused_torch_keys": unused, "mapping": list(self.mapping)}


def _strip_prefixes(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Normalize checkpoint prefixes: 'model.' wrapper, 'module.' DDP."""
    out = {}
    for k, v in sd.items():
        for pre in ("model.", "module."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def convert_vovnet(cv: Converter, tpre: str, fpre: str, spec: Dict) -> None:
    """tpre e.g. 'backbone.bottom_up.', fpre e.g. 'backbone/'."""
    depthwise = spec["dw"]

    def conv_norm(tname: str, fname: str):
        cv.conv(f"{tpre}{tname}/conv", f"{fpre}{fname}/conv", bias=False)
        cv.frozen_bn(f"{tpre}{tname}/norm", f"{fpre}{fname}/norm")

    def dw_block(tname: str, fname: str):
        cv.conv(f"{tpre}{tname}/dw_conv3x3", f"{fpre}{fname}/dw_conv",
                bias=False)
        cv.conv(f"{tpre}{tname}/pw_conv1x1", f"{fpre}{fname}/pw_conv",
                bias=False)
        cv.frozen_bn(f"{tpre}{tname}/pw_norm", f"{fpre}{fname}/pw_norm")

    # stem (vovnet.py:432-436); stem_1 is a standard conv in every body
    conv_norm("stem.stem_1", "stem_1")
    for i in (2, 3):
        (dw_block if depthwise else conv_norm)(f"stem.stem_{i}", f"stem_{i}")
    for i in range(4):
        stage = i + 2
        for b in range(spec["block_per_stage"][i]):
            mod = f"OSA{stage}_{b + 1}"
            tmod = f"stage{stage}.{mod}"
            if depthwise:
                # the reduction exists when in_ch != stage_ch (first block)
                conv_norm(f"{tmod}.conv_reduction.{mod}_reduction_0",
                          f"{mod}/reduction")
            for l in range(spec["layer_per_block"]):
                (dw_block if depthwise else conv_norm)(
                    f"{tmod}.layers.{l}.{mod}_{l}", f"{mod}/layer{l}")
            conv_norm(f"{tmod}.concat.{mod}_concat", f"{mod}/concat")
            cv.conv(f"{tpre}{tmod}.ese.fc", f"{fpre}{mod}/ese/fc")


def convert_resnet(cv: Converter, tpre: str, fpre: str,
                   depth: int = 50) -> None:
    """detectron2 ResNet keys (stem.conv1, res{s}.{b}.conv{1..3}[.norm],
    res{s}.{b}.shortcut) -> the JAX tree (stem_conv1, res{s}_{b}/conv{c},
    shortcut)."""
    def conv_norm(tname: str, fname: str):
        cv.conv(f"{tpre}{tname}", f"{fpre}{fname}/conv", bias=False)
        cv.frozen_bn(f"{tpre}{tname}.norm", f"{fpre}{fname}/norm")

    conv_norm("stem.conv1", "stem_conv1")
    for i, n_blocks in enumerate(RESNET_STAGE_BLOCKS[depth]):
        stage = i + 2
        for b in range(n_blocks):
            for c in (1, 2, 3):
                conv_norm(f"res{stage}.{b}.conv{c}", f"res{stage}_{b}/conv{c}")
            if b == 0:
                conv_norm(f"res{stage}.{b}.shortcut",
                          f"res{stage}_{b}/shortcut")


def convert_mobilenet(cv: Converter, tpre: str, fpre: str) -> None:
    """Reference MobileNetV2 keys (mobilenet.py:22-116: features.0 =
    Sequential(Conv2d, FrozenBN); features.{1..17}.conv = Sequential of
    pw/dw/pw-linear convs each followed by FrozenBN, the pw omitted when
    expand_ratio == 1) -> the JAX tree (features0_conv/bn stem,
    features{i}/conv{j}/bn{j} blocks)."""
    cv.conv(f"{tpre}features.0.0", f"{fpre}features0_conv", bias=False)
    cv.frozen_bn(f"{tpre}features.0.1", f"{fpre}features0_bn")
    idx = 0
    for t, c, n, s in INVERTED_RESIDUAL_SETTING:
        for _ in range(n):
            idx += 1
            # torch Sequential indices of the convs (a FrozenBN after each)
            seq = (0, 3, 6) if t != 1 else (0, 3)
            for j, sq in enumerate(seq):
                cv.conv(f"{tpre}features.{idx}.conv.{sq}",
                        f"{fpre}features{idx}/conv{j}", bias=False)
                cv.frozen_bn(f"{tpre}features.{idx}.conv.{sq + 1}",
                             f"{fpre}features{idx}/bn{j}")


def convert_fpn(cv: Converter, tpre: str, fpre: str, stages=(3, 4, 5),
                top_levels: int = 2) -> None:
    for s in stages:
        cv.conv(f"{tpre}fpn_lateral{s}", f"{fpre}fpn_lateral{s}")
        cv.conv(f"{tpre}fpn_output{s}", f"{fpre}fpn_output{s}")
    if top_levels >= 1:
        cv.conv(f"{tpre}top_block.p6", f"{fpre}top_block_p6")
    if top_levels >= 2:
        cv.conv(f"{tpre}top_block.p7", f"{fpre}top_block_p7")


def convert_fcos_head(cv: Converter, tpre: str, fpre: str,
                      num_convs: Dict[str, int], num_levels: int = 5,
                      norm: str = "GN") -> None:
    """tpre e.g. 'proposal_generator.fcos_head.'. Torch towers are
    Sequential with conv at stride-3 indices (conv, GN, relu)."""
    step = 3 if norm == "GN" else 2
    for tower, n in num_convs.items():
        for i in range(n):
            cv.conv(f"{tpre}{tower}.{i * step}", f"{fpre}{tower}/conv{i}")
            if norm == "GN":
                cv.group_norm(f"{tpre}{tower}.{i * step + 1}",
                              f"{fpre}{tower}/norm{i}")
    cv.conv(f"{tpre}cls_logits", f"{fpre}cls_logits")
    cv.conv(f"{tpre}bbox_pred", f"{fpre}bbox_pred")
    cv.conv(f"{tpre}ctrness", f"{fpre}ctrness")
    for l in range(num_levels):
        cv.mapping.append((f"{tpre}scales.{l}", f"{fpre}scale{l}", "scalar"))
        if cv.has(f"{tpre}scales.{l}.scale"):
            cv.put(f"{fpre}scale{l}/scale", cv.take(f"{tpre}scales.{l}.scale"))


def convert_mask_head(cv: Converter, tpre: str, fpre: str,
                      num_conv: int = 4) -> None:
    for k in range(1, num_conv + 1):
        cv.conv(f"{tpre}mask_fcn{k}", f"{fpre}mask_fcn{k}")
    cv.conv(f"{tpre}spatialAtt.conv", f"{fpre}spatialAtt/conv", bias=False)
    cv.deconv(f"{tpre}deconv", f"{fpre}deconv/kernel", f"{fpre}deconv/bias")
    cv.conv(f"{tpre}predictor", f"{fpre}predictor")


def convert_maskiou_head(cv: Converter, tpre: str, fpre: str,
                         num_conv: int = 4, conv_dims: int = 256,
                         resolution: int = 7) -> None:
    for k in range(1, num_conv + 1):
        cv.conv(f"{tpre}maskiou_fcn{k}", f"{fpre}maskiou_fcn{k}")
    # fc1: permute columns from (C, H, W) to (H, W, C) flatten order
    cv.mapping.append((f"{tpre}maskiou_fc1", f"{fpre}maskiou_fc1", "linear_chw"))
    if cv.has(f"{tpre}maskiou_fc1.weight"):
        w = cv.take(f"{tpre}maskiou_fc1.weight")  # (1024, C*H*W)
        w = w.reshape(w.shape[0], conv_dims, resolution, resolution)
        w = np.transpose(w, (0, 2, 3, 1)).reshape(w.shape[0], -1)
        cv.put(f"{fpre}maskiou_fc1/kernel", _linear(w))
        cv.put(f"{fpre}maskiou_fc1/bias", cv.take(f"{tpre}maskiou_fc1.bias"))
    cv.linear(f"{tpre}maskiou_fc2", f"{fpre}maskiou_fc2")
    cv.linear(f"{tpre}maskiou", f"{fpre}maskiou")


def convert_keypoint_head(cv: Converter, tpre: str, fpre: str,
                          num_conv: int = 8) -> None:
    """The KRCNN head: conv_fcn{1..num_conv} and the score_lowres deconv
    (its (I, O, kh, kw) weight as the JAX (kh, kw, O, I) kernel)."""
    for k in range(1, num_conv + 1):
        cv.conv(f"{tpre}conv_fcn{k}", f"{fpre}conv_fcn{k}")
    cv.deconv(f"{tpre}score_lowres", f"{fpre}score_lowres_kernel",
              f"{fpre}score_lowres_bias")


def convert_checkpoint(
    state_dict: Dict[str, np.ndarray],
    conv_body: str = "V-39-eSE",
    fcos_norm: str = "GN",
    num_cls_convs: int = 4,
    num_box_convs: int = 4,
    num_share_convs: int = 0,
    num_levels: int = 5,
    mask_num_conv: int = 4,
    maskiou_num_conv: int = 4,
    keypoint_num_conv: int = 8,
    fpn_stages=(3, 4, 5),
    top_levels: int = 2,
    backbone: str = "vovnet",
    resnet_depth: int = 50,
) -> Tuple[Dict[str, Any], Dict[str, List[str]]]:
    """Full-model conversion. Returns (params_tree, report).
    ``backbone``: "vovnet" (the body ``conv_body``), "resnet" (of
    ``resnet_depth``) or "mobilenet"."""
    sd = _strip_prefixes(state_dict)
    cv = Converter(sd)

    # backbone-only checkpoints (vovnet39_ese_detectron2.pth) have bare keys
    bpre = "backbone.bottom_up." if any(
        k.startswith("backbone.bottom_up.") for k in sd) else ""
    if backbone == "resnet":
        convert_resnet(cv, bpre, "backbone/", resnet_depth)
    elif backbone == "mobilenet":
        convert_mobilenet(cv, bpre, "backbone/")
    else:
        convert_vovnet(cv, bpre, "backbone/", STAGE_SPECS[conv_body])
    convert_fpn(cv, "backbone.", "fpn/", fpn_stages, top_levels)
    convert_fcos_head(
        cv, "proposal_generator.fcos_head.", "fcos_head/",
        {"cls_tower": num_cls_convs, "bbox_tower": num_box_convs,
         "share_tower": num_share_convs},
        num_levels, fcos_norm)
    convert_mask_head(cv, "roi_heads.mask_head.", "roi_heads/mask_head/",
                      mask_num_conv)
    convert_maskiou_head(cv, "roi_heads.maskiou_head.",
                         "roi_heads/maskiou_head/", maskiou_num_conv)
    convert_keypoint_head(cv, "roi_heads.keypoint_head.",
                          "roi_heads/keypoint_head/", keypoint_num_conv)
    return cv.nest(), cv.report()


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth (optionally {'model': ...} wrapped) into numpy arrays.
    Unpickles the file (``weights_only=False``, as detectron2 checkpoints
    need): load only checkpoints from a trusted source."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in ckpt.items()}


def merge_params(init_params: Dict[str, Any], converted: Dict[str, Any],
                 path: str = "") -> Tuple[Dict[str, Any], List[str]]:
    """Overlay converted arrays onto an init tree (shape-checked); returns
    (merged, missing_paths), the check_keys analog."""
    missing: List[str] = []

    def rec(init_node, conv_node, p):
        out = {}
        for k, v in init_node.items():
            cp = f"{p}/{k}" if p else k
            if isinstance(v, dict):
                out[k] = rec(v, conv_node.get(k, {}) if conv_node else {}, cp)
            else:
                cv_val = conv_node.get(k) if conv_node else None
                if cv_val is None:
                    missing.append(cp)
                    out[k] = v
                else:
                    if tuple(np.shape(cv_val)) != tuple(np.shape(v)):
                        raise ValueError(
                            f"shape mismatch at {cp}: ckpt {np.shape(cv_val)}"
                            f" vs model {np.shape(v)}")
                    out[k] = np.asarray(cv_val, dtype=np.float32)
        return out

    merged = rec(init_params, converted, path)
    return merged, missing
