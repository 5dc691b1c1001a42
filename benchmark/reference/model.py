"""The plain reference of CenterMask inference: float32 PyTorch with TF32
off, no hand kernels, no captured graphs, no batching.

It is a frozen copy of the plain paths of ``centermask2_tpu_torch``
(VoVNet-eSE and ResNet trunks with FrozenBN, FPN with P6/P7, the FCOS
head and its decode with class-aware greedy NMS, multilevel ROIAlign,
the SAG-Mask head and MaskIoU), rewritten to import nothing of the
program: it reads the configuration as a plain dict, the weights as a
{name: tensor} dict keyed as the program's ``state_dict``, and the image
as the resized uint8 array the benchmark made. It works out again what
the program derives from them: the normalized canvas (the program
normalizes a uint8 space-to-depth pack on the device), the plain stem
(the program folds it into space-to-depth kernels), the level of each
box and the bilinear pooling (kernel 2 in the program), the NMS keep set
(kernel 1).

``precision="fp8"`` computes every convolution and dense layer on
inputs and weights rounded to float8 e4m3 with one scale a tensor
(products and sums in float32): the reference in the nearest precision
below the configuration's bfloat16, the correctness check's control.

Departures from the program, each exact in the program's own terms or
below its rounding: the stem is the plain 3x3 stem; ROIAlign is the
separable form (two 1-D pooling matrices a box); the level of a box uses
a float64 log2; greedy NMS runs over the IoU matrix on the host.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PRECISIONS = ("f32", "fp8")
FP8_MAX = 448.0  # largest finite float8 e4m3 value

# VoVNet bodies with standard convolutions (centermask2 vovnet.py:30-108)
VOVNET_SPECS = {
    "V-19-slim-eSE": ([64, 64, 128], [64, 80, 96, 112], [112, 256, 384, 512],
                      3, [1, 1, 1, 1]),
    "V-19-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024],
                 3, [1, 1, 1, 1]),
    "V-39-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024],
                 5, [1, 1, 2, 2]),
    "V-57-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024],
                 5, [1, 1, 4, 3]),
    "V-99-eSE": ([64, 64, 128], [128, 160, 192, 224], [256, 512, 768, 1024],
                 5, [1, 3, 9, 3]),
}
RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale, back in float32."""
    amax = t.abs().amax().clamp_min(1e-30)
    s = FP8_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).float() / s


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Conv(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, pad=1, groups=1,
                 bias=True, transpose=False):
        super().__init__()
        shape = (cin, cout, k, k) if transpose else (cout, cin // groups, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.pad, self.groups = stride, pad, groups
        self.transpose = transpose
        self.fp8 = False

    def forward(self, x):
        w = self.weight
        if self.fp8:
            x, w = q8(x), q8(w)
        if self.transpose:
            return F.conv_transpose2d(x, w, self.bias, self.stride, self.pad)
        return F.conv2d(x, w, self.bias, self.stride, self.pad, 1,
                        self.groups)


class Dense(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))
        self.fp8 = False

    def forward(self, x):
        w = self.weight
        if self.fp8:
            x, w = q8(x), q8(w)
        return F.linear(x, w, self.bias)


class FrozenBN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.register_buffer("frozen_scale", torch.empty(c))
        self.register_buffer("frozen_bias", torch.empty(c))

    def forward(self, x):
        return x * self.frozen_scale[None, :, None, None] \
            + self.frozen_bias[None, :, None, None]


class GN(nn.Module):
    """GroupNorm(32), eps 1e-5; a group of one value is its bias."""

    def __init__(self, c):
        super().__init__()
        self.gn = nn.GroupNorm(32, c, eps=1e-5)

    def forward(self, x):
        if math.prod(x.shape[1:]) == self.gn.num_groups:
            return self.gn.bias.reshape(1, -1, 1, 1).expand_as(x)
        return self.gn(x)


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, k=3, stride=1, pad=1, act=True):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, pad, bias=False)
        self.norm = FrozenBN(cout)
        self.act = act

    def forward(self, x):
        x = self.norm(self.conv(x))
        return F.relu(x) if self.act else x


class ESE(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc = Conv(c, c, 1, pad=0)

    def forward(self, x):
        gate = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (torch.clamp(gate + 3.0, 0.0, 6.0) / 6.0)


class OSA(nn.Module):
    def __init__(self, cin, stage_ch, concat_ch, layers, identity):
        super().__init__()
        self.n = layers
        ch = cin
        for i in range(layers):
            self.add_module(f"layer{i}", ConvNormAct(ch, stage_ch))
            ch = stage_ch
        self.concat = ConvNormAct(cin + layers * stage_ch, concat_ch, 1,
                                  pad=0)
        self.ese = ESE(concat_ch)
        self.identity = identity

    def forward(self, x):
        outs = [x]
        y = x
        for i in range(self.n):
            y = getattr(self, f"layer{i}")(y)
            outs.append(y)
        y = self.ese(self.concat(torch.cat(outs, dim=1)))
        return y + x if self.identity else y


class VoVNet(nn.Module):
    def __init__(self, body: str):
        super().__init__()
        stem, conv_ch, out_ch, layers, blocks = VOVNET_SPECS[body]
        self.stem_1 = ConvNormAct(3, stem[0], stride=2)
        self.stem_2 = ConvNormAct(stem[0], stem[1])
        self.stem_3 = ConvNormAct(stem[1], stem[2], stride=2)
        self.stages = []
        ch = stem[2]
        for i in range(4):
            names = []
            for b in range(blocks[i]):
                name = f"OSA{i + 2}_{b + 1}"
                self.add_module(name, OSA(ch, conv_ch[i], out_ch[i], layers,
                                          b > 0))
                ch = out_ch[i]
                names.append(name)
            self.stages.append(names)
        self.channels = out_ch[1:]

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem_3(self.stem_2(self.stem_1(x)))
        feats = []
        for i, names in enumerate(self.stages):
            if i > 0:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            for name in names:
                x = getattr(self, name)(x)
            if i > 0:
                feats.append(x)
        return feats  # stage3, stage4, stage5


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, mid, stride, stride_in_1x1):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = ConvNormAct(cin, mid, 1, s1, 0)
        self.conv2 = ConvNormAct(mid, mid, 3, s3, 1)
        self.conv3 = ConvNormAct(mid, cout, 1, 1, 0, act=False)
        self.shortcut = (ConvNormAct(cin, cout, 1, stride, 0, act=False)
                         if cin != cout or stride != 1 else None)

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return F.relu(y + (x if self.shortcut is None else self.shortcut(x)))


class ResNet(nn.Module):
    def __init__(self, depth: int, stride_in_1x1: bool, stem_out: int = 64,
                 res2_out: int = 256, width: int = 64):
        super().__init__()
        self.stem_conv1 = ConvNormAct(3, stem_out, 7, 2, 3)
        self.stages = []
        ch, mid, out = stem_out, width, res2_out
        for i, n in enumerate(RESNET_BLOCKS[depth]):
            names = []
            for b in range(n):
                name = f"res{i + 2}_{b}"
                self.add_module(name, Bottleneck(
                    ch, out, mid, 2 if b == 0 and i > 0 else 1,
                    stride_in_1x1))
                ch = out
                names.append(name)
            self.stages.append(names)
            mid, out = mid * 2, out * 2
        self.channels = [res2_out * 2, res2_out * 4, res2_out * 8]

    def forward(self, x) -> List[torch.Tensor]:
        x = F.max_pool2d(self.stem_conv1(x), 3, 2, 1)
        feats = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i > 0:
                feats.append(x)
        return feats  # res3, res4, res5


class FPN(nn.Module):
    """Laterals and outputs on strides 8, 16, 32, then P6 and P7."""

    def __init__(self, in_channels: Sequence[int], out: int):
        super().__init__()
        for c, st in zip(in_channels, (3, 4, 5)):
            self.add_module(f"fpn_lateral{st}", Conv(c, out, 1, pad=0))
            self.add_module(f"fpn_output{st}", Conv(out, out))
        self.top_block_p6 = Conv(out, out, stride=2)
        self.top_block_p7 = Conv(out, out, stride=2)

    def forward(self, feats) -> List[torch.Tensor]:
        prev = self.fpn_lateral5(feats[2])
        outs = [self.fpn_output5(prev)]
        for idx, st in ((1, 4), (0, 3)):
            lat = getattr(self, f"fpn_lateral{st}")(feats[idx])
            up = F.interpolate(prev, scale_factor=2.0, mode="nearest")
            prev = lat + up[:, :, :lat.shape[2], :lat.shape[3]]
            outs.insert(0, getattr(self, f"fpn_output{st}")(prev))
        p6 = self.top_block_p6(outs[-1])
        return outs + [p6, self.top_block_p7(F.relu(p6))]  # p3..p7


class Tower(nn.Module):
    def __init__(self, n, c):
        super().__init__()
        self.n = n
        for i in range(n):
            self.add_module(f"conv{i}", Conv(c, c))
            self.add_module(f"norm{i}", GN(c))

    def forward(self, x):
        for i in range(self.n):
            x = F.relu(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x)))
        return x


class FCOSHead(nn.Module):
    def __init__(self, classes, c, n_cls, n_box, levels):
        super().__init__()
        self.cls_tower = Tower(n_cls, c)
        self.bbox_tower = Tower(n_box, c)
        self.cls_logits = Conv(c, classes)
        self.bbox_pred = Conv(c, 4)
        self.ctrness = Conv(c, 1)
        self.levels = levels
        for lvl in range(levels):
            self.add_module(f"scale{lvl}", _Scale())

    def forward(self, feats):
        out = []
        for lvl, f in enumerate(feats):
            cf, bf = self.cls_tower(f), self.bbox_tower(f)
            reg = getattr(self, f"scale{lvl}")(self.bbox_pred(bf))
            out.append((self.cls_logits(cf), F.relu(reg), self.ctrness(bf)))
        return out


class _Scale(nn.Module):
    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(1))

    def forward(self, x):
        return x * self.scale


class MaskHead(nn.Module):
    def __init__(self, c, classes, dims, n):
        super().__init__()
        self.n = n
        ch = c
        for k in range(n):
            self.add_module(f"mask_fcn{k + 1}", Conv(ch, dims))
            ch = dims
        self.spatialAtt = nn.Module()
        self.spatialAtt.conv = Conv(2, 1, bias=False)
        self.deconv = Conv(dims, dims, 2, 2, 0, transpose=True)
        self.predictor = Conv(dims, classes, 1, pad=0)

    def forward(self, x):
        for k in range(self.n):
            x = F.relu(getattr(self, f"mask_fcn{k + 1}")(x))
        att = self.spatialAtt.conv(torch.cat(
            [x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], 1))
        x = x * torch.sigmoid(att)
        return self.predictor(F.relu(self.deconv(x)))


class MaskIoUHead(nn.Module):
    def __init__(self, c, classes, dims, n, resolution):
        super().__init__()
        self.n = n
        ch = c + 1
        for k in range(n):
            self.add_module(f"maskiou_fcn{k + 1}",
                            Conv(ch, dims, stride=2 if k + 1 == n else 1))
            ch = dims
        side = resolution // 2
        self.maskiou_fc1 = Dense(dims * side * side, 1024)
        self.maskiou_fc2 = Dense(1024, 1024)
        self.maskiou = Dense(1024, classes)

    def forward(self, x, mask):
        x = torch.cat([x, F.max_pool2d(mask, 2, 2)], dim=1)
        for k in range(self.n):
            x = F.relu(getattr(self, f"maskiou_fcn{k + 1}")(x))
        x = F.relu(self.maskiou_fc1(x.reshape(x.shape[0], -1)))
        return self.maskiou(F.relu(self.maskiou_fc2(x)))


class Dense_(NamedTuple):
    """The head's outputs over every location, levels concatenated."""

    feats: List[torch.Tensor]  # p3, p4, p5 for the ROI heads
    locations: torch.Tensor  # (L, 2) x, y
    strides: torch.Tensor  # (L,)
    level_starts: List[int]
    level_shapes: List[tuple]
    masked: torch.Tensor  # (L, C) sigmoid(cls) * sigmoid(ctr), -1 below
    boxes: torch.Tensor  # (L, 4) xyxy


class Reference(nn.Module):
    """CenterMask inference from a configuration dict (the program's
    whole configuration, as the benchmark's configuration file holds
    it)."""

    def __init__(self, cfg: Dict, precision: str = "f32"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
        m = cfg["MODEL"]
        fcos, tpu = m["FCOS"], cfg["TPU"]
        self._refuse(cfg)
        name = m["BACKBONE"]["NAME"]
        if "resnet" in name:
            r = m["RESNETS"]
            trunk = ResNet(r["DEPTH"], r["STRIDE_IN_1X1"],
                           r["STEM_OUT_CHANNELS"], r["RES2_OUT_CHANNELS"],
                           r["NUM_GROUPS"] * r["WIDTH_PER_GROUP"])
        else:
            trunk = VoVNet(m["VOVNET"]["CONV_BODY"])
        self.backbone = trunk
        c = m["FPN"]["OUT_CHANNELS"]
        self.fpn = FPN(trunk.channels, c)
        self.classes = fcos["NUM_CLASSES"]
        self.fcos_head = FCOSHead(self.classes, c, fcos["NUM_CLS_CONVS"],
                                  fcos["NUM_BOX_CONVS"], 5)
        mh, mi = m["ROI_MASK_HEAD"], m["ROI_MASKIOU_HEAD"]
        self.roi_heads = nn.Module()
        self.roi_heads.mask_head = MaskHead(c, self.classes, mh["CONV_DIM"],
                                            mh["NUM_CONV"])
        self.roi_heads.maskiou_head = MaskIoUHead(
            c, self.classes, mi["CONV_DIM"], mi["NUM_CONV"],
            mh["POOLER_RESOLUTION"])
        self.strides = list(fcos["FPN_STRIDES"])
        self.thresh = fcos["INFERENCE_TH_TEST"]
        self.nms_thresh = fcos["NMS_TH"]
        self.candidates_k = min(tpu["NMS_CANDIDATES"],
                               fcos["PRE_NMS_TOPK_TEST"])
        self.topk = min(fcos["POST_NMS_TOPK_TEST"],
                        cfg["TEST"]["DETECTIONS_PER_IMAGE"])
        self.resolution = mh["POOLER_RESOLUTION"]
        self.sampling = tpu["POOLER_SAMPLING_RATIO"]
        self.mean = torch.tensor(m["PIXEL_MEAN"], dtype=torch.float32)
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.fp8 = precision == "fp8"

    @staticmethod
    def _refuse(cfg: Dict) -> None:
        """The options this reference leaves out, refused."""
        m, fcos = cfg["MODEL"], cfg["MODEL"]["FCOS"]
        wanted = {
            "MODEL.MASK_ON": (m["MASK_ON"], True),
            "MODEL.MASKIOU_ON": (m["MASKIOU_ON"], True),
            "MODEL.KEYPOINT_ON": (m["KEYPOINT_ON"], False),
            "MODEL.FPN.NORM": (m["FPN"]["NORM"], ""),
            "MODEL.FPN.FUSE_TYPE": (m["FPN"]["FUSE_TYPE"], "sum"),
            "MODEL.FCOS.TOP_LEVELS": (fcos["TOP_LEVELS"], 2),
            "MODEL.FCOS.NORM": (fcos["NORM"], "GN"),
            "MODEL.FCOS.NUM_SHARE_CONVS": (fcos["NUM_SHARE_CONVS"], 0),
            "MODEL.FCOS.USE_SCALE": (fcos["USE_SCALE"], True),
            "MODEL.FCOS.USE_DEFORMABLE": (fcos["USE_DEFORMABLE"], False),
            "MODEL.FCOS.THRESH_WITH_CTR": (fcos["THRESH_WITH_CTR"], False),
            "MODEL.ROI_MASK_HEAD.NORM": (m["ROI_MASK_HEAD"]["NORM"], ""),
            "MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK": (
                m["ROI_MASK_HEAD"]["CLS_AGNOSTIC_MASK"], False),
            "MODEL.ROI_MASK_HEAD.ASSIGN_CRITERION": (
                m["ROI_MASK_HEAD"]["ASSIGN_CRITERION"], "ratio"),
            "MODEL.VOVNET.NORM": (m["VOVNET"]["NORM"], "FrozenBN"),
            "MODEL.RESNETS.NORM": (m["RESNETS"]["NORM"], "FrozenBN"),
        }
        for key, (have, want) in wanted.items():
            if (have or "") != (want or "") if isinstance(want, str) \
                    else have != want:
                raise NotImplementedError(f"{key} {have!r}: the reference "
                                          f"covers {want!r} only")
        if fcos["PRE_NMS_TOPK_TEST"] < cfg["TPU"]["NMS_CANDIDATES"]:
            raise NotImplementedError("the per-level decode (NMS_CANDIDATES "
                                      "above PRE_NMS_TOPK_TEST)")
        if list(m["ROI_HEADS"]["IN_FEATURES"]) != ["p3", "p4", "p5"]:
            raise NotImplementedError("ROI features other than p3-p5")

    def load(self, weights: Dict[str, torch.Tensor]) -> "Reference":
        self.load_state_dict({k: v.float() for k, v in weights.items()},
                             strict=True)
        return self

    # ---- the image -----------------------------------------------------
    def canvas(self, image_u8: torch.Tensor, hw) -> torch.Tensor:
        """(1, 3, H, W) normalized canvas: BGR minus the mean over the
        image, zero elsewhere."""
        h, w = image_u8.shape[:2]
        x = torch.zeros((1, 3, hw[0], hw[1]), device=image_u8.device)
        x[0, :, :h, :w] = (image_u8.float()
                           - self.mean.to(image_u8.device)).permute(2, 0, 1)
        return x

    def dense(self, image_u8: torch.Tensor, hw) -> Dense_:
        p = self.fpn(self.backbone(self.canvas(image_u8, hw)))
        locs, strides, starts, shapes, masked, boxes = [], [], [], [], [], []
        n = 0
        for (logit, reg, ctr), st, f in zip(self.fcos_head(p), self.strides,
                                            p):
            _, C, H, W = logit.shape
            dev = logit.device
            xs = (torch.arange(W, device=dev) * st + st // 2).float()
            ys = (torch.arange(H, device=dev) * st + st // 2).float()
            loc = torch.stack([xs[None, :].expand(H, W).reshape(-1),
                               ys[:, None].expand(H, W).reshape(-1)], 1)
            cls = torch.sigmoid(logit[0].permute(1, 2, 0).reshape(-1, C))
            cen = torch.sigmoid(ctr[0].reshape(-1))
            s = torch.where(cls > self.thresh, cls * cen[:, None],
                            torch.full_like(cls, -1.0))
            r = reg[0].permute(1, 2, 0).reshape(-1, 4) * st
            boxes.append(torch.cat([loc - r[:, :2], loc + r[:, 2:]], 1))
            locs.append(loc)
            masked.append(s)
            strides.append(torch.full((H * W,), float(st), device=dev))
            starts.append(n)
            shapes.append((H, W))
            n += H * W
        return Dense_(p[:3], torch.cat(locs), torch.cat(strides), starts,
                      shapes, torch.cat(masked), torch.cat(boxes))

    def index_of(self, d: Dense_, xy: np.ndarray) -> np.ndarray:
        """The flat location index of each (x, y) on the grid; -1 off it.
        Grid points of different levels never coincide."""
        out = np.full(len(xy), -1, np.int64)
        for i, (x, y) in enumerate(np.rint(xy).astype(np.int64)):
            for start, (H, W), st in zip(d.level_starts, d.level_shapes,
                                         self.strides):
                if (x - st // 2) % st or (y - st // 2) % st:
                    continue
                col, row = (x - st // 2) // st, (y - st // 2) // st
                if 0 <= col < W and 0 <= row < H:
                    out[i] = start + row * W + col
        return out

    # ---- decode ----------------------------------------------------------
    def candidates(self, d: Dense_) -> Dict[str, torch.Tensor]:
        """The two-stage top-k of (location, class) pairs by
        sigmoid(cls) sigmoid(ctr), equal values lowest index first:
        ``loc``, ``cls``, ``scores`` (the square root), ``valid`` (above
        the threshold), in descending order."""
        L, C = d.masked.shape
        K = min(self.candidates_k, L * C)
        best = d.masked.amax(dim=1)
        top_locs = torch.sort(best, descending=True, stable=True
                              ).indices[:min(K, L)]
        rows = d.masked[top_locs]
        vals, flat = torch.sort(rows.reshape(-1), descending=True,
                                stable=True)
        vals, flat = vals[:K], flat[:K]
        valid = vals > 0.0
        return {"loc": top_locs[flat // C], "cls": flat % C,
                "scores": torch.where(valid, torch.sqrt(vals.clamp_min(0.0)),
                                      torch.zeros_like(vals)),
                "valid": valid}

    def decode(self, d: Dense_) -> Dict[str, torch.Tensor]:
        """The candidates, the class-aware greedy NMS and the post-NMS
        top-k."""
        c = self.candidates(d)
        loc, cls, scores = c["loc"], c["cls"], c["scores"]
        keep = self.nms(d.boxes[loc], scores, cls, c["valid"])
        kept = torch.where(keep, scores, torch.full_like(scores, -math.inf))
        top, idx = torch.sort(kept, descending=True, stable=True)
        top, idx = top[:self.topk], idx[:self.topk]
        ok = top > -math.inf
        return {"scores": torch.where(ok, scores[idx], 0.0),
                "pred_classes": cls[idx], "pred_boxes": torch.where(
                    ok[:, None], d.boxes[loc[idx]], 0.0),
                "locations": d.locations[loc[idx]], "valid": ok,
                "index": loc[idx]}

    def nms(self, boxes, scores, classes, valid) -> torch.Tensor:
        """Greedy class-aware NMS: boxes offset by class, visited by
        descending score (stable), each kept unless an earlier kept box
        overlaps it above the threshold."""
        max_coord = torch.where(valid[:, None], boxes, 0.0).amax()
        b = (boxes + (classes.float() * (max_coord + 1.0))[:, None]).double()
        order = torch.sort(torch.where(valid, scores, -math.inf),
                           descending=True, stable=True).indices
        b = b[order]
        lt = torch.maximum(b[:, None, :2], b[None, :, :2])
        rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
        inter = (rb - lt).clamp_min(0.0).prod(-1)
        area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
        union = area[:, None] + area[None, :] - inter
        iou = torch.where(union > 0, inter / torch.where(union > 0, union,
                                                         1.0), 0.0)
        over = (iou > self.nms_thresh).cpu().numpy()
        alive = valid[order].cpu().numpy().copy()
        keep = np.zeros_like(alive)
        for i in range(len(alive)):
            if alive[i]:
                keep[i] = True
                alive[i + 1:] &= ~over[i, i + 1:]
        out = torch.zeros_like(valid)
        out[order] = torch.from_numpy(keep).to(valid.device)
        return out

    # ---- the ROI heads ---------------------------------------------------
    def roi_align(self, feats, boxes, img_area: float) -> torch.Tensor:
        """(R, C, o, o): aligned bilinear ROIAlign on the level of each
        box (CenterMask's ratio rule), separable per box."""
        o, s = self.resolution, self.sampling
        areas = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
                 ).double().clamp_min(1e-12)
        lv = torch.ceil(5 - torch.log2(img_area / areas
                                       + np.finfo(np.float64).eps))
        lv = (lv.clamp(3, 5) - 3).long().tolist()
        out = []
        grid = (torch.arange(o * s, device=boxes.device) + 0.5) / s
        for r, level in enumerate(lv):
            f = feats[level][0]
            sc = 1.0 / self.strides[level]
            x0, y0, x1, y1 = (boxes[r] * sc - 0.5).tolist()
            ys = y0 + grid * ((y1 - y0) / o)
            xs = x0 + grid * ((x1 - x0) / o)
            ay = _pool_matrix(ys, f.shape[1], o, s)
            ax = _pool_matrix(xs, f.shape[2], o, s)
            out.append(torch.einsum("ih,chw,jw->cij", ay, f, ax))
        return torch.stack(out)

    def roi_outputs(self, d: Dense_, boxes, classes, img_area: float):
        """(mask logits (R, 2o, 2o) of each box's class, MaskIoU outputs
        (R, classes)) for the given boxes and classes."""
        pooled = self.roi_align(d.feats, boxes, img_area)
        rows = torch.arange(len(classes), device=boxes.device)
        logits = self.roi_heads.mask_head(pooled)[rows, classes.long()]
        iou = self.roi_heads.maskiou_head(pooled,
                                          torch.sigmoid(logits)[:, None])
        return logits, iou

    def masks(self, d: Dense_, boxes, classes, scores, valid,
              img_area: float):
        """(masks (R, 2o, 2o) probabilities, mask scores (R,)) for the
        given boxes, classes and scores."""
        logits, iou = self.roi_outputs(d, boxes, classes, img_area)
        ms = scores * iou[torch.arange(len(classes)), classes.long()]
        return torch.sigmoid(logits), torch.where(valid, ms, 0.0)

    @torch.no_grad()
    def serve(self, image_u8: torch.Tensor, hw) -> Dict[str, torch.Tensor]:
        """The program's seven outputs for one image at canvas ``hw``."""
        d = self.dense(image_u8, hw)
        out = self.decode(d)
        probs, ms = self.masks(d, out["pred_boxes"], out["pred_classes"],
                               out["scores"], out["valid"],
                               float(hw[0] * hw[1]))
        out["pred_masks"] = probs
        out["mask_scores"] = ms
        out.pop("index")
        return out


def _pool_matrix(coords: torch.Tensor, size: int, o: int, s: int
                 ) -> torch.Tensor:
    """(o, size): bilinear taps of each sample (zero outside [-1, size],
    clamped to [0, size - 1]) averaged over the s samples of a bin."""
    inr = (coords >= -1.0) & (coords <= size)
    c = coords.clamp(0.0, size - 1.0)
    low = torch.floor(c)
    frac = c - low
    high = (low + 1).clamp_max(size - 1.0)
    j = torch.arange(size, device=coords.device, dtype=coords.dtype)
    w = (1.0 - frac)[:, None] * (j == low[:, None]) \
        + frac[:, None] * (j == high[:, None])
    w = w * inr[:, None]
    return w.reshape(o, s, size).mean(dim=1)
