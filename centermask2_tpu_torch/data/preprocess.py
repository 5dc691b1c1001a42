"""Host-side preprocessing (the port's own copy of
``centermask2_tpu/data/preprocess.py``), bit-compatible with the
reference pipeline (reference: deploy_utils.py:19-21, 60-98):

- ResizeShortestEdge(800, max 1333) with PIL bilinear on the BGR uint8
  image (detectron2 ResizeTransform semantics),
- BGR mean subtraction [103.53, 116.28, 123.675], std 1,
- zero-pad bottom/right to the deployment canvas (1344x1344),
- for the s2d serving layout: the factor-4 space-to-depth pack of the
  RAW uint8 image over the quantized tight canvas, normalized on the
  device (``CenterMask._normalize_u8_s2d``).

The s2d passes (``s2d_preprocess``, ``s2d_pack_u8``, ``s2d_pack_u8_tight``)
run the fused normalize, pad and factor-4 space-to-depth of
``native/s2d.cpp`` in one pass: built with ``g++`` at first use into
``centermask2_tpu_torch/_build/`` (``utils/native.py``; a failed build
raises) and bit-equal to their plain numpy versions
(``s2d_preprocess_plain``, ``s2d_pack_u8_plain``), which the tests hold
it against. PIL is imported by the two functions that read or resize an
image, so a caller that feeds arrays needs no PIL.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from ..utils import tracing
from ..utils.native import BUILD_ROOT, load_library

MIN_EDGE_SIZE = 800
MAX_EDGE_SIZE = 1333
FIXED_EDGE_SIZE = 1344

PIXEL_MEAN = np.array([103.53, 116.28, 123.675], np.float32)  # BGR
PIXEL_STD = np.array([1.0, 1.0, 1.0], np.float32)

_S2D_SRC = Path(__file__).resolve().parent / "native" / "s2d.cpp"
_S2D_BUILD_ROOT = BUILD_ROOT
_S2D_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
              "-std=c++17")


def compute_resize_shape(
    h: int, w: int, short: int = MIN_EDGE_SIZE, max_size: int = MAX_EDGE_SIZE
) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge.get_output_shape: returns (newh, neww)."""
    scale = short * 1.0 / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        scale = max_size * 1.0 / max(newh, neww)
        newh = newh * scale
        neww = neww * scale
    return int(newh + 0.5), int(neww + 0.5)


def read_image_bgr(path: str) -> np.ndarray:
    """Read an image as HWC uint8 BGR (detectron2 read_image(format='BGR'))."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        arr = np.asarray(img)
    return arr[:, :, ::-1].copy()


def resize_shortest_edge(
    img: np.ndarray, short: int = MIN_EDGE_SIZE, max_size: int = MAX_EDGE_SIZE
) -> np.ndarray:
    """PIL-bilinear resize of an HWC uint8 image (ResizeTransform)."""
    h, w = img.shape[:2]
    newh, neww = compute_resize_shape(h, w, short, max_size)
    if (newh, neww) == (h, w):
        return img
    from PIL import Image

    pil = Image.fromarray(img)
    pil = pil.resize((neww, newh), Image.BILINEAR)
    return np.asarray(pil)


def single_preprocessing(
    image_hwc: np.ndarray, fixed_size: int = FIXED_EDGE_SIZE
) -> np.ndarray:
    """Normalize + zero-pad bottom/right to (fixed, fixed)
    (reference deploy_utils.py:76-98). HWC in, HWC out."""
    img = (image_hwc.astype(np.float32) - PIXEL_MEAN) / PIXEL_STD
    h, w = img.shape[:2]
    if h > fixed_size or w > fixed_size:
        raise ValueError(
            f"resized image ({h}x{w}) exceeds the padded canvas "
            f"{fixed_size}x{fixed_size}; pick a TPU.FIXED_EDGE_SIZE >= the "
            f"resize max edge (INPUT.MAX_SIZE_TEST rounded up to /32)")
    out = np.zeros((fixed_size, fixed_size, 3), np.float32)
    out[:h, :w] = img
    return out


def stem_space_to_depth(images_nhwc: np.ndarray) -> np.ndarray:
    """Factor-4 space-to-depth feeding the s2d stem
    (``models/backbones/vovnet.py::s2d_stem_forward``).

    Produces the (B, H/4+1, W/4+1, 16C) natural-order layout: output
    channel rho*4C + kap*C + c at spatial (i, j) holds input pixel
    (4i + rho - 2, 4j + kap - 2), zero outside, i.e. pad 2 on every
    side, then one reshape/transpose. Requires H % 4 == W % 4 == 0.
    """
    B, H, W, C = images_nhwc.shape
    assert H % 4 == 0 and W % 4 == 0, (H, W)
    P = np.pad(images_nhwc, ((0, 0), (2, 2), (2, 2), (0, 0)))
    Ho, Wo = H // 4 + 1, W // 4 + 1
    out = np.ascontiguousarray(
        P.reshape(B, Ho, 4, Wo, 4, C).transpose(0, 1, 3, 2, 4, 5))
    return out.reshape(B, Ho, Wo, 16 * C)


def _declare_s2d(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.s2d_preprocess_u8.restype = None
    lib.s2d_preprocess_u8.argtypes = [u8p, i64, i64, i64, i64, f32p, f32p]
    lib.s2d_preprocess_f32.restype = None
    lib.s2d_preprocess_f32.argtypes = [f32p, i64, i64, i64, i64, f32p, f32p]
    lib.s2d_pack_u8_rect.restype = None
    lib.s2d_pack_u8_rect.argtypes = [u8p, i64, i64, i64, i64, i64, u8p]


def _s2d_lib() -> ctypes.CDLL:
    """Build (once) and load the fused native pass; raises if g++ fails."""
    return load_library(_S2D_SRC, _S2D_FLAGS, _S2D_BUILD_ROOT, "s2d",
                        _declare_s2d)


def _check_s2d_preprocess(image_hwc: np.ndarray, fixed_size: int) -> None:
    h, w, C = image_hwc.shape
    if h > fixed_size or w > fixed_size:
        raise ValueError(
            f"resized image ({h}x{w}) exceeds the padded canvas "
            f"{fixed_size}x{fixed_size}")
    if C > 16:  # the native pass's per-phase mean buffer holds 4*C floats
        raise ValueError(f"s2d_preprocess supports C <= 16 channels, got {C}")
    if fixed_size % 4:
        raise ValueError(f"s2d canvas must be divisible by 4, got "
                         f"{fixed_size}")


def s2d_preprocess_plain(image_hwc: np.ndarray,
                         fixed_size: int = FIXED_EDGE_SIZE) -> np.ndarray:
    """``s2d_preprocess`` in numpy: normalize, pad, then
    ``stem_space_to_depth`` (the plain version of the native pass)."""
    _check_s2d_preprocess(image_hwc, fixed_size)
    return stem_space_to_depth(
        single_preprocessing(image_hwc, fixed_size)[None])


def s2d_preprocess(image_hwc: np.ndarray,
                   fixed_size: int = FIXED_EDGE_SIZE) -> np.ndarray:
    """Normalize + pad-to-canvas + space-to-depth for ONE resized image
    (uint8 or float32 HWC BGR) in one native pass: the (1, F/4+1, F/4+1,
    16C) f32 network input, bit-equal to ``s2d_preprocess_plain``."""
    _check_s2d_preprocess(image_hwc, fixed_size)
    h, w, C = image_hwc.shape
    Ho = fixed_size // 4 + 1
    out = np.empty((Ho, Ho, 16 * C), np.float32)
    mean = np.ascontiguousarray(PIXEL_MEAN[:C], np.float32)
    if image_hwc.dtype == np.uint8:
        _s2d_lib().s2d_preprocess_u8(np.ascontiguousarray(image_hwc), h, w,
                                     C, fixed_size, mean, out)
    else:
        _s2d_lib().s2d_preprocess_f32(
            np.ascontiguousarray(image_hwc, np.float32), h, w, C, fixed_size,
            mean, out)
    return out[None]


def _u8_canvas(image_hwc: np.ndarray, fixed_size) -> Tuple[int, int]:
    """The (Fh, Fw) canvas of an s2d uint8 pack, checked."""
    h, w, C = image_hwc.shape
    # np.ndim == 0 also catches numpy scalar ints (np.isscalar does not)
    fh, fw = ((int(fixed_size),) * 2 if np.ndim(fixed_size) == 0
              else tuple(int(v) for v in fixed_size))
    if h > fh or w > fw:
        raise ValueError(
            f"resized image ({h}x{w}) exceeds the padded canvas {fh}x{fw}")
    if C > 16:
        raise ValueError(f"s2d_pack_u8 supports C <= 16 channels, got {C}")
    if fh % 4 or fw % 4:
        raise ValueError(
            f"s2d canvas must be divisible by 4, got {fh}x{fw} (check "
            "TPU.FIXED_EDGE_SIZE / TPU.SIZE_BUCKETS)")
    return fh, fw


def s2d_pack_u8_plain(image_hwc: np.ndarray,
                      fixed_size=FIXED_EDGE_SIZE) -> np.ndarray:
    """``s2d_pack_u8`` in numpy: pad into the canvas, then
    ``stem_space_to_depth`` (the plain version of the native pass)."""
    fh, fw = _u8_canvas(image_hwc, fixed_size)
    h, w, C = image_hwc.shape
    canvas = np.zeros((fh, fw, C), np.uint8)
    canvas[:h, :w] = np.asarray(image_hwc, np.uint8)
    return stem_space_to_depth(canvas[None])


def s2d_pack_u8(image_hwc: np.ndarray,
                fixed_size=FIXED_EDGE_SIZE) -> np.ndarray:
    """Pad + space-to-depth ONE resized uint8 image WITHOUT normalizing,
    in one native pass: the (1, Fh/4+1, Fw/4+1, 16C) uint8 network input
    for the on-device normalization path (``CenterMask._normalize_u8_s2d``),
    a quarter of the f32 canvas's bytes; bit-equal to
    ``s2d_pack_u8_plain``. ``fixed_size``: the canvas, an int (square) or
    an (Fh, Fw) pair (rectangular, see s2d_pack_u8_tight). The native
    pass is the ``tracing`` span ``pack``."""
    fh, fw = _u8_canvas(image_hwc, fixed_size)
    h, w, C = image_hwc.shape
    out = np.empty((fh // 4 + 1, fw // 4 + 1, 16 * C), np.uint8)
    with tracing.span("pack"):
        _s2d_lib().s2d_pack_u8_rect(
            np.ascontiguousarray(image_hwc, np.uint8), h, w, C, fh, fw, out)
    return out[None]


def s2d_pack_u8_tight(image_hwc: np.ndarray,
                      fixed_size: int = FIXED_EDGE_SIZE,
                      multiple: int = 32) -> np.ndarray:
    """s2d_pack_u8 over the TIGHT canvas: the smallest
    (multiple-aligned) rectangle covering the resized image instead of
    the full deployment square. The device zero-pads the pack back to
    the square (``CenterMask.inference(canvas_hw=...)``) with equal
    outputs, because every s2d cell outside the tight pack reads only
    canvas padding, which is zero in both formulations. ``multiple``
    quantizes the tight canvas to bound the number of program shapes."""
    h, w, _ = image_hwc.shape
    align = lambda v: min(-(-v // multiple) * multiple, fixed_size)
    return s2d_pack_u8(image_hwc, (align(h), align(w)))


def s2d_serving_canvas(h: int, w: int,
                       fixed_size=FIXED_EDGE_SIZE,
                       short: int = MIN_EDGE_SIZE) -> Tuple[int, int]:
    """Quantized tight canvas for a resized (h, w) image: each dim is
    either align32(short) (the dim a ResizeShortestEdge(short) output
    can't exceed in its short direction) or the full ``fixed_size``, so
    at most 4 distinct canvases per deployment. Aligned to 32 (the
    detectron2 size_divisibility), so the canvas is also valid for
    tight-COMPUTE serving. ``fixed_size`` may be an int (square
    deployment canvas) or an (H, W) pair; the cap is per axis."""
    fh, fw = ((fixed_size, fixed_size) if isinstance(fixed_size, int)
              else (int(fixed_size[0]), int(fixed_size[1])))
    s = min(-(-short // 32) * 32, fh, fw)
    return (s if h <= s else fh, s if w <= s else fw)


def preprocess_for_model(
    path: str,
    fixed_size: int = FIXED_EDGE_SIZE,
    short: int = MIN_EDGE_SIZE,
    max_size: int = MAX_EDGE_SIZE,
    s2d: bool = False,
    u8: bool = False,
    tight: bool = False,
    read_image: Callable[[str], np.ndarray] = read_image_bgr,
) -> Dict:
    """Full host pipeline for one image: the NHWC network input plus the
    metadata postprocessing needs. ``s2d``: the TPU.S2D_STEM_INPUT
    layout, normalized on the host (f32). ``u8`` (implies s2d): the raw
    uint8 s2d pack, normalized on the device (pass "valid_hw" to the
    model). ``tight`` (u8 only): packed over the quantized tight canvas
    (s2d_serving_canvas); the consumer then calls the model with
    canvas_hw=(fixed_size, fixed_size) to pad it back on the device, or
    with no canvas_hw to run at the tight canvas. ``read_image``: path ->
    HWC uint8 BGR array (default: PIL)."""
    original = read_image(path)
    h, w = original.shape[:2]
    image = resize_shortest_edge(original, short, max_size)
    if u8 and tight:
        inp = s2d_pack_u8(
            image, s2d_serving_canvas(image.shape[0], image.shape[1],
                                      fixed_size, short))
    elif u8:
        inp = s2d_pack_u8(image, fixed_size)
    elif s2d:
        inp = s2d_preprocess(image, fixed_size)
    else:
        inp = single_preprocessing(image.astype(np.float32), fixed_size)[None]
    return {
        "input": inp,
        "resized_hw": image.shape[:2],
        "original_hw": (h, w),
        "valid_hw": np.asarray([image.shape[:2]], np.int32),
        "short": short,
        "max_size": max_size,
    }


def postprocess_scale(h: int, w: int, short: int = MIN_EDGE_SIZE,
                      max_size: int = MAX_EDGE_SIZE) -> float:
    """Recompute the resize scale from the original size
    (reference deploy_utils.py:138-144)."""
    scale = short / min(h, w)
    new_h = int(np.floor(h * scale))
    new_w = int(np.floor(w * scale))
    if max(new_h, new_w) > max_size:
        scale = max_size / max(new_h, new_w) * scale
    return scale
