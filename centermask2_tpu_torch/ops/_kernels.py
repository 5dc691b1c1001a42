"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into its own
shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The sources build in
parallel, one ``nvcc`` each. A library lands in
``centermask2_tpu_torch/_build/<name>-<hash>/``, keyed by the hash of its
source and flags, so an edited source rebuilds and a finished build is
reused; ``.gitignore`` lists ``_build/``.

The launch functions take CUDA tensors only, check device, dtype, shape
and contiguity, launch on PyTorch's current stream, raise if the C entry
returns a CUDA error, and add one to their launch count
(``nms_launches``, ``roi_align_launches``,
``roi_align_backward_launches``). The counts are host integers: a
launch recorded into a CUDA graph counts once, at capture, and a replay
adds nothing. ``ops/nms.py`` and ``ops/roi_align.py`` register these
functions as the CUDA implementations of the operators
``cm2::nms_keep_sorted``, ``cm2::roi_align`` and
``cm2::roi_align_backward``, whose CPU implementations are the plain
PyTorch versions.

``csrc/stamp.cu`` is no model kernel: ``section_stamp`` writes the
device's ``%globaltimer`` into the section ring of a captured program
(``utils/tracing.py``, whose ``Ring`` is its plain version on the CPU).
Its launches are counted on the device, by the ring's cursor, and not
in ``launch_counts``: a replay launches it without this function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
# per-source extra flags: the NMS IoU must not be contracted into FMAs
EXTRA_FLAGS = {"nms": ["-fmad=false"], "roi_align": [], "stamp": []}

MAX_NMS_N = 8192
MAX_ROI_SAMPLES = 64  # kMaxSamples in csrc/roi_align.cu: o * s per axis
ROI_AXES_BYTES = 2176  # sizeof(RoiAxes) in csrc/roi_align.cu

nms_launches = 0
roi_align_launches = 0
roi_align_backward_launches = 0

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    global nms_launches, roi_align_launches, roi_align_backward_launches
    nms_launches = 0
    roi_align_launches = 0
    roi_align_backward_launches = 0


def launch_counts() -> Dict[str, int]:
    return {"nms": nms_launches, "roi_align": roi_align_launches,
            "roi_align_backward": roi_align_backward_launches}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    flags = NVCC_FLAGS + EXTRA_FLAGS[name]
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"libcm2_{name}.so"


def build(names: Sequence[str] = tuple(EXTRA_FLAGS)) -> float:
    """Compile every listed source that has no library yet, all ``nvcc``
    processes at once, then load them. Returns the wall seconds spent.
    The compiler's output (``-Xptxas=-v``: registers, shared memory,
    spills per kernel) is kept beside each library as ``build.log``."""
    t0 = time.perf_counter()
    procs: List = []
    for name in names:
        if name in _libs:
            continue
        lib = _lib_path(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = open(lib.parent / "build.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + (lib.parent / "build.log").read_text())
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return time.perf_counter() - t0


def build_logs() -> Dict[str, str]:
    """The compiler output of each built library."""
    out = {}
    for name in EXTRA_FLAGS:
        log = _lib_path(name).parent / "build.log"
        if log.exists():
            out[name] = log.read_text()
    return out


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "nms":
        lib.cm2_nms_keep_sorted.argtypes = [vp, vp, vp, vp, ci, ci, cf, vp]
        lib.cm2_nms_keep_sorted.restype = ci
    elif name == "stamp":
        lib.cm2_section_stamp.argtypes = [vp, vp, ci, ci, ci,
                                          ctypes.c_longlong, ci, vp]
        lib.cm2_section_stamp.restype = ci
    else:
        lib.cm2_roi_align.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, vp, vp,
                                      vp, ci, ci, ci, ci, vp, vp]
        lib.cm2_roi_align.restype = ci
        lib.cm2_roi_align_backward.argtypes = [
            ci, vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci,
            vp, vp, vp, vp, vp]
        lib.cm2_roi_align_backward.restype = ci
        lib.cm2_roi_tap_windows.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp,
                                            ci, ci, ci, ci, vp, vp]
        lib.cm2_roi_tap_windows.restype = ci
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build([name])
    return _libs[name]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def _require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device, got {[x.device for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return dev


def nms_keep_sorted(sboxes: torch.Tensor, svalid: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Kernel 1 (csrc/nms.cu): greedy keep mask (B, N) bool over score-
    sorted boxes (B, N, 4) f32 with validity (B, N) bool; N % 64 == 0,
    N <= 8192."""
    global nms_launches
    dev = _require_cuda("nms_keep_sorted", sboxes, svalid)
    if sboxes.dtype != torch.float32 or svalid.dtype != torch.bool:
        raise ValueError("nms_keep_sorted: boxes f32 and valid bool required")
    if sboxes.dim() != 3 or sboxes.shape[-1] != 4 or \
            tuple(svalid.shape) != tuple(sboxes.shape[:2]):
        raise ValueError(f"nms_keep_sorted: shapes {tuple(sboxes.shape)}, "
                         f"{tuple(svalid.shape)}")
    B, n = svalid.shape
    if n % 64 != 0 or n > MAX_NMS_N or n == 0 or B == 0:
        raise ValueError(f"nms_keep_sorted: N={n} must be a nonzero multiple "
                         f"of 64 and at most {MAX_NMS_N}")
    if sboxes.data_ptr() % 16:
        raise ValueError("nms_keep_sorted: boxes must be 16-byte aligned")
    keep = torch.empty((B, n), dtype=torch.bool, device=dev)
    # overlap bitmask scratch: rows of n/64 words rounded up to even (the
    # scan stages them in 16-byte copies)
    words = n // 64
    mask = torch.empty((B, n, words + words % 2), dtype=torch.int64,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib("nms").cm2_nms_keep_sorted(
        sboxes.data_ptr(), svalid.data_ptr(), keep.data_ptr(),
        mask.data_ptr(), B, n, float(iou_threshold), stream)
    _check(rc, "cm2_nms_keep_sorted")
    nms_launches += 1
    return keep


_ROI_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def roi_align(features: Sequence[torch.Tensor], boxes: torch.Tensor,
              batch_indices: torch.Tensor, levels: torch.Tensor,
              scales: Sequence[float], output_size: int, sampling_ratio: int,
              aligned: bool) -> torch.Tensor:
    """Kernel 2 (csrc/roi_align.cu): multilevel ROIAlign of NCHW levels
    (N, C, Hl, Wl), f32 or bf16, -> (R, C, o, o) in the features' dtype."""
    global roi_align_launches
    if output_size * sampling_ratio > MAX_ROI_SAMPLES:
        raise ValueError(f"roi_align: output_size * sampling_ratio = "
                         f"{output_size * sampling_ratio} exceeds the "
                         f"kernel's {MAX_ROI_SAMPLES} samples per axis")
    feats = list(features)
    dev = _require_cuda("roi_align", *feats, boxes, batch_indices, levels)
    dt = feats[0].dtype
    if dt not in _ROI_DTYPES or any(f.dtype != dt for f in feats):
        raise ValueError(f"roi_align: features must share f32 or bf16, got "
                         f"{[f.dtype for f in feats]}")
    N, C = feats[0].shape[:2]
    if any(f.dim() != 4 or f.shape[:2] != (N, C) for f in feats):
        raise ValueError("roi_align: levels must be (N, C, H, W) alike in N, C")
    if boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError("roi_align: boxes must be (R, 4) f32")
    R = boxes.shape[0]
    if batch_indices.dtype != torch.int32 or levels.dtype != torch.int32 or \
            batch_indices.shape != (R,) or levels.shape != (R,):
        raise ValueError("roi_align: batch_indices/levels must be (R,) int32")
    if len(feats) != len(scales) or sampling_ratio <= 0:
        raise ValueError("roi_align: one scale per level and a sampling "
                         "ratio > 0 are required")
    L = len(feats)
    out = torch.empty((R, C, output_size, output_size), dtype=dt, device=dev)
    if R == 0:  # nothing to launch
        return out
    ptrs = (ctypes.c_void_p * L)(*[f.data_ptr() for f in feats])
    hs = (ctypes.c_int * L)(*[f.shape[2] for f in feats])
    ws = (ctypes.c_int * L)(*[f.shape[3] for f in feats])
    sc = (ctypes.c_float * L)(*[float(s) for s in scales])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib("roi_align").cm2_roi_align(
        _ROI_DTYPES[dt], ctypes.cast(ptrs, ctypes.c_void_p),
        ctypes.cast(hs, ctypes.c_void_p), ctypes.cast(ws, ctypes.c_void_p),
        ctypes.cast(sc, ctypes.c_void_p), L, N, C, boxes.data_ptr(),
        batch_indices.data_ptr(), levels.data_ptr(), R, output_size,
        sampling_ratio, int(aligned), out.data_ptr(), stream)
    _check(rc, "cm2_roi_align")
    roi_align_launches += 1
    return out


def _roi_bwd_args(what: str, boxes: torch.Tensor,
                  batch_indices: torch.Tensor, levels: torch.Tensor,
                  shapes: Sequence[Sequence[int]], scales: Sequence[float],
                  output_size: int, sampling_ratio: int):
    """Checks kernel 2b's ROI arguments; returns the device, the level
    shapes as int tuples, R and the host arrays of heights, widths and
    scales."""
    if output_size * sampling_ratio > MAX_ROI_SAMPLES or sampling_ratio <= 0:
        raise ValueError(f"{what}: output_size * sampling_ratio "
                         f"= {output_size * sampling_ratio} outside the "
                         f"kernel's 1..{MAX_ROI_SAMPLES} samples per axis")
    dev = _require_cuda(what, boxes, batch_indices, levels)
    shapes = [tuple(int(v) for v in shp) for shp in shapes]
    N, C = shapes[0][:2]
    if any(len(shp) != 4 or shp[:2] != (N, C) or min(shp) <= 0
           for shp in shapes) or len(shapes) != len(scales):
        raise ValueError(f"{what}: levels must be nonempty (N, C, H, W) "
                         "alike in N, C, one scale each")
    R = boxes.shape[0]
    if boxes.dtype != torch.float32 or tuple(boxes.shape) != (R, 4):
        raise ValueError(f"{what}: boxes {tuple(boxes.shape)} must be (R, 4) "
                         "f32")
    if batch_indices.dtype != torch.int32 or levels.dtype != torch.int32 or \
            batch_indices.shape != (R,) or levels.shape != (R,):
        raise ValueError(f"{what}: batch_indices/levels must be (R,) int32")
    L = len(shapes)
    hs = (ctypes.c_int * L)(*[shp[2] for shp in shapes])
    ws = (ctypes.c_int * L)(*[shp[3] for shp in shapes])
    sc = (ctypes.c_float * L)(*[float(s) for s in scales])
    return dev, shapes, R, hs, ws, sc


def roi_align_backward(grad: torch.Tensor, boxes: torch.Tensor,
                       batch_indices: torch.Tensor, levels: torch.Tensor,
                       shapes: Sequence[Sequence[int]], dtype: torch.dtype,
                       scales: Sequence[float], output_size: int,
                       sampling_ratio: int,
                       aligned: bool) -> List[torch.Tensor]:
    """Kernel 2b (csrc/roi_align.cu): the feature gradient of kernel 2.
    grad (R, C, o, o) in ``dtype`` (f32 or bf16); returns one (N, C, Hl,
    Wl) gradient per level of ``shapes`` in ``dtype``, views of one
    buffer that the kernel writes once (no zeroing, no scratch). The
    prepass's tables are allocated here: tap windows (R, 6) int32, axis
    tables (R, ROI_AXES_BYTES) uint8 and a nonzero flag per ROI (R,)
    uint8."""
    global roi_align_backward_launches
    dev, shapes, R, hs, ws, sc = _roi_bwd_args(
        "roi_align_backward", boxes, batch_indices, levels, shapes, scales,
        output_size, sampling_ratio)
    _require_cuda("roi_align_backward", grad, boxes)
    N, C = shapes[0][:2]
    if dtype not in _ROI_DTYPES or grad.dtype != dtype:
        raise ValueError(f"roi_align_backward: grad {grad.dtype} must be the "
                         f"features' dtype {dtype}, f32 or bf16")
    if tuple(grad.shape) != (R, C, output_size, output_size):
        raise ValueError(f"roi_align_backward: grad {tuple(grad.shape)} for "
                         f"{R} ROIs, {C} channels")
    L = len(shapes)
    sizes = [N * C * h * w for _, _, h, w in shapes]
    offsets = [sum(sizes[:i]) for i in range(L)]
    out = torch.empty(sum(sizes), dtype=dtype, device=dev)
    windows = torch.empty((R, 6), dtype=torch.int32, device=dev)
    axes = torch.empty((R, ROI_AXES_BYTES), dtype=torch.uint8, device=dev)
    flags = torch.empty(R, dtype=torch.uint8, device=dev)
    offs = (ctypes.c_longlong * L)(*offsets)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib("roi_align").cm2_roi_align_backward(
        _ROI_DTYPES[dtype], grad.data_ptr(),
        ctypes.cast(hs, ctypes.c_void_p), ctypes.cast(ws, ctypes.c_void_p),
        ctypes.cast(sc, ctypes.c_void_p), ctypes.cast(offs, ctypes.c_void_p),
        L, N, C, boxes.data_ptr(), batch_indices.data_ptr(),
        levels.data_ptr(), R, output_size, sampling_ratio, int(aligned),
        *(t.data_ptr() if R else None for t in (windows, axes, flags)),
        out.data_ptr(), stream)
    _check(rc, "cm2_roi_align_backward")
    roi_align_backward_launches += 1
    return [out[o:o + n].view(shp)
            for o, n, shp in zip(offsets, sizes, shapes)]


def roi_tap_windows(boxes: torch.Tensor, batch_indices: torch.Tensor,
                    levels: torch.Tensor, shapes: Sequence[Sequence[int]],
                    scales: Sequence[float], output_size: int,
                    sampling_ratio: int, aligned: bool) -> torch.Tensor:
    """Kernel 2b's prepass alone, to check its table against
    ``ops/roi_align.py::roi_tap_windows``: (R, 6) int32 rows (level,
    image, first row, last row, first column, last column). Not a launch
    of kernel 2b: the count stays."""
    dev, shapes, R, hs, ws, sc = _roi_bwd_args(
        "roi_tap_windows", boxes, batch_indices, levels, shapes, scales,
        output_size, sampling_ratio)
    windows = torch.empty((R, 6), dtype=torch.int32, device=dev)
    if R == 0:
        return windows
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _lib("roi_align").cm2_roi_tap_windows(
        ctypes.cast(hs, ctypes.c_void_p), ctypes.cast(ws, ctypes.c_void_p),
        ctypes.cast(sc, ctypes.c_void_p), len(shapes), shapes[0][0],
        boxes.data_ptr(), batch_indices.data_ptr(), levels.data_ptr(), R,
        output_size, sampling_ratio, int(aligned), windows.data_ptr(), stream)
    _check(rc, "cm2_roi_tap_windows")
    return windows


def section_stamp(ring: torch.Tensor, cursor: torch.Tensor, slot: int,
                  key: int, last: bool) -> None:
    """``csrc/stamp.cu``: ``%globaltimer`` into word ``1 + slot`` of the
    ring's row ``cursor % rows`` (``ring``: (rows, width) int64;
    ``cursor``: (1,) int64); slot 0 writes ``key`` into word 0 too, and
    ``last`` advances the cursor. Recorded into a CUDA graph, each replay
    stamps the row its cursor then points at."""
    _require_cuda("section_stamp", ring, cursor)
    if ring.dtype != torch.int64 or cursor.dtype != torch.int64 or \
            ring.dim() != 2 or cursor.numel() != 1:
        raise ValueError("section_stamp: ring (rows, width) int64 and a "
                         "(1,) int64 cursor required")
    rows, width = ring.shape
    if not 0 <= slot < width - 1:
        raise ValueError(f"section_stamp: slot {slot} outside the ring's "
                         f"{width - 1} stamps")
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    rc = _lib("stamp").cm2_section_stamp(
        ring.data_ptr(), cursor.data_ptr(), rows, width, slot, int(key),
        int(last), stream)
    _check(rc, "cm2_section_stamp")
