// Multilevel ROIAlign (aligned, fixed sampling ratio) for Hopper (sm_90a).
//
// Replaces: centermask2_tpu/ops/roi_align_pallas.py::_gather_rows_kernel
// (launched by multilevel_roi_align_pallas), together with the XLA work
// around it: ops/roi_align.py::_multilevel_impl's level pick, sample
// coordinates, bilinear taps and s x s bin mean. One launch computes the
// whole op and writes (R, C, o, o) straight from the NCHW FPN levels.
//
// Bound on this card: bytes. At the main path's R = 50, C = 256, o = 14,
// s = 2 the output is 2.5 M values and each reads 16 taps; the arithmetic
// (~10 flops a tap) is far below the f32 peak, and the taps a ROI touches
// come from its (at most whole) level plane, so the least traffic is the
// output write plus the level region the ROIs cover.
//
// Design: the simple right kernel. One thread per output element
// (r, c, ph, pw), pw fastest, so neighbouring threads write neighbouring
// addresses and read neighbouring sample columns of one feature row. The
// taps are accumulated in f32 for bf16 and f32 inputs alike. There is no
// shared-memory staging yet: a later redesign can give a block one ROI's
// channel slice and reuse its taps from shared memory.
//
// Rounding follows the JAX formulas (not detectron2's) as XLA evaluates
// them, divisions by a constant being products with its f32 reciprocal:
// sample grid y0 + ((i + 0.5) * (1/s)) * (roi_h * (1/o)), taps zero
// outside [-1, H], clamped to [0, H-1], high tap min(low + 1, H - 1), taps
// combined as ((w1 v1 + w2 v2) + w3 v3) + w4 v4, bin mean as the sum times
// 1/(s*s). Every product and sum is an explicit _rn intrinsic, so no FMA
// contraction changes it; the plain PyTorch version does the same f32
// operations.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int num;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void roi_align_kernel(Levels lv, int num_images, int channels,
                                 const float* __restrict__ boxes,
                                 const int32_t* __restrict__ batch_idx,
                                 const int32_t* __restrict__ levels,
                                 int num_rois, int o, int s, int aligned,
                                 T* __restrict__ out) {
  const long long total = (long long)num_rois * channels * o * o;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int pw = (int)(idx % o);
  long long t = idx / o;
  const int ph = (int)(t % o);
  t /= o;
  const int c = (int)(t % channels);
  const int r = (int)(t / channels);

  const int l = min(max(levels[r], 0), lv.num - 1);
  const int b = min(max(batch_idx[r], 0), num_images - 1);
  const int H = lv.h[l];
  const int W = lv.w[l];
  const float scale = lv.scale[l];
  const float off = aligned ? 0.5f : 0.f;
  const float x0 = __fsub_rn(__fmul_rn(boxes[4 * r + 0], scale), off);
  const float y0 = __fsub_rn(__fmul_rn(boxes[4 * r + 1], scale), off);
  const float x1 = __fsub_rn(__fmul_rn(boxes[4 * r + 2], scale), off);
  const float y1 = __fsub_rn(__fmul_rn(boxes[4 * r + 3], scale), off);
  float roi_w = __fsub_rn(x1, x0);
  float roi_h = __fsub_rn(y1, y0);
  if (!aligned) {  // legacy ROIAlign forces min size 1
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  const float inv_o = __fdiv_rn(1.f, (float)o);
  const float inv_s = __fdiv_rn(1.f, (float)s);
  const float bin_h = __fmul_rn(roi_h, inv_o);
  const float bin_w = __fmul_rn(roi_w, inv_o);
  const float fH = (float)H;
  const float fW = (float)W;
  const T* f = static_cast<const T*>(lv.ptr[l]) +
               ((size_t)b * channels + c) * (size_t)H * W;

  float acc = 0.f;
  for (int iy = 0; iy < s; ++iy) {
    const float gy = __fmul_rn(__fadd_rn((float)(ph * s + iy), 0.5f), inv_s);
    const float y = __fadd_rn(y0, __fmul_rn(gy, bin_h));
    for (int ix = 0; ix < s; ++ix) {
      const float gx = __fmul_rn(__fadd_rn((float)(pw * s + ix), 0.5f), inv_s);
      const float x = __fadd_rn(x0, __fmul_rn(gx, bin_w));
      if (!(y >= -1.f && y <= fH && x >= -1.f && x <= fW)) continue;
      float yc = fmaxf(y, 0.f);
      float xc = fmaxf(x, 0.f);
      const float yl = fminf(floorf(yc), fH - 1.f);
      const float xl = fminf(floorf(xc), fW - 1.f);
      yc = fminf(yc, fH - 1.f);
      xc = fminf(xc, fW - 1.f);
      const float ly = __fsub_rn(yc, yl);
      const float lx = __fsub_rn(xc, xl);
      const float hy = __fsub_rn(1.f, ly);
      const float hx = __fsub_rn(1.f, lx);
      const int y_lo = (int)yl;
      const int x_lo = (int)xl;
      const int y_hi = min(y_lo + 1, H - 1);
      const int x_hi = min(x_lo + 1, W - 1);
      const float v1 = load(f + (size_t)y_lo * W + x_lo);
      const float v2 = load(f + (size_t)y_lo * W + x_hi);
      const float v3 = load(f + (size_t)y_hi * W + x_lo);
      const float v4 = load(f + (size_t)y_hi * W + x_hi);
      float v = __fadd_rn(__fmul_rn(v1, __fmul_rn(hy, hx)),
                          __fmul_rn(v2, __fmul_rn(hy, lx)));
      v = __fadd_rn(v, __fmul_rn(v3, __fmul_rn(ly, hx)));
      v = __fadd_rn(v, __fmul_rn(v4, __fmul_rn(ly, lx)));
      acc = __fadd_rn(acc, v);
    }
  }
  store(out + idx, __fmul_rn(acc, __fdiv_rn(1.f, (float)(s * s))));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output). feats/heights/
// widths/scales are host arrays of num_levels entries, each feature an
// NCHW (num_images, channels, h, w) device tensor; boxes (R, 4) f32,
// batch_idx/levels (R,) int32 on the device; out (R, channels, o, o).
// Returns cudaGetLastError() after the launch.
extern "C" int cm2_roi_align(int dtype, const void* const* feats,
                             const int* heights, const int* widths,
                             const float* scales, int num_levels,
                             int num_images, int channels, const float* boxes,
                             const int32_t* batch_idx, const int32_t* levels,
                             int num_rois, int output_size,
                             int sampling_ratio, int aligned, void* out,
                             void* stream) {
  if (num_levels <= 0 || num_levels > kMaxLevels || num_images <= 0 ||
      channels <= 0 || num_rois < 0 || output_size <= 0 ||
      sampling_ratio <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_rois == 0) return (int)cudaSuccess;
  Levels lv;
  lv.num = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = feats[i];
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.scale[i] = scales[i];
  }
  const long long total =
      (long long)num_rois * channels * output_size * output_size;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_kernel<float><<<blocks, kThreads, 0, s>>>(
        lv, num_images, channels, boxes, batch_idx, levels, num_rois,
        output_size, sampling_ratio, aligned, static_cast<float*>(out));
  } else {
    roi_align_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        lv, num_images, channels, boxes, batch_idx, levels, num_rois,
        output_size, sampling_ratio, aligned,
        static_cast<__nv_bfloat16*>(out));
  }
  return (int)cudaGetLastError();
}
