// Multilevel ROIAlign (aligned, fixed sampling ratio) for Hopper (sm_90a):
// kernel 2, the forward, and kernel 2b, its feature gradient.
//
// Kernel 2 replaces: centermask2_tpu/ops/roi_align_pallas.py::
// _gather_rows_kernel (launched by multilevel_roi_align_pallas), together
// with the XLA work around it: ops/roi_align.py::_multilevel_impl's level
// pick, sample coordinates, bilinear taps and s x s bin mean. One launch
// computes the whole op and writes (R, C, o, o) straight from the NCHW FPN
// levels.
//
// Bound on this card: the output write and the level region the ROIs
// cover (bytes), or the ~12 flops a tap (operations), whichever is larger;
// at the main path's R = 50, C = 256, o = 14, s = 2 both are a few
// microseconds. What the kernel pays for instead is its gathers: 16
// scalar taps per output value from NCHW planes, ~40 M loads at the main
// path's shapes (1.25 M warp-wide), each a trip through the load/store
// pipe for 2 or 4 bytes a lane; tiny ROIs, whose taps hit a few cache
// lines, take about as long as large ones, so the count of gathers and
// not the lines they touch sets the time. The design keeps every other
// cost out of that loop:
//  - a block owns one ROI and a group of kGroup channels, grid
//    R x ceil(C / kGroup); four channels a block gave the most blocks in
//    flight and the fewest registers (32) of the group sizes tried;
//  - prologue (fill_axes, shared with kernel 2b): the block reads the
//    ROI's box, level and image once and fills two axis tables in shared
//    memory, one entry per sample along y and along x (o*s each, at most
//    kMaxSamples): low and high tap as row or column offsets, the two
//    weights, and the in-range flag;
//  - each thread owns one output position (ph, pw) and carries kGroup
//    f32 sums: per sample it takes its 4 tap offsets and weights from the
//    tables once, then reads the 4 taps of every channel of the group
//    through the read-only path. All index arithmetic is 32-bit: one
//    division per output position, none per output value;
//  - bf16 outputs of neighbouring positions are paired by a shuffle and
//    stored as __nv_bfloat162 where o*o is even, scalars otherwise.
// The ROI's feature window is not staged in shared memory: a ROI can be
// as large as its whole level, so the window has no static bound. L1 and
// L2 carry the reuse between neighbouring samples and channels.
//
// Kernel 2b has no TPU kernel to replace: JAX computes the VJP in XLA as
// two matmuls per level (ops/roi_align.py::_separable_feature_grad,
// :325-349). It scatters g[r, c, ph, pw] * w_tap / (s*s) into the 4 taps
// of every in-range sample with f32 atomicAdd, into one zeroed f32
// scratch laid out as the levels one after the other, each NCHW; a cast
// pass writes bf16 levels from it (f32 levels are the scratch itself).
// The same block shape and the same prologue as kernel 2, so forward and
// backward can never disagree on a tap. Bound: reading g and writing the
// level gradients (bytes); what the kernel pays for is R*C*o*o*s*s*4
// atomic adds (205 M on the training step's R = 256, C = 256, o = 14,
// s = 2), which collide in L2 wherever samples of a ROI share a pixel,
// and the scratch's zeroing and read-modify-write. Combining a bin's
// samples that hit one pixel, or staging a small ROI's window in shared
// memory, is later work. The sums land in an order that changes from run
// to run.
//
// Rounding follows the JAX formulas (not detectron2's) as XLA evaluates
// them, divisions by a constant being products with its f32 reciprocal:
// sample grid y0 + ((i + 0.5) * (1/s)) * (roi_h * (1/o)), taps zero
// outside [-1, H], clamped to [0, H-1], high tap min(low + 1, H - 1), taps
// combined as ((w1 v1 + w2 v2) + w3 v3) + w4 v4 with w1 = hy * hx, ...,
// samples summed in (iy, ix) order, bin mean as the sum times 1/(s*s).
// Every product and sum is an explicit _rn intrinsic, so no FMA
// contraction changes it; the plain PyTorch version does the same f32
// operations.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // o * s along one axis
constexpr int kGroup = 4;        // channels per block
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int num;
};

// One axis of a ROI's sample grid: taps as offsets (y: row * W, x: col).
struct Axis {
  int lo[kMaxSamples];
  int hi[kMaxSamples];
  float l[kMaxSamples];  // weight of the high tap
  float h[kMaxSamples];  // weight of the low tap
  unsigned char ok[kMaxSamples];
};

// Element offset of each level in kernel 2b's f32 scratch.
struct LevelOffsets {
  long long v[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// Fills the ROI's two axis tables (entry k < o*s of the y table, then of
// the x table); the caller synchronises the block afterwards.
__device__ __forceinline__ void fill_axes(const Levels& lv, int l,
                                          const float* __restrict__ boxes,
                                          int r, int o, int s, int aligned,
                                          Axis& ay, Axis& ax) {
  const int H = lv.h[l];
  const int W = lv.w[l];
  const int pts = o * s;
  for (int i = threadIdx.x; i < 2 * pts; i += blockDim.x) {
    const bool is_x = i >= pts;
    const int k = is_x ? i - pts : i;
    const float scale = lv.scale[l];
    const float off = aligned ? 0.5f : 0.f;
    const float p0 = __fsub_rn(__fmul_rn(__ldg(boxes + 4 * r + (is_x ? 0 : 1)),
                                         scale), off);
    const float p1 = __fsub_rn(__fmul_rn(__ldg(boxes + 4 * r + (is_x ? 2 : 3)),
                                         scale), off);
    float len = __fsub_rn(p1, p0);
    if (!aligned) len = fmaxf(len, 1.f);  // legacy ROIAlign: min size 1
    const float bin = __fmul_rn(len, __fdiv_rn(1.f, (float)o));
    const float g = __fmul_rn(__fadd_rn((float)k, 0.5f),
                              __fdiv_rn(1.f, (float)s));
    const float v = __fadd_rn(p0, __fmul_rn(g, bin));
    const int size = is_x ? W : H;
    const float lim = (float)size;
    float vc = fmaxf(v, 0.f);
    const float lo = fminf(floorf(vc), lim - 1.f);
    vc = fminf(vc, lim - 1.f);
    const float lw = __fsub_rn(vc, lo);
    const int ilo = (int)lo;
    const int stride = is_x ? 1 : W;
    Axis& a = is_x ? ax : ay;
    a.lo[k] = ilo * stride;
    a.hi[k] = min(ilo + 1, size - 1) * stride;
    a.l[k] = lw;
    a.h[k] = __fsub_rn(1.f, lw);
    a.ok[k] = v >= -1.f && v <= lim;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_kernel(Levels lv, int num_images, int channels,
                     const float* __restrict__ boxes,
                     const int32_t* __restrict__ batch_idx,
                     const int32_t* __restrict__ levels, int o, int s,
                     int aligned, T* __restrict__ out) {
  __shared__ Axis ay, ax;
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kGroup;
  const int l = min(max(__ldg(levels + r), 0), lv.num - 1);
  const int b = min(max(__ldg(batch_idx + r), 0), num_images - 1);
  const int H = lv.h[l];
  const int W = lv.w[l];
  fill_axes(lv, l, boxes, r, o, s, aligned, ay, ax);
  __syncthreads();

  const int oo = o * o;
  const int nc = min(kGroup, channels - c0);
  const int plane = H * W;
  const T* f0 = static_cast<const T*>(lv.ptr[l]) +
                ((size_t)b * channels + c0) * (size_t)plane;
  T* o0 = out + ((size_t)r * channels + c0) * (size_t)oo;
  const float inv_ss = __fdiv_rn(1.f, (float)(s * s));
  for (int base = 0; base < oo; base += blockDim.x) {
    const int p = base + threadIdx.x;  // p's parity is the lane's
    const bool live = p < oo;
    const int ph = live ? p / o : 0;
    const int pw = live ? p - ph * o : 0;
    float acc[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) acc[j] = 0.f;
    if (live) {
      for (int iy = 0; iy < s; ++iy) {
        const int ky = ph * s + iy;
        if (!ay.ok[ky]) continue;
        const int ylo = ay.lo[ky], yhi = ay.hi[ky];
        const float ly = ay.l[ky], hy = ay.h[ky];
        for (int ix = 0; ix < s; ++ix) {
          const int kx = pw * s + ix;
          if (!ax.ok[kx]) continue;
          const int xlo = ax.lo[kx], xhi = ax.hi[kx];
          const float lx = ax.l[kx], hx = ax.h[kx];
          const float w1 = __fmul_rn(hy, hx), w2 = __fmul_rn(hy, lx);
          const float w3 = __fmul_rn(ly, hx), w4 = __fmul_rn(ly, lx);
          const int t1 = ylo + xlo, t2 = ylo + xhi;
          const int t3 = yhi + xlo, t4 = yhi + xhi;
          const T* f = f0;
#pragma unroll
          for (int j = 0; j < kGroup; ++j, f += plane) {
            if (j < nc) {
              float v = __fadd_rn(__fmul_rn(load(f + t1), w1),
                                  __fmul_rn(load(f + t2), w2));
              v = __fadd_rn(v, __fmul_rn(load(f + t3), w3));
              v = __fadd_rn(v, __fmul_rn(load(f + t4), w4));
              acc[j] = __fadd_rn(acc[j], v);
            }
          }
        }
      }
    }
    T* dst = o0 + p;
    if constexpr (sizeof(T) == 2) {
      if ((oo & 1) == 0) {  // pairs (p, p+1) sit in lanes (2i, 2i+1)
#pragma unroll
        for (int j = 0; j < kGroup; ++j, dst += oo) {
          const float v = __fmul_rn(acc[j], inv_ss);
          const float next = __shfl_down_sync(kFull, v, 1);
          if (live && !(p & 1) && j < nc) {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(v, next);
          }
        }
        continue;
      }
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j, dst += oo) {
      if (live && j < nc) {
        const float v = __fmul_rn(acc[j], inv_ss);
        if constexpr (sizeof(T) == 2) {
          *dst = __float2bfloat16_rn(v);
        } else {
          *dst = v;
        }
      }
    }
  }
}

// Kernel 2b: scatter of the output gradient into the f32 level scratch.
// Block and prologue as kernel 2; each thread owns one output position
// and, per sample, adds g * w_tap / (s*s) to the 4 taps of each channel of
// its group. scratch + off[l] is level l's (num_images, channels, H, W).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    roi_align_backward_kernel(Levels lv, LevelOffsets offs, int num_images,
                              int channels, const float* __restrict__ boxes,
                              const int32_t* __restrict__ batch_idx,
                              const int32_t* __restrict__ levels, int o,
                              int s, int aligned, const T* __restrict__ grad,
                              float* __restrict__ scratch) {
  __shared__ Axis ay, ax;
  const int r = blockIdx.x;
  const int c0 = blockIdx.y * kGroup;
  const int l = min(max(__ldg(levels + r), 0), lv.num - 1);
  const int b = min(max(__ldg(batch_idx + r), 0), num_images - 1);
  fill_axes(lv, l, boxes, r, o, s, aligned, ay, ax);
  __syncthreads();

  const int oo = o * o;
  const int nc = min(kGroup, channels - c0);
  const int plane = lv.h[l] * lv.w[l];
  float* s0 = scratch + offs.v[l] + ((size_t)b * channels + c0) * (size_t)plane;
  const T* g0 = grad + ((size_t)r * channels + c0) * (size_t)oo;
  const float inv_ss = __fdiv_rn(1.f, (float)(s * s));
  for (int p = threadIdx.x; p < oo; p += blockDim.x) {
    const int ph = p / o;
    const int pw = p - ph * o;
    float gv[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      gv[j] = j < nc ? __fmul_rn(load(g0 + (size_t)j * oo + p), inv_ss) : 0.f;
    }
    for (int iy = 0; iy < s; ++iy) {
      const int ky = ph * s + iy;
      if (!ay.ok[ky]) continue;
      const int ylo = ay.lo[ky], yhi = ay.hi[ky];
      const float ly = ay.l[ky], hy = ay.h[ky];
      for (int ix = 0; ix < s; ++ix) {
        const int kx = pw * s + ix;
        if (!ax.ok[kx]) continue;
        const int xlo = ax.lo[kx], xhi = ax.hi[kx];
        const float lx = ax.l[kx], hx = ax.h[kx];
        const float w1 = __fmul_rn(hy, hx), w2 = __fmul_rn(hy, lx);
        const float w3 = __fmul_rn(ly, hx), w4 = __fmul_rn(ly, lx);
        const int t1 = ylo + xlo, t2 = ylo + xhi;
        const int t3 = yhi + xlo, t4 = yhi + xhi;
        float* f = s0;
#pragma unroll
        for (int j = 0; j < kGroup; ++j, f += plane) {
          if (j < nc) {
            atomicAdd(f + t1, __fmul_rn(gv[j], w1));
            atomicAdd(f + t2, __fmul_rn(gv[j], w2));
            atomicAdd(f + t3, __fmul_rn(gv[j], w3));
            atomicAdd(f + t4, __fmul_rn(gv[j], w4));
          }
        }
      }
    }
  }
}

// The cast pass of kernel 2b: f32 scratch -> bf16 level gradients.
__global__ void cast_bf16_kernel(const float* __restrict__ src,
                                 __nv_bfloat16* __restrict__ dst,
                                 long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    dst[i] = __float2bfloat16_rn(src[i]);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (features and output). feats/heights/
// widths/scales are host arrays of num_levels entries, each feature an
// NCHW (num_images, channels, h, w) device tensor; boxes (R, 4) f32,
// batch_idx/levels (R,) int32 on the device; out (R, channels, o, o),
// 4-byte aligned. output_size * sampling_ratio <= 64. Returns
// cudaGetLastError() after the launch.
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
      sampling_ratio <= 0 || output_size * sampling_ratio > kMaxSamples ||
      (dtype != 0 && dtype != 1)) {
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
  const int oo = output_size * output_size;
  const int threads = std::min(kMaxThreads, (oo + 31) / 32 * 32);
  const dim3 grid(num_rois, (channels + kGroup - 1) / kGroup);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    roi_align_kernel<float><<<grid, threads, 0, s>>>(
        lv, num_images, channels, boxes, batch_idx, levels, output_size,
        sampling_ratio, aligned, static_cast<float*>(out));
  } else {
    roi_align_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        lv, num_images, channels, boxes, batch_idx, levels, output_size,
        sampling_ratio, aligned, static_cast<__nv_bfloat16*>(out));
  }
  return (int)cudaGetLastError();
}

// Kernel 2b. dtype: 0 = float32, 1 = bfloat16 (grad and the level
// gradients). heights/widths/scales/offsets are host arrays of num_levels
// entries; grad (R, channels, o, o) on the device; scratch holds
// scratch_elems f32 (every level's (num_images, channels, h, w), level l
// at offsets[l]) and is zeroed here on the stream; out_bf16 (dtype 1 only)
// receives the cast of the whole scratch, same layout. Returns
// cudaGetLastError() after the launches.
extern "C" int cm2_roi_align_backward(
    int dtype, const void* grad, const int* heights, const int* widths,
    const float* scales, const long long* offsets, int num_levels,
    int num_images, int channels, const float* boxes,
    const int32_t* batch_idx, const int32_t* levels, int num_rois,
    int output_size, int sampling_ratio, int aligned, float* scratch,
    long long scratch_elems, void* out_bf16, void* stream) {
  if (num_levels <= 0 || num_levels > kMaxLevels || num_images <= 0 ||
      channels <= 0 || num_rois < 0 || output_size <= 0 ||
      sampling_ratio <= 0 || output_size * sampling_ratio > kMaxSamples ||
      scratch_elems <= 0 || (dtype != 0 && dtype != 1) ||
      (dtype == 1 && out_bf16 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv;
  LevelOffsets offs;
  lv.num = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = nullptr;
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.scale[i] = scales[i];
    offs.v[i] = offsets[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0,
                                    (size_t)scratch_elems * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  if (num_rois > 0) {
    const int oo = output_size * output_size;
    const int threads = std::min(kMaxThreads, (oo + 31) / 32 * 32);
    const dim3 grid(num_rois, (channels + kGroup - 1) / kGroup);
    if (dtype == 0) {
      roi_align_backward_kernel<float><<<grid, threads, 0, st>>>(
          lv, offs, num_images, channels, boxes, batch_idx, levels,
          output_size, sampling_ratio, aligned,
          static_cast<const float*>(grad), scratch);
    } else {
      roi_align_backward_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
          lv, offs, num_images, channels, boxes, batch_idx, levels,
          output_size, sampling_ratio, aligned,
          static_cast<const __nv_bfloat16*>(grad), scratch);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (dtype == 1) {
    const long long blocks = std::min<long long>(
        (scratch_elems + 255) / 256, 132LL * 16);
    cast_bf16_kernel<<<(unsigned)blocks, 256, 0, st>>>(
        scratch, static_cast<__nv_bfloat16*>(out_bf16), scratch_elems);
  }
  return (int)cudaGetLastError();
}
