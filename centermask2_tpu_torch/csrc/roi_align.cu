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
// Kernel 2b, the feature gradient, has no TPU kernel to replace: JAX
// computes the VJP in XLA as the separable transpose of the pool, two
// matmuls per level (ops/roi_align.py::_separable_feature_grad,
// :325-349): d[c, y, x] = sum_r sum_i sum_j Ay[r,i,y] Ax[r,j,x] g[r,c,i,j].
// Bound on this card: reading g and writing the level gradients once
// (bytes); at the training step's R = 256, C = 256, o = 14, s = 2 that is
// ~64 MB in bf16, ~19 us. A scatter of every sample's 4 taps with atomics
// collides wherever the samples of small or stacked ROIs share a pixel
// and needs a zeroed f32 scratch and a cast pass. This kernel gathers
// instead: each level pixel is summed by one thread at a time, over the
// ROIs that reach it, in ascending ROI order, so its sums come out in a
// fixed order, the same on every run. No global atomics, no scratch, no
// memset, no cast pass.
//  - prepass (roi_prepass_kernel, a block per ROI): the ROI's level and
//    image, clamped as kernel 2 clamps them; its axis tables from
//    fill_axes (so a tap the forward reads is the tap the backward
//    writes), stored with plain row and column taps; its tap window, the
//    first and last row and column that an in-range sample's low or high
//    tap reaches (empty where no sample is in range); and whether its g
//    has a nonzero value (the padded rows of a training step are zero,
//    and add nothing).
//  - main kernel: a block owns a kTileY x kTileX tile of one level of one
//    image and kBwdGroup channels. It tests every window and flag against
//    its tile (a ballot and a prefix sum per round of kBwdThreads ROIs)
//    and lists the hits in ascending order. The ROIs of the list are
//    staged with cp.async into two shared buffers (axis tables, g slice),
//    the next while the current one is summed. Per ROI the block builds
//    the dense pooling weights of the tile's columns and rows (bin x
//    pixel, the s samples of a bin added up) with each pixel's range of
//    bins, then transposes the pool separably over those ranges:
//    T[i][x] = sum_j wx[j][x] g[i][j], then D[y][x] += sum_i wy[i][y]
//    T[i][x]. The runs are short (one or two bins a pixel for large ROIs,
//    at most o for tiny ones), so the work follows the pixels the ROIs
//    reach and not the samples that collide on them.
//  - D lives in shared memory, zeroed at the block's first ROI; each tile
//    pixel is stored once, in the features' dtype, times 1/(s*s). A tile
//    that lists no ROI stores zeros.
// The per-level fields of the parameters are read with constant indices:
// an array parameter indexed by a variable is copied to every thread's
// stack, local-memory traffic in every block, empty tiles included.

// Rounding follows the JAX formulas (not detectron2's) as XLA evaluates
// them, divisions by a constant being products with its f32 reciprocal:
// sample grid y0 + ((i + 0.5) * (1/s)) * (roi_h * (1/o)), taps zero
// outside [-1, H], clamped to [0, H-1], high tap min(low + 1, H - 1), taps
// combined as ((w1 v1 + w2 v2) + w3 v3) + w4 v4 with w1 = hy * hx, ...,
// samples summed in (iy, ix) order, bin mean as the sum times 1/(s*s).
// Every product and sum is an explicit _rn intrinsic, so no FMA
// contraction changes it; the plain PyTorch version does the same f32
// operations. Kernel 2b takes the same sample coordinates and taps and
// sums in its own fixed order; the plain VJP sums in einsum order.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kMaxSamples = 64;  // o * s along one axis
constexpr int kGroup = 4;        // channels per block
constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// kernel 2b: a block owns a kTileY x kTileX tile (a row of 32 bf16 stores
// is 64 B) and kBwdGroup channels, and tests kBwdThreads ROIs a round
constexpr int kTileY = 16;
constexpr int kTileX = 32;
constexpr int kBwdGroup = 8;
constexpr int kBwdThreads = 256;

struct Levels {
  const void* ptr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float scale[kMaxLevels];
  int num;
};

// One axis of a ROI's sample grid: taps as offsets (y: row * row_stride,
// x: col).
struct Axis {
  int lo[kMaxSamples];
  int hi[kMaxSamples];
  float l[kMaxSamples];  // weight of the high tap
  float h[kMaxSamples];  // weight of the low tap
  unsigned char ok[kMaxSamples];
};

// Element offset of each level in kernel 2b's output buffer.
struct LevelOffsets {
  long long v[kMaxLevels];
};

// Kernel 2b's prepass record of one ROI: clamped level and image, and its
// tap window (y0 > y1 and x0 > x1 where no sample is in range).
struct Window {
  int level, image, y0, y1, x0, x1;
};

// Kernel 2b's axis tables of one ROI, as the prepass stores them (taps
// as plain rows and columns); 16-byte aligned for the cp.async copies.
struct __align__(16) RoiAxes {
  Axis y, x;
};

// Kernel 2b's grid: blocks [start[l], start[l+1]) cover level l, image by
// image, each image's tiles row by row, nx[l] tiles to a row.
struct Tiles {
  int start[kMaxLevels + 1];
  int nx[kMaxLevels];
  int per_image[kMaxLevels];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Fills the ROI's two axis tables (entry k < o*s of the y table, then of
// the x table), y taps as row * row_stride; the caller synchronises the
// block afterwards.
__device__ __forceinline__ void fill_axes(const Levels& lv, int l,
                                          const float* __restrict__ boxes,
                                          int r, int o, int s, int aligned,
                                          int row_stride, Axis& ay,
                                          Axis& ax) {
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
    const int stride = is_x ? 1 : row_stride;
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
  fill_axes(lv, l, boxes, r, o, s, aligned, W, ay, ax);
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

// The weight of sample k's taps on p: both count where they coincide at
// the border (hi = min(lo + 1, size - 1)).
__device__ __forceinline__ float tap_weight(const Axis& a, int k, int p) {
  return __fadd_rn(a.lo[k] == p ? a.h[k] : 0.f, a.hi[k] == p ? a.l[k] : 0.f);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Kernel 2b's prepass, a block of kBwdThreads per ROI: its Window, its
// axis tables (taps as plain rows and columns) into axes[r], and whether
// its gradient has a nonzero value (flags[r]: the rows of padded ROIs are
// zero, and a ROI whose gradient is zero adds nothing); axes, grad and
// flags may be null.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    roi_prepass_kernel(Levels lv, int num_images, int channels,
                       const float* __restrict__ boxes,
                       const int32_t* __restrict__ batch_idx,
                       const int32_t* __restrict__ levels, int o, int s,
                       int aligned, const T* __restrict__ grad,
                       Window* __restrict__ win, RoiAxes* __restrict__ axes,
                       unsigned char* __restrict__ flags) {
  __shared__ RoiAxes tab;
  __shared__ int ext[4];
  const int r = blockIdx.x;
  const int l = min(max(__ldg(levels + r), 0), lv.num - 1);
  const int b = min(max(__ldg(batch_idx + r), 0), num_images - 1);
  fill_axes(lv, l, boxes, r, o, s, aligned, 1, tab.y, tab.x);
  __syncthreads();
  const int pts = o * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0: rows, warp 1: columns
    const Axis& a = warp ? tab.x : tab.y;
    int first = INT_MAX, last = -1;
    for (int k = lane; k < pts; k += 32) {
      if (a.ok[k]) {
        first = min(first, a.lo[k]);
        last = max(last, a.hi[k]);
      }
    }
    first = __reduce_min_sync(kFull, first);
    last = __reduce_max_sync(kFull, last);
    if (lane == 0) {
      ext[2 * warp] = first;
      ext[2 * warp + 1] = last;
    }
  }
  if (axes != nullptr) {
    const int4* src = reinterpret_cast<const int4*>(&tab);
    int4* dst = reinterpret_cast<int4*>(axes + r);
    for (int i = threadIdx.x; i < (int)(sizeof(RoiAxes) / 16);
         i += blockDim.x) {
      dst[i] = src[i];
    }
  }
  bool nz = false;
  if (flags != nullptr) {  // 16-byte loads between a scalar head and tail
    const size_t n = (size_t)channels * o * o;
    const T* g = grad + (size_t)r * n;
    const size_t lead = ((16 - ((uintptr_t)g & 15)) & 15) / sizeof(T);
    const size_t head = lead < n ? lead : n;
    const size_t vecs = (n - head) * sizeof(T) / 16;
    const int4* v = reinterpret_cast<const int4*>(g + head);
    for (size_t i = threadIdx.x; i < head; i += blockDim.x) {
      nz |= load(g + i) != 0.f;
    }
#pragma unroll 8
    for (size_t i = threadIdx.x; i < vecs; i += blockDim.x) {
      const int4 q = __ldg(v + i);
      // a value is zero where its bits are +0 or -0
      const int m = sizeof(T) == 2 ? 0x7fff7fff : 0x7fffffff;
      nz |= ((q.x & m) | (q.y & m) | (q.z & m) | (q.w & m)) != 0;
    }
    for (size_t i = head + vecs * 16 / sizeof(T) + threadIdx.x; i < n;
         i += blockDim.x) {
      nz |= load(g + i) != 0.f;
    }
  }
  nz = __syncthreads_or(nz);
  if (flags != nullptr && threadIdx.x == 0) flags[r] = nz;
  if (threadIdx.x == 0) {
    Window w{l, b, 0, -1, 0, -1};
    if (ext[1] >= 0 && ext[3] >= 0) {  // a sample in range on both axes
      w.y0 = ext[0];
      w.y1 = ext[1];
      w.x0 = ext[2];
      w.x1 = ext[3];
    }
    win[r] = w;
  }
}

// Element (y, x, c) of a block's tile sums: c innermost, swizzled by x so
// that a warp reading one channel of 32 columns hits 32 banks.
__device__ __forceinline__ int tile_index(int y, int x, int c) {
  return (y * kTileX + x) * kBwdGroup + (c ^ ((x >> 2) & (kBwdGroup - 1)));
}

// Bytes of one staged gradient slice: kBwdGroup channels of o*o values,
// copied in aligned 4-byte words (one more word where the slice starts
// mid-word), rounded up to 16.
__host__ __device__ __forceinline__ int slice_bytes(int oo, int elt) {
  return (kBwdGroup * oo * elt + 4 + 15) / 16 * 16;
}

// Kernel 2b's main kernel, grid (tiles.start[num levels], ceil(C /
// kBwdGroup)), kBwdThreads threads. Dynamic shared memory: D (kTileY x
// kTileX x kBwdGroup f32), T (o x kTileX x kBwdGroup f32), the ROI's
// pooling weights on the tile's columns and rows (o x kTileX and o x
// kTileY f32), then nbuf buffers each of one ROI's axis tables and its
// gradient slice, staged with cp.async; with two, ROI e + 1 is copied
// while ROI e is summed. out + offs.v[l] is level l's (images, channels,
// H, W).
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    roi_align_backward_kernel(Levels lv, LevelOffsets offs, Tiles tiles,
                              int channels, const Window* __restrict__ win,
                              const RoiAxes* __restrict__ axes,
                              const unsigned char* __restrict__ flags,
                              int num_rois, int o, int s, int nbuf,
                              const T* __restrict__ grad,
                              T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int list[kBwdThreads];
  __shared__ int4 list_win[kBwdThreads];  // y0, y1, x0, x1 of each entry
  __shared__ int warp_hits[kBwdThreads / 32];
  // per tile column and row, by ROI parity: first and last bin with a
  // nonzero pooling weight on it
  __shared__ int jx0[2][kTileX], jx1[2][kTileX], jy0[2][kTileY],
      jy1[2][kTileY];

  // the block's level, image and tile; the per-level fields are picked
  // with constant indices (a parameter array indexed by a variable is
  // copied to every thread's stack)
  int l = 0, t = blockIdx.x, per_image = 1, nx = 1, H = 1, W = 1;
  long long level_off = 0;
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < lv.num && t >= tiles.start[i]) l = i;
  }
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i) {
    if (i == l) {
      t -= tiles.start[i];
      per_image = tiles.per_image[i];
      nx = tiles.nx[i];
      H = lv.h[i];
      W = lv.w[i];
      level_off = offs.v[i];
    }
  }
  const int b = t / per_image;
  t -= b * per_image;
  const int ty = t / nx;
  const int y0 = ty * kTileY;
  const int x0 = (t - ty * nx) * kTileX;
  const int ylast = min(y0 + kTileY, H) - 1, xlast = min(x0 + kTileX, W) - 1;
  const int c0 = blockIdx.y * kBwdGroup;
  const int nc = min(kBwdGroup, channels - c0);
  const int oo = o * o;
  const int sbytes = slice_bytes(oo, sizeof(T));
  float* acc = reinterpret_cast<float*>(smem);   // tile_index(y, x, c)
  float* tx = acc + kTileY * kTileX * kBwdGroup;  // [i][x][c]
  float* wx = tx + o * kTileX * kBwdGroup;        // [j][x]
  float* wy = wx + o * kTileX;                    // [i][y]
  RoiAxes* tab = reinterpret_cast<RoiAxes*>(wy + o * kTileY);
  unsigned char* slices = reinterpret_cast<unsigned char*>(tab + nbuf);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < kTileX) {
    jx0[0][tid] = o;
    jx1[0][tid] = -1;
  } else if (tid < kTileX + kTileY) {
    jy0[0][tid - kTileX] = o;
    jy1[0][tid - kTileX] = -1;
  }

  // cp.async of ROI r's axis tables and gradient slice into buffer buf;
  // returns the slice's first element in the buffer
  const size_t gend = (size_t)num_rois * channels * oo * sizeof(T);
  auto stage = [&](int r, int buf) -> const T* {
    const int4* src = reinterpret_cast<const int4*>(axes + r);
    int4* dst = reinterpret_cast<int4*>(tab + buf);
    for (int i = tid; i < (int)(sizeof(RoiAxes) / 16); i += kBwdThreads) {
      __pipeline_memcpy_async(dst + i, src + i, 16);
    }
    const size_t e0 = ((size_t)r * channels + c0) * oo * sizeof(T);
    const size_t e1 = e0 + (size_t)nc * oo * sizeof(T);
    const char* gb = reinterpret_cast<const char*>(grad);
    unsigned char* d = slices + (size_t)buf * sbytes;
    if (((e0 | e1) & 15) == 0) {  // 16-byte copies
      for (size_t w = e0 + 16 * (size_t)tid; w < e1; w += 16 * kBwdThreads) {
        __pipeline_memcpy_async(d + (w - e0), gb + w, 16);
      }
      __pipeline_commit();
      return reinterpret_cast<const T*>(d);
    }
    const size_t w0 = e0 & ~(size_t)3;
    for (size_t w = w0 + 4 * (size_t)tid; w < e1; w += 4 * kBwdThreads) {
      // the last word of the gradient may end past it: zero-fill that part
      __pipeline_memcpy_async(d + (w - w0), gb + w, 4,
                              w + 4 > gend ? w + 4 - gend : 0);
    }
    __pipeline_commit();
    return reinterpret_cast<const T*>(d + (e0 - w0));
  };

  int done = 0;  // ROIs summed in earlier rounds: the parity of the ranges
  for (int base = 0; base < num_rois; base += kBwdThreads) {
    // this round's ROIs whose window meets the tile and whose gradient
    // has a nonzero value, in ascending order
    bool hit = false;
    Window w{};
    const int r = base + tid;
    if (r < num_rois) {
      w = win[r];
      hit = w.level == l && w.image == b && w.y0 <= ylast && w.y1 >= y0 &&
            w.x0 <= xlast && w.x1 >= x0 && flags[r];
    }
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int pos = 0, n = 0;
#pragma unroll
    for (int v = 0; v < kBwdThreads / 32; ++v) {
      pos += v < warp ? warp_hits[v] : 0;
      n += warp_hits[v];
    }
    if (hit) {
      pos += __popc(ballot & ((1u << lane) - 1u));
      list[pos] = r;
      list_win[pos] = make_int4(w.y0, w.y1, w.x0, w.x1);
    }
    __syncthreads();

    const T* next = n > 0 ? stage(list[0], 0) : nullptr;
    for (int e = 0; e < n; ++e) {
      const int buf = nbuf == 2 ? e & 1 : 0, set = (done + e) & 1;
      const T* gs = next;
      if (nbuf == 1 && e > 0) gs = stage(list[e], 0);
      if (done + e == 0) {  // the block's first ROI: D starts at zero
        float4* a4 = reinterpret_cast<float4*>(acc);
        for (int i = tid; i < kTileY * kTileX * kBwdGroup / 4;
             i += kBwdThreads) {
          a4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      __pipeline_wait_prior(0);
      __syncthreads();
      if (nbuf == 2 && e + 1 < n) next = stage(list[e + 1], buf ^ 1);
      const int4 wr = list_win[e];
      const int xa = max(wr.z, x0) - x0, xb = min(wr.w, xlast) - x0;
      const int ya = max(wr.x, y0) - y0, yb = min(wr.y, ylast) - y0;
      // the next ROI's bin ranges start empty
      if (tid < kTileX) {
        jx0[set ^ 1][tid] = o;
        jx1[set ^ 1][tid] = -1;
      } else if (tid < kTileX + kTileY) {
        jy0[set ^ 1][tid - kTileX] = o;
        jy1[set ^ 1][tid - kTileX] = -1;
      }

      // the pooling weight of bin j on tile column x (and of bin i on row
      // y): the sum of its s samples' tap weights, and each pixel's first
      // and last bin of nonzero weight (shared-memory min and max: the
      // same result in any order)
      {
        const Axis& ax = tab[buf].x;
        const Axis& ay = tab[buf].y;
        for (int it = tid; it < o * (kTileX + kTileY); it += kBwdThreads) {
          const bool is_x = it < o * kTileX;
          const int q = is_x ? it : it - o * kTileX;
          const int j = is_x ? q / kTileX : q / kTileY;
          const int p = is_x ? q % kTileX : q % kTileY;
          if (is_x ? p < xa || p > xb : p < ya || p > yb) continue;
          const Axis& a = is_x ? ax : ay;
          const int pabs = (is_x ? x0 : y0) + p;
          float v = 0.f;
          for (int k = j * s; k < j * s + s; ++k) {
            if (a.ok[k]) v = __fadd_rn(v, tap_weight(a, k, pabs));
          }
          (is_x ? wx : wy)[q] = v;
          if (v != 0.f) {
            atomicMin(is_x ? &jx0[set][p] : &jy0[set][p], j);
            atomicMax(is_x ? &jx1[set][p] : &jy1[set][p], j);
          }
        }
      }
      __syncthreads();

      // columns (x, c) of the window in the tile: 2^lg threads a row
      const int span = (xb - xa + 1) * kBwdGroup;
      int lg = 3;
      while ((1 << lg) < span) ++lg;
      const int u = tid & ((1 << lg) - 1);
      const int c = u & (kBwdGroup - 1);
      const int x = xa + (u >> 3);
      const int step = kBwdThreads >> lg;

      // T[i][x] = sum over the bins j of column x of wx[j][x] g[i][j], for
      // the bins i of the tile rows
      if (u < span) {
        int i0 = o, i1 = -1;
        for (int y = ya; y <= yb; ++y) {
          i0 = min(i0, jy0[set][y]);
          i1 = max(i1, jy1[set][y]);
        }
        const int ja = c < nc ? jx0[set][x] : o, jb = jx1[set][x];
        for (int i = i0 + (tid >> lg); i <= i1; i += step) {
          const T* gr = gs + c * oo + i * o;
          float v = 0.f;
#pragma unroll 4
          for (int j = ja; j <= jb; ++j) {
            v = __fadd_rn(v, __fmul_rn(wx[j * kTileX + x], to_float(gr[j])));
          }
          tx[(i * kTileX + x) * kBwdGroup + c] = v;
        }
      }
      __syncthreads();

      // D[y][x] += sum over the bins i of row y of wy[i][y] T[i][x]; the
      // next ROI's first barrier orders these reads before its writes
      if (u < span) {
        for (int y = ya + (tid >> lg); y <= yb; y += step) {
          const int ia = jy0[set][y], ib = jy1[set][y];
          if (ia > ib) continue;
          float v = 0.f;
#pragma unroll 4
          for (int i = ia; i <= ib; ++i) {
            v = __fadd_rn(v, __fmul_rn(wy[i * kTileY + y],
                                       tx[(i * kTileX + x) * kBwdGroup + c]));
          }
          float& d = acc[tile_index(y, x, c)];
          d = __fadd_rn(d, v);
        }
      }
    }
    done += n;
    __syncthreads();
  }

  // each pixel once, times the bin mean's 1/(s*s); zeros where the block
  // listed no ROI. A thread owns column lane of rows warp + 8m.
  const float inv_ss = __fdiv_rn(1.f, (float)(s * s));
  const size_t plane = (size_t)H * W;
  if (x0 + lane <= xlast) {
    T* o0 = out + level_off + ((size_t)b * channels + c0) * plane +
            (size_t)y0 * W + x0 + lane;
    for (int y = warp; y < kTileY && y0 + y <= ylast;
         y += kBwdThreads / 32) {
      T* dst = o0 + (size_t)y * W;
      for (int c = 0; c < nc; ++c, dst += plane) {
        store(dst, done == 0 ? 0.f
                             : __fmul_rn(acc[tile_index(y, lane, c)], inv_ss));
      }
    }
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

namespace {

// Levels of kernel 2b's entries from the host arrays; false if a size is
// out of range.
bool fill_levels(const int* heights, const int* widths, const float* scales,
                 int num_levels, Levels& lv) {
  lv.num = num_levels;
  for (int i = 0; i < num_levels; ++i) {
    lv.ptr[i] = nullptr;
    lv.h[i] = heights[i];
    lv.w[i] = widths[i];
    lv.scale[i] = scales[i];
    if (lv.h[i] <= 0 || lv.w[i] <= 0) return false;
  }
  return true;
}

template <typename T>
cudaError_t launch_backward(const Levels& lv, const LevelOffsets& offs,
                            int num_images, int channels, const float* boxes,
                            const int32_t* batch_idx, const int32_t* levels,
                            int num_rois, int o, int s, int aligned,
                            const void* grad, Window* win, RoiAxes* axes,
                            unsigned char* flags, void* out,
                            cudaStream_t st) {
  const T* g = static_cast<const T*>(grad);
  if (num_rois > 0) {
    roi_prepass_kernel<T><<<num_rois, kBwdThreads, 0, st>>>(
        lv, num_images, channels, boxes, batch_idx, levels, o, s, aligned, g,
        win, axes, flags);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  Tiles tiles;
  tiles.start[0] = 0;
  for (int i = 0; i < lv.num; ++i) {
    tiles.nx[i] = (lv.w[i] + kTileX - 1) / kTileX;
    tiles.per_image[i] = tiles.nx[i] * ((lv.h[i] + kTileY - 1) / kTileY);
    tiles.start[i + 1] = tiles.start[i] + num_images * tiles.per_image[i];
  }
  // two staging buffers where they fit beside D and T, else one; the
  // kernel's static shared memory, the card's opt-in limit and the
  // dynamic size last allowed are looked up once per process
  static size_t static_smem = 0, optin = 0, allowed = 0;
  cudaError_t err;
  if (optin == 0) {
    cudaFuncAttributes attr;
    int dev = 0, v = 0;
    if ((err = cudaFuncGetAttributes(&attr, roi_align_backward_kernel<T>)) !=
            cudaSuccess ||
        (err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess) {
      return err;
    }
    static_smem = attr.sharedSizeBytes;
    optin = (size_t)v;
    allowed = 48 * 1024 - static_smem;  // the default budget
  }
  const size_t fixed = sizeof(float) * ((size_t)kTileY * kTileX * kBwdGroup +
                                        (size_t)o * kTileX * kBwdGroup +
                                        (size_t)o * (kTileX + kTileY));
  const size_t stage = sizeof(RoiAxes) + slice_bytes(o * o, sizeof(T));
  const size_t limit = optin - static_smem;
  const int nbuf = fixed + 2 * stage <= limit ? 2 : 1;
  const size_t smem = fixed + nbuf * stage;
  if (smem > limit) return cudaErrorInvalidValue;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(roi_align_backward_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid(tiles.start[lv.num], (channels + kBwdGroup - 1) / kBwdGroup);
  roi_align_backward_kernel<T><<<grid, kBwdThreads, smem, st>>>(
      lv, offs, tiles, channels, win, axes, flags, num_rois, o, s, nbuf, g,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// Kernel 2b: prepass, then the gather. dtype: 0 = float32, 1 = bfloat16
// (grad and the level gradients). heights/widths/scales/offsets are host
// arrays of num_levels entries; grad (R, channels, o, o) on the device;
// the prepass fills three device tables of num_rois entries: windows (6
// int32 each), axes (sizeof(RoiAxes) = 2176 bytes each, 16-byte aligned)
// and flags (one byte each); out holds every level's
// (num_images, channels, h, w), level l at element offsets[l], each
// element written once. Returns cudaGetLastError() after each launch.
extern "C" int cm2_roi_align_backward(
    int dtype, const void* grad, const int* heights, const int* widths,
    const float* scales, const long long* offsets, int num_levels,
    int num_images, int channels, const float* boxes,
    const int32_t* batch_idx, const int32_t* levels, int num_rois,
    int output_size, int sampling_ratio, int aligned, void* windows,
    void* axes, void* flags, void* out, void* stream) {
  Levels lv;
  if (num_levels <= 0 || num_levels > kMaxLevels || num_images <= 0 ||
      channels <= 0 || num_rois < 0 || output_size <= 0 ||
      sampling_ratio <= 0 || output_size * sampling_ratio > kMaxSamples ||
      (dtype != 0 && dtype != 1) || out == nullptr ||
      (num_rois > 0 && (windows == nullptr || axes == nullptr ||
                        flags == nullptr || grad == nullptr)) ||
      !fill_levels(heights, widths, scales, num_levels, lv)) {
    return (int)cudaErrorInvalidValue;
  }
  LevelOffsets offs;
  for (int i = 0; i < num_levels; ++i) offs.v[i] = offsets[i];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Window* win = static_cast<Window*>(windows);
  RoiAxes* ax = static_cast<RoiAxes*>(axes);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  return (int)(dtype == 0
                   ? launch_backward<float>(lv, offs, num_images, channels,
                                            boxes, batch_idx, levels,
                                            num_rois, output_size,
                                            sampling_ratio, aligned, grad,
                                            win, ax, fl, out, st)
                   : launch_backward<__nv_bfloat16>(
                         lv, offs, num_images, channels, boxes, batch_idx,
                         levels, num_rois, output_size, sampling_ratio,
                         aligned, grad, win, ax, fl, out, st));
}

// Kernel 2b's prepass alone, its windows only, for checking the table:
// windows receives num_rois > 0 Windows. Returns cudaGetLastError() after
// the launch.
extern "C" int cm2_roi_tap_windows(const int* heights, const int* widths,
                                   const float* scales, int num_levels,
                                   int num_images, const float* boxes,
                                   const int32_t* batch_idx,
                                   const int32_t* levels, int num_rois,
                                   int output_size, int sampling_ratio,
                                   int aligned, void* windows, void* stream) {
  Levels lv;
  if (num_levels <= 0 || num_levels > kMaxLevels || num_images <= 0 ||
      num_rois <= 0 || output_size <= 0 || sampling_ratio <= 0 ||
      output_size * sampling_ratio > kMaxSamples || windows == nullptr ||
      !fill_levels(heights, widths, scales, num_levels, lv)) {
    return (int)cudaErrorInvalidValue;
  }
  roi_prepass_kernel<float>
      <<<num_rois, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          lv, num_images, 1, boxes, batch_idx, levels, output_size,
          sampling_ratio, aligned, nullptr, static_cast<Window*>(windows),
          nullptr, nullptr);
  return (int)cudaGetLastError();
}
