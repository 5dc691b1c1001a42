// GroupNorm followed by ReLU over channels-last maps, for Hopper (sm_90a):
// kernel 3, the FCOS towers' norm (models/fcos/head.py::Tower).
//
// Replaces no TPU kernel: the JAX package normalizes with flax's
// GroupNorm in XLA (centermask2_tpu/layers/blocks.py:138), which fuses it
// with the ReLU after it. The port's plain version
// (ops/group_norm.py::group_norm_relu_plain) is the chain the tower ran
// before: the bf16 map cast to f32, aten's group_norm (moments, then
// apply), the cast back, the ReLU, each a pass over device memory, and
// aten's CUDA group_norm takes NCHW only, so cuDNN transposed every tower
// conv's input to NHWC and its output back.
//
// Semantics: x (N, H, W, C) contiguous (a channels-last (N, C, H, W)
// tensor), f32 or bf16; G groups of C / G neighbouring channels; f32 mean
// and biased variance per (sample, group) over H * W * C / G values;
// y = relu(x * scale + shift) with scale = gamma * rstd, shift = beta -
// mean * scale, rstd = 1 / sqrt(var + eps), rounded once to x's dtype
// (round to nearest even). A group of one value equals its mean, so its
// output is beta exactly (scale 0), as layers/blocks.py::GroupNorm
// returns it.
//
// Bound on this card: bytes. A normalization does a few operations a
// value; the least it can move is the map read once and written once,
// 38.5 MB a tower layer of a 1344x1344 request in bf16 (all five
// levels), ~11.5 us at HBM speed. This design reads the map twice
// (statistics, then apply), 58 MB, ~17 us; the re-read is mostly L2
// hits: the largest level is 14.4 MB of the card's 50 MB L2. The design:
//  - one call covers every level of a tower layer (the layer's weights are
//    shared across FPN levels): the levels' pointers travel by value in
//    the kernel's parameters, and each launch's blocks are cut from all
//    levels, so the small levels (P5-P7) ride along with P3 instead of
//    each paying a launch of a few blocks;
//  - every thread owns one 16-byte vector of channels (8 bf16 or 4 f32)
//    at fixed channel offset, so a warp reads whole position rows of C
//    values, coalesced; a block of kThreads covers kThreads / (C / V)
//    positions a step and holds kItems steps in registers, all loads in
//    flight before any arithmetic;
//  - statistics (gn_stats_kernel): each thread takes the exact mean of its
//    kItems values per channel, then their squared deviations from it
//    (two passes over registers, no cancellation); the block merges its
//    rows per channel and its channels per group with Chan's formula and
//    writes one (mean, M2) pair a group: ~600 blocks at 1344x1344 and
//    ~300 at 800x1088 fill the card's 132 SMs at batch 1, where aten's
//    moments kernel ran one block per (sample, group), 32 blocks;
//  - finalize (gn_finalize_kernel, a block per level, sample and group):
//    the blocks' pairs read twice, the mean from their weighted means,
//    then M2 as their M2 plus their means' squared distance from it, each
//    summed in a fixed order (threads, then warp trees, then warps), so
//    every run sums alike (no atomics) and no sum cancels; gamma and beta
//    fold into a per-channel scale and shift;
//  - apply (gn_apply_relu_kernel): the statistics kernel's blocks again,
//    each thread with its channels' scale and shift in registers: one FMA,
//    the ReLU and the rounding a value, 16-byte stores.
// Workspace (the pairs and the scale/shift rows) comes from the caller
// (PyTorch's caching allocator); every kernel runs on the caller's stream,
// so a CUDA graph captures the three launches as they are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // statistics and apply blocks
constexpr int kItems = 8;           // positions a thread holds in registers
constexpr int kFinalThreads = 256;  // finalize: a block per group
constexpr int kMaxLevels = 8;
constexpr int kMaxVec = 8;          // values in a 16-byte vector (bf16)

struct Levels {
  const void* x[kMaxLevels];
  void* y[kMaxLevels];
  int positions[kMaxLevels];      // H * W
  int chunks[kMaxLevels];         // blocks a sample
  int first_block[kMaxLevels];    // the level's first block of a launch
  int levels, n, c, groups;
  int rows;                       // positions a block step: kThreads / (C/V)
};

// a block's level, sample and chunk; static indices into the parameters
struct Task {
  const void* x;
  void* y;
  int level, sample, chunk, positions, chunks, first;
};

__device__ __forceinline__ Task locate(const Levels& p, int block) {
  Task t{p.x[0], p.y[0], 0, 0, 0, p.positions[0], p.chunks[0],
         p.first_block[0]};
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i < p.levels && block >= p.first_block[i]) {
      t = Task{p.x[i], p.y[i], i, 0, 0, p.positions[i], p.chunks[i],
               p.first_block[i]};
    }
  }
  const int local = block - t.first;
  t.sample = local / t.chunks;
  t.chunk = local - t.sample * t.chunks;
  return t;
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void to_float(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 from_float(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // little-endian: the value at the lower address is the low half-word
  __device__ static void to_float(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 from_float(const float* f) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Chan's merge of (count, mean, M2) b into a
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  if (na == 0.f) {
    na = nb;
    ma = mb;
    m2a = m2b;
    return;
  }
  const float n = na + nb;
  const float d = mb - ma;
  const float w = nb / n;
  ma = fmaf(d, w, ma);
  m2a = m2a + m2b + d * d * na * w;
  na = n;
}

// The block's slice of the map: thread (row, slot) holds positions
// row + i * rows, i < kItems, of the chunk, channels slot * V ...
struct Slice {
  long long base;  // element offset of the chunk's first position, slot 0
  int row, slot, len;
  bool active;
};

template <typename T>
__device__ __forceinline__ Slice slice_of(const Levels& p, const Task& t) {
  constexpr int V = Vec<T>::kN;
  const int vecs = p.c / V;
  Slice s;
  s.slot = threadIdx.x % vecs;
  s.row = threadIdx.x / vecs;
  s.active = s.row < p.rows;
  const int chunk_len = kItems * p.rows;
  const int pos0 = t.chunk * chunk_len;
  s.len = min(chunk_len, t.positions - pos0);
  s.base = ((long long)t.sample * t.positions + pos0) * p.c +
            (long long)s.slot * V;
  return s;
}

template <typename T>
__device__ __forceinline__ int load_items(const Levels& p, const T* x,
                                          const Slice& s, uint4* u) {
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = s.row + i * p.rows;
    if (s.active && q < s.len) {
      u[i] = *reinterpret_cast<const uint4*>(x + s.base + (long long)q * p.c);
      cnt = i + 1;
    }
  }
  return cnt;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const Levels p, float2* __restrict__ partials) {
  constexpr int V = Vec<T>::kN;
  __shared__ float s_mean[kThreads * kMaxVec];
  __shared__ float s_m2[kThreads * kMaxVec];
  __shared__ float s_cnt[kThreads];
  const Task t = locate(p, blockIdx.x);
  const Slice s = slice_of<T>(p, t);
  uint4 u[kItems];
  const int cnt = load_items<T>(p, static_cast<const T*>(t.x), s, u);

  float mean[V], m2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) mean[j] = m2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < cnt) {
      float f[V];
      Vec<T>::to_float(u[i], f);
#pragma unroll
      for (int j = 0; j < V; ++j) mean[j] += f[j];
    }
  }
  if (cnt > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) mean[j] = mean[j] / (float)cnt;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < cnt) {
      float f[V];
      Vec<T>::to_float(u[i], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - mean[j];
        m2[j] = fmaf(d, d, m2[j]);
      }
    }
  }
  if (s.active) {
    const int c0 = s.row * p.c + s.slot * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s_mean[c0 + j] = mean[j];
      s_m2[c0 + j] = m2[j];
    }
    if (s.slot == 0) s_cnt[s.row] = (float)cnt;
  }
  __syncthreads();
  // each channel over the rows, in row order; a row's count falls with
  // the row, so the first empty row ends the merge
  for (int c = threadIdx.x; c < p.c; c += kThreads) {
    float na = s_cnt[0], ma = s_mean[c], m2a = s_m2[c];
    for (int r = 1; r < p.rows && s_cnt[r] > 0.f; ++r) {
      chan_merge(na, ma, m2a, s_cnt[r], s_mean[r * p.c + c],
                 s_m2[r * p.c + c]);
    }
    s_mean[c] = ma;  // row 0 of channel c is read by this thread alone
    s_m2[c] = m2a;
  }
  __syncthreads();
  // the group's channels share one count: the chunk's positions
  const int cg = p.c / p.groups;
  for (int g = threadIdx.x; g < p.groups; g += kThreads) {
    float sum = 0.f;
    for (int j = 0; j < cg; ++j) sum += s_mean[g * cg + j];
    const float mg = sum / (float)cg;
    float m2g = 0.f;
    for (int j = 0; j < cg; ++j) {
      const float d = s_mean[g * cg + j] - mg;
      m2g += s_m2[g * cg + j] + d * d * (float)s.len;
    }
    partials[(long long)blockIdx.x * p.groups + g] = make_float2(mg, m2g);
  }
}

// The sum of every thread's v in a fixed order (warp trees, then the
// warps' sums in warp order): the same on every run.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // an earlier call's readers are done with red
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kFinalThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

__global__ void __launch_bounds__(kFinalThreads)
    gn_finalize_kernel(const Levels p, const float2* __restrict__ partials,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta, float eps,
                       float* __restrict__ scale_shift) {
  // block (level * n + sample, group)
  __shared__ float red[kFinalThreads / 32];
  const int level = blockIdx.x / p.n;
  const int sample = blockIdx.x - level * p.n;
  const int g = blockIdx.y;
  int positions = p.positions[0], chunks = p.chunks[0],
      first = p.first_block[0];
#pragma unroll
  for (int i = 1; i < kMaxLevels; ++i) {
    if (i == level) {
      positions = p.positions[i];
      chunks = p.chunks[i];
      first = p.first_block[i];
    }
  }
  first += sample * chunks;
  const int chunk_len = kItems * p.rows;
  const int cg = p.c / p.groups;
  const float total = (float)positions * cg;
  // the blocks' pairs, twice: the mean from their weighted means, then M2
  // as the blocks' M2 plus their means' squared distance from it
  float s = 0.f;
  for (int k = threadIdx.x; k < chunks; k += kFinalThreads) {
    const float nk = (float)(min(chunk_len, positions - k * chunk_len) * cg);
    s = fmaf(nk, partials[(long long)(first + k) * p.groups + g].x, s);
  }
  const float mean = block_sum(s, red) / total;
  float m2 = 0.f;
  for (int k = threadIdx.x; k < chunks; k += kFinalThreads) {
    const float nk = (float)(min(chunk_len, positions - k * chunk_len) * cg);
    const float2 pk = partials[(long long)(first + k) * p.groups + g];
    const float d = pk.x - mean;
    m2 += fmaf(nk * d, d, pk.y);
  }
  m2 = block_sum(m2, red);
  const float rstd = 1.f / sqrtf(fmaxf(m2 / total, 0.f) + eps);
  float* scale = scale_shift + (long long)blockIdx.x * 2 * p.c;
  float* shift = scale + p.c;
  for (int j = threadIdx.x; j < cg; j += kFinalThreads) {
    const int ch = g * cg + j;
    if (total == 1.f) {  // one value: its mean, so beta exactly
      scale[ch] = 0.f;
      shift[ch] = beta[ch];
    } else {
      const float sc = gamma[ch] * rstd;
      scale[ch] = sc;
      shift[ch] = beta[ch] - mean * sc;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_apply_relu_kernel(const Levels p,
                         const float* __restrict__ scale_shift) {
  constexpr int V = Vec<T>::kN;
  const Task t = locate(p, blockIdx.x);
  const Slice s = slice_of<T>(p, t);
  if (!s.active) return;
  uint4 u[kItems];
  const int cnt = load_items<T>(p, static_cast<const T*>(t.x), s, u);
  const float* row =
      scale_shift + ((long long)t.level * p.n + t.sample) * 2 * p.c +
      s.slot * V;
  float sc[V], sh[V];
#pragma unroll
  for (int j = 0; j < V; j += 4) {
    const float4 a = *reinterpret_cast<const float4*>(row + j);
    const float4 b = *reinterpret_cast<const float4*>(row + p.c + j);
    sc[j] = a.x, sc[j + 1] = a.y, sc[j + 2] = a.z, sc[j + 3] = a.w;
    sh[j] = b.x, sh[j + 1] = b.y, sh[j + 2] = b.z, sh[j + 3] = b.w;
  }
  T* y = static_cast<T*>(t.y);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (i < cnt) {
      float f[V];
      Vec<T>::to_float(u[i], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float v = fmaf(f[j], sc[j], sh[j]);
        f[j] = v < 0.f ? 0.f : v;  // NaN passes, as torch's relu
      }
      *reinterpret_cast<uint4*>(y + s.base +
                                (long long)(s.row + i * p.rows) * p.c) =
          Vec<T>::from_float(f);
    }
  }
}

// Fills the launch's parameters; false where the shapes are outside the
// kernels' reach.
bool plan(int dtype, int levels, const int* positions, int n, int c,
          int groups, Levels& p, long long& blocks) {
  if ((dtype != 0 && dtype != 1) || levels <= 0 || levels > kMaxLevels ||
      n <= 0 || c <= 0 || groups <= 0 || c % groups != 0) {
    return false;
  }
  const int v = dtype == 1 ? Vec<__nv_bfloat16>::kN : Vec<float>::kN;
  if (c % v != 0 || c / v > kThreads) return false;
  p.levels = levels;
  p.n = n;
  p.c = c;
  p.groups = groups;
  p.rows = kThreads / (c / v);
  const long long chunk_len = (long long)kItems * p.rows;
  blocks = 0;
  for (int i = 0; i < kMaxLevels; ++i) {
    p.x[i] = nullptr;
    p.y[i] = nullptr;
    p.positions[i] = p.chunks[i] = 0;
    p.first_block[i] = (int)blocks;
    if (i >= levels) continue;
    if (positions[i] <= 0) return false;
    p.positions[i] = positions[i];
    p.chunks[i] = (int)((positions[i] + chunk_len - 1) / chunk_len);
    blocks += (long long)n * p.chunks[i];
    if (blocks >= (1LL << 31)) return false;
  }
  return true;
}

}  // namespace

// The (mean, M2) pairs the statistics pass writes: one a group of each
// block, as float2; -1 where the shapes are outside the kernels' reach.
extern "C" long long cm2_group_norm_pairs(int dtype, int levels,
                                          const int* positions, int n, int c,
                                          int groups) {
  Levels p;
  long long blocks = 0;
  if (!plan(dtype, levels, positions, n, c, groups, p, blocks)) return -1;
  return blocks * groups;
}

// dtype 0 f32, 1 bf16; xs, ys: one (n, H, W, c) map a level; gamma, beta:
// (c,) f32; pairs: cm2_group_norm_pairs(...) float2; scale_shift:
// 2 * levels * n * c floats.
extern "C" int cm2_group_norm_relu(int dtype, int levels,
                                   const void* const* xs, void* const* ys,
                                   const int* positions, int n, int c,
                                   int groups, float eps, const float* gamma,
                                   const float* beta, void* pairs,
                                   float* scale_shift, void* stream) {
  Levels p;
  long long blocks = 0;
  if (!plan(dtype, levels, positions, n, c, groups, p, blocks) ||
      gamma == nullptr || beta == nullptr || pairs == nullptr ||
      scale_shift == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < levels; ++i) {
    if (xs[i] == nullptr || ys[i] == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    p.x[i] = xs[i];
    p.y[i] = ys[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* pr = static_cast<float2*>(pairs);
  const unsigned grid = (unsigned)blocks;
  if (dtype == 1) {
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p, pr);
  } else {
    gn_stats_kernel<float><<<grid, kThreads, 0, st>>>(p, pr);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize_kernel<<<dim3(levels * n, groups), kFinalThreads, 0, st>>>(
      p, pr, gamma, beta, eps, scale_shift);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1) {
    gn_apply_relu_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        p, scale_shift);
  } else {
    gn_apply_relu_kernel<float><<<grid, kThreads, 0, st>>>(p, scale_shift);
  }
  return (int)cudaGetLastError();
}
