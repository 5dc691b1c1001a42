// Exact greedy NMS keep mask over score-sorted boxes, for Hopper (sm_90a).
//
// Replaces: centermask2_tpu/ops/nms_pallas.py::_kernel (launched by
// greedy_keep_sorted). Same function: the keep mask over the sorted order
// that the sequential greedy loop gives, with IoU > thr decided in f32 in
// the operation order of structures/boxes.py::pairwise_iou (0 when the
// union is <= 0). Bit-identical to the greedy loop.
//
// Bound on this card: neither bytes nor operations. At the main path's
// N = 1024 the inputs are 16 KB of boxes and the N^2/2 IoU tests about
// 7 M f32 operations: both bounds are well under a microsecond. What costs
// is the greedy scan's chain of dependent decisions (N of them), each
// 64-box block's propagation loads, and launch latency.
//
// Design. The TPU kernel sweeps 128-box tiles in order and settles each
// tile by a fixpoint on the matrix unit. Here:
//  1. nms_mask_kernel: one parallel launch fills the upper-triangle
//     overlap bitmask, N x ceil(N/64) u64 words (128 KB at N = 1024) in
//     scratch the wrapper allocates: block (col, row, image) tests 64 row
//     boxes against 64 column boxes held in shared memory.
//  2. nms_scan_kernel: one block per image runs the greedy scan with the
//     "removed" words in shared memory. Per 64-box block, thread 0 settles
//     the block serially from its diagonal word (prefetched to shared
//     memory by 64 threads at once), then all threads OR the kept rows
//     into the later words in parallel. The dependent chain is N steps of
//     shared-memory work, not N global-memory round trips.
//
// Rounding: the IoU uses __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, and the
// file is built with -fmad=false, so no a*b+c is contracted into an FMA
// and every keep decision matches the XLA/PyTorch f32 arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWord = 64;                 // boxes per bitmask word
constexpr int kMaxN = 8192;               // as MAX_PALLAS_N on the TPU
constexpr int kMaxWords = kMaxN / kWord;  // 128
constexpr int kScanThreads = 128;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// pairwise_iou(a, b) > thr, in structures/boxes.py's f32 order.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b,
                                         float area_b, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
  return iou > thr;
}

// mask[b, i, w] bit k: box i overlaps later box w*64+k.
// grid (words, words, batch), 64 threads; lower-triangle blocks exit.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes, int n,
                                int words, float thr,
                                unsigned long long* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_block < row_block) return;
  const float4* bx = boxes + (size_t)blockIdx.z * n;
  __shared__ float4 col_box[kWord];
  __shared__ float col_area[kWord];
  const int t = threadIdx.x;
  const float4 c = bx[col_block * kWord + t];
  col_box[t] = c;
  col_area[t] = box_area(c);
  __syncthreads();

  const int i = row_block * kWord + t;
  const float4 a = bx[i];
  const float area_a = box_area(a);
  unsigned long long bits = 0ull;
  for (int k = (row_block == col_block) ? t + 1 : 0; k < kWord; ++k) {
    if (overlaps(a, area_a, col_box[k], col_area[k], thr)) bits |= 1ull << k;
  }
  mask[((size_t)blockIdx.z * n + i) * words + col_block] = bits;
}

// One block per image: the greedy scan over the bitmask.
__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const uint8_t* __restrict__ valid, int n,
                                int words, uint8_t* __restrict__ keep) {
  __shared__ unsigned long long removed[kMaxWords];
  __shared__ unsigned long long diag[kWord];
  __shared__ unsigned long long kept_bits;
  const int b = blockIdx.x;
  const unsigned long long* m = mask + (size_t)b * n * words;
  const uint8_t* vb = valid + (size_t)b * n;
  uint8_t* kb = keep + (size_t)b * n;

  // invalid boxes are never kept and never suppress: start them removed
  for (int w = threadIdx.x; w < words; w += blockDim.x) {
    unsigned long long inv = 0ull;
    for (int k = 0; k < kWord; ++k) {
      if (!vb[w * kWord + k]) inv |= 1ull << k;
    }
    removed[w] = inv;
  }
  __syncthreads();

  for (int cb = 0; cb < words; ++cb) {
    if (threadIdx.x < kWord) {
      diag[threadIdx.x] = m[(size_t)(cb * kWord + threadIdx.x) * words + cb];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long rem = removed[cb];
      unsigned long long kept = 0ull;
      for (int k = 0; k < kWord; ++k) {
        if (!((rem >> k) & 1ull)) {
          kept |= 1ull << k;
          rem |= diag[k];
        }
      }
      kept_bits = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_bits;
    if (threadIdx.x < kWord) {
      kb[cb * kWord + threadIdx.x] = (uint8_t)((kept >> threadIdx.x) & 1ull);
    }
    for (int w = cb + 1 + threadIdx.x; w < words; w += blockDim.x) {
      unsigned long long acc = 0ull;
      unsigned long long kk = kept;
      while (kk) {
        const int k = __ffsll((long long)kk) - 1;
        kk &= kk - 1;
        acc |= m[(size_t)(cb * kWord + k) * words + w];
      }
      removed[w] |= acc;
    }
    __syncthreads();
  }
}

}  // namespace

// boxes (batch, n, 4) f32 sorted by descending score, 16-byte aligned;
// valid/keep (batch, n) bytes 0/1; mask scratch batch*n*(n/64) u64.
// n % 64 == 0 and n <= 8192. Returns cudaGetLastError() after the launches.
extern "C" int cm2_nms_keep_sorted(const float* boxes, const uint8_t* valid,
                                   uint8_t* keep, unsigned long long* mask,
                                   int batch, int n, float thr, void* stream) {
  if (batch <= 0 || n <= 0 || n % kWord != 0 || n > kMaxN) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = n / kWord;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, batch), kWord, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), n, words, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<batch, kScanThreads, 0, s>>>(mask, valid, n, words, keep);
  return (int)cudaGetLastError();
}
