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
// is the greedy scan's chain of N dependent decisions, which no amount of
// parallelism shortens, plus two launches: a practical floor of a few
// microseconds.
//
// Design. The TPU kernel sweeps 128-box tiles in order and settles each
// tile by a fixpoint on the matrix unit. Here:
//  1. nms_mask_kernel: one parallel launch fills the upper-triangle
//     overlap bitmask, N rows of `ws` u64 words (ceil(N/64) rounded up to
//     even, so that every row starts 16-byte aligned) in scratch the
//     wrapper allocates: block (col, row, image) tests 64 row boxes
//     against 64 column boxes held in shared memory, four threads a row.
//  2. nms_scan_kernel: one block per image runs the greedy scan strip by
//     strip (a strip: the 64 mask rows of one 64-box word, words >= its
//     own). No global-memory access sits on the dependent chain:
//     - each strip is staged in shared memory by cp.async 16-byte copies,
//       double-buffered: warps 1.. copy strip cb+1 while warp 0 settles
//       strip cb (two strips of 64 KB at N = 8192: dynamic shared memory);
//     - warp 0 settles the strip from its diagonal column, held in
//       registers: fixpoint rounds of two OR-reductions, one round when no
//       candidate of the strip overlaps another (a served request), else
//       the 64-step greedy loop as integer work;
//     - the kept rows are then ORed into every later word in parallel,
//       one warp per word, lanes over the 64 rows, an OR-reduce per
//       32-bit half; the work per strip does not depend on how many
//       boxes were kept;
//     - the "removed" and "kept" words stay in shared memory, and the
//       keep bytes are written once at the end, coalesced, 4 a thread.
//     Two barriers per strip.
//
// Rounding: the IoU uses __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, and the
// file is built with -fmad=false, so no a*b+c is contracted into an FMA
// and every keep decision matches the XLA/PyTorch f32 arithmetic.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kWord = 64;                 // boxes per bitmask word
constexpr int kMaxN = 8192;               // as MAX_PALLAS_N on the TPU
constexpr int kMaxWords = kMaxN / kWord;  // 128
constexpr int kMaskThreads = 256;         // four a row box
constexpr int kScanThreads = 512;         // 16 warps
constexpr int kRounds = 4;                // fixpoint rounds before the loop
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// mask[b, i, w] bit k: box i overlaps later box w*64+k; rows of ws words.
// grid (words, words, batch) of 256 threads, lower-triangle blocks exit:
// four threads a row box, each testing 16 of the 64 column boxes held in
// shared memory, their 16-bit parts joined by two shuffles.
__global__ void __launch_bounds__(kMaskThreads)
    nms_mask_kernel(const float4* __restrict__ boxes, int n, int ws,
                    float thr, u64* __restrict__ mask) {
  const int col_block = blockIdx.x;
  const int row_block = blockIdx.y;
  if (col_block < row_block) return;
  const float4* bx = boxes + (size_t)blockIdx.z * n;
  __shared__ float4 col_box[kWord];
  __shared__ float col_area[kWord];
  const int t = threadIdx.x;
  if (t < kWord) {
    const float4 c = bx[col_block * kWord + t];
    col_box[t] = c;
    col_area[t] = box_area(c);
  }
  __syncthreads();

  const int row = t >> 2;
  const int k0 = (t & 3) * 16;
  const int i = row_block * kWord + row;
  const float4 a = bx[i];
  const float area_a = box_area(a);
  unsigned bits = 0u;
  for (int k = (row_block == col_block) ? max(k0, row + 1) : k0; k < k0 + 16;
       ++k) {
    if (overlaps(a, area_a, col_box[k], col_area[k], thr)) {
      bits |= 1u << (k - k0);
    }
  }
  u64 word = (u64)bits << k0;
  word |= __shfl_xor_sync(kFull, word, 1);
  word |= __shfl_xor_sync(kFull, word, 2);
  if (k0 == 0) mask[((size_t)blockIdx.z * n + i) * ws + col_block] = word;
}

// Copy mask rows cb*64 .. cb*64+63, words (cb & ~1) .. ws-1, into `dst`
// (row stride ss words, each word at its own column index), by threads
// t = 0 .. nt-1 of the block.
__device__ __forceinline__ void stage_strip(const u64* __restrict__ m, int cb,
                                            int ws, int ss, u64* dst, int t,
                                            int nt) {
  const int w0 = cb & ~1;
  const int chunks = (ws - w0) >> 1;  // 16-byte chunks per row
  const u64* src = m + (size_t)cb * kWord * ws + w0;
  for (int i = t; i < kWord * chunks; i += nt) {
    const int r = i / chunks;
    const int c = 2 * (i - r * chunks);
    cp_async16(dst + r * ss + w0 + c, src + (size_t)r * ws + c);
  }
  cp_async_commit();
}

// The greedy keep word of strip cb's 64 boxes, in warp 0, from the
// removed word `rem` and the strip's diagonal column (row k's word cb at
// s[k * ss + cb], bits of later boxes only). First the fixpoint rounds
// K <- ~rem & ~OR_{k in K} row k from K = ~rem: bits 0..t-1 are final
// after t rounds, and the fixed point is the greedy set, so a strip in
// which no candidate overlaps another (a served request's) settles in one
// round of two OR-reductions. Else, after kRounds, the greedy loop: 64
// steps of integer work, the column read by broadcast loads that do not
// depend on the chain.
__device__ __forceinline__ u64 settle(const u64* s, int ss, int cb, u64 rem,
                                      int lane) {
  const u64 d_lo = s[lane * ss + cb];
  const u64 d_hi = s[(lane + 32) * ss + cb];
  u64 k = ~rem;
  for (int round = 0; round < kRounds; ++round) {
    const u64 v = (((k >> lane) & 1ull) ? d_lo : 0ull) |
                  (((k >> (lane + 32)) & 1ull) ? d_hi : 0ull);
    const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
    const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
    const u64 next = ~rem & ~(lo | ((u64)hi << 32));
    if (next == k) return k;
    k = next;
  }
  unsigned rlo = (unsigned)rem, rhi = (unsigned)(rem >> 32);
  unsigned klo = 0u, khi = 0u;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const u64 d = s[j * ss + cb];
    if (!(rlo & (1u << j))) {
      klo |= 1u << j;
      rlo |= (unsigned)d;
      rhi |= (unsigned)(d >> 32);
    }
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const u64 d = s[(j + 32) * ss + cb];
    if (!(rhi & (1u << j))) {
      khi |= 1u << j;
      rhi |= (unsigned)(d >> 32);
    }
  }
  return klo | ((u64)khi << 32);
}

// One block per image: the greedy scan over the bitmask. Dynamic shared
// memory: two strip buffers of 64 x ss words.
__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const u64* __restrict__ mask,
                    const uint8_t* __restrict__ valid, int n, int words,
                    int ws, int ss, uint8_t* __restrict__ keep) {
  extern __shared__ __align__(16) u64 strips[];
  __shared__ u64 removed[kMaxWords];
  __shared__ u64 kept_words[kMaxWords];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const u64* m = mask + (size_t)b * n * ws;

  stage_strip(m, 0, ws, ss, strips, threadIdx.x, blockDim.x);
  // invalid boxes are never kept and never suppress: start them removed
  for (int w = warp; w < words; w += nwarps) {
    const uint8_t* v = valid + (size_t)b * n + w * kWord;
    const unsigned lo = __ballot_sync(kFull, v[lane] == 0);
    const unsigned hi = __ballot_sync(kFull, v[lane + 32] == 0);
    if (lane == 0) removed[w] = lo | ((u64)hi << 32);
  }

  for (int cb = 0; cb < words; ++cb) {
    cp_async_wait_all();
    __syncthreads();  // strip cb landed; removed[cb] final
    if (cb + 1 < words && warp > 0) {  // warp 0 goes on to settle
      stage_strip(m, cb + 1, ws, ss, strips + ((cb + 1) & 1) * kWord * ss,
                  threadIdx.x - 32, blockDim.x - 32);
    }
    const u64* s = strips + (cb & 1) * kWord * ss;
    if (warp == 0) {
      const u64 kept = settle(s, ss, cb, removed[cb], lane);
      if (lane == 0) kept_words[cb] = kept;
    }
    __syncthreads();
    const u64 kept = kept_words[cb];
    if (kept) {
      const bool k_lo = (kept >> lane) & 1ull;
      const bool k_hi = (kept >> (lane + 32)) & 1ull;
      for (int w = cb + 1 + warp; w < words; w += nwarps) {
        const u64 v = (k_lo ? s[lane * ss + w] : 0ull) |
                      (k_hi ? s[(lane + 32) * ss + w] : 0ull);
        const unsigned lo = __reduce_or_sync(kFull, (unsigned)v);
        const unsigned hi = __reduce_or_sync(kFull, (unsigned)(v >> 32));
        if (lane == 0) removed[w] |= lo | ((u64)hi << 32);
      }
    }
  }
  __syncthreads();
  // keep bytes, 4 a thread: byte j of word i/16 bit (i%16)*4 + j
  uint32_t* kb = reinterpret_cast<uint32_t*>(keep + (size_t)b * n);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    const unsigned bits = (unsigned)(kept_words[i >> 4] >> ((i & 15) * 4));
    kb[i] = (bits & 1u) | ((bits >> 1) & 1u) << 8 | ((bits >> 2) & 1u) << 16 |
            ((bits >> 3) & 1u) << 24;
  }
}

int scan_smem_set = 0;  // dynamic shared memory the scan kernel may use

}  // namespace

// boxes (batch, n, 4) f32 sorted by descending score, 16-byte aligned;
// valid/keep (batch, n) bytes 0/1, keep 4-byte aligned; mask scratch
// batch*n*ws u64 with ws = n/64 rounded up to even, 16-byte aligned.
// n % 64 == 0 and n <= 8192. Returns the first CUDA error of the launches
// (a scan refused for its shared memory included), else 0.
extern "C" int cm2_nms_keep_sorted(const float* boxes, const uint8_t* valid,
                                   uint8_t* keep, unsigned long long* mask,
                                   int batch, int n, float thr, void* stream) {
  if (batch <= 0 || n <= 0 || n % kWord != 0 || n > kMaxN) {
    return (int)cudaErrorInvalidValue;
  }
  const int words = n / kWord;
  const int ws = words + (words & 1);
  // smem row stride: ss/2 odd, so the lanes of a column read fall on
  // distinct bank pairs (2-way at most) and rows stay 16-byte aligned
  const int ss = ((ws / 2) | 1) * 2;
  const int smem = 2 * kWord * ss * (int)sizeof(u64);
  if (smem > scan_smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    scan_smem_set = smem;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  nms_mask_kernel<<<dim3(words, words, batch), kMaskThreads, 0, s>>>(
      reinterpret_cast<const float4*>(boxes), n, ws, thr, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // a warp per later word, and at least one beside warp 0 to stage strips
  const int threads = std::min(kScanThreads, std::max(64, 32 * (words - 1)));
  nms_scan_kernel<<<batch, threads, smem, s>>>(mask, valid, n, words, ws, ss,
                                               keep);
  return (int)cudaGetLastError();
}
