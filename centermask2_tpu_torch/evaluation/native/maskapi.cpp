// COCO RLE mask operations — native implementation (the port's own copy
// of centermask2_tpu/evaluation/native/maskapi.cpp).
//
// The replacement for the pycocotools C maskApi the
// reference depends on (reference: centermask2/centermask/modeling/
// centermask/mask_head.py:82 mask_utils.area/frPyObjects;
// evaluation/coco_evaluation.py:388-397 RLE encode of predictions).
// Implements the COCO run-length encoding (column-major, counts alternate
// zeros/ones starting with zeros) and its compressed string form, plus
// area and IoU kernels used by the evaluator's matching stage.
//
// Exposed as a C ABI for ctypes; buffers are caller-allocated where
// possible, with a simple grow-API for variable-length outputs.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// ---------------------------------------------------------------------------
// RLE encode: column-major binary mask (h*w bytes, mask[i + h*j]) ->
// counts. Returns number of counts written (<= h*w+1). counts_out must
// have capacity h*w+1.
int64_t rle_encode(const uint8_t* mask, int64_t h, int64_t w,
                   uint32_t* counts_out) {
  int64_t n = h * w;
  int64_t k = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      counts_out[k++] = run;
      run = 0;
      prev = v;
    }
    ++run;
  }
  counts_out[k++] = run;
  return k;
}

// RLE decode -> column-major mask (h*w bytes).
void rle_decode(const uint32_t* counts, int64_t m, int64_t h, int64_t w,
                uint8_t* mask_out) {
  int64_t pos = 0;
  uint8_t v = 0;
  int64_t n = h * w;
  for (int64_t i = 0; i < m; ++i) {
    uint32_t c = counts[i];
    for (uint32_t j = 0; j < c && pos < n; ++j) mask_out[pos++] = v;
    v = 1 - v;
  }
  while (pos < n) mask_out[pos++] = 0;
}

uint64_t rle_area(const uint32_t* counts, int64_t m) {
  uint64_t a = 0;
  for (int64_t i = 1; i < m; i += 2) a += counts[i];
  return a;
}

// ---------------------------------------------------------------------------
// Compressed string form (pycocotools rleToString): per count, delta vs
// count[i-2], base-32 varint with 5 data bits + continuation, offset by
// 48 into printable ASCII.
int64_t rle_to_string(const uint32_t* counts, int64_t m, char* out,
                      int64_t out_cap) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; ++i) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      c += 48;
      if (p >= out_cap) return -1;
      out[p++] = (char)c;
    }
  }
  return p;
}

// Inverse (rleFrString). Returns number of counts.
int64_t rle_from_string(const char* s, int64_t slen, uint32_t* counts_out,
                        int64_t cap) {
  int64_t m = 0;
  int64_t p = 0;
  while (p < slen) {
    int64_t x = 0;
    int64_t k = 0;
    bool more = true;
    while (more) {
      if (p >= slen) return -1;
      int64_t c = (int64_t)s[p++] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++k;
      if (!more && (c & 0x10)) x |= -1LL << (5 * k);
    }
    if (m > 2) x += (int64_t)counts_out[m - 2];
    if (m >= cap) return -1;
    counts_out[m++] = (uint32_t)x;
  }
  return m;
}

// ---------------------------------------------------------------------------
// IoU between two RLEs (pycocotools rleIoU single pair). iscrowd: union is
// the detection's area only (gt crowd regions don't penalize).
double rle_iou_single(const uint32_t* dt, int64_t mdt, const uint32_t* gt,
                      int64_t mgt, int32_t iscrowd) {
  // run-merge intersection computation over column-major runs
  uint64_t inter = 0, a_dt = 0, a_gt = 0;
  a_dt = rle_area(dt, mdt);
  a_gt = rle_area(gt, mgt);
  // walk both RLEs as (start, end, value) run streams
  int64_t ia = 0, ib = 0;
  uint64_t ca = dt[0], cb = gt[0];
  uint8_t va = 0, vb = 0;
  uint64_t pos_a = 0, pos_b = 0;
  // positions advance in lockstep on min boundary
  uint64_t pa_end = ca, pb_end = cb;
  uint64_t cur = 0;
  while (ia < mdt && ib < mgt) {
    uint64_t nxt = std::min(pa_end, pb_end);
    if (va && vb) inter += nxt - cur;
    cur = nxt;
    if (nxt == pa_end) {
      ++ia;
      if (ia < mdt) { pa_end += dt[ia]; va = 1 - va; }
    }
    if (nxt == pb_end) {
      ++ib;
      if (ib < mgt) { pb_end += gt[ib]; vb = 1 - vb; }
    }
  }
  double u = iscrowd ? (double)a_dt
                     : (double)a_dt + (double)a_gt - (double)inter;
  if (u <= 0) return 0.0;
  return (double)inter / u;
}

// Batched IoU: dt_counts/gt_counts are concatenated, with offsets.
void rle_iou(const uint32_t* dt_counts, const int64_t* dt_off,
             const int64_t* dt_len, int64_t ndt, const uint32_t* gt_counts,
             const int64_t* gt_off, const int64_t* gt_len, int64_t ngt,
             const int32_t* iscrowd, double* out) {
  for (int64_t i = 0; i < ndt; ++i)
    for (int64_t j = 0; j < ngt; ++j)
      out[i * ngt + j] = rle_iou_single(
          dt_counts + dt_off[i], dt_len[i], gt_counts + gt_off[j], gt_len[j],
          iscrowd ? iscrowd[j] : 0);
}

// Box IoU (xywh, COCO convention), iscrowd semantics as above.
void bb_iou(const double* dt, int64_t ndt, const double* gt, int64_t ngt,
            const int32_t* iscrowd, double* out) {
  for (int64_t i = 0; i < ndt; ++i) {
    double dx0 = dt[i * 4], dy0 = dt[i * 4 + 1];
    double dw = dt[i * 4 + 2], dh = dt[i * 4 + 3];
    double da = dw * dh;
    for (int64_t j = 0; j < ngt; ++j) {
      double gx0 = gt[j * 4], gy0 = gt[j * 4 + 1];
      double gw = gt[j * 4 + 2], gh = gt[j * 4 + 3];
      double ga = gw * gh;
      double ix = std::min(dx0 + dw, gx0 + gw) - std::max(dx0, gx0);
      double iy = std::min(dy0 + dh, gy0 + gh) - std::max(dy0, gy0);
      double inter = (ix > 0 && iy > 0) ? ix * iy : 0.0;
      double u = (iscrowd && iscrowd[j]) ? da : da + ga - inter;
      out[i * ngt + j] = u > 0 ? inter / u : 0.0;
    }
  }
}

// Merge (union/intersection) of two RLEs -> counts_out (cap must be
// >= mdt+mgt). Returns count length.
int64_t rle_merge(const uint32_t* a, int64_t ma, const uint32_t* b,
                  int64_t mb, int32_t intersect, uint32_t* counts_out,
                  int64_t cap) {
  int64_t ia = 0, ib = 0, m = 0;
  uint64_t pa_end = a[0], pb_end = b[0];
  uint8_t va = 0, vb = 0;
  uint64_t cur = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  auto emit = [&](uint64_t upto, uint8_t v) -> bool {
    if (v != prev) {
      if (m >= cap) return false;
      counts_out[m++] = run;
      run = 0;
      prev = v;
    }
    run += (uint32_t)(upto - cur);
    return true;
  };
  while (ia < ma && ib < mb) {
    uint64_t nxt = std::min(pa_end, pb_end);
    uint8_t v = intersect ? (va & vb) : (va | vb);
    if (nxt > cur) {
      if (!emit(nxt, v)) return -1;
      cur = nxt;
    }
    if (nxt == pa_end) { ++ia; if (ia < ma) { pa_end += a[ia]; va = 1 - va; } }
    if (nxt == pb_end) { ++ib; if (ib < mb) { pb_end += b[ib]; vb = 1 - vb; } }
  }
  if (m >= cap) return -1;
  counts_out[m++] = run;
  return m;
}

// ---------------------------------------------------------------------------
// COCOeval greedy matching for one (image, category, areaRng, maxDet)
// cell — the O(T*D*G) inner loop of evaluateImg, the hot path COCOeval_opt
// moves to C++ in the reference's stack (coco_evaluation.py:25,566).
// Inputs are in sorted order (dts by -score capped at maxDet; gts
// non-ignored first). Semantics mirror pycocotools exactly: a dt takes
// the best gt with iou >= max(thr, current best) (later index wins
// ties), crowd gts can be matched repeatedly, and the scan stops at the
// first ignored gt once a real match exists. Outputs must be
// zero-initialized by the caller.
void coco_match(const double* iou_thrs, int64_t T,
                const double* ious,  // D x G row-major (sorted order)
                int64_t D, int64_t G,
                const uint8_t* gt_ig, const uint8_t* gt_crowd,
                const int64_t* gt_ids, const int64_t* dt_ids,
                int64_t* dt_matches,  // T x D
                int64_t* gt_matches,  // T x G
                uint8_t* dt_ignore) { // T x D
  for (int64_t t = 0; t < T; ++t) {
    int64_t* gm = gt_matches + t * G;
    int64_t* dm = dt_matches + t * D;
    uint8_t* di = dt_ignore + t * D;
    for (int64_t d = 0; d < D; ++d) {
      double best = std::min(iou_thrs[t], 1.0 - 1e-10);
      int64_t m = -1;
      const double* row = ious + d * G;
      for (int64_t g = 0; g < G; ++g) {
        if (gm[g] > 0 && !gt_crowd[g]) continue;
        if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
        if (row[g] < best) continue;
        best = row[g];
        m = g;
      }
      if (m < 0) continue;
      di[d] = gt_ig[m];
      dm[d] = gt_ids[m];
      gm[m] = dt_ids[d];
    }
  }
}

}  // extern "C"
