// Fused normalize + pad + factor-4 space-to-depth host preprocessing.
//
// Replaces three full-image numpy passes (mean subtraction, zero-pad
// copy into the 1344x1344 canvas, space-to-depth relayout) with ONE
// cache-tiled pass from the resized image straight into the network
// input buffer. This is the host half of the s2d stem input contract
// (models/backbones/vovnet.py:s2d_stem_forward): output channel
// rho*4C + kap*C + c at spatial (i, j) holds normalized image pixel
// (4i + rho - 2, 4j + kap - 2), zero outside the resized image (the
// reference zero-pads the normalized canvas, deploy_utils.py:85-90).
//
// Two output modes:
//   s2d_preprocess_*  -> f32, mean-subtracted (full host normalization)
//   s2d_pack_u8       -> raw uint8, same layout (1/4 the bytes across
//                        the host->device link; the model normalizes
//                        on device — CenterMask._normalize_u8_s2d)
//
// The port's own copy of centermask2_tpu/data/native/s2d.cpp.
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17
// (data/preprocess.py, through utils/native.py).

#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// One output row i of the s2d layout: out_row has Wo * 16 * C elems.
// Source rows r = 4i + rho - 2 for rho in 0..3; columns c = 4j + kap - 2.
// NORM subtracts mean4 (mean tiled over the 4 column phases) and is only
// meaningful for float output.
template <typename T, typename OutT, bool NORM>
inline void s2d_row(const T* img, int64_t h, int64_t w, int64_t C,
                    const float* mean4, int64_t i, int64_t Wo,
                    OutT* out_row) {
  const int64_t cs = 4 * C;        // channels per row-phase block
  const int64_t ochan = 16 * C;    // output channels
  // j positions whose 4 column taps are all in-image:
  // need 4j - 2 >= 0 and 4j + 1 < w  ->  1 <= j < (w - 2) / 4 + 1
  const int64_t j_lo = 1;
  const int64_t j_hi = (w - 2) / 4 + 1 < Wo ? (w - 2) / 4 + 1 : Wo;
  for (int64_t rho = 0; rho < 4; ++rho) {
    const int64_t r = 4 * i + rho - 2;
    OutT* o = out_row + rho * cs;  // block base for this row phase
    if (r < 0 || r >= h) {
      for (int64_t j = 0; j < Wo; ++j)
        std::memset(o + j * ochan, 0, sizeof(OutT) * cs);
      continue;
    }
    const T* src = img + r * w * C;
    // fast interior: all 4 column taps inside the image, no branches
    for (int64_t j = j_lo; j < j_hi; ++j) {
      OutT* oj = o + j * ochan;
      const T* s = src + (4 * j - 2) * C;
      if (NORM) {
        for (int64_t t = 0; t < cs; ++t)
          oj[t] = static_cast<OutT>(static_cast<float>(s[t]) - mean4[t]);
      } else {
        for (int64_t t = 0; t < cs; ++t)
          oj[t] = static_cast<OutT>(s[t]);
      }
    }
    // borders (j = 0 and the right edge): per-tap bounds checks
    for (int64_t j = 0; j < Wo; ++j) {
      if (j == j_lo) j = j_hi;
      if (j >= Wo) break;
      OutT* oj = o + j * ochan;
      const int64_t cbase = 4 * j - 2;
      for (int64_t kap = 0; kap < 4; ++kap) {
        const int64_t c = cbase + kap;
        if (c < 0 || c >= w) {
          std::memset(oj + kap * C, 0, sizeof(OutT) * C);
        } else {
          const T* s = src + c * C;
          for (int64_t ch = 0; ch < C; ++ch)
            oj[kap * C + ch] = NORM
                ? static_cast<OutT>(static_cast<float>(s[ch])
                                    - mean4[kap * C + ch])
                : static_cast<OutT>(s[ch]);
        }
      }
    }
  }
}

template <typename T, typename OutT, bool NORM>
void s2d_run(const T* img, int64_t h, int64_t w, int64_t C, int64_t fh,
             int64_t fw, const float* mean, OutT* out) {
  const int64_t Ho = (fh + 4) / 4;  // == fh/4 + 1
  const int64_t Wo = (fw + 4) / 4;
  const int64_t row_sz = Wo * 16 * C;
  float mean4[64];  // mean tiled over the 4 column phases (C <= 16)
  if (NORM)
    for (int64_t t = 0; t < 4 * C; ++t) mean4[t] = mean[t % C];
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < Ho; ++i)
    s2d_row<T, OutT, NORM>(img, h, w, C, mean4, i, Wo, out + i * row_sz);
}

}  // namespace

extern "C" {

// img: (h, w, C) row-major; out: ((fixed+4)/4, (fixed+4)/4, 16*C).
// Requires h <= fixed, w <= fixed, fixed % 4 == 0 (checked by the caller).
void s2d_preprocess_u8(const uint8_t* img, int64_t h, int64_t w, int64_t C,
                       int64_t fixed, const float* mean, float* out) {
  s2d_run<uint8_t, float, true>(img, h, w, C, fixed, fixed, mean, out);
}

void s2d_preprocess_f32(const float* img, int64_t h, int64_t w, int64_t C,
                        int64_t fixed, const float* mean, float* out) {
  s2d_run<float, float, true>(img, h, w, C, fixed, fixed, mean, out);
}

// Raw uint8 pack (no normalization — done on device).
void s2d_pack_u8(const uint8_t* img, int64_t h, int64_t w, int64_t C,
                 int64_t fixed, uint8_t* out) {
  s2d_run<uint8_t, uint8_t, false>(img, h, w, C, fixed, fixed, nullptr, out);
}

// Rectangular-canvas raw pack: out ((fh+4)/4, (fw+4)/4, 16*C). Used for
// the TIGHT serving transfer — canvas just covering the resized image;
// the device zero-pads to the deployment square (bit-identical, ~1.7x
// fewer host->device bytes).
void s2d_pack_u8_rect(const uint8_t* img, int64_t h, int64_t w, int64_t C,
                      int64_t fh, int64_t fw, uint8_t* out) {
  s2d_run<uint8_t, uint8_t, false>(img, h, w, C, fh, fw, nullptr, out);
}

}  // extern "C"
