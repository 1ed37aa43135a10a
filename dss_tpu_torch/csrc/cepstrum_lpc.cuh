// Cepstrum -> LPC for one frame on one warp: the arithmetic that D1's prologue
// (dsp_synthesis.cu) and the neural vocoder's LPC kernel (cepstrum_lpc.cu) share, so that the
// card has one route from cepstrum to LPC.
//
// In the order of vocoder/lpc.py::lpc_from_cepstrum_framewise, and bit for bit with it on the
// card: the three row-wise products (DCT over 32 log energies, powf(10, .), bands -> 161 PSD
// bins, 17 inverse-FFT lags), each summed as the same pairwise tree (K padded to 32 / 32 /
// 256; the 256-term tree as eight products a lane and a five-level butterfly, which adds the
// same pairs); the lag window; Levinson-Durbin in the order of lpc.py::levinson.  Every + - *
// / is written __fadd_rn / __fmul_rn / __fdiv_rn, so nvcc contracts nothing into an FMA.
//
// Included by one .cu each: the names live in that file's unnamed namespace.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOrder = 16;
constexpr int kBands = 18;
constexpr int kFreq = 161;
constexpr int kLags = kOrder + 1;
// The constant tables, one buffer (ops/cepstrum_lpc.py::tables): the inverse-FFT lags
// transposed and padded to [17][256], DCT_MATRIX_32 [18][32], BAND_MATRIX [18][161],
// LAG_WINDOW [17].
constexpr int kTabIrfft = 0;
constexpr int kTabDct = kTabIrfft + kLags * 256;
constexpr int kTabBand = kTabDct + kBands * 32;
constexpr int kTabLag = kTabBand + kBands * kFreq;
constexpr int kPsd = 256;  // floats of shared memory a warp stages the PSD in

// ((p0+p1)+(p2+p3))+...: the pairwise tree, N a power of two, every index a constant.
template <int N>
__device__ __forceinline__ float tree(const float (&p)[N]) {
  if constexpr (N == 1) {
    return p[0];
  } else {
    float q[N / 2];
#pragma unroll
    for (int j = 0; j < N / 2; ++j) q[j] = __fadd_rn(p[2 * j], p[2 * j + 1]);
    return tree(q);
  }
}

// One frame on one warp.  ceps: cepstrum coefficient `lane` (0 for lanes >= 18); psd: this
// warp's kPsd floats of shared memory.  Writes the taps into lpc (every lane, the same
// values) and returns the residual energy.
__device__ __forceinline__ float cepstrum_lpc(float ceps, const float* tab, int lane, float* psd,
                                              float (&lpc)[kOrder]) {
  // Log band energies: lane n sums ceps[k] * DCT_MATRIX_32[k][n] over k < 18 (tree of 32).
  float p[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const float c = __shfl_sync(kFull, ceps, k < kBands ? k : 0);
    p[k] = k < kBands ? __fmul_rn(c, __ldg(tab + kTabDct + k * 32 + lane)) : 0.0f;
  }
  const float band = powf(10.0f, tree(p));
  float bands[kBands];
#pragma unroll
  for (int k = 0; k < kBands; ++k) bands[k] = __shfl_sync(kFull, band, k);

  // PSD bin f (f = lane + 32 r): bands @ BAND_MATRIX, tree of 32; bins 161-255 are the
  // 256-term tree's zero padding.
#pragma unroll
  for (int r = 0; r < kPsd / kLanes; ++r) {
    const int f = lane + 32 * r;
    if (f < kFreq) {
#pragma unroll
      for (int k = 0; k < 32; ++k)
        p[k] = k < kBands ? __fmul_rn(bands[k], __ldg(tab + kTabBand + k * kFreq + f)) : 0.0f;
      psd[f] = tree(p);
    } else {
      psd[f] = 0.0f;
    }
  }
  __syncwarp();
  float ps[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ps[i] = psd[8 * lane + i];
  __syncwarp();

  // Lags 0..16 of the inverse FFT: lane l sums bins 8l..8l+7, the butterfly adds lanes in
  // the tree's pairs; then the lag window.
  float r[kLags];
#pragma unroll
  for (int k = 0; k < kLags; ++k) {
    const float4* il = reinterpret_cast<const float4*>(tab + kTabIrfft + k * 256 + 8 * lane);
    const float4 lo = __ldg(il), hi = __ldg(il + 1);
    float q[8] = {__fmul_rn(ps[0], lo.x), __fmul_rn(ps[1], lo.y), __fmul_rn(ps[2], lo.z),
                  __fmul_rn(ps[3], lo.w), __fmul_rn(ps[4], hi.x), __fmul_rn(ps[5], hi.y),
                  __fmul_rn(ps[6], hi.z), __fmul_rn(ps[7], hi.w)};
    float v = tree(q);
#pragma unroll
    for (int o = 1; o < kLanes; o *= 2) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
    r[k] = __fmul_rn(v, __ldg(tab + kTabLag + k));
  }

  // Levinson-Durbin (every lane, the same values).
#pragma unroll
  for (int k = 0; k < kOrder; ++k) lpc[k] = 0.0f;
  float err = __fadd_rn(r[0], 1e-9f);
#pragma unroll
  for (int i = 0; i < kOrder; ++i) {
    float acc = r[i + 1];
#pragma unroll
    for (int j = 0; j < i; ++j) acc = __fadd_rn(acc, __fmul_rn(lpc[j], r[i - j]));
    const float k = __fdiv_rn(-acc, err);
    float nxt[kOrder];
#pragma unroll
    for (int j = 0; j < i; ++j) nxt[j] = __fadd_rn(lpc[j], __fmul_rn(k, lpc[i - 1 - j]));
#pragma unroll
    for (int j = 0; j < i; ++j) lpc[j] = nxt[j];
    lpc[i] = k;
    err = __fmul_rn(err, __fsub_rn(1.0f, __fmul_rn(k, k)));
  }
  return err;
}

// Tap `lane` of lpc (lanes >= 16: 0), with every index a constant so lpc stays in registers.
__device__ __forceinline__ float lane_tap(const float (&lpc)[kOrder], int lane) {
  float mine = 0.0f;
#pragma unroll
  for (int k = 0; k < kOrder; ++k)
    if (lane == k) mine = lpc[k];
  return mine;
}

}  // namespace
