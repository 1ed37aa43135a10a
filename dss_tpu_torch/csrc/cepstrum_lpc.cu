// The neural vocoder's LPC: cepstrum -> 16 taps for every frame of a synthesis block of B
// streams x L frames, in one launch.
//
// No TPU kernel stands behind it: the JAX package leaves the LPC of its net path to XLA
// (dss_tpu/vocoder/net.py, lpc.py's bands_from_cepstrum, lpc_from_bands: products, an
// inverse real FFT and a 16-step Levinson scan).  The port ran the same eagerly, ~400 small
// launches a block (the Levinson loop alone ~2i + 10 in step i), which held the host before
// the sampler could start.
//
// What bounds it.  A frame reads 18 floats and writes 16, and costs ~12.5 kFLOP (18 x 18,
// 18 x 161 and 161 x 17 multiply-adds, 18 powers, Levinson): at 16 x 50 frames ~0.1 MB with
// the tables and ~10 MFLOP, a few hundredths of a microsecond at the card's rates.  What is
// left is one warp's dependent chain through a frame (the butterflies and Levinson's 16
// divisions), so every frame gets a warp of its own and all of them run at once: the grid
// covers B x L frames, kWarps frames a block.  The arithmetic is cepstrum_lpc.cuh's, which
// D1's prologue runs too, so the taps equal vocoder/lpc.py::lpc_from_cepstrum_framewise on
// the card bit for bit, and a frame's taps depend on that frame alone: chunked calls equal
// one call, and a shard's rows equal the batch's rows.
//
// The input is read through its strides (the features [B, L, 20] as the vocoder slices them,
// no copy); the taps are written in the sampler's layout [L, B, 16].
#include <cuda_runtime.h>

#include "cepstrum_lpc.cuh"

namespace {

constexpr int kWarps = 4;  // frames a block

__global__ void __launch_bounds__(kWarps * kLanes)
cepstrum_lpc_kernel(const float* __restrict__ ceps, long long sb, long long sl, long long sc,
                    const float* __restrict__ tab, float* __restrict__ lpc_out, int B,
                    long long n) {
  __shared__ __align__(16) float sh[kWarps * kPsd];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long f = static_cast<long long>(blockIdx.x) * kWarps + warp;  // t * B + b
  if (f >= n) return;  // the whole warp: nothing below waits on another warp
  const long long t = f / B, b = f % B;
  const float c = lane < kBands ? __ldg(ceps + b * sb + t * sl + lane * sc) : 0.0f;
  float lpc[kOrder];
  cepstrum_lpc(c, tab, lane, sh + warp * kPsd, lpc);
  if (lane < kOrder) lpc_out[f * kOrder + lane] = lane_tap(lpc, lane);
}

}  // namespace

// One launch.  ceps: element (b, t, k) at ceps[b * sb + t * sl + k * sc], k < 18; lpc:
// [L, B, 16] contiguous.
extern "C" int dss_cepstrum_lpc(const float* ceps, long long sb, long long sl, long long sc,
                                const float* tables, float* lpc, int B, int L,
                                cudaStream_t stream) {
  if (B <= 0 || L <= 0) return 0;
  const long long n = static_cast<long long>(B) * L;
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  cepstrum_lpc_kernel<<<blocks, kWarps * kLanes, 0, stream>>>(ceps, sb, sl, sc, tables, lpc, B,
                                                              n);
  return static_cast<int>(cudaGetLastError());
}
