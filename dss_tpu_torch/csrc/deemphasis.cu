// The neural vocoder's de-emphasis: y[t] = s[t] + 0.85 y[t-1] over a synthesis block of B
// streams x N samples, in one launch.
//
// No TPU kernel stands behind it: the JAX package de-emphasizes its net path in XLA
// (dss_tpu/vocoder/net.py, a blocked cumulative product per frame).  The port ran a blocked
// form too, a [160 x 160] in-frame product and an [L x L] product over the frame ends; the
// libraries round such products by their shapes, so a block split into calls (or a batch into
// shards) gave other bits.
//
// This kernel runs the recurrence itself, one multiply and one add a sample, each rounded once
// (__fmul_rn / __fadd_rn: nvcc contracts nothing into an fma), in the order of
// ops/deemphasis.py::deemphasis_plain and of csrc/deemphasis_host.cpp.  So it equals both bit
// for bit, and a sample depends only on its stream's past: any split of a stream into calls,
// and any split of a batch into shards, gives the same bits as one call.
//
// What bounds it.  A block moves 8 bytes a sample (~0.5 MB at 16 x 50 frames, well under a
// microsecond at the card's bandwidth); what is left is the dependent chain, a multiply and an
// add a sample, N x ~8 cycles (~40 us at 50 frames).  So every stream gets a block of its own:
// the block's threads stage a tile of the stream in shared memory, one thread runs the chain
// over it (eight samples in registers at a time, so the loads are off the chain), and all
// threads write the tile back.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;  // samples staged at a time (16 KB)
constexpr int kRun = 8;      // samples the chain holds in registers

__global__ void __launch_bounds__(kThreads)
deemphasis_kernel(const float* __restrict__ sig, long long s_row, const float* __restrict__ y0,
                  float* __restrict__ out, long long o_row, float* __restrict__ last,
                  long long n, float a) {
  __shared__ __align__(16) float tile[kTile];
  const long long b = blockIdx.x;
  const float* in = sig + b * s_row;
  float* y_out = out + b * o_row;
  float y = y0[b];  // thread 0's chain
  for (long long base = 0; base < n; base += kTile) {
    const int m = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int i = threadIdx.x; i < m; i += kThreads) tile[i] = in[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int i = 0;
      for (; i + kRun <= m; i += kRun) {
        float v[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j) v[j] = tile[i + j];
#pragma unroll
        for (int j = 0; j < kRun; ++j) {
          y = __fadd_rn(v[j], __fmul_rn(a, y));
          v[j] = y;
        }
#pragma unroll
        for (int j = 0; j < kRun; ++j) tile[i + j] = v[j];
      }
      for (; i < m; ++i) {
        y = __fadd_rn(tile[i], __fmul_rn(a, y));
        tile[i] = y;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) y_out[base + i] = tile[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) last[b] = y;
}

}  // namespace

// One launch.  sig: stream b's sample t at sig[b * s_row + t]; y0 [B]; out: the same layout
// with row stride o_row (a column slice of a longer buffer is fine); last [B] receives y[N-1].
extern "C" int dss_deemphasis(const float* sig, long long s_row, const float* y0, float* out,
                              long long o_row, float* last, int B, long long n, float a,
                              cudaStream_t stream) {
  if (B <= 0 || n <= 0) return 0;
  deemphasis_kernel<<<B, kThreads, 0, stream>>>(sig, s_row, y0, out, o_row, last, n, a);
  return static_cast<int>(cudaGetLastError());
}
