// Log power per sliding window and channel: out[w, c] = log(mean_l x[w*H + l, c]^2 + 0.01).
//
// Replaces the Pallas kernel dss_tpu/ops/pallas/log_power.py (_log_power_kernel,
// _log_power_call, entry log_power_pallas).  That kernel squares a VMEM-resident tile
// once and forms windows from L/H shifted hop-group sums, because a TPU core walks the
// tiles in order.  On Hopper the work is tiny (online: [80..360, 64] -> [4..32, 64];
// offline: [~20000, 64]) and bound by bytes, not operations: each input row is read by
// L/H = 5 windows, but those re-reads hit L1/L2, so device-memory traffic stays one read
// of the input and one write of the output.  So the design is the simplest correct one:
// one thread per (window, channel) output, threads of a warp on neighbouring channels so
// every load and the store are coalesced, and a sequential sum over the L samples of the
// window (the same order as the plain version's mean).  At the online packet shapes the
// launch itself dominates; there is nothing to gain from tiling.
#include <cuda_runtime.h>

namespace {

__global__ void log_power_kernel(const float* __restrict__ x, float* __restrict__ out,
                                 int channels, int num_win, int hop, int length,
                                 float inv_length, float eps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_win * channels) return;
  const int w = idx / channels;
  const int c = idx - w * channels;
  const float* p = x + (size_t)w * hop * channels + c;
  float acc = 0.f;
  for (int l = 0; l < length; ++l) {
    const float v = p[(size_t)l * channels];
    acc = fmaf(v, v, acc);
  }
  out[idx] = logf(acc * inv_length + eps);
}

}  // namespace

// x: [n_rows, channels] f32 contiguous; out: [num_win, channels] f32 contiguous.
// The caller guarantees (num_win - 1) * hop + length <= n_rows.
extern "C" int dss_log_power(const float* x, float* out, int channels, int num_win,
                             int hop, int length, float eps, void* stream) {
  const int total = num_win * channels;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  log_power_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, channels, num_win, hop, length, 1.f / (float)length, eps);
  return (int)cudaGetLastError();
}
