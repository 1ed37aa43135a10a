// The packet front end in one launch: the IIR cascade with carried state, warm-start
// framing and log power per window and channel.
//
//   block = [carry_in (R rows); cascade(x) (T rows)]           (N = R + T rows)
//   feats[w, c] = log(mean_{l < length} block[w * hop + l, c]^2 + eps),  w < W,
//                 W = floor((N - length) / hop) + 1 (0 when N < length)
//   carry_out   = block[N - (length - hop) :]
//   zi_out      = the cascade's section states after the T samples
//
// Replaces, on the packet path, the Pallas log-power kernel
// dss_tpu/ops/pallas/log_power.py (_log_power_kernel, pallas_call at :60) together with
// the sequential cascade it is fed by (dss_tpu/ops/filters.py:166-194, sosfilt_scan, a
// lax.scan that XLA fuses with the framing and log power into one program per packet,
// dss_tpu/ops/hga.py:171-187).  The standalone port of that log-power kernel,
// csrc/log_power.cu, stays for log_power_frames on other callers.
//
// What bounds it.  At the deployed packet (T = 40, C = 64, S = 16) the work is 48 KB of
// bytes and 0.4 MFLOP: 1.4e-5 ms and 6e-6 ms on an H100.  What is left is latency: each
// channel is a serial recurrence, S sections deep per sample and T samples long, 9 f32
// operations per section and sample, plus the launch and the first loads.  A warp that
// is alone on its scheduler issues a dependent operation only every ~4 clocks, so the
// design spreads the recurrence over warps and orders each warp's work so that
// independent operations follow one another.
//
// Design.  One lane per channel, 32 channels per block, so a packet is ceil(C / 32)
// blocks on as many SMs.  The sections are pipelined over the block's warps: warp w owns
// kPer consecutive sections (their coefficients and states in registers for the whole
// launch; sections past S are exact identities) and filters chunks of kChunk samples, in
// wavefront order inside the chunk (section s on sample q - s at step q); at block step
// t it takes chunk t - w from warp w - 1 through a double-buffered hand-off in shared
// memory, so the warps work on different chunks at once and a block barrier ends each
// step (the last warp frames its chunk from shared memory in a loop that is not unrolled,
// which keeps the code of a step small).  Warp 0 reads the packet from device memory two
// chunks ahead.  The carried rows
// are staged in shared memory by the whole block with one round of loads.  The last warp
// frames: the carried rows first (during the steps before its first chunk arrives), then
// each filtered row is squared into a hop-group sum, as the TPU kernel does
// (log_power.py:37-46), finished group sums go to a ring of length / hop entries per lane
// in shared memory, and a window is written as soon as its last group closes.  The filtered signal never
// goes to device memory except the last length - hop rows (carry_out).
//
// Numerics.  The section update is written with __fmul_rn / __fadd_rn / __fsub_rn in the
// plain version's order (ops/filters.py::sosfilt_scan):
//   y = b0*x + z0;   z0 = (b1*x - a1*y) + z1;   z1 = b2*x - a2*y
// so nvcc contracts nothing into an FMA and zi_out and carry_out equal the eager torch
// version (which rounds once per operation) bit for bit.  The window sums take another
// order than the plain version's mean: features agree within 1e-5, as K1 does.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;       // channels per block
constexpr int kChunk = 8;        // samples a warp filters between two block barriers
constexpr int kMaxSections = 64;
constexpr int kMaxCarry = 256;   // carried rows staged in shared memory
constexpr int kMaxGroups = 16;   // length / hop: the ring of group sums in shared memory
constexpr int kBatch = 16;       // loads a warp keeps in flight while staging

template <int kPer>  // sections per warp
__global__ void __launch_bounds__(4 * kLanes)
filter_log_power_kernel(const float* __restrict__ x, const float* __restrict__ sos,
                        const float* __restrict__ zi_in,
                        const float* __restrict__ carry_in, float* __restrict__ feats,
                        float* __restrict__ zi_out, float* __restrict__ carry_out, int T,
                        int C, int S, int R, int hop, int length, int num_win,
                        float eps) {
  extern __shared__ float smem[];
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int c = blockIdx.x * kLanes + lane;
  const bool live = c < C;  // dead lanes compute on zeros: every lane meets the barriers
  const int groups = length / hop;
  float* hand = smem;                                          // [warps][2][kChunk][32]
  float* staged = hand + warps * 2 * kChunk * kLanes;          // [R][32]
  float* ring = staged + R * kLanes + lane;                    // [groups][32]

  // This warp's sections, identities past S.
  float b0[kPer], b1[kPer], b2[kPer], a1[kPer], a2[kPer], z0[kPer], z1[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = warp * kPer + i;
    const bool real = s < S;
    b0[i] = real ? sos[s * 6 + 0] : 1.f;
    b1[i] = real ? sos[s * 6 + 1] : 0.f;
    b2[i] = real ? sos[s * 6 + 2] : 0.f;
    a1[i] = real ? sos[s * 6 + 4] : 0.f;
    a2[i] = real ? sos[s * 6 + 5] : 0.f;
    z0[i] = real && live ? zi_in[(s * 2 + 0) * C + c] : 0.f;
    z1[i] = real && live ? zi_in[(s * 2 + 1) * C + c] : 0.f;
  }
  // The carried rows, kBatch loads in flight per warp before any is stored.
  for (int r0 = warp; r0 < R; r0 += kBatch * warps) {
    float t[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + u * warps;
      t[u] = live && r < R ? carry_in[(size_t)r * C + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (r0 + u * warps < R) staged[(r0 + u * warps) * kLanes + lane] = t[u];
  }
  // Warp 0's packet rows, two chunks ahead.
  auto row = [&](int k) { return live && k < T ? x[(size_t)k * C + c] : 0.f; };
  float cur[kChunk], nxt[kChunk];
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      cur[i] = row(i);
      nxt[i] = row(kChunk + i);
    }
  }
  __syncthreads();

  // One section on one sample, in the plain version's order of operations.
  auto section = [&](int s, float& u) {
    const float y = __fadd_rn(__fmul_rn(b0[s], u), z0[s]);
    z0[s] = __fadd_rn(__fsub_rn(__fmul_rn(b1[s], u), __fmul_rn(a1[s], y)), z1[s]);
    z1[s] = __fsub_rn(__fmul_rn(b2[s], u), __fmul_rn(a2[s], y));
    u = y;
  };

  // The last warp's framing state: rows of the block from first_keep on are carried out;
  // rows are summed per hop group into a ring of the last `groups` group sums in shared
  // memory (a ring in registers would be copied whole at every row: its shift is
  // conditional); window w closes with group w + groups - 1.
  const bool last = warp == warps - 1;
  const int first_keep = R + T - (length - hop);
  const float len_f = (float)length;
  float acc = 0.f;
  int in_group = 0, group = 0, slot = 0;
  auto take_row = [&](float v, int r) {
    if (live && r >= first_keep) carry_out[(size_t)(r - first_keep) * C + c] = v;
    acc = fmaf(v, v, acc);
    if (++in_group < hop) return;
    ring[slot * kLanes] = acc;
    acc = 0.f;
    in_group = 0;
    slot = slot + 1 == groups ? 0 : slot + 1;  // now the oldest group's slot
    const int w = group - groups + 1;
    ++group;
    if (w < 0 || w >= num_win || !live) return;
    float part[kMaxGroups];  // independent loads first, then the sum oldest first
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      const int p = min(slot + g < groups ? slot + g : slot + g - groups, groups - 1);
      part[g] = g < groups ? ring[p * kLanes] : 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < groups) sum += part[g];
    feats[(size_t)w * C + c] = logf(sum / len_f + eps);
  };
  // The carried rows go through the ring during the steps before the first chunk
  // reaches the last warp (all of them at step 0 when there is one warp).
  const int carry_per_step = warps > 1 ? (R + warps - 2) / (warps - 1) : R;
  int carried = 0;
  // take_row is written once in the code and runs in loops that are not unrolled: the
  // step's code has to stay small, since a lone warp has no other warp to hide its
  // instruction fetches behind.

  const int chunks = (T + kChunk - 1) / kChunk;
  for (int step = 0; step < chunks + warps - 1; ++step) {
    if (last) {
      const int end = min(R, carried + carry_per_step);
#pragma unroll 1
      for (; carried < end; ++carried) take_row(staged[carried * kLanes + lane], carried);
    }
    const int j = step - warp;
    if (j >= 0 && j < chunks) {
      const int k0 = j * kChunk;
      float v[kChunk];
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          v[i] = cur[i];
          cur[i] = nxt[i];
          nxt[i] = row(k0 + 2 * kChunk + i);
        }
      } else {
        const float* in = hand + ((warp - 1) * 2 + (j & 1)) * kChunk * kLanes + lane;
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[i] = in[i * kLanes];
      }
      if (k0 + kChunk <= T) {
        // A whole chunk in wavefront order: at q, section s runs sample q - s.  The
        // updates of one q are independent, so a lone warp issues them back to back
        // instead of waiting out each dependency; each element sees the same operations.
#pragma unroll
        for (int q = 0; q < kChunk + kPer - 1; ++q)
#pragma unroll
          for (int s = 0; s < kPer; ++s)
            if (q - s >= 0 && q - s < kChunk) section(s, v[q - s]);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          if (k0 + i < T)
#pragma unroll
            for (int s = 0; s < kPer; ++s) section(s, v[i]);
      }
      float* out = hand + (warp * 2 + (j & 1)) * kChunk * kLanes + lane;
#pragma unroll
      for (int i = 0; i < kChunk; ++i) out[i * kLanes] = v[i];
      if (last) {
        const int rows = min(kChunk, T - k0);
#pragma unroll 1
        for (int i = 0; i < rows; ++i) take_row(out[i * kLanes], R + k0 + i);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = warp * kPer + i;
    if (s < S && live) {
      zi_out[(s * 2 + 0) * C + c] = z0[i];
      zi_out[(s * 2 + 1) * C + c] = z1[i];
    }
  }
}

__global__ void empty_kernel() {}

int launch(int per, int warps, const float* x, const float* sos, const float* zi_in,
           const float* carry_in, float* feats, float* zi_out, float* carry_out, int T,
           int C, int S, int R, int hop, int length, float eps, void* stream) {
  if (T < 1 || C < 1 || S < 1 || S > kMaxSections || R < 0 || R > kMaxCarry ||
      hop < 1 || length % hop != 0 || length / hop > kMaxGroups ||
      R + T < length - hop || warps < 1 || warps > 4 || per * warps < S)
    return (int)cudaErrorInvalidValue;
  const int n = R + T;
  const int num_win = n >= length ? (n - length) / hop + 1 : 0;
  const int blocks = (C + kLanes - 1) / kLanes;
  const size_t smem =
      (size_t)(warps * 2 * kChunk + R + length / hop) * kLanes * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (per == 4)
    filter_log_power_kernel<4><<<blocks, warps * kLanes, smem, st>>>(
        x, sos, zi_in, carry_in, feats, zi_out, carry_out, T, C, S, R, hop, length,
        num_win, eps);
  else if (per == 16)
    filter_log_power_kernel<16><<<blocks, warps * kLanes, smem, st>>>(
        x, sos, zi_in, carry_in, feats, zi_out, carry_out, T, C, S, R, hop, length,
        num_win, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x [T, C], sos [S, 6], zi_in / zi_out [S, 2, C], carry_in [R, C],
// carry_out [length - hop, C], feats [W, C]; all f32, contiguous, on the card.
// Takes T >= 1, S <= 64, R <= 256, hop dividing length at most 16 times and
// R + T >= length - hop; returns cudaErrorInvalidValue for anything else, else
// cudaGetLastError() after the launch on `stream`.  Sections go 4 to a warp up to
// S = 16 (the deployed cascade: 4 warps), 16 to a warp beyond.
extern "C" int dss_filter_log_power(const float* x, const float* sos, const float* zi_in,
                                    const float* carry_in, float* feats, float* zi_out,
                                    float* carry_out, int T, int C, int S, int R, int hop,
                                    int length, float eps, void* stream) {
  const int per = S <= 16 ? 4 : 16;
  return launch(per, (S + per - 1) / per, x, sos, zi_in, carry_in, feats, zi_out,
                carry_out, T, C, S, R, hop, length, eps, stream);
}

// The same with the whole cascade (S <= 16) on one warp: no pipeline, the design this
// kernel was measured against.
extern "C" int dss_filter_log_power_one_warp(const float* x, const float* sos,
                                             const float* zi_in, const float* carry_in,
                                             float* feats, float* zi_out, float* carry_out,
                                             int T, int C, int S, int R, int hop,
                                             int length, float eps, void* stream) {
  return launch(16, 1, x, sos, zi_in, carry_in, feats, zi_out, carry_out, T, C, S, R,
                hop, length, eps, stream);
}

// The launch floor: an empty kernel launched through the same ctypes path, with the
// grid and block the front-end kernel takes for C channels of the deployed cascade.
extern "C" int dss_empty_launch(int C, void* stream) {
  empty_kernel<<<(C + kLanes - 1) / kLanes, 4 * kLanes, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
