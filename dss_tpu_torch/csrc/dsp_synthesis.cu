// D1: the DSP vocoder's sample loop (pulse train + noise excitation, 16-tap all-pole
// synthesis filter, de-emphasis, clip) over B streams and T frames of 160 samples.
//
//   per sample, with the frame's lpc[16], gain, v_mix, voiced, period held:
//     pulse_now = phase <= 0
//     t1        = pulse_now ? (voiced ? v_mix * sqrt(period) : 0) : 0    (= v_mix * pulse)
//     phase     = (pulse_now ? period : phase) - 1
//     e         = gain * ((t1 + (1 - v_mix) * n) + (v_mix * 0.25) * n)
//     s         = e - tree_sum(sig_mem[k] * lpc[k])      sig_mem[0] newest
//     sig_mem   = [s, sig_mem[0..14]]
//     y         = s + 0.85 * y
//     pcm       = clip(y, -1, 1)
//
// No TPU kernel stands behind it: the JAX package runs this loop as two nested lax.scans
// (dss_tpu/vocoder/dsp.py:67-93, de-emphasis :87-93, clip :98), which XLA lowers to a
// serial loop.  Eagerly in PyTorch the loop costs ~20 launches a sample; here a call is
// one launch.
//
// What bounds it.  The work per sample is ~45 f32 operations and 8 bytes (noise in, pcm
// out): a 260-frame word is ~2 MFLOP and ~0.4 MB, microseconds at the card's rates.  What
// is left is the recurrence: s depends on the previous s through one product and four
// additions of the tree and the subtraction, ~6 dependent operations (~25 clocks) a
// sample, and 41,600 samples a word run one after another.
//
// Design (the simple kernel).  One warp per stream, one block per stream.  Lane 0 runs
// the chain from registers: the 16 taps, the 16 newest samples (a 16-fold unrolled loop
// turns the history shift into register renaming), phase and y.  The other lanes stage
// the next frame's noise and constants into shared memory while lane 0 filters the
// current one (their loads are issued before the chain and stored after it), and write
// the finished frame's 160 samples to device memory coalesced.
//
// Numerics.  Every operation is written with __fmul_rn / __fadd_rn / __fsub_rn /
// __fsqrt_rn in the plain version's order (ops/dsp_synthesis.py::dsp_synthesis_plain),
// so nvcc contracts nothing into an FMA and the kernel equals the plain version bit for
// bit, pcm and carried state.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrame = 160;
constexpr int kOrder = 16;
constexpr int kLanes = 32;
constexpr int kPerLane = kFrame / kLanes;  // noise values a lane stages per frame
constexpr float kPreemph = 0.85f;
static_assert(kOrder == 16, "the tap tree below is written for 16 taps");

struct FrameConst {
  float lpc[kOrder];
  float gain, v_mix, amp;  // amp = v_mix * sqrt(period) when voiced, else 0
  int period;
};

__global__ void __launch_bounds__(kLanes)
dsp_synthesis_kernel(const float* __restrict__ lpc, const float* __restrict__ gain,
                     const float* __restrict__ v_mix, const uint8_t* __restrict__ voiced,
                     const int* __restrict__ period, const float* __restrict__ noise,
                     const float* __restrict__ sig_mem_in, const int* __restrict__ phase_in,
                     const float* __restrict__ deemph_in, float* __restrict__ pcm,
                     float* __restrict__ sig_mem_out, int* __restrict__ phase_out,
                     float* __restrict__ deemph_out, int T) {
  __shared__ float sh_noise[2][kFrame];
  __shared__ FrameConst sh_const[2];
  __shared__ float sh_out[kFrame];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const float* noise_b = noise + static_cast<size_t>(b) * T * kFrame;
  float* pcm_b = pcm + static_cast<size_t>(b) * T * kFrame;

  // Frame t's inputs travel through registers (Staged) into shared memory: lanes 0-15
  // carry a tap each, lane 16 the scalars, every lane kPerLane noise values.
  struct Staged {
    float nz[kPerLane];
    float c, v, g;
    int p;
    bool voiced;
  };
  auto load = [&](int t, Staged& st) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) st.nz[j] = noise_b[t * kFrame + j * kLanes + lane];
    const size_t i = static_cast<size_t>(b) * T + t;
    if (lane < kOrder) st.c = lpc[i * kOrder + lane];
    if (lane == kOrder) {
      st.v = v_mix[i];
      st.g = gain[i];
      st.p = period[i];
      st.voiced = voiced[i] != 0;
    }
  };
  auto store = [&](int buf, const Staged& st) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) sh_noise[buf][j * kLanes + lane] = st.nz[j];
    if (lane < kOrder) sh_const[buf].lpc[lane] = st.c;
    if (lane == kOrder) {
      sh_const[buf].gain = st.g;
      sh_const[buf].v_mix = st.v;
      sh_const[buf].period = st.p;
      sh_const[buf].amp =
          st.voiced ? __fmul_rn(st.v, __fsqrt_rn(static_cast<float>(st.p))) : 0.0f;
    }
  };

  Staged st{};
  load(0, st);
  store(0, st);

  float m[kOrder];
#pragma unroll
  for (int k = 0; k < kOrder; ++k) m[k] = sig_mem_in[b * kOrder + k];
  int phase = phase_in[b];
  float y = deemph_in[b];
  __syncwarp();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + 1 < T) load(t + 1, st);  // in flight while lane 0 runs the chain
    if (lane == 0) {
      const FrameConst& fc = sh_const[cur];
      float a[kOrder];
#pragma unroll
      for (int k = 0; k < kOrder; ++k) a[k] = fc.lpc[k];
      const float g = fc.gain, amp = fc.amp;
      const float omv = __fsub_rn(1.0f, fc.v_mix);
      const float vq = __fmul_rn(fc.v_mix, 0.25f);
      const int per = fc.period;
      for (int i0 = 0; i0 < kFrame; i0 += kOrder) {
#pragma unroll
        for (int k = 0; k < kOrder; ++k) {
          const float n = sh_noise[cur][i0 + k];
          const bool pulse_now = phase <= 0;
          const float t1 = pulse_now ? amp : 0.0f;
          phase = (pulse_now ? per : phase) - 1;
          const float e = __fmul_rn(
              g, __fadd_rn(__fadd_rn(t1, __fmul_rn(omv, n)), __fmul_rn(vq, n)));
          // The products, then the pairwise tree ((p0+p1)+(p2+p3))+..., each level a
          // loop of constant trip count so that every index is a constant and the
          // arrays stay in registers.
          float p[kOrder], q[kOrder / 2], r[kOrder / 4], u[kOrder / 8];
#pragma unroll
          for (int j = 0; j < kOrder; ++j) p[j] = __fmul_rn(m[j], a[j]);
#pragma unroll
          for (int j = 0; j < kOrder / 2; ++j) q[j] = __fadd_rn(p[2 * j], p[2 * j + 1]);
#pragma unroll
          for (int j = 0; j < kOrder / 4; ++j) r[j] = __fadd_rn(q[2 * j], q[2 * j + 1]);
#pragma unroll
          for (int j = 0; j < kOrder / 8; ++j) u[j] = __fadd_rn(r[2 * j], r[2 * j + 1]);
          const float s = __fsub_rn(e, __fadd_rn(u[0], u[1]));
#pragma unroll
          for (int j = kOrder - 1; j > 0; --j) m[j] = m[j - 1];
          m[0] = s;
          y = __fadd_rn(s, __fmul_rn(kPreemph, y));
          sh_out[i0 + k] = fminf(fmaxf(y, -1.0f), 1.0f);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      pcm_b[t * kFrame + j * kLanes + lane] = sh_out[j * kLanes + lane];
    if (t + 1 < T) store(cur ^ 1, st);
    __syncwarp();
  }

  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kOrder; ++k) sig_mem_out[b * kOrder + k] = m[k];
    phase_out[b] = phase;
    deemph_out[b] = y;
  }
}

}  // namespace

extern "C" int dss_dsp_synthesis(const float* lpc, const float* gain, const float* v_mix,
                                 const uint8_t* voiced, const int* period,
                                 const float* noise, const float* sig_mem_in,
                                 const int* phase_in, const float* deemph_in, float* pcm,
                                 float* sig_mem_out, int* phase_out, float* deemph_out,
                                 int B, int T, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return 0;  // the wrapper copies the state for T = 0
  dsp_synthesis_kernel<<<B, kLanes, 0, stream>>>(lpc, gain, v_mix, voiced, period, noise,
                                                 sig_mem_in, phase_in, deemph_in, pcm,
                                                 sig_mem_out, phase_out, deemph_out, T);
  return static_cast<int>(cudaGetLastError());
}
