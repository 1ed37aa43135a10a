// The DSP vocoder's sample loop on the host: D1's operations in D1's order
// (csrc/dsp_synthesis.cu, ops/dsp_synthesis.py::dsp_synthesis_plain), compiled
// with the host compiler and called through ctypes by
// ops/dsp_synthesis.py::dsp_synthesis_host for tensors on the CPU.
//
//   per stream and sample, with the frame's lpc[16], amp, gain and period held:
//     pulse_now = phase <= 0
//     t1        = pulse_now ? amp : 0          amp = v_mix * sqrt(period) if voiced
//     phase     = (pulse_now ? period : phase) - 1
//     e         = gain * ((t1 + excite_a) + excite_b)
//     s         = e - tree_sum(sig_mem[k] * lpc[k])      sig_mem[0] newest
//     sig_mem   = [s, sig_mem[0..14]]
//     y         = s + 0.85f * y
//     pcm       = clip(y, -1, 1)
//
// excite_a = (1 - v_mix) * noise and excite_b = (v_mix * 0.25) * noise are
// computed by the caller, as the plain version does, so only + - * on float32
// are left here.  Built with -ffp-contract=off and without -ffast-math, every
// operation is rounded once in this order: the loop equals the numpy plain
// version and the kernel bit for bit, pcm and carried state.  It is not a
// port of a TPU kernel; it exists because the plain loop (~10 numpy calls a
// sample) holds the interpreter lock against training threads, and a ctypes
// call releases it.
#include <stdint.h>

namespace {

constexpr int kFrame = 160;
constexpr int kOrder = 16;
constexpr float kPreemph = 0.85f;

// ((p0+p1)+(p2+p3))+... over 16 products: the pairwise tree of _tree_sum.
inline float tree_sum16(const float* p) {
  float q[8], r[4];
  for (int k = 0; k < 8; ++k) q[k] = p[2 * k] + p[2 * k + 1];
  for (int k = 0; k < 4; ++k) r[k] = q[2 * k] + q[2 * k + 1];
  return (r[0] + r[1]) + (r[2] + r[3]);
}

}  // namespace

extern "C" int dss_dsp_synthesis_host(
    const float* lpc, const float* amp, const float* gain, const int32_t* period,
    const float* excite_a, const float* excite_b, float* sig_mem, int32_t* phase,
    float* deemph, float* pcm, int B, int T) {
  if (B < 0 || T < 0) return 1;
  for (int b = 0; b < B; ++b) {
    float mem[kOrder];
    for (int k = 0; k < kOrder; ++k) mem[k] = sig_mem[b * kOrder + k];
    int32_t ph = phase[b];
    float y = deemph[b];
    for (int t = 0; t < T; ++t) {
      const int64_t f = int64_t(b) * T + t;
      const float* a = lpc + f * kOrder;
      const float amp_t = amp[f], gain_t = gain[f];
      const int32_t period_t = period[f];
      const float* xa = excite_a + f * kFrame;
      const float* xb = excite_b + f * kFrame;
      float* out = pcm + f * kFrame;
      for (int i = 0; i < kFrame; ++i) {
        const bool pulse_now = ph <= 0;
        const float t1 = pulse_now ? amp_t : 0.0f;
        ph = (pulse_now ? period_t : ph) - 1;
        const float e = gain_t * ((t1 + xa[i]) + xb[i]);
        float p[kOrder];
        for (int k = 0; k < kOrder; ++k) p[k] = mem[k] * a[k];
        const float s = e - tree_sum16(p);
        for (int k = kOrder - 1; k > 0; --k) mem[k] = mem[k - 1];
        mem[0] = s;
        y = s + kPreemph * y;
        // np.clip: NaN stays NaN.
        out[i] = y < -1.0f ? -1.0f : (y > 1.0f ? 1.0f : y);
      }
    }
    for (int k = 0; k < kOrder; ++k) sig_mem[b * kOrder + k] = mem[k];
    phase[b] = ph;
    deemph[b] = y;
  }
  return 0;
}
