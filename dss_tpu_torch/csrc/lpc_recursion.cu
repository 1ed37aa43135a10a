// D2: the vocoder trainer's teacher-forced LPC recursion over B streams and T frames of
// 160 samples (dss_tpu/train/trainer_vocoder.py:142-189, VocoderTrainer._recursion).
//
//   per sample, with the frame's lpc[16] held and hist[0] the newest reconstruction:
//     pred    = -tree_sum(hist[k] * lpc[k])
//     e_tgt   = mulaw_encode(clip(s - pred, -1, 1))                 the correcting target
//     e_fb    = clip(e_tgt + n, 0, 255)                             noise mode
//             = clip(clip(n, e_tgt - drift, e_tgt + drift), 0, 255)  feedback mode
//     rec     = clip(pred + decode[e_fb], -1, 1)
//     hist    = [rec, hist[0..14]]
//
// No TPU kernel stands behind it: the JAX package runs this loop as a lax.scan, which XLA
// lowers to a serial loop.  Eagerly in PyTorch it costs ~12 launches a sample (~29,000
// for a 32 x 2400-sample training batch); here a batch is one launch.  Its outputs carry
// no gradient (the trainer uses them as indices and as mu-law inputs), so there is no
// backward.
//
// What bounds it.  The bytes are ~28 a sample (signal and the injected index in; pred,
// rec and two int64 indices out): 2 MB for a batch, ~0.6 us at the card's rate.  What is
// left is the recurrence: the next prediction waits for rec through one product and
// four additions of the tap tree, and rec waits for the mu-law encode (log1pf), the
// table read and the clips: ~100-150 clocks a sample, 2400 samples one after another.
//
// Design (the simple kernel, as D1).  One warp per stream, one block per stream.  Lane 0
// runs the chain from registers: the 16 taps and the 16 newest reconstructions (a
// 16-fold unrolled loop turns the history shift into register renaming).  The other
// lanes stage the next frame's signal, injected indices and taps into shared memory
// while lane 0 runs the current one, and write the finished frame's four outputs to
// device memory coalesced.
//
// Numerics.  Every operation is written with __fmul_rn / __fadd_rn / __fsub_rn in the
// plain version's order (ops/lpc_recursion.py::lpc_recursion_plain), log1pf is
// libdevice's (what torch's CUDA log1p calls), rintf rounds half to even as torch.round,
// and the mu-law scale is a multiplication by the float32 reciprocal the wrapper passes,
// as the plain version multiplies.  Built without --use_fast_math, so the kernel equals
// the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrame = 160;
constexpr int kOrder = 16;
constexpr int kLanes = 32;
constexpr int kPerLane = kFrame / kLanes;  // samples a lane stages per frame
constexpr int kLevels = 256;
static_assert(kOrder == 16, "the tap tree below is written for 16 taps");

__device__ __forceinline__ float clip1(float x) { return fminf(fmaxf(x, -1.0f), 1.0f); }

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// mulaw_encode in the plain version's order: sign(x) * log1p(|x| * 255) * inv, then
// round(((y + 1) * 0.5) * 255) clipped to the levels.
__device__ __forceinline__ int mulaw_encode(float x, float inv_log1p_mu) {
  x = clip1(x);
  const float t = log1pf(__fmul_rn(fabsf(x), 255.0f));
  const float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float y = __fmul_rn(__fmul_rn(sgn, t), inv_log1p_mu);
  const float q = __fmul_rn(__fmul_rn(__fadd_rn(y, 1.0f), 0.5f), 255.0f);
  return clampi(static_cast<int>(rintf(q)), 0, kLevels - 1);
}

__global__ void __launch_bounds__(kLanes)
lpc_recursion_kernel(const float* __restrict__ signal, const float* __restrict__ lpc,
                     const long long* __restrict__ inject,
                     const float* __restrict__ decode_table, float* __restrict__ pred_out,
                     long long* __restrict__ tgt_out, long long* __restrict__ fb_out,
                     float* __restrict__ rec_out, int T, int feedback, int drift,
                     float inv_log1p_mu) {
  __shared__ float sh_sig[2][kFrame];
  __shared__ int sh_inj[2][kFrame];
  __shared__ float sh_lpc[2][kOrder];
  __shared__ float sh_table[kLevels];
  __shared__ float sh_pred[kFrame], sh_rec[kFrame];
  __shared__ int sh_tgt[kFrame], sh_fb[kFrame];
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const size_t base = static_cast<size_t>(b) * T * kFrame;

  struct Staged {
    float s[kPerLane];
    int n[kPerLane];
    float c;
  };
  auto load = [&](int t, Staged& st) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const size_t i = base + t * kFrame + j * kLanes + lane;
      st.s[j] = signal[i];
      st.n[j] = inject != nullptr ? static_cast<int>(inject[i]) : 0;
    }
    if (lane < kOrder) st.c = lpc[(static_cast<size_t>(b) * T + t) * kOrder + lane];
  };
  auto store = [&](int buf, const Staged& st) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      sh_sig[buf][j * kLanes + lane] = st.s[j];
      sh_inj[buf][j * kLanes + lane] = st.n[j];
    }
    if (lane < kOrder) sh_lpc[buf][lane] = st.c;
  };

  for (int k = lane; k < kLevels; k += kLanes) sh_table[k] = decode_table[k];
  Staged st{};
  load(0, st);
  store(0, st);
  float m[kOrder];
#pragma unroll
  for (int k = 0; k < kOrder; ++k) m[k] = 0.0f;
  __syncwarp();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    if (t + 1 < T) load(t + 1, st);  // in flight while lane 0 runs the chain
    if (lane == 0) {
      float a[kOrder];
#pragma unroll
      for (int k = 0; k < kOrder; ++k) a[k] = sh_lpc[cur][k];
      for (int i0 = 0; i0 < kFrame; i0 += kOrder) {
#pragma unroll
        for (int k = 0; k < kOrder; ++k) {
          const int i = i0 + k;
          // The products, then the pairwise tree ((p0+p1)+(p2+p3))+..., each level a
          // loop of constant trip count so that the arrays stay in registers.
          float p[kOrder], q[kOrder / 2], r[kOrder / 4], u[kOrder / 8];
#pragma unroll
          for (int j = 0; j < kOrder; ++j) p[j] = __fmul_rn(m[j], a[j]);
#pragma unroll
          for (int j = 0; j < kOrder / 2; ++j) q[j] = __fadd_rn(p[2 * j], p[2 * j + 1]);
#pragma unroll
          for (int j = 0; j < kOrder / 4; ++j) r[j] = __fadd_rn(q[2 * j], q[2 * j + 1]);
#pragma unroll
          for (int j = 0; j < kOrder / 8; ++j) u[j] = __fadd_rn(r[2 * j], r[2 * j + 1]);
          const float pred = -__fadd_rn(u[0], u[1]);
          const int tgt =
              mulaw_encode(clip1(__fsub_rn(sh_sig[cur][i], pred)), inv_log1p_mu);
          const int n = sh_inj[cur][i];
          const int fb = feedback ? clampi(clampi(n, tgt - drift, tgt + drift), 0, kLevels - 1)
                                  : clampi(tgt + n, 0, kLevels - 1);
          const float rec = clip1(__fadd_rn(pred, sh_table[fb]));
#pragma unroll
          for (int j = kOrder - 1; j > 0; --j) m[j] = m[j - 1];
          m[0] = rec;
          sh_pred[i] = pred;
          sh_rec[i] = rec;
          sh_tgt[i] = tgt;
          sh_fb[i] = fb;
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = j * kLanes + lane;
      const size_t o = base + t * kFrame + i;
      pred_out[o] = sh_pred[i];
      rec_out[o] = sh_rec[i];
      tgt_out[o] = sh_tgt[i];
      fb_out[o] = sh_fb[i];
    }
    if (t + 1 < T) store(cur ^ 1, st);
    __syncwarp();
  }
}

}  // namespace

extern "C" int dss_lpc_recursion(const float* signal, const float* lpc,
                                 const long long* inject, const float* decode_table,
                                 float* pred, long long* exc_tgt, long long* exc_fb,
                                 float* sig_rec, int B, int T, int feedback, int drift_bound,
                                 float inv_log1p_mu, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return 0;
  lpc_recursion_kernel<<<B, kLanes, 0, stream>>>(signal, lpc, inject, decode_table, pred,
                                                 exc_tgt, exc_fb, sig_rec, T, feedback,
                                                 drift_bound, inv_log1p_mu);
  return static_cast<int>(cudaGetLastError());
}
