// The bunched LPCNet sample-rate loop: S samples per network step, S in {2, 4, 8}.
//
// Replaces the Pallas kernel dss_tpu/ops/pallas/sampler.py (_make_bunched_kernel,
// _bunched_sampler_call, entry sampler_frames_bunched_pallas), the kernel form of
// LPCNetModel.bunch_step.  Per frame: the conditioning share of both GRUs' input
// projections, once.  Then F / S steps, each:
//   1. pred_0 = -history . lpc; mu-law indices of the S newest samples and of pred_0;
//   2. GRU-A's input as the sum of 2S+1 rows, one from each embedding table pre-fused
//      with its band of gru_a_wx (order: sample lags 0..S-1, prediction, excitation lags
//      0..S-1), plus the conditioning share;
//   3. GRU-A (reset-after, wh * mask) and GRU-B, once;
//   4. all S dual heads from h_b: tanh(h_b @ W[GB, S*512] + inner bias) * gain;
//   5. for j = 0..S-1 in order: logits of head j (+ for j >= 1 one row of each of the two
//      [256, 256] correction tables, picked by the previous excitation of the bunch and
//      by the index of pred_j); temperature and Gumbel noise, or greedy when the frame's
//      temperature is negative; the exact lowest-index argmax; mu-law decode,
//      clip(pred_j + e), the history shift, the store at sample i*S + j, and pred_{j+1}
//      from the shifted history;
//   6. the new excitation history, most recent first.
// The Gumbel noise is an input laid out [T, F, B, 256] by position in the frame, the
// bunch-1 kernel's layout, so a stream's noise does not depend on the bunch.
//
// What bounds it on Hopper: as the bunch-1 kernel, the loop is serial and every step
// streams GRU-A's 1.8 MB recurrent matrix through one SM from L2.  The recurrence now
// runs once per S samples, so its share per sample falls by S; what is left per sample
// is the tail of step 5, a chain of S dependent rounds that no other work overlaps.
//
// Design: one block of 1024 threads per stream, whatever the batch: what the TPU splits
// into a row-gather path (B <= 4) and a one-hot-product path (B > 4) is a row gather
// here in both cases.  State (h_a, h_b, a ring of the last P samples, the index
// history) lives in shared memory.
//  * The heads.  At bunch S the head matrix is GB * S * 512 floats: 128 KB at S = 2,
//    256 KB at S = 4, 512 KB at S = 8, against 227 KB of shared memory, so the bunch-1
//    kernel's staging does not carry over.  For every S the heads are read from global
//    memory (they stay in L2) as one more split-K product over all 1024 threads: float4
//    column quads times slices of the 32 rows, partial sums met in shared memory.  Only
//    GRU-B's 12 KB recurrent matrix is staged.
//  * The tail.  Only warps 0..7 run it (one thread per level), synchronised by a named
//    barrier of 256 threads, one barrier per sub-sample: after the warp argmax each of
//    the 256 threads reduces the 8 warp results itself and derives the excitation, the
//    sample and the next prediction redundantly (identical instructions on identical
//    values), so no single-thread pass and no second barrier is needed.  The history is a
//    ring of 32 slots, so a new sample lands in a slot that no prediction reads, and the
//    share of the next prediction that older samples give is summed before the barrier,
//    off the chain: after it, one multiply-add with the new sample remains.  The
//    per-warp results are double-buffered by the parity of j.  Thread 0 alone writes the
//    ring, the output and the excitation history that the next step's gather reads; the
//    mu-law indices of the S newest samples are encoded by an idle warp at the top of the
//    next step, and mu-law decode is a 256-entry table in shared memory.
//  * The S noise values of a step are loaded before the first round, off the chain.
// Weights are f32 and GRU-A's recurrent product is dense over wh * mask, as in the
// bunch-1 kernel; the same levers are left (bf16, the tile-sparse product, a cluster
// split), plus one of its own: the next step's recurrent product depends only on h_a, so
// warps 8..31 could run it while warps 0..7 are in the tail.
#include "sampler_common.cuh"

namespace {

using namespace dss;

struct Weights {
  const float* emb;        // [2S+1, 256, 3*GA]: each table @ its band of gru_a_wx
  const float* wx_a_cond;  // [CD, 3*GA]: gru_a_wx conditioning rows
  const float* bx_a;       // [3*GA]
  const float* wh_a;       // [GA, 3*GA]: gru_a_wh * gru_a_mask
  const float* bh_a;       // [3*GA]
  const float* wx_b;       // [GA + CD, 3*GB]
  const float* bx_b;       // [3*GB]
  const float* wh_b;       // [GB, 3*GB]
  const float* bh_b;       // [3*GB]
  const float* w_out;      // [GB, S*512]: head j in columns [j*512, (j+1)*512)
  const float* g_out;      // [S*512]
  const float* ib_out;     // [S*512]: inner (pre-tanh) biases, zeros when absent
  const float* b_out;      // [S*256]
  const float* corr;       // [S-1, 2, 256, 256]: (bunch_exc_emb_b{j}, bunch_pred_emb_b{j})
};

constexpr int kTailThreads = kLevels;        // warps 0..7, one thread per level
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kRing = 32;                    // sample-history ring; lag k at (pos + k) % 32
constexpr int kRingMask = kRing - 1;

__device__ __forceinline__ void tail_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kTailThreads) : "memory");
}

template <int S>
__global__ void __launch_bounds__(kThreads) lpcnet_sampler_bunched_kernel(
    const float* __restrict__ cond, const float* __restrict__ lpc,
    const float* __restrict__ temp, const float* __restrict__ noise, Weights w,
    const float* __restrict__ h_a0, const float* __restrict__ h_b0,
    const float* __restrict__ sig_mem0, const int* __restrict__ exc0,
    float* __restrict__ sig_out, float* __restrict__ h_a1, float* __restrict__ h_b1,
    float* __restrict__ sig_mem1, int* __restrict__ exc1,
    int T, int F, int B, int GA, int GB, int CD, int P, int gA, int gB, int gH,
    int part_floats) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int NA = 3 * GA;
  const int NB = 3 * GB;
  constexpr int NO = S * 2 * kLevels;   // head columns
  constexpr int NE = 2 * S + 1;         // fused embedding tables

  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;                  // [part_floats] split-K partial sums
  float* s_whb = s_part + part_floats;   // [GB * NB] GRU-B recurrent weights, staged once
  float* s_gxc = s_whb + GB * NB;        // [NA] per-frame conditioning part of gx_a
  float* s_gxbc = s_gxc + NA;            // [NB] per-frame conditioning part of gx_b
  float* s_ghb = s_gxbc + NB;            // [NB]
  float* s_ha = s_ghb + NB;              // [GA]
  float* s_hb = s_ha + GA;               // [GB]
  float* s_cond = s_hb + GB;             // [CD]
  float* s_lpc = s_cond + CD;            // [P]
  float* s_ring = s_lpc + P;             // [32] sample history; lag k at (pos + k) % 32
  float* s_dec = s_ring + kRing;         // [256] mu-law decode table
  float* s_logit = s_dec + kLevels;      // [S * 256] logits of the S heads, outer bias in
  float* s_redv = s_logit + S * kLevels; // [2][8] per-warp argmax values, by parity of j
  int* s_redi = (int*)(s_redv + 2 * kTailWarps);  // [2][8]
  int* s_sidx = s_redi + 2 * kTailWarps; // [S] mu-law index of sample lag j
  int* s_exc = s_sidx + S;               // [S] excitation lag j
  int* s_pidx = s_exc + S;               // [1] mu-law index of pred_0 of the next step
  float* s_pred = (float*)(s_pidx + 1);  // [1] pred_0 of the next step

  for (int i = tid; i < GB * NB; i += nt) s_whb[i] = w.wh_b[i];
  for (int u = tid; u < GA; u += nt) s_ha[u] = h_a0[b * GA + u];
  for (int u = tid; u < GB; u += nt) s_hb[u] = h_b0[b * GB + u];
  for (int k = tid; k < kRing; k += nt) s_ring[k] = k < P ? sig_mem0[b * P + k] : 0.f;
  for (int k = tid; k < kLevels; k += nt) s_dec[k] = mulaw_decode(k);
  if (tid < S) s_exc[tid] = exc0[b * S + tid];
  int pos = 0;  // ring slot of the most recent sample; every thread tracks it

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B + b;
    for (int k = tid; k < CD; k += nt) s_cond[k] = cond[tb * CD + k];
    for (int k = tid; k < P; k += nt) s_lpc[k] = lpc[tb * P + k];
    const float tmp = temp[tb];
    const bool greedy = tmp < 0.f;
    __syncthreads();
    // The frame's first prediction, from the carried history and this frame's filter.
    if (tid == 0) {
      float pred = 0.f;
      for (int k = 0; k < P; ++k) pred = fmaf(s_ring[(pos + k) & kRingMask], s_lpc[k], pred);
      s_pred[0] = -pred;
      s_pidx[0] = mulaw_encode(-pred);
    }
    // The conditioning vector is constant over the frame: its share of both GRUs'
    // input projections is computed once per frame.
    matvec_partial(s_cond, w.wx_a_cond, CD, NA, gA, s_part, tid, nt);
    __syncthreads();
    for (int c = tid; c < NA; c += nt) s_gxc[c] = reduce_part(s_part, gA, NA, c) + w.bx_a[c];
    __syncthreads();
    matvec_partial(s_cond, w.wx_b + (size_t)GA * NB, CD, NB, gB, s_part, tid, nt);
    __syncthreads();
    for (int c = tid; c < NB; c += nt) s_gxbc[c] = reduce_part(s_part, gB, NB, c) + w.bx_b[c];
    __syncthreads();

    for (int i = 0; i < F / S; ++i) {
      // The mu-law indices of the S newest samples, on a warp the tail leaves idle.
      if (tid >= kTailThreads && tid < kTailThreads + S)
        s_sidx[tid - kTailThreads] = mulaw_encode(s_ring[(pos + tid - kTailThreads) & kRingMask]);
      // GRU-A: the recurrent product as split-K partials, then each unit reduces its three
      // gate columns, adds the 2S+1 gathered rows and updates its state.
      matvec_partial(s_ha, w.wh_a, GA, NA, gA, s_part, tid, nt);
      __syncthreads();
      for (int u = tid; u < GA; u += nt) {
        const float* rows[NE];
#pragma unroll
        for (int j = 0; j < S; ++j) {
          rows[j] = w.emb + ((size_t)j * kLevels + s_sidx[j]) * NA;
          rows[S + 1 + j] = w.emb + ((size_t)(S + 1 + j) * kLevels + s_exc[j]) * NA;
        }
        rows[S] = w.emb + ((size_t)S * kLevels + s_pidx[0]) * NA;
        float gx[3], gh[3];
        for (int q = 0; q < 3; ++q) {
          const int c = q * GA + u;
          gh[q] = reduce_part(s_part, gA, NA, c) + w.bh_a[c];
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < NE; ++n) acc += __ldg(rows[n] + c);
          gx[q] = acc + s_gxc[c];
        }
        const float r = sigmoidf(gx[0] + gh[0]);
        const float z = sigmoidf(gx[1] + gh[1]);
        const float n = tanhf(gx[2] + r * gh[2]);
        s_ha[u] = (1.f - z) * n + z * s_ha[u];
      }
      __syncthreads();

      // GRU-B: input product from h_a (split-K partials), recurrent product from the
      // staged weights.
      matvec_partial(s_ha, w.wx_b, GA, NB, gB, s_part, tid, nt);
      for (int c = tid; c < NB; c += nt) {
        float acc = 0.f;
        for (int k = 0; k < GB; ++k) acc = fmaf(s_hb[k], s_whb[k * NB + c], acc);
        s_ghb[c] = acc + w.bh_b[c];
      }
      __syncthreads();
      for (int u = tid; u < GB; u += nt) {
        float gx[3];
        for (int q = 0; q < 3; ++q)
          gx[q] = reduce_part(s_part, gB, NB, q * GB + u) + s_gxbc[q * GB + u];
        const float r = sigmoidf(gx[0] + s_ghb[u]);
        const float z = sigmoidf(gx[1] + s_ghb[GB + u]);
        const float n = tanhf(gx[2] + r * s_ghb[2 * GB + u]);
        s_hb[u] = (1.f - z) * n + z * s_hb[u];
      }
      __syncthreads();

      // All S dual heads: one split-K product from global memory, then per level the
      // two tanh halves of its head and the outer bias.
      matvec_partial(s_hb, w.w_out, GB, NO, gH, s_part, tid, nt);
      __syncthreads();
      for (int c = tid; c < S * kLevels; c += nt) {
        const int c1 = (c / kLevels) * 2 * kLevels + (c % kLevels);
        const int c2 = c1 + kLevels;
        const float t1 = tanhf(reduce_part(s_part, gH, NO, c1) + w.ib_out[c1]) * w.g_out[c1];
        const float t2 = tanhf(reduce_part(s_part, gH, NO, c2) + w.ib_out[c2]) * w.g_out[c2];
        s_logit[c] = t1 + t2 + w.b_out[c];
      }
      __syncthreads();

      // The tail: S dependent rounds on warps 0..7, thread `tid` holding level `tid`.
      if (tid < kTailThreads) {
        float nz[S];
#pragma unroll
        for (int j = 0; j < S; ++j)
          nz[j] = greedy ? 0.f
                         : noise[((size_t)(t * F + i * S + j) * B + b) * kLevels + tid];
        float pred = s_pred[0];
        int p_idx = s_pidx[0];
        float last = s_ring[pos];  // the newest sample
        int prev = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          // What the samples before this round's give to the next prediction.
          float older = s_lpc[1] * last;
          for (int k = 2; k < P; ++k)
            older = fmaf(s_ring[(pos + k - 1) & kRingMask], s_lpc[k], older);
          float logit = s_logit[j * kLevels + tid];
          if (j > 0) {
            const float* ce = w.corr + (size_t)(j - 1) * 2 * kLevels * kLevels;
            logit += __ldg(ce + (size_t)prev * kLevels + tid) +
                     __ldg(ce + (size_t)(kLevels + p_idx) * kLevels + tid);
          }
          float v = greedy ? logit : logit * tmp + nz[j];
          int ix = tid;
          warp_argmax(v, ix);
          float* redv = s_redv + (j & 1) * kTailWarps;
          int* redi = s_redi + (j & 1) * kTailWarps;
          if ((tid & 31) == 0) { redv[tid >> 5] = v; redi[tid >> 5] = ix; }
          tail_barrier();
          v = redv[0];
          ix = redi[0];
#pragma unroll
          for (int q = 1; q < kTailWarps; ++q) {
            if (redv[q] > v) { v = redv[q]; ix = redi[q]; }
          }
          const float sample = fminf(fmaxf(pred + s_dec[ix], -1.f), 1.f);
          pos = (pos + kRingMask) & kRingMask;  // the slot of lag 31, which nothing reads
          pred = -fmaf(s_lpc[0], sample, older);
          p_idx = mulaw_encode(pred);
          if (tid == 0) {
            s_ring[pos] = sample;
            sig_out[(size_t)b * T * F + (size_t)t * F + i * S + j] = sample;
            s_exc[S - 1 - j] = ix;
            if (j == S - 1) { s_pred[0] = pred; s_pidx[0] = p_idx; }
          }
          last = sample;
          prev = ix;
        }
      } else {
        pos = (pos + S * kRingMask) & kRingMask;
      }
      __syncthreads();
    }
  }
  for (int u = tid; u < GA; u += nt) h_a1[b * GA + u] = s_ha[u];
  for (int u = tid; u < GB; u += nt) h_b1[b * GB + u] = s_hb[u];
  for (int k = tid; k < P; k += nt) sig_mem1[b * P + k] = s_ring[(pos + k) & kRingMask];
  if (tid < S) exc1[b * S + tid] = s_exc[tid];
}

struct Plan {
  int gA, gB, gH, part_floats;
  long long smem;
};

// Split-K group counts and shared-memory bytes for these widths at kThreads.
Plan plan(int S, int GA, int GB, int CD, int P) {
  const int NA = 3 * GA, NB = 3 * GB, NO = S * 2 * kLevels;
  Plan p;
  p.gA = max(1, kThreads / (NA / 4));
  p.gB = min(16, max(1, kThreads / (NB / 4)));
  p.gH = min(GB, max(1, kThreads / (NO / 4)));
  p.part_floats = max(max(p.gA * NA, p.gB * NB), p.gH * NO);
  p.part_floats = (p.part_floats + 3) / 4 * 4;
  const long long words = (long long)p.part_floats + (long long)GB * NB + NA + 2LL * NB + GA +
                          GB + CD + P + kRing + kLevels + (long long)S * kLevels +
                          4LL * kTailWarps + 2LL * S + 2;
  p.smem = words * 4;
  return p;
}

template <int S>
int launch(const float* cond, const float* lpc, const float* temp, const float* noise,
           const Weights& w, const float* h_a0, const float* h_b0, const float* sig_mem0,
           const int* exc0, float* sig_out, float* h_a1, float* h_b1, float* sig_mem1,
           int* exc1, int T, int F, int B, int GA, int GB, int CD, int P,
           cudaStream_t stream) {
  const Plan p = plan(S, GA, GB, CD, P);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lpcnet_sampler_bunched_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  lpcnet_sampler_bunched_kernel<S><<<B, kThreads, (size_t)p.smem, stream>>>(
      cond, lpc, temp, noise, w, h_a0, h_b0, sig_mem0, exc0, sig_out, h_a1, h_b1, sig_mem1,
      exc1, T, F, B, GA, GB, CD, P, p.gA, p.gB, p.gH, p.part_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors f32 contiguous and 16-byte aligned except exc0/exc1 (int32 [B, S], most
// recent first).  Shapes: cond [T,B,CD], lpc [T,B,P], temp [T,B], noise [T,F,B,256] (may
// be null when every temp < 0), sig_out [B, T*F], state [B, .]; the weights as in
// `Weights` above.  S must be 2, 4 or 8 and divide F; GA and GB multiples of 4;
// max(S, 2) <= P <= 32.
// Returns a cudaError_t value (0 = launched).
extern "C" int dss_lpcnet_sampler_bunched(
    const float* cond, const float* lpc, const float* temp, const float* noise,
    const float* emb, const float* wx_a_cond, const float* bx_a, const float* wh_a,
    const float* bh_a, const float* wx_b, const float* bx_b, const float* wh_b,
    const float* bh_b, const float* w_out, const float* g_out, const float* ib_out,
    const float* b_out, const float* corr, const float* h_a0, const float* h_b0,
    const float* sig_mem0, const int* exc0, float* sig_out, float* h_a1, float* h_b1,
    float* sig_mem1, int* exc1, int S, int T, int F, int B, int GA, int GB, int CD, int P,
    void* stream) {
  if (GA % 4 != 0 || GB % 4 != 0 || S < 1 || F % S != 0 || P < S || P < 2 || P > kRing)
    return (int)cudaErrorInvalidValue;
  const Weights w{emb, wx_a_cond, bx_a, wh_a, bh_a, wx_b, bx_b, wh_b, bh_b,
                  w_out, g_out, ib_out, b_out, corr};
  const cudaStream_t st = (cudaStream_t)stream;
#define DSS_LAUNCH(N)                                                                   \
  case N:                                                                               \
    return launch<N>(cond, lpc, temp, noise, w, h_a0, h_b0, sig_mem0, exc0, sig_out,    \
                     h_a1, h_b1, sig_mem1, exc1, T, F, B, GA, GB, CD, P, st)
  switch (S) {
    DSS_LAUNCH(2);
    DSS_LAUNCH(4);
    DSS_LAUNCH(8);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DSS_LAUNCH
}
