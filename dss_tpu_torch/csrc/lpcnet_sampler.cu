// The bunch-1 LPCNet sample-rate loop: T frames x F samples per stream, autoregressive.
//
// Replaces the Pallas kernel dss_tpu/ops/pallas/sampler.py (_make_kernel, _sampler_call,
// entry sampler_frames_pallas).  Per sample it computes, in order: the LPC prediction;
// mu-law encodings of the last sample and of the prediction; the GRU-A input projection
// as three row gathers from embedding tables pre-fused with gru_a_wx (plus the per-frame
// conditioning projection); GRU-A (reset-after) with the masked recurrent matrix; GRU-B;
// the dual tanh heads (optional inner bias); Gumbel-max over 256 levels at the frame's
// temperature, or greedy when the temperature is negative; mu-law decode, clip and the
// history shift.  The argmax is the exact lowest-index argmax.  The Gumbel noise is an
// input (drawn by the wrapper, keyed by the stream seed and the absolute frame index),
// so the kernel and its plain PyTorch version consume identical noise.
//
// What bounds it on Hopper: the loop is serial, 16 000 dependent network steps per second
// of audio, and each step streams the weights that the recurrence touches (GRU-A's
// [384, 1152] recurrent matrix is 1.8 MB in f32) through one SM.  Its roofline bound (all
// weights read once, GRU-A's recurrent product at the mask's kept tiles: ~0.3 MFLOP per
// sample at the f32 peak) is far below what a single block can reach; the kernel is latency-bound on the per-sample chain and on one SM's
// share of L2 bandwidth.  The TPU's sequential frame grid becomes a loop inside the block.
//
// Design of this first version: one thread block of 1024 threads per stream (B = 1
// online), looping over T x F samples.  h_a, h_b, the 16-sample history, the last
// excitation and the per-frame conditioning projections live in shared memory, and so do
// the small GRU-B recurrent and output-head matrices (76 KB), staged once per launch.
// The large matrices (GRU-A recurrent 1.8 MB, the fused embedding tables, GRU-B's input
// rows; about 7 MB in f32) stay in global memory and are served from the 50 MB L2 after
// the first sample: they do not fit one SM's 227 KB.  Each large product runs as
// float4 column quads times slices of the input rows, so every thread has a short chain
// of coalesced 16-byte loads and hundreds of loads are in flight; the slices' partial sums
// meet in shared memory, where each GRU unit reduces its three gate columns and updates
// its state in the same pass.  Weights are f32 and the GRU-A recurrent product is dense
// over wh * mask; bf16 storage, the tile-sparse product (19.9% of [16 x 128] tiles kept
// in the shipped checkpoint) and a cluster split of the recurrent matrix over several
// SMs' shared memory are the levers for a later version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLevels = 256;
constexpr float kMu = 255.f;
constexpr float kLog1pMu = 5.545177444479562f;  // log1p(255)

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ int mulaw_encode(float x) {
  x = fminf(fmaxf(x, -1.f), 1.f);
  const float y = sgn(x) * log1pf(kMu * fabsf(x)) / kLog1pMu;
  const float v = rintf((y + 1.f) * 0.5f * (float)(kLevels - 1));
  return (int)fminf(fmaxf(v, 0.f), (float)(kLevels - 1));
}

__device__ __forceinline__ float mulaw_decode(int idx) {
  const float y = (float)idx / (float)(kLevels - 1) * 2.f - 1.f;
  return sgn(y) * (powf(1.f + kMu, fabsf(y)) - 1.f) / kMu;
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

struct Weights {
  const float* emb;        // [3, 256, 3*GA]: emb_{sig,pred,exc} @ gru_a_wx[embedding rows]
  const float* wx_a_cond;  // [CD, 3*GA]: gru_a_wx conditioning rows
  const float* bx_a;       // [3*GA]
  const float* wh_a;       // [GA, 3*GA]: gru_a_wh * gru_a_mask
  const float* bh_a;       // [3*GA]
  const float* wx_b;       // [GA + CD, 3*GB]
  const float* bx_b;       // [3*GB]
  const float* wh_b;       // [GB, 3*GB]
  const float* bh_b;       // [3*GB]
  const float* w_out;      // [GB, 512]: concat(fc_out1_w, fc_out2_w)
  const float* g_out;      // [512]
  const float* ib_out;     // [512]: inner (pre-tanh) biases, zeros when absent
  const float* b_out;      // [256]
};

// part[g*N + c] = sum over k in group g of x[k] * W[k*N + c], for c < N (N % 4 == 0).
// One work item is a quad of 4 adjacent columns (one 16-byte load per row, so a warp
// reads 512 contiguous bytes) times one of G slices of the K rows: short per-thread
// load chains, many loads in flight.
__device__ __forceinline__ void matvec_partial(const float* x, const float* __restrict__ W,
                                               int K, int N, int G, float* part, int tid,
                                               int nt) {
  const int NQ = N >> 2;
  const int KS = (K + G - 1) / G;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  for (int j = tid; j < NQ * G; j += nt) {
    const int g = j / NQ;
    const int q = j - g * NQ;
    const int k1 = min(K, (g + 1) * KS);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int k = g * KS; k < k1; ++k) {
      const float4 w = __ldg(W4 + (size_t)k * NQ + q);
      const float xv = x[k];
      acc.x = fmaf(xv, w.x, acc.x);
      acc.y = fmaf(xv, w.y, acc.y);
      acc.z = fmaf(xv, w.z, acc.z);
      acc.w = fmaf(xv, w.w, acc.w);
    }
    reinterpret_cast<float4*>(part + (size_t)g * N)[q] = acc;
  }
}

__device__ __forceinline__ float reduce_part(const float* part, int G, int N, int c) {
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc += part[g * N + c];
  return acc;
}

// One block size: __launch_bounds__ caps the build at 64 registers per thread, which
// is what lets 1024 threads launch (96 registers refuse with cudaError 701).
constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads) lpcnet_sampler_kernel(
    const float* __restrict__ cond, const float* __restrict__ lpc,
    const float* __restrict__ temp, const float* __restrict__ noise, Weights w,
    const float* __restrict__ h_a0, const float* __restrict__ h_b0,
    const float* __restrict__ sig_mem0, const int* __restrict__ exc0,
    float* __restrict__ sig_out, float* __restrict__ h_a1, float* __restrict__ h_b1,
    float* __restrict__ sig_mem1, int* __restrict__ exc1,
    int T, int F, int B, int GA, int GB, int CD, int P, int gA, int gB, int part_floats) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int NA = 3 * GA;
  const int NB = 3 * GB;
  constexpr int NO = 2 * kLevels;

  extern __shared__ __align__(16) float smem[];
  float* s_part = smem;                 // [part_floats] split-K partial sums
  float* s_wout = s_part + part_floats; // [GB * 512] head weights, staged once
  float* s_whb = s_wout + GB * NO;      // [GB * NB] GRU-B recurrent weights, staged once
  float* s_gxc = s_whb + GB * NB;       // [NA] per-frame conditioning part of gx_a
  float* s_gxbc = s_gxc + NA;           // [NB] per-frame conditioning part of gx_b
  float* s_ghb = s_gxbc + NB;           // [NB]
  float* s_ha = s_ghb + NB;             // [GA]
  float* s_hb = s_ha + GA;              // [GB]
  float* s_cond = s_hb + GB;            // [CD]
  float* s_lpc = s_cond + CD;           // [P]
  float* s_sig = s_lpc + P;             // [P] history, most recent first
  float* s_redv = s_sig + P;            // [32]
  int* s_redi = (int*)(s_redv + 32);    // [32]
  int* s_exc = s_redi + 32;             // [1]

  for (int i = tid; i < GB * NO; i += nt) s_wout[i] = w.w_out[i];
  for (int i = tid; i < GB * NB; i += nt) s_whb[i] = w.wh_b[i];
  for (int u = tid; u < GA; u += nt) s_ha[u] = h_a0[b * GA + u];
  for (int u = tid; u < GB; u += nt) s_hb[u] = h_b0[b * GB + u];
  for (int k = tid; k < P; k += nt) s_sig[k] = sig_mem0[b * P + k];
  if (tid == 0) s_exc[0] = exc0[b];

  const float* emb_sig = w.emb;
  const float* emb_pred = w.emb + (size_t)kLevels * NA;
  const float* emb_exc = w.emb + (size_t)2 * kLevels * NA;

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B + b;
    for (int k = tid; k < CD; k += nt) s_cond[k] = cond[tb * CD + k];
    for (int k = tid; k < P; k += nt) s_lpc[k] = lpc[tb * P + k];
    const float tmp = temp[tb];
    const bool greedy = tmp < 0.f;
    __syncthreads();
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

    for (int i = 0; i < F; ++i) {
      // Every thread derives the prediction and both indices itself (16 FMAs and two
      // log1p): cheaper than a barrier to broadcast them.
      float pred = 0.f;
      for (int k = 0; k < P; ++k) pred = fmaf(s_sig[k], s_lpc[k], pred);
      pred = -pred;
      const int sig_idx = mulaw_encode(s_sig[0]);
      const int pred_idx = mulaw_encode(pred);
      const int exc = s_exc[0];

      // GRU-A: recurrent product as split-K partials, then each unit reduces its three
      // gate columns, adds the fused embedding rows and updates its state.
      matvec_partial(s_ha, w.wh_a, GA, NA, gA, s_part, tid, nt);
      __syncthreads();
      for (int u = tid; u < GA; u += nt) {
        float gx[3], gh[3];
        for (int q = 0; q < 3; ++q) {
          const int c = q * GA + u;
          gh[q] = reduce_part(s_part, gA, NA, c) + w.bh_a[c];
          gx[q] = emb_sig[(size_t)sig_idx * NA + c] + emb_pred[(size_t)pred_idx * NA + c] +
                  emb_exc[(size_t)exc * NA + c] + s_gxc[c];
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

      // Dual heads and Gumbel-max; threads 0..255 hold one level each (nt >= 256).
      if (tid < kLevels) {
        float p1 = 0.f, p2 = 0.f;
        for (int k = 0; k < GB; ++k) {
          const float h = s_hb[k];
          p1 = fmaf(h, s_wout[k * NO + tid], p1);
          p2 = fmaf(h, s_wout[k * NO + kLevels + tid], p2);
        }
        const float t1 = tanhf(p1 + w.ib_out[tid]) * w.g_out[tid];
        const float t2 = tanhf(p2 + w.ib_out[kLevels + tid]) * w.g_out[kLevels + tid];
        const float logit = t1 + t2 + w.b_out[tid];
        float v = greedy ? logit
                         : logit * tmp + noise[((size_t)(t * F + i) * B + b) * kLevels + tid];
        int ix = tid;
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, v, off);
          const int oi = __shfl_down_sync(0xffffffffu, ix, off);
          if (ov > v || (ov == v && oi < ix)) { v = ov; ix = oi; }
        }
        if ((tid & 31) == 0) { s_redv[tid >> 5] = v; s_redi[tid >> 5] = ix; }
      }
      __syncthreads();
      if (tid == 0) {
        float v = s_redv[0];
        int ix = s_redi[0];
        for (int q = 1; q < kLevels / 32; ++q) {
          if (s_redv[q] > v) { v = s_redv[q]; ix = s_redi[q]; }
        }
        s_exc[0] = ix;
        const float sample = fminf(fmaxf(pred + mulaw_decode(ix), -1.f), 1.f);
        for (int k = P - 1; k > 0; --k) s_sig[k] = s_sig[k - 1];
        s_sig[0] = sample;
        sig_out[(size_t)b * T * F + (size_t)t * F + i] = sample;
      }
      __syncthreads();
    }
  }
  for (int u = tid; u < GA; u += nt) h_a1[b * GA + u] = s_ha[u];
  for (int u = tid; u < GB; u += nt) h_b1[b * GB + u] = s_hb[u];
  for (int k = tid; k < P; k += nt) sig_mem1[b * P + k] = s_sig[k];
  if (tid == 0) exc1[b] = s_exc[0];
}

struct Plan {
  int gA, gB, part_floats;
  long long smem;
};

// Split-K group counts and shared-memory bytes for these widths at kThreads.
Plan plan(int GA, int GB, int CD, int P) {
  const int NA = 3 * GA, NB = 3 * GB;
  Plan p;
  p.gA = max(1, kThreads / (NA / 4));
  p.gB = min(16, max(1, kThreads / (NB / 4)));
  p.part_floats = max(p.gA * NA, p.gB * NB);
  p.part_floats = (p.part_floats + 3) / 4 * 4;
  const long long floats = (long long)p.part_floats + GB * 2LL * kLevels + (long long)GB * NB +
                           NA + 2LL * NB + GA + GB + CD + 2LL * P + 32 + 32 + 1;
  p.smem = floats * 4;
  return p;
}

}  // namespace

// All tensors f32 contiguous and 16-byte aligned except exc0/exc1 (int32).  Shapes:
// cond [T,B,CD], lpc [T,B,P], temp [T,B], noise [T,F,B,256] (may be null when every
// temp < 0), sig_out [B, T*F], state [B, .].  GA and GB must be multiples of 4.
// Returns a cudaError_t value (0 = launched).
extern "C" int dss_lpcnet_sampler(
    const float* cond, const float* lpc, const float* temp, const float* noise,
    const float* emb, const float* wx_a_cond, const float* bx_a, const float* wh_a,
    const float* bh_a, const float* wx_b, const float* bx_b, const float* wh_b,
    const float* bh_b, const float* w_out, const float* g_out, const float* ib_out,
    const float* b_out, const float* h_a0, const float* h_b0, const float* sig_mem0,
    const int* exc0, float* sig_out, float* h_a1, float* h_b1, float* sig_mem1, int* exc1,
    int T, int F, int B, int GA, int GB, int CD, int P, void* stream) {
  if (GA % 4 != 0 || GB % 4 != 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan(GA, GB, CD, P);
  if (p.smem > 232448) return (int)cudaErrorInvalidValue;
  if (p.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lpcnet_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  Weights w{emb, wx_a_cond, bx_a, wh_a, bh_a, wx_b, bx_b, wh_b, bh_b, w_out, g_out, ib_out, b_out};
  lpcnet_sampler_kernel<<<B, kThreads, (size_t)p.smem, (cudaStream_t)stream>>>(
      cond, lpc, temp, noise, w, h_a0, h_b0, sig_mem0, exc0, sig_out, h_a1, h_b1, sig_mem1,
      exc1, T, F, B, GA, GB, CD, P, p.gA, p.gB, p.part_floats);
  return (int)cudaGetLastError();
}
