// D3: the word decoder's inference forward in one launch (models/decoder.py,
// BidirectionalSpeechSynthesisModel): a stacked bidirectional LSTM and the Linear(2H -> F)
// regressor over a right-padded batch with per-row lengths, from a given (h0, c0).
//
//   per layer l and direction d, over the row's own T valid frames (forward 0..T-1,
//   backward T-1..0):
//     xp[t]  = (W_ih . in[t]) + (b_ih + b_hh)                   every frame, in parallel
//     pre    = xp[t] + W_hh . h                                 gates i, f, g, o
//     c      = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
//   layer l + 1 reads [h_fwd[t], h_bwd[t]]; the regressor W_out . y[t] + b_out runs on the
//   last layer's frames, and frames T .. Tp-1 of a row hold its frame T-1 (the word
//   path's repeat-pad).  The final (h, c) of each layer and direction are the states
//   after the row's last step, as a packed nn.LSTM run leaves them.
//
// No TPU kernel stands behind it: the JAX package leaves the decoder to XLA's scan.  It
// replaces cuDNN's packed LSTM on the word head: cuDNN ran the packed 2 x 100
// bidirectional decoder a timestep at a time, ~1,400 launches a word (a gemv and a cell
// kernel per layer, direction and frame, plus the packing), 8-10 ms of host time for
// ~0.19 GFLOP of work.
//
// What bounds it.  The work is small (T = 250, 2 x 100 hidden, 64 inputs: ~0.19 GFLOP,
// ~3 us at 67 TFLOP/s), the chain is long: 2 layers x T dependent steps, each a [400 x 100]
// matrix-vector product, four gate activations and the cell.  On one SM a step costs at
// least the product's 40,000 multiply-adds over its 128 lanes (~310 clocks) plus the
// latency of the reduction, the activations, the cell and a block barrier (~400 clocks):
// the chain estimate is 500 steps x ~700 clocks at 1.98 GHz, ~0.18 ms at T = 250, plus
// the input projections.  Measured (tools/torch_bilstm_phases.py, H100, the SM at
// 1.4-1.9 GHz over the kernel): ~1,220 clocks a step (the product ~590: 200 weights a
// thread leave no registers to load h ahead; the activations ~435: each IEEE reciprocal's
// special-case branch keeps the four gate chains apart), 0.50-0.52 ms at T = 250.
//
// Design.  A cluster of 8 blocks of 256 threads a batch row; block rank r works on
// direction r / 4 and gate r % 4.
//  * Input projections: the 8 blocks split them by direction and gate; each stages its
//    [H x K] rows of W_ih in shared memory once a layer and streams the row's frames
//    through in double-buffered chunks (cp.async); a thread keeps 16 frames of two rows in
//    registers.  The result goes to scratch in device memory (it stays in L2).
//  * Recurrence: ranks 0 and 4, one a direction, run the row's T steps.  W_hh stays in
//    registers for the whole layer: a hidden unit is a pair of lanes, lane k holding the
//    columns k * ceil(H/2) .. of the unit's four gate rows (50 of them, so H <= 100), 200
//    floats (8 warps leave a thread 255 registers; 13 would leave 128: a quarter of the
//    SM's registers serves a quarter of its warps).  A step reads h from shared memory
//    (double-buffered, 16-byte loads, one barrier a step), multiplies-and-adds, adds the
//    pair's partial sums by a shuffle, and both lanes compute the four activations and
//    the cell.  Each frame's projections are loaded two steps ahead.
//  * Between phases the cluster meets at a barrier: layer l + 1 reads both directions of
//    layer l at every frame.  cluster.sync() fences the device-memory hand-over (and
//    invalidates the L1), and the scratch is read through L2.
//  * The regressor: the 8 blocks split the frames; W_out^T and a chunk of frames sit in
//    shared memory, a thread computes one feature of one frame; the thread of frame T-1
//    writes the repeat-pad.
//
// Numerics.  float32 throughout.  Every sum is one fused multiply-add chain in a fixed
// order: a projection over the inputs in order, the regressor over its 2H inputs in
// order, the recurrent product per lane over its columns in order and then lane 0 +
// lane 1.  Every other operation is rounded once, in the order of the plain version
// (ops/bilstm.py::bilstm_decode_plain): sigmoid as 1 / (1 + exp(-x)) with the reciprocal
// correctly rounded, libdevice's expf and tanhf (what torch's CUDA exp and tanh call),
// __fmul_rn / __fadd_rn where a product or a sum must not be contracted.  Built without
// --use_fast_math, so kernel and plain version agree bit for bit.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 2;                      // lanes a hidden unit
constexpr int kCols = 50;                      // recurrent columns a lane holds, per gate
constexpr int kMaxHidden = kLanes * kCols;     // 100: the widest H the registers hold
constexpr int kThreads = 256;                  // 8 warps: 128 pairs of lanes
constexpr int kBlk = 52;                       // floats of a lane's h block (16-byte rows)
constexpr int kHBuf = kLanes * kBlk;           // floats of an h buffer
constexpr int kCluster = 8;                    // blocks a row: 2 directions x 4 gates
constexpr int kMaxLayers = 4;
constexpr int kFrames = 16;                    // frames a projecting thread keeps
constexpr int kMaxPhases = 8;                  // frame phases of the projection
constexpr long long kMaxSmem = 232448;         // dynamic shared memory a block may ask for
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* x;        // [B, Tx, E]
  const int* lengths;    // [B]
  const float *h0, *c0;  // [2L, B, H] each, or null: zeros
  const float* w_ih[kMaxLayers][2];  // [4H, K]: K = E at layer 0, 2H above
  const float* w_hh[kMaxLayers][2];  // [4H, H]
  const float* b_ih[kMaxLayers][2];  // [4H]
  const float* b_hh[kMaxLayers][2];  // [4H]
  const float* w_out;    // [F, 2H]
  const float* b_out;    // [F]
  float* xp;             // scratch [B, 2, Tx, 4H]: a layer's input projections
  float* y[2];           // scratch [B, Tx, 2H]: layer l's outputs in y[l % 2]
  float* feats;          // [B, Tp, F]
  float *hn, *cn;        // [2L, B, H] each
  int B, Tx, Tp, E, H, L, F;
  int region[2];         // floats of the two shared-memory work regions
};

// A row length in floats whose float4 stride is odd: a warp's 16-byte loads of adjacent
// rows then hit distinct banks.
__host__ __device__ inline int padded(int K) {
  const int p = (K + 3) & ~3;
  return ((p >> 2) & 1) ? p : p + 4;
}

// A projecting thread computes rows r and r + ceil(H/2) of kFrames frames; the threads
// of a block cover the rows ceil(H/2) times over (the frame phases).
__host__ __device__ inline int phases(int H) {
  const int n = kThreads / ((H + 1) / 2);
  return n < kMaxPhases ? n : kMaxPhases;
}

// Floats of the two shared-memory work regions: [0] the projection's weight rows or the
// regressor's W_out^T, [1] the projection's two chunks of frames or the regressor's.
__host__ inline void regions(int E, int H, int L, int F, int out[2]) {
  const int Kp = padded(L > 1 ? std::max(E, 2 * H) : E);
  const int rows = 2 * ((H + 1) / 2);
  out[0] = (std::max(rows * Kp, 2 * H * F) + 3) & ~3;
  out[1] = (std::max(2 * phases(H) * kFrames * Kp, (kThreads / F) * 2 * H) + 3) & ~3;
}

__host__ inline long long smem_bytes(int E, int H, int L, int F) {
  int r[2];
  regions(E, H, L, F, r);
  return 4LL * ((long long)r[0] + r[1] + 2 * kHBuf);
}

__host__ inline bool supported(int E, int H, int L, int F) {
  return H >= 1 && H <= kMaxHidden && L >= 1 && L <= kMaxLayers && E >= 1 && F >= 1 &&
         F <= kThreads && smem_bytes(E, H, L, F) <= kMaxSmem;
}

#ifdef DSS_BILSTM_TRACE
// Built only with -DDSS_BILSTM_TRACE (a measuring build, tools/torch_bilstm_phases.py):
// the first block's thread 0 stamps the global timer (ns) at the kernel's start and after
// each phase (g_trace[0..2L+1]), and sums the SM clocks of its recurrent steps by part
// (g_trace[10..13]: the product and its reduction, the gate activations, the cell, the
// barrier; g_trace[14]: the steps; g_trace[15]: the SM clocks of the whole recurrences).
__device__ long long g_trace[16];
#define BL_STAMP(i)                                                                   \
  do {                                                                                \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                        \
      long long ns;                                                                   \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                          \
      g_trace[i] = ns;                                                                \
    }                                                                                 \
  } while (0)
#define BL_CLOCK(v) const long long v = clock64()
#define BL_SUMS long long bl_sum[6] = {}
#define BL_ADD(i, a, b) bl_sum[(i) - 10] += (b) - (a)
#define BL_FLUSH()                                                        \
  if (blockIdx.x == 0 && threadIdx.x == 0)                                \
    for (int i = 0; i < 6; ++i) g_trace[10 + i] += bl_sum[i]
#else
#define BL_STAMP(i) \
  do {              \
  } while (0)
#define BL_CLOCK(v)
#define BL_SUMS
#define BL_ADD(i, a, b)
#define BL_FLUSH()
#endif

__device__ __forceinline__ float sigmoid_rn(float v) {
  return __frcp_rn(__fadd_rn(1.f, expf(-v)));
}

// Copies rows [n][K] of `src` (row stride K) into `dst` (row stride Kp) asynchronously:
// 16 bytes at a time where K allows it.
__device__ __forceinline__ void stage(float* dst, int Kp, const float* src, int K, int n) {
  if ((K & 3) == 0) {
    const int K4 = K >> 2;
    for (int i = threadIdx.x; i < n * K4; i += kThreads) {
      const int r = i / K4, k4 = i - r * K4;
      __pipeline_memcpy_async(dst + (size_t)r * Kp + 4 * k4, src + (size_t)r * K + 4 * k4, 16);
    }
  } else {
    for (int i = threadIdx.x; i < n * K; i += kThreads) {
      const int r = i / K, k = i - r * K;
      __pipeline_memcpy_async(dst + (size_t)r * Kp + k, src + (size_t)r * K + k, 4);
    }
  }
  __pipeline_commit();
}

// Zeroes columns K .. Kp-1 of rows [n][Kp].
__device__ __forceinline__ void zero_pad(float* dst, int Kp, int K, int n) {
  const int w = Kp - K;
  for (int i = threadIdx.x; i < n * w; i += kThreads) dst[(size_t)(i / w) * Kp + K + i % w] = 0.f;
}

// The input projections of gate q's rows of direction d for frames 0 .. len-1 of `in`
// ([Tx, K], row-major) into xp_d ([Tx, 4H]).  sW holds the rows [2 ceil(H/2)][Kp] (zero
// past H), sX two chunks of frames [chunk][Kp] (the next one arrives while this one is
// used), all zero past K.  The frames are read after a cluster barrier, so the L1 holds
// nothing stale of them.
__device__ void project(const Params& p, int l, int d, int q, int len, const float* in,
                        float* xp_d, float* sW, float* sX) {
  const int H = p.H, G = 4 * H, tid = threadIdx.x;
  const int K = l == 0 ? p.E : 2 * H;
  const int Kp = padded(K), K4 = Kp >> 2;
  const int Hh = (H + 1) / 2, P = phases(H), chunk = P * kFrames;
  stage(sW, Kp, p.w_ih[l][d] + (size_t)q * H * K, K, H);
  zero_pad(sW, Kp, K, H);
  for (int i = H * Kp + tid; i < 2 * Hh * Kp; i += kThreads) sW[i] = 0.f;
  zero_pad(sX, Kp, K, 2 * chunk);
  if (len > 0) stage(sX, Kp, in, K, min(chunk, len));
  const int r = tid % Hh, ph = tid / Hh;
  const bool on = ph < P, on1 = on && r + Hh < H;
  const float* b_ih = p.b_ih[l][d] + q * H;
  const float* b_hh = p.b_hh[l][d] + q * H;
  const float bias0 = on ? __fadd_rn(b_ih[r], b_hh[r]) : 0.f;
  const float bias1 = on1 ? __fadd_rn(b_ih[r + Hh], b_hh[r + Hh]) : 0.f;
  for (int t0 = 0, i = 0; t0 < len; t0 += chunk, ++i) {
    const int n = min(chunk, len - t0);
    __pipeline_wait_prior(0);
    __syncthreads();  // this chunk (and the rows) landed; the other buffer is free
    float* cur = sX + (size_t)(i & 1) * chunk * Kp;
    if (t0 + chunk < len)
      stage(sX + (size_t)((i + 1) & 1) * chunk * Kp, Kp, in + (size_t)(t0 + chunk) * K, K,
            min(chunk, len - t0 - chunk));
    if (on) {
      float acc0[kFrames], acc1[kFrames];
#pragma unroll
      for (int m = 0; m < kFrames; ++m) acc0[m] = acc1[m] = 0.f;
      const float4* w0 = reinterpret_cast<const float4*>(sW) + (size_t)r * K4;
      const float4* w1 = w0 + (size_t)Hh * K4;
      const float4* x4 = reinterpret_cast<const float4*>(cur) + (size_t)ph * K4;
      for (int k4 = 0; k4 < K4; ++k4) {
        const float4 wa = w0[k4], wb = w1[k4];
#pragma unroll
        for (int m = 0; m < kFrames; ++m) {
          const float4 xv = x4[(size_t)m * P * K4 + k4];
          acc0[m] = fmaf(wa.x, xv.x, acc0[m]);
          acc1[m] = fmaf(wb.x, xv.x, acc1[m]);
          acc0[m] = fmaf(wa.y, xv.y, acc0[m]);
          acc1[m] = fmaf(wb.y, xv.y, acc1[m]);
          acc0[m] = fmaf(wa.z, xv.z, acc0[m]);
          acc1[m] = fmaf(wb.z, xv.z, acc1[m]);
          acc0[m] = fmaf(wa.w, xv.w, acc0[m]);
          acc1[m] = fmaf(wb.w, xv.w, acc1[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < kFrames; ++m) {
        const int f = ph + P * m;
        if (f < n) {
          float* o = xp_d + (size_t)(t0 + f) * G + q * H + r;
          o[0] = __fadd_rn(acc0[m], bias0);
          if (on1) o[Hh] = __fadd_rn(acc1[m], bias1);
        }
      }
    }
    __syncthreads();  // this chunk is used: the next turn's copy may overwrite it
  }
  __pipeline_wait_prior(0);  // nothing left in flight (a row of length 0 waits here)
}

// Direction d of layer l over the row's len frames: h into y_out ([Tx, 2H], columns
// d*H ..), the final (h, c) into hn / cn.  sH: two h buffers of kHBuf floats, lane k's
// columns k*nc .. k*nc + nc-1 at k*kBlk.
__device__ void recur(const Params& p, int l, int d, int b, int len, const float* xp_d,
                      float* y_out, float* sH) {
  const int H = p.H, G = 4 * H, tid = threadIdx.x;
  const int nc = (H + kLanes - 1) / kLanes;  // columns of a lane
  const int u = tid >> 1, k = tid & 1;
  const bool on = u < H;
  const float* whh = p.w_hh[l][d];
  float w[4][kCols];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = k * nc + j;
      w[g][j] = on && j < nc && c < H ? whh[(size_t)(g * H + u) * H + c] : 0.f;
    }
  }
  BL_SUMS;
  const size_t st = ((size_t)(l * 2 + d) * p.B + b) * H + u;
  float h = on && p.h0 ? p.h0[st] : 0.f;
  float c = on && p.c0 ? p.c0[st] : 0.f;
  const int slot = (u / nc) * kBlk + u % nc;  // unit u's place in an h buffer
  for (int i = tid; i < 2 * kHBuf; i += kThreads) sH[i] = 0.f;
  __syncthreads();
  if (on && k == 0) sH[slot] = h;
  __syncthreads();
  // The four gates of unit u at frame t (lanes past H read unit H-1's, unused); the rows
  // past the row's length are clamped to its last, so that a load is never predicated and
  // its register is written only by the load: it is in flight for a whole step.
  const float* xq_at = xp_d + min(u, H - 1);
  auto load = [&](int s, float4& x) {
    const float* at = xq_at + (size_t)(d == 0 ? min(s, len - 1) : max(len - 1 - s, 0)) * G;
    x = make_float4(__ldcg(at), __ldcg(at + H), __ldcg(at + 2 * H), __ldcg(at + 3 * H));
  };
  auto step = [&](int s, int t, const float4& xq) {
    BL_CLOCK(c0);
    const float4* hc = reinterpret_cast<const float4*>(sH + (s & 1) * kHBuf + k * kBlk);
    float* hn = sH + ((s + 1) & 1) * kHBuf;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int j4 = 0; j4 < kCols / 4; ++j4) {
      const float4 v = hc[j4];
      const float hv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * j4 + e;
        a0 = fmaf(w[0][j], hv[e], a0);
        a1 = fmaf(w[1][j], hv[e], a1);
        a2 = fmaf(w[2][j], hv[e], a2);
        a3 = fmaf(w[3][j], hv[e], a3);
      }
    }
    {
      static_assert(kCols % 4 == 2, "the tail below is two columns");
      const float2 v = reinterpret_cast<const float2*>(hc + kCols / 4)[0];
      const float hv[2] = {v.x, v.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kCols - 2 + e;
        a0 = fmaf(w[0][j], hv[e], a0);
        a1 = fmaf(w[1][j], hv[e], a1);
        a2 = fmaf(w[2][j], hv[e], a2);
        a3 = fmaf(w[3][j], hv[e], a3);
      }
    }
    // lane 0 + lane 1, on both lanes of the pair.
    a0 = __fadd_rn(a0, __shfl_xor_sync(kFull, a0, 1));
    a1 = __fadd_rn(a1, __shfl_xor_sync(kFull, a1, 1));
    a2 = __fadd_rn(a2, __shfl_xor_sync(kFull, a2, 1));
    a3 = __fadd_rn(a3, __shfl_xor_sync(kFull, a3, 1));
    BL_CLOCK(c1);
    // Both lanes activate all four gates: four independent chains, no divergence.
    const float ig = sigmoid_rn(__fadd_rn(xq.x, a0));
    const float fg = sigmoid_rn(__fadd_rn(xq.y, a1));
    const float gg = tanhf(__fadd_rn(xq.z, a2));
    const float og = sigmoid_rn(__fadd_rn(xq.w, a3));
    BL_CLOCK(c2);
    c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
    h = __fmul_rn(og, tanhf(c));
    if (on && k == 0) {
      hn[slot] = h;
      y_out[(size_t)t * 2 * H + d * H + u] = h;
    }
    BL_CLOCK(c3);
    __syncthreads();
    BL_CLOCK(c4);
    BL_ADD(10, c0, c1);
    BL_ADD(11, c1, c2);
    BL_ADD(12, c2, c3);
    BL_ADD(13, c3, c4);
    BL_ADD(14, 0, 1);
  };
  // Two steps a turn, each frame's projections loaded two steps ahead into one of two
  // register pairs.
  BL_CLOCK(r0);
  if (len > 0) {
    float4 xa, xb;
    load(0, xa);
    load(1, xb);
    const int dt = d == 0 ? 1 : -1;
    int t = d == 0 ? 0 : len - 1;
    for (int s = 0; s < len; s += 2, t += 2 * dt) {
      step(s, t, xa);
      load(s + 2, xa);
      if (s + 1 < len) {
        step(s + 1, t + dt, xb);
        load(s + 3, xb);
      }
    }
  }
  BL_CLOCK(r1);
  BL_ADD(15, r0, r1);
  BL_FLUSH();
  if (on && k == 0) {
    p.hn[st] = h;
    p.cn[st] = c;
  }
}

// The regressor on frames 0 .. len-1 of y ([Tx, 2H]), split over the cluster's blocks by
// frame, and the repeat-pad of frames len .. Tp-1.  sW holds W_out^T [2H][F], sY a chunk
// of frames [kThreads / F][2H].
__device__ void regress(const Params& p, int b, int rank, int len, const float* y, float* sW,
                        float* sY) {
  const int H2 = 2 * p.H, F = p.F, tid = threadIdx.x;
  for (int i = tid; i < H2 * F; i += kThreads) {
    const int k = i / F, o = i - k * F;
    sW[i] = p.w_out[(size_t)o * H2 + k];
  }
  const int FC = kThreads / F;
  const int per = (len + kCluster - 1) / kCluster;
  const int lo = min(len, rank * per), hi = min(len, lo + per);
  const int fo = tid / F, o = tid - fo * F;
  const float bias = fo < FC ? p.b_out[o] : 0.f;
  float* out = p.feats + (size_t)b * p.Tp * F;
  for (int t0 = lo; t0 < hi; t0 += FC) {
    const int n = min(FC, hi - t0);
    __syncthreads();  // W_out^T is staged; the last chunk's frames are read
    for (int i = tid; i < n * H2; i += kThreads) sY[i] = __ldcg(y + (size_t)t0 * H2 + i);
    __syncthreads();
    if (fo < n) {
      const float* yr = sY + fo * H2;
      float acc = 0.f;
      for (int k = 0; k < H2; ++k) acc = fmaf(sW[k * F + o], yr[k], acc);
      const float v = __fadd_rn(acc, bias);
      const int t = t0 + fo;
      out[(size_t)t * F + o] = v;
      if (t == len - 1)
        for (int tt = len; tt < p.Tp; ++tt) out[(size_t)tt * F + o] = v;
    }
  }
  if (len == 0 && rank == 0)
    for (int i = tid; i < p.Tp * F; i += kThreads) out[i] = 0.f;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
bilstm_decoder_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int d = rank >> 2, q = rank & 3;
  const int len = min(max(p.lengths[b], 0), p.Tx);
  float* sA = smem;
  float* sB = smem + p.region[0];
  float* sH = sB + p.region[1];
  const size_t rows = (size_t)b * p.Tx;
  BL_STAMP(0);
  for (int l = 0; l < p.L; ++l) {
    const float* in = l == 0 ? p.x + rows * p.E : p.y[(l - 1) & 1] + rows * 2 * p.H;
    float* xp_d = p.xp + ((size_t)b * 2 + d) * p.Tx * 4 * p.H;
    project(p, l, d, q, len, in, xp_d, sA, sB);
    cluster.sync();
    BL_STAMP(2 * l + 1);
    if (q == 0) recur(p, l, d, b, len, xp_d, p.y[l & 1] + rows * 2 * p.H, sH);
    cluster.sync();
    BL_STAMP(2 * l + 2);
  }
  regress(p, b, rank, len, p.y[(p.L - 1) & 1] + rows * 2 * p.H, sA, sB);
  BL_STAMP(2 * p.L + 1);
}

}  // namespace

// One launch: a cluster of 8 blocks a batch row.  All float tensors f32 contiguous;
// lengths int32 [B] on the card (clamped to 0 .. Tx; a row of length 0 leaves its state
// and writes zero features); layer_w holds 4 pointers a layer and direction, in the order
// (layer, direction, [w_ih, w_hh, b_ih, b_hh]); h0 and c0 may be null (zeros).  Scratch:
// xp B * 2 * Tx * 4H floats, y0 and y1 B * Tx * 2H (y1 unused at L = 1).  Tp >= Tx.
// Returns a cudaError_t value (0 = launched).
extern "C" int dss_bilstm_decoder(const float* x, const int* lengths, const float* h0,
                                  const float* c0, const void* const* layer_w,
                                  const float* w_out, const float* b_out, float* xp, float* y0,
                                  float* y1, float* feats, float* hn, float* cn, int B, int Tx,
                                  int Tp, int E, int H, int L, int F, cudaStream_t stream) {
  if (!supported(E, H, L, F) || B < 1 || Tx < 1 || Tp < Tx) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.lengths = lengths;
  p.h0 = h0;
  p.c0 = c0;
  for (int l = 0; l < L; ++l)
    for (int d = 0; d < 2; ++d) {
      const void* const* w = layer_w + (l * 2 + d) * 4;
      p.w_ih[l][d] = static_cast<const float*>(w[0]);
      p.w_hh[l][d] = static_cast<const float*>(w[1]);
      p.b_ih[l][d] = static_cast<const float*>(w[2]);
      p.b_hh[l][d] = static_cast<const float*>(w[3]);
    }
  p.w_out = w_out;
  p.b_out = b_out;
  p.xp = xp;
  p.y[0] = y0;
  p.y[1] = y1;
  p.feats = feats;
  p.hn = hn;
  p.cn = cn;
  p.B = B;
  p.Tx = Tx;
  p.Tp = Tp;
  p.E = E;
  p.H = H;
  p.L = L;
  p.F = F;
  regions(E, H, L, F, p.region);
  const int bytes = (int)smem_bytes(E, H, L, F);
  // The shared-memory limit is a property of the kernel on each device: raised once per
  // device to the largest size launched there.
  static std::mutex mu;
  static int granted[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    if (bytes > granted[dev]) {
      e = cudaFuncSetAttribute(bilstm_decoder_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (e != cudaSuccess) return (int)e;
      granted[dev] = bytes;
    }
  }
  bilstm_decoder_kernel<<<B * kCluster, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// What the kernel takes at these widths: out[0] the widest H whose W_hh the recurrent
// block keeps in registers, out[1] the shared-memory bytes a block asks for, out[2] 1 when
// the kernel takes (E, H, L, F), out[3] the blocks a row (cluster size), out[4] threads a
// block, out[5] the most layers.  Needs no card.
extern "C" int dss_bilstm_plan(int E, int H, int L, int F, int* out) {
  out[0] = kMaxHidden;
  out[1] = H >= 1 && F >= 1 && E >= 1 ? (int)smem_bytes(E, H, L, F) : 0;
  out[2] = supported(E, H, L, F) ? 1 : 0;
  out[3] = kCluster;
  out[4] = kThreads;
  out[5] = kMaxLayers;
  return 0;
}

#ifdef DSS_BILSTM_TRACE
// The traced launches' stamps and clock sums (synchronizes); zero clears them.
extern "C" int dss_bilstm_trace(long long* out, int zero) {
  if (zero) {
    static const long long z[16] = {};
    return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
#endif
