// D1: the DSP vocoder's whole call — frame parameters, noise, and the sample loop (pulse
// train + noise excitation, 16-tap all-pole synthesis filter, de-emphasis, clip) — over B
// streams and T frames of 160 samples, in one launch, frame-parallel.
//
// The sample loop, per stream and sample, with the frame's lpc[16], gain, v_mix, voiced and
// period held:
//     pulse_now = phase <= 0
//     t1        = pulse_now ? (voiced ? v_mix * sqrt(period) : 0) : 0
//     phase     = (pulse_now ? period : phase) - 1
//     e         = gain * ((t1 + (1 - v_mix) * n) + (v_mix * 0.25) * n)
//     s         = e - tree_sum(sig_mem[k] * lpc[k])      sig_mem[0] newest
//     sig_mem   = [s, sig_mem[0..14]]
//     y         = s + 0.85 * y
//     pcm       = clip(y, -1, 1)
//
// No TPU kernel stands behind it: the JAX package runs the frame-rate part eagerly and the
// loop as two nested lax.scans (dss_tpu/vocoder/dsp.py:44-98), which XLA runs serially.
//
// What bounds it.  A 260-frame word is ~0.35 MB and ~2 MFLOP: microseconds at the card's
// rates.  Run serially, the loop is a chain of 41,600 dependent samples (~6 dependent
// operations each, s through one product and the tap tree); the first form of this kernel
// ran it on one lane of one SM (1.6 ms a word).  Only a 16-float memory, a pitch phase and
// a de-emphasis value carry from frame to frame, and the filter is linear in its state, so
// the work is rearranged into frame-parallel phases with two short serial passes:
//
//   A  (frame-parallel, one warp a frame) the frame parameters, in the eager order of
//      vocoder/dsp.py::frame_parameters: the pitch decode; cepstrum -> LPC in the order of
//      vocoder/lpc.py::lpc_from_cepstrum_framewise (cepstrum_lpc.cuh, which the neural
//      vocoder's LPC kernel shares); gain, v_mix, voiced; and, unless the caller gives it, the
//      noise (the counter hash and Box-Muller of vocoder/dsp.py::gaussian_noise).
//   B  (serial, one warp, beside A on an SM of its own) the pitch phase entering each
//      frame: the pulses of a frame fall at max(p, 0) + j * period, which gives the phase
//      after it (the division by the period as a product and a shift).
//   B' (frame-parallel) each frame's 160 excitation samples.
//   C  (frame-parallel, one lane a run) each frame's linear map from entering to leaving
//      state: the sample loop from each of the 16 unit memories with no excitation (the
//      transition Phi and the de-emphasis weights w), and from zero state with the frame's
//      excitation (c and cd).  17 runs of 160 samples a frame.
//   D  (serial, one warp) the carry: m' = c + tree(Phi m), d' = (cd + tree(w m)) + 0.85^160 d,
//      17 lanes, one 16-term tree each; the state goes round through shared memory, and
//      four more warps stream the frames' records into a ring of shared memory by cp.async,
//      up to 24 frames ahead.
//   E  (frame-parallel, one lane a frame) each frame's 160 samples rerun from its entering
//      state with the serial loop's arithmetic, then de-emphasis and clip.
//
// One thread-block cluster a stream (8 blocks of 16 warps) runs the phases with a cluster
// barrier between them; phase outputs go through a scratch buffer in device memory (it stays
// in L2: ~2 KB a frame).  Warps are numbered across the cluster with the block fastest, so a
// phase with few frames spreads over all 8 SMs.  A call is one launch whatever B and T; each
// phase loops over the frames it has.  Chunk invariance: A, B', C and E are per-frame
// arithmetic and B, D run over frames in order from the carried state, and the state a call
// returns is D's (not the last samples of E), so 100 frames equal 50 + 50 bit for bit.
//
// Numerics.  Every + - * / is written __fadd_rn / __fmul_rn / __fdiv_rn (nvcc contracts
// nothing into an FMA), in the order of the plain versions: phases B-E equal
// ops/dsp_synthesis.py::dsp_synthesis_blocked_plain bit for bit, and phase A the eager
// frame_parameters and gaussian_noise on the card (torch's powf, logf, cosf and sinf are the
// same library calls, and torch divides a CUDA tensor by a scalar as a product with the
// scalar's float reciprocal, which the gain follows).  Against the serial loop
// (dsp_synthesis_plain) the entering states differ by rounding (the same terms summed in
// another order).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cepstrum_lpc.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFrame = 160;
constexpr int kRuns = kOrder + 1;          // runs of phase C a frame
constexpr int kFeat = 20;
constexpr int kRow = 20;                   // floats a row of a frame's record (16-B rows)
constexpr int kRec = kRuns * kRow;         // a frame's record: its 17 x 17 carry map
constexpr int kCluster = 8;                // blocks a stream
constexpr int kWarps = 16;                 // warps a block
constexpr int kThreads = kWarps * kLanes;
constexpr int kClusterWarps = kCluster * kWarps;
constexpr int kChunk = 8;                  // frames a slot of the carry pass's ring
constexpr int kSlots = 4;                  // slots: the feed runs up to 3 slots ahead
constexpr int kProducers = 4;              // warps that stream records into the ring
constexpr float kPreemph = 0.85f;
static_assert(kOrder == 16, "the tap tree below is written for 16 taps");
static_assert(kFrame % kLanes == 0 && kFrame % kOrder == 0, "frame layout");
static_assert(kRow % 4 == 0 && kRow > kOrder, "record layout");

struct Args {
  const float* features;  // [B, T, 20], or null: the parameters are given
  const float* tables;
  float* lpc;             // [B, T, 16]   written by phase A, or given
  float* gain;            // [B, T]
  float* v_mix;           // [B, T]
  uint8_t* voiced;        // [B, T]
  int* period;            // [B, T]
  float* noise;           // [B, T, 160]  written by phase A when gen_noise, else given
  const float* sig_mem_in;
  const int* phase_in;
  const float* deemph_in;
  float* pcm;             // [B, T * 160]
  float* sig_mem_out;
  int* phase_out;
  float* deemph_out;
  float* excite;          // scratch [B, T, 160]
  float* rec;             // scratch [B, T, 17 rows, kRow]: row j < 16 Phi[j][0..15], c_j;
                          // row 16 w[0..15], cd
  float* m_in;            // scratch [B, T, 16]
  float* d_in;            // scratch [B, T]
  int* ph_in;             // scratch [B, T]
  uint32_t seed, first_frame;
  float deemph_frame;     // 0.85^160 as the de-emphasis rounds it
  int T, gen_noise;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);  // torch.clamp: NaN stays NaN
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {  // MurmurHash3's finalizer
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// features[18] -> period in [32, 256], round half to even (vocoder/features.py).
__device__ __forceinline__ int decode_period(float f18) {
  return static_cast<int>(clampf(rintf(__fadd_rn(__fmul_rn(f18, 50.0f), 100.0f)), 32.0f,
                                 256.0f));
}

// The pitch phase after a frame entered with phase p (ops/dsp_synthesis.py::next_phase).
// inv = ceil(2^16 / period): for 0 <= x < 160, (x * inv) >> 16 is x / period for every
// period >= 1, a product and a shift on phase B's chain in place of a division.
__device__ __forceinline__ int next_phase(int p, int period, int inv) {
  const int f = max(p, 0);
  const int x = kFrame - 1 - f;
  const int rest = x - ((x * inv) >> 16) * period;
  return f >= kFrame ? p - kFrame : period - 1 - rest;
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  __threadfence_block();  // what this thread wrote to shared memory, before the signal
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#ifdef DSS_DSP_TRACE
// Built only with -DDSS_DSP_TRACE (a measuring build): the global timer (ns) at the kernel's
// start and after each phase, in the first block of the first stream.
__device__ long long g_trace[8];
#define DSP_TRACE(i)                                                                   \
  do {                                                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                         \
      long long ns;                                                                    \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));                           \
      g_trace[i] = ns;                                                                 \
    }                                                                                  \
  } while (0)
#else
#define DSP_TRACE(i) \
  do {               \
  } while (0)
#endif

// Phase A for frame fi (= b * T + t) on one warp.  psd: this warp's 256 floats of shared
// memory.
__device__ void frame_prologue(const Args& a, int b, int t, int lane, float* psd) {
  const size_t fi = static_cast<size_t>(b) * a.T + t;
  const float* feat = a.features + fi * kFeat;
  const float ceps = lane < kBands ? __ldg(feat + lane) : 0.0f;
  const float f18 = __ldg(feat + kBands), f19 = __ldg(feat + kBands + 1);
  float lpc[kOrder];
  const float err = cepstrum_lpc(ceps, a.tables, lane, psd, lpc);

  const float corr = clampf(__fadd_rn(f19, 0.5f), 0.0f, 1.0f);
  if (lane < kOrder) a.lpc[fi * kOrder + lane] = lane_tap(lpc, lane);
  if (lane == kOrder) {
    const float e = err < 1e-12f ? 1e-12f : err;
    // torch divides a CUDA tensor by a scalar as a product with its float reciprocal.
    a.gain[fi] = __fsqrt_rn(__fmul_rn(__fmul_rn(e, 1.0f / 320.0f), 2.0f));
    a.v_mix[fi] = clampf(__fdiv_rn(__fsub_rn(corr, 0.3f), 0.5f), 0.0f, 1.0f);
    a.voiced[fi] = corr > 0.3f;
    a.period[fi] = decode_period(f18);
  }

  if (a.gen_noise) {
    // Two uniforms a pair of outputs: the radius from position 2i, the angle from 2i + 1.
    const uint32_t key = fmix32(fmix32(a.first_frame + static_cast<uint32_t>(t)) ^
                                (a.seed + static_cast<uint32_t>(b)));
    float* nz = a.noise + fi * kFrame;
    for (int i = lane; i < kFrame / 2; i += kLanes) {
      const float u0 = __fmul_rn(static_cast<float>(fmix32(key ^ (2u * i)) >> 8),
                                 5.9604644775390625e-08f);
      const float u1 = __fmul_rn(static_cast<float>(fmix32(key ^ (2u * i + 1u)) >> 8),
                                 5.9604644775390625e-08f);
      const float rad = __fsqrt_rn(__fmul_rn(logf(__fsub_rn(1.0f, u0)), -2.0f));
      const float theta = __fmul_rn(static_cast<float>(2.0 * 3.141592653589793), u1);
      nz[i] = __fmul_rn(rad, cosf(theta));
      nz[kFrame / 2 + i] = __fmul_rn(rad, sinf(theta));
    }
  }
}

// Phase B on one warp: the pitch phase entering each frame of stream b, 32 frames a round.
__device__ void pitch_phases(const Args& a, int b, int lane) {
  const size_t base = static_cast<size_t>(b) * a.T;
  int p = a.phase_in[b];
  for (int t0 = 0; t0 < a.T; t0 += kLanes) {
    const int t = t0 + lane;
    int per = 1, mine = 0;
    if (t < a.T)
      per = a.features ? decode_period(__ldg(a.features + (base + t) * kFeat + kBands))
                       : __ldcg(a.period + base + t);
    const int inv = (65536 + per - 1) / per;
    const int n = min(kLanes, a.T - t0);
    int pers[kLanes], invs[kLanes];  // every lane gets the round's 32 periods first
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      pers[i] = __shfl_sync(kFull, per, i);
      invs[i] = __shfl_sync(kFull, inv, i);
    }
#pragma unroll
    for (int i = 0; i < kLanes; ++i) {
      if (i < n) {
        if (lane == i) mine = p;
        p = next_phase(p, pers[i], invs[i]);
      }
    }
    if (t < a.T) a.ph_in[base + t] = mine;
  }
  if (lane == 0) a.phase_out[b] = p;
  DSP_TRACE(6);
}

// Phase B' for frame fi on one warp: its excitation from its entering phase.
__device__ void frame_excitation(const Args& a, size_t fi, int lane) {
  const float g = __ldcg(a.gain + fi), vm = __ldcg(a.v_mix + fi);
  const int per = __ldcg(a.period + fi);
  const float amp = __ldcg(a.voiced + fi) ? __fmul_rn(vm, __fsqrt_rn(static_cast<float>(per)))
                                          : 0.0f;
  const float omv = __fsub_rn(1.0f, vm), vq = __fmul_rn(vm, 0.25f);
  const int f = max(__ldcg(a.ph_in + fi), 0);
#pragma unroll
  for (int j = 0; j < kFrame / kLanes; ++j) {
    const int i = lane + j * kLanes;
    const float n = __ldcg(a.noise + fi * kFrame + i);
    const float t1 = (i >= f && (i - f) % per == 0) ? amp : 0.0f;
    a.excite[fi * kFrame + i] =
        __fmul_rn(g, __fadd_rn(__fadd_rn(t1, __fmul_rn(omv, n)), __fmul_rn(vq, n)));
  }
}

// The sample loop over one frame on one lane, from memory m and de-emphasis value y:
// excitation from ep where live, else zero; the clipped samples to out when kStore.
template <bool kStore>
__device__ __forceinline__ void run_frame(const float (&lpc)[kOrder], float (&m)[kOrder],
                                          float& y, const float* ep, bool live, float* out) {
  float ex[kOrder];  // this block of 16 samples' excitation; the next one is loaded ahead
#pragma unroll
  for (int k = 0; k < kOrder; ++k) ex[k] = live ? __ldcg(ep + k) : 0.0f;
  for (int i0 = 0; i0 < kFrame; i0 += kOrder) {
    float nx[kOrder];
#pragma unroll
    for (int k = 0; k < kOrder; ++k)
      nx[k] = live && i0 + kOrder < kFrame ? __ldcg(ep + i0 + kOrder + k) : 0.0f;
#pragma unroll
    for (int k = 0; k < kOrder; ++k) {
      float p[kOrder];
#pragma unroll
      for (int j = 0; j < kOrder; ++j) p[j] = __fmul_rn(m[j], lpc[j]);
      const float s = __fsub_rn(ex[k], tree(p));
#pragma unroll
      for (int j = kOrder - 1; j > 0; --j) m[j] = m[j - 1];
      m[0] = s;
      y = __fadd_rn(s, __fmul_rn(kPreemph, y));
      if (kStore) out[i0 + k] = fminf(fmaxf(y, -1.0f), 1.0f);
    }
#pragma unroll
    for (int k = 0; k < kOrder; ++k) ex[k] = nx[k];
  }
}

__device__ __forceinline__ void load_lpc(const Args& a, size_t fi, float (&lpc)[kOrder]) {
  const float4* src = reinterpret_cast<const float4*>(a.lpc + fi * kOrder);
#pragma unroll
  for (int k = 0; k < kOrder / 4; ++k) {
    const float4 v = __ldcg(src + k);
    lpc[4 * k] = v.x;
    lpc[4 * k + 1] = v.y;
    lpc[4 * k + 2] = v.z;
    lpc[4 * k + 3] = v.w;
  }
}

// Phase D.  Warp 0 of the stream's first block walks the frames (carry_pass); warps 1 ..
// kProducers of that block stream the records into a ring of kSlots slots of kChunk frames
// (carry_feed).  Named barriers hand the slots over: kBarFull + s when slot s is filled,
// kBarEmpty + s when it has been read.
constexpr int kFeedThreads = (1 + kProducers) * kLanes;
constexpr int kBarFull = 1, kBarEmpty = kBarFull + kSlots;
static_assert(kBarEmpty + kSlots <= 16, "named barriers");

__device__ void carry_feed(const Args& a, int b, int producer_lane, float* ring) {
  const size_t base = static_cast<size_t>(b) * a.T;
  for (int c = 0; c * kChunk < a.T; ++c) {
    const int slot = c % kSlots;
    if (c >= kSlots) named_barrier(kBarEmpty + slot, kFeedThreads);
    const int frames = min(kChunk, a.T - c * kChunk);
    const float* src = a.rec + (base + static_cast<size_t>(c) * kChunk) * kRec;
    float* dst = ring + slot * kChunk * kRec;
    for (int u = producer_lane; u < frames * kRec / 4; u += kProducers * kLanes)
      cp_async16(dst + 4 * u, src + 4 * u);
    cp_async_commit();
    cp_async_wait<0>();
    named_arrive(kBarFull + slot, kFeedThreads);
  }
}

// Lanes 0-15 carry the filter memory, lane 16 the de-emphasis value; the state is broadcast
// through shared memory (sh_x, 20 floats) and each lane reads its row of the record.
__device__ void carry_pass(const Args& a, int b, int lane, const float* ring, float* sh_x) {
  const size_t base = static_cast<size_t>(b) * a.T;
  float x = lane < kOrder ? a.sig_mem_in[b * kOrder + lane]
                          : (lane == kOrder ? a.deemph_in[b] : 0.0f);
  const int chunks = (a.T + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % kSlots;
    named_barrier(kBarFull + slot, kFeedThreads);
    const int frames = min(kChunk, a.T - c * kChunk);
    const float* slot_rows = ring + slot * kChunk * kRec + min(lane, kOrder) * kRow;
    float4 row[kOrder / 4];  // this lane's row of the frame's record, read one frame ahead
    float cj;
#pragma unroll
    for (int k = 0; k < kOrder / 4; ++k) row[k] = reinterpret_cast<const float4*>(slot_rows)[k];
    cj = slot_rows[kOrder];
    for (int f = 0; f < frames; ++f) {
      const int t = c * kChunk + f;
      float m[kOrder];
      if (lane <= kOrder) sh_x[lane] = x;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < kOrder / 4; ++k) {
        const float4 v = reinterpret_cast<const float4*>(sh_x)[k];
        m[4 * k] = v.x;
        m[4 * k + 1] = v.y;
        m[4 * k + 2] = v.z;
        m[4 * k + 3] = v.w;
      }
      const float d = sh_x[kOrder];
      __syncwarp();
      if (lane < kOrder) a.m_in[(base + t) * kOrder + lane] = x;
      if (lane == kOrder) a.d_in[base + t] = x;
      float p[kOrder];
#pragma unroll
      for (int k = 0; k < kOrder / 4; ++k) {
        p[4 * k] = __fmul_rn(row[k].x, m[4 * k]);
        p[4 * k + 1] = __fmul_rn(row[k].y, m[4 * k + 1]);
        p[4 * k + 2] = __fmul_rn(row[k].z, m[4 * k + 2]);
        p[4 * k + 3] = __fmul_rn(row[k].w, m[4 * k + 3]);
      }
      const float acc = __fadd_rn(cj, tree(p));
      if (f + 1 < frames) {
        const float* nxt = slot_rows + (f + 1) * kRec;
#pragma unroll
        for (int k = 0; k < kOrder / 4; ++k) row[k] = reinterpret_cast<const float4*>(nxt)[k];
        cj = nxt[kOrder];
      }
      if (lane <= kOrder)
        x = lane < kOrder ? acc : __fadd_rn(acc, __fmul_rn(a.deemph_frame, d));
    }
    if (c + kSlots < chunks) named_arrive(kBarEmpty + slot, kFeedThreads);
  }
  if (lane < kOrder) a.sig_mem_out[b * kOrder + lane] = x;
  if (lane == kOrder) a.deemph_out[b] = x;
}

// The phases hand over through device memory: cluster.sync() fences it (MEMBAR.ALL.GPU in
// the SASS, then the L1 is invalidated) before and after the barrier.
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  cluster.sync();
}


__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
dsp_synthesis_kernel(Args a) {
  // Phase A's PSD staging (256 floats a warp) and phase D's ring of records share it.
  constexpr int kShared =
      kWarps * kPsd > kSlots * kChunk * kRec ? kWarps * kPsd : kSlots * kChunk * kRec;
  __shared__ __align__(16) float sh[kShared];
  __shared__ __align__(16) float sh_x[kRow];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.x / kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  // Warps and lanes numbered across the cluster with the block fastest, so that a phase
  // with few frames spreads them over every SM of the cluster.
  const int gw = warp * kCluster + rank;
  const int gl = gw * kLanes + lane;                                       // lane in cluster
  const int T = a.T;
  const size_t base = static_cast<size_t>(b) * T;
  DSP_TRACE(0);

  // A and B side by side: warp 0 of the first block walks the pitch phases, the other
  // blocks compute the frame parameters (B's chain has its SM to itself).
  if (gw == 0) {
    pitch_phases(a, b, lane);
  } else if (a.features && rank > 0) {
    for (int t = warp * (kCluster - 1) + rank - 1; t < T; t += kClusterWarps - kWarps)
      frame_prologue(a, b, t, lane, sh + warp * kPsd);
  }
  cluster_barrier(cluster);
  DSP_TRACE(1);
  for (int t = gw; t < T; t += kClusterWarps) frame_excitation(a, base + t, lane);
  cluster_barrier(cluster);
  DSP_TRACE(2);

  // C: run q is frame q / 17's unit memory q % 17 (16: zero state and the excitation).
  for (int q = gl; q < kRuns * T; q += kClusterWarps * kLanes) {
    const size_t fi = base + q / kRuns;
    const int k = q % kRuns;
    float lpc[kOrder], m[kOrder], y = 0.0f;
    load_lpc(a, fi, lpc);
#pragma unroll
    for (int j = 0; j < kOrder; ++j) m[j] = j == k ? 1.0f : 0.0f;
    run_frame<false>(lpc, m, y, a.excite + fi * kFrame, k == kOrder, nullptr);
    float* out = a.rec + fi * kRec + k;  // column k of the record
#pragma unroll
    for (int j = 0; j < kOrder; ++j) out[j * kRow] = m[j];
    out[kOrder * kRow] = y;
  }
  cluster_barrier(cluster);
  DSP_TRACE(3);
  if (rank == 0 && warp == 0)
    carry_pass(a, b, lane, sh, sh_x);
  else if (rank == 0 && warp <= kProducers)
    carry_feed(a, b, (warp - 1) * kLanes + lane, sh);
  cluster_barrier(cluster);
  DSP_TRACE(4);

  // E: frame t from its entering state.
  for (int t = gl; t < T; t += kClusterWarps * kLanes) {
    const size_t fi = base + t;
    float lpc[kOrder], m[kOrder];
    load_lpc(a, fi, lpc);
#pragma unroll
    for (int j = 0; j < kOrder; ++j) m[j] = __ldcg(a.m_in + fi * kOrder + j);
    float y = __ldcg(a.d_in + fi);
    run_frame<true>(lpc, m, y, a.excite + fi * kFrame, true, a.pcm + fi * kFrame);
  }
  DSP_TRACE(5);
}

}  // namespace

// One launch: a cluster of kCluster blocks a stream.  With features null the parameters and
// the noise are the caller's (phase A does not run); else phase A writes them into lpc ..
// period, and the noise too when gen_noise.  scratch holds B * T * 518 floats.
extern "C" int dss_dsp_synthesis(const float* features, const float* tables, float* lpc,
                                 float* gain, float* v_mix, uint8_t* voiced, int* period,
                                 float* noise, const float* sig_mem_in, const int* phase_in,
                                 const float* deemph_in, float* pcm, float* sig_mem_out,
                                 int* phase_out, float* deemph_out, float* scratch,
                                 unsigned seed, unsigned first_frame, float deemph_frame,
                                 int B, int T, int gen_noise, cudaStream_t stream) {
  if (B <= 0 || T <= 0) return 0;  // the wrapper copies the state for T = 0
  const size_t n = static_cast<size_t>(B) * T;
  Args a;
  a.features = features;
  a.tables = tables;
  a.lpc = lpc;
  a.gain = gain;
  a.v_mix = v_mix;
  a.voiced = voiced;
  a.period = period;
  a.noise = noise;
  a.sig_mem_in = sig_mem_in;
  a.phase_in = phase_in;
  a.deemph_in = deemph_in;
  a.pcm = pcm;
  a.sig_mem_out = sig_mem_out;
  a.phase_out = phase_out;
  a.deemph_out = deemph_out;
  a.excite = scratch;
  a.rec = a.excite + n * kFrame;
  a.m_in = a.rec + n * kRec;
  a.d_in = a.m_in + n * kOrder;
  a.ph_in = reinterpret_cast<int*>(a.d_in + n);
  a.seed = seed;
  a.first_frame = first_frame;
  a.deemph_frame = deemph_frame;
  a.T = T;
  a.gen_noise = features != nullptr && gen_noise;
  dsp_synthesis_kernel<<<B * kCluster, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DSS_DSP_TRACE
// The last traced launch's timestamps (synchronizes).
extern "C" int dss_dsp_trace(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace)));
}
#endif
