// The LPCNet sample-rate loop for every bunch: S samples per network step, S in
// {1, 2, 4, 8}, one kernel, run by a thread-block cluster per stream.
//
// Replaces both Pallas sampler kernels of dss_tpu/ops/pallas/sampler.py: the bunch-1
// kernel (_make_kernel, _sampler_call, entry sampler_frames_pallas), the kernel form of
// LPCNetModel.sample_step, and the bunched kernel (_make_bunched_kernel,
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
// The Gumbel noise is an input laid out [T, F, B, 256] by position in the frame, so a
// stream's noise does not depend on the bunch.  Weights and arithmetic are f32.
//
// What bounds it on Hopper.  The loop is serial: 16 000 / S dependent steps per second of
// audio.  A step touches about 1 MB of dense weights (0.5 MB at S = 1, GRU-A's recurrent
// matrix counted at its kept tiles), and one SM reads about 100-200 GB/s from L2, so a
// single block that streams them is bound by bytes through one SM (the kernels before
// this one: 16.5 us a step at S = 1, 28 us at S = 8; 71% and 51% of that were the
// products).  With the weights on chip the bound is the serial chain itself.  A lone warp
// starts a dependent instruction every 4 to 6 clocks, so a phase costs its longest
// thread's instruction count times about 5 clocks, plus the latencies that cannot be
// hidden: one L2 round trip for the gathered rows of a step and one per sub-sample for
// the correction rows, one block-to-block hop per exchange, and sigmoid -> tanh twice and
// tanh -> argmax -> log1p once per step.
//
// Design.  A cluster of N = 8 blocks of 1024 threads runs one stream (8 was the fastest of
// 8, 4, 2 and 1 at every bunch); the grid is B * N blocks.  Each block stages its share of every dense weight into its shared
// memory once per launch and keeps it for all T x F samples:
//  * GRU-A is split by output unit.  Block r owns the units [u0[r], u0[r+1]) with their
//    three gate columns, and of gru_a_wh * mask only the kept [16 x 128] tiles that feed
//    them: the wrapper compacts those (ops/sampler.py, cluster_layout) into work items,
//    one column of one kept tile each (16 weights, first row, destination).  A model with
//    no mask, or widths that 16 and 128 do not divide, is the same code with every
//    (ragged) tile kept.  Unit ranges are balanced by kept bytes.  A thread takes an
//    item: the threads of a warp hold adjacent columns of a tile, read their weights as
//    512 contiguous bytes and the 16 states as one broadcast.  Partial sums of a column
//    meet in shared memory in slots, one per kept row block, and are added in slot order:
//    no atomics, a fixed order.
//  * After its update a block sends its slice of the new h_a to every block (h_a is
//    double-buffered by step parity), multiplies that slice with its own rows of
//    gru_b_wx[:GA] and sends the [3 GB] partial to every block.  Every block then adds the
//    N partials in a fixed order and runs GRU-B's units itself, so h_b needs no broadcast.
//  * The S dual heads are split by level: block r computes S*256/N logits from its
//    resident columns and sends them to every block.
//  * The exchanges are asynchronous stores onto transaction barriers, not cluster
//    barriers: see `send` below.
//  * Every block runs the tail (step 5) itself, on warp 0, lane l holding levels 8l ..
//    8l+7, with identical instructions on identical values, so the 2S+1 indices of the
//    next gather need no broadcast.  The tail has no barrier and no shared-memory traffic
//    between rounds: the sample history lives in the warp's registers (lane k the sample
//    of lag k), the next prediction is a warp sum of tap * history started before the
//    argmax, the argmax is two integer warp reductions, and one mu-law encoding serves
//    both indices.  The step's S rows of noise are fetched ahead into shared memory.
//    Only rank 0 writes the output.
//  * The next step's GRU-A recurrent projection needs only the new h_a: warps 16..31 run
//    it as soon as the slices have arrived, beside GRU-B and the heads on warps 0..15.
//    GRU-B's recurrent projection, which needs the new h_b, runs on warps 1..3 beside the
//    tail.  Both are off the chain.
//  * The products on the chain split a column's rows over a few lanes and add up by
//    shuffles, with the weights laid out in shared memory so that a warp's loads hit 32
//    different banks; each lane then finishes a gate or a head column, so no phase goes
//    through shared memory and a block barrier just to add partial sums.
//  * The fused embedding tables and the correction tables stay in global memory (L2); a
//    block gathers only its own columns of the 2S+1 rows.
// What does not fit a block's 227 KB (an unpruned recurrent matrix) is read from global
// memory by the same code; the host's plan() decides per launch.  Chunked calls equal one call bit for bit: nothing depends on timing.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "sampler_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dss;

constexpr int kWarps = kThreads / 32;
constexpr int kFrontThreads = kThreads / 2;  // warps 0..15: GRU-B and the heads
constexpr int kBackThreads = kThreads - kFrontThreads;  // warps 16..31: the next GRU-A product
constexpr int kFrontWarps = kFrontThreads / 32;
constexpr int kMaxOrder = 32;                // LPC taps: one lane of the tail's warp each
// Blocks per stream: the portable cluster size.  tools/torch_sampler_cluster_sizes.py builds
// its own copies at other sizes to time them.
#ifndef DSS_SAMPLER_CLUSTER
#define DSS_SAMPLER_CLUSTER 8
#endif
constexpr int kCluster = DSS_SAMPLER_CLUSTER;
static_assert(kCluster == 1 || kCluster == 2 || kCluster == 4 || kCluster == 8, "cluster size");
constexpr unsigned kFull = 0xffffffffu;

// Offsets (in floats, each a multiple of 4) of the regions of a block's shared memory.
struct Smem {
  int part, whb, tiles, work, wxb, wout, gout, ibout, bout, cnt, bha, gh, gxc, gxbc, ghb,
      pb, ha, hown, hb, cond, dec, logit, noise, bars, sidx, exc, pidx, total;
};

struct Args {
  const float *cond, *lpc, *temp, *noise;
  const float* emb;        // [2S+1, 256, 3*GA]: each table @ its band of gru_a_wx
  const float* wx_a_cond;  // [CD, 3*GA]: gru_a_wx conditioning rows
  const float* bx_a;       // [3*GA]
  const float* bh_a;       // [3*GA]
  const float* wx_b;       // [GA + CD, 3*GB]
  const float* bx_b;       // [3*GB]
  const float* wh_b;       // [GB, 3*GB]
  const float* bh_b;       // [3*GB]
  const float* corr;       // [S-1, 2, 256, 256]; null at S = 1
  const float* tiles;      // [N, wmax/32, 4, 32, 4]: block r's work items in groups of 32
  const int2* work;        // [N, wmax]: (first row, slot * 3 * nuM + local column)
  const int* nwork;        // [N]
  const int* cnt;          // [N, 3*nuM]: slots to add per local column
  const int* u0;           // [N+1]: unit ranges
  const float* w_out;      // [N, GB, 2*nl]: block r's head columns, a level's two halves adjacent
  const float* g_out;      // [N, 2*nl]
  const float* ib_out;     // [N, 2*nl]: inner (pre-tanh) biases, zeros when absent
  const float* b_out;      // [N, nl]
  const float *h_a0, *h_b0, *sig_mem0;
  const int* exc0;
  float *sig_out, *h_a1, *h_b1, *sig_mem1;
  int* exc1;
  int T, F, B, GA, GB, CD, P, nuM, wmax, maxslots;
  int gC, gBc;             // split-K group counts of the per-frame products
  int Kx;                  // padded row stride of the gru_b_wx rows in shared memory
  int resA, resB, resH;    // which weights are resident in shared memory
  Smem L;
#ifdef DSS_SAMPLER_TRACE
  long long* trace;        // null, or [13] clocks of one step (see TRACE)
#endif
};

// Where the time of a step goes, in a build with DSS_SAMPLER_TRACE only (the normal build
// has no such code): thread `first` of stream 0's rank-0 block stores its SM clock into the
// buffer that dss_lpcnet_sampler_set_trace named, during the last frame's step 3.  Thread
// 0 does so at each phase boundary (stamps 0..11), the first thread of the upper warps at
// the end of the next step's GRU-A projection (stamp 12).
#ifdef DSS_SAMPLER_TRACE
long long* g_trace = nullptr;
#define TRACE(k, first) \
  if (a.trace && tid == (first) && blockIdx.x == 0 && t == T - 1 && i == 3) a.trace[k] = clock64()
#else
#define TRACE(k, first) ((void)0)
#endif

__device__ __forceinline__ void back_barrier() {
  asm volatile("bar.sync 2, %0;" ::"n"(kBackThreads) : "memory");
}

__device__ __forceinline__ void front_barrier() {
  asm volatile("bar.sync 3, %0;" ::"n"(kFrontThreads) : "memory");
}

// Block-to-block traffic inside the cluster goes through Hopper's asynchronous stores: a
// store into another block's shared memory that, on landing, counts its bytes off a
// transaction barrier (mbarrier) in that block.  The receiver posts the bytes it expects
// for the phase and waits on its own barrier; no fence and no cluster-wide rendezvous is
// on the chain.  (cluster.sync() costs a GPU-scope memory barrier and an L1 invalidation
// each time: measured 0.75 us a barrier, 1.5 us of a 6.2 us step at S = 1.)  One store
// instruction of a warp reaches several blocks, each lane its own.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address, in the cluster's shared window, of block `rank`'s copy of `addr`.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// v into block `rank`'s copy of `p`, counted off that block's copy of `bar`.
__device__ __forceinline__ void send(const float* p, unsigned bar, int rank, float v) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               :: "r"(peer_addr(smem_addr(p), rank)), "f"(v), "r"(peer_addr(bar, rank))
               : "memory");
}

__device__ __forceinline__ void send(const float* p, unsigned bar, int rank, float4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(peer_addr(smem_addr(p), rank)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
         "r"(peer_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void barrier_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// The one arrival of the phase, by the receiver itself, with the bytes the phase will bring.
__device__ __forceinline__ void barrier_expect(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of this parity has completed.  A wait that never ends is a bug in
// the protocol: it traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void barrier_wait(unsigned bar, int parity) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// A weight that the plan keeps resident is read with shared-memory loads, one that it
// leaves in global memory through the read-only path: a generic load that lands in shared
// memory takes several times the latency of a shared one.  The shared loads carry no
// memory clobber, so that the compiler may start several before the first use; they stay
// behind the barrier that follows the staging because both are volatile.
template <bool kShared>
__device__ __forceinline__ float4 load4(const float* p) {
  if (kShared) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(smem_addr(p)));
    return v;
  }
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <bool kShared>
__device__ __forceinline__ int2 load2(const int2* p) {
  if (kShared) {
    int2 v;
    asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(smem_addr(p)));
    return v;
  }
  return __ldg(p);
}

__device__ __forceinline__ void fma4(float4& acc, float x, const float4& w) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
}

// x[0..K) @ W[K, ldw] at the four columns 4*qq .. 4*qq+3, by the four lanes l8, l8 + 8,
// l8 + 16, l8 + 24 of a warp (l8 = lane & 7 picks the quad, rg = lane >> 3 the rows k = rg
// mod 4): the 8 lanes of a quarter-warp read 128 contiguous bytes of one row, so the loads
// have no bank conflicts.  The partial sums meet by shuffles in a fixed order; all four
// lanes return the sums.  Every lane of the warp must call it (`on` = this quad exists).
template <bool kShared>
__device__ __forceinline__ float4 quad_product(const float* x, const float* W, int K, int ldw,
                                               int qq, int rg, bool on) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (on) {
#pragma unroll 4
    for (int k = rg; k < K; k += 4) fma4(acc, x[k], load4<kShared>(W + k * ldw + 4 * qq));
  }
#pragma unroll
  for (int off = 8; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  return acc;
}

// The dot product of 16 weights with the 16 states at h (16-byte aligned), in row order.
__device__ __forceinline__ float dot16(const float4& w0, const float4& w1, const float4& w2,
                                       const float4& w3, const float* h) {
  const float4* h4 = reinterpret_cast<const float4*>(h);
  const float4 x0 = h4[0], x1 = h4[1], x2 = h4[2], x3 = h4[3];
  float acc = w0.x * x0.x;
  acc = fmaf(w0.y, x0.y, acc); acc = fmaf(w0.z, x0.z, acc); acc = fmaf(w0.w, x0.w, acc);
  acc = fmaf(w1.x, x1.x, acc); acc = fmaf(w1.y, x1.y, acc); acc = fmaf(w1.z, x1.z, acc);
  acc = fmaf(w1.w, x1.w, acc); acc = fmaf(w2.x, x2.x, acc); acc = fmaf(w2.y, x2.y, acc);
  acc = fmaf(w2.z, x2.z, acc); acc = fmaf(w2.w, x2.w, acc); acc = fmaf(w3.x, x3.x, acc);
  acc = fmaf(w3.y, x3.y, acc); acc = fmaf(w3.z, x3.z, acc); acc = fmaf(w3.w, x3.w, acc);
  return acc;
}

// The sum of v over the warp, added in a fixed order; every lane returns the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The sum of v over the lanes that differ in the bits below `width` (a power of two).
__device__ __forceinline__ float lanes_sum(float v, int width) {
  for (int off = 1; off < width; off <<= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The update of one reset-after GRU unit spread over three lanes of a warp: lane `r_lane`
// holds the r gate, `z_lane` the z gate (`gate` 0 and 1), and the lane with `gate` 2 the
// n gate.  `pre` is the input projection and `gh` the recurrent one of the lane's gate
// column.  Returns, on the n-gate lane, the new state of the unit whose old state is
// `h_old`.  Every lane of the warp must call it.
__device__ __forceinline__ float gru_unit(int gate, int r_lane, int z_lane, float pre, float gh,
                                          float h_old) {
  const float act = gate < 2 ? sigmoidf(pre + gh) : 0.f;
  const float r = __shfl_sync(kFull, act, r_lane);
  const float z = __shfl_sync(kFull, act, z_lane);
  return (1.f - z) * tanhf(pre + r * gh) + z * h_old;
}

// GRU-A's recurrent product over this block's work items, by the kBackThreads threads
// (pt = 0 .. kBackThreads - 1) of the upper warps: s_gh[lc] = sum over kept rows of
// h * W + bh, for the block's local columns lc (gate q of local unit ul at q * nuM + ul).
template <bool kShared>
__device__ __forceinline__ void gru_a_recurrent(const float* h, const float* tiles,
                                                const int2* work, int nwork,
                                                const int* s_cnt, const float* s_bha,
                                                float* s_part, float* s_gh, int NAl,
                                                int pt) {
  for (int e = pt; e < nwork; e += kBackThreads) {
    const int2 d = load2<kShared>(work + e);
    const float* wp = tiles + ((e >> 5) * 128 + (e & 31)) * 4;
    s_part[d.y] = dot16(load4<kShared>(wp), load4<kShared>(wp + 128),
                        load4<kShared>(wp + 256), load4<kShared>(wp + 384), h + d.x);
  }
  back_barrier();
  for (int lc = pt; lc < NAl; lc += kBackThreads) {
    const int n = s_cnt[lc];
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < n; ++s) acc += s_part[s * NAl + lc];
    s_gh[lc] = acc + s_bha[lc];
  }
}

// GRU-B's recurrent projection s_ghb = h_b @ wh_b + bh_b, beside the tail: the warps 1, 2
// and 3 take 8 column quads each.  s_whb holds wh_b [GB, NB] and then bh_b.
__device__ __forceinline__ void gru_b_recurrent(const float* s_hb, const float* s_whb,
                                                float* s_ghb, int GB, int warp, int gq,
                                                int l8) {
  const int NB = 3 * GB;
  for (int q0 = (warp - 1) * 8; q0 < NB / 4; q0 += 24) {
    const int qq = q0 + l8;
    const bool on = qq < NB / 4;
    float4 acc = quad_product<true>(s_hb, s_whb, GB, NB, qq, gq, on);
    if (on && gq == 0) {
      const float4 bias = *reinterpret_cast<const float4*>(s_whb + GB * NB + 4 * qq);
      acc.x += bias.x; acc.y += bias.y; acc.z += bias.z; acc.w += bias.w;
      *reinterpret_cast<float4*>(s_ghb + 4 * qq) = acc;
    }
  }
}

// This block's partial of h_a @ gru_b_wx[:GA]: its nu new states times its rows.  A warp
// takes 4 column quads; the 8 lanes of a quad (rg = lane & 7) split the rows k = rg mod 8
// and add up by shuffles; lane rg sends the four sums to rank rg.  W is row-major with
// row stride ldw; resident, ldw is NB + 4, so that the 8 rows a quarter-warp reads fall
// into 32 different banks.
template <bool kShared>
__device__ __forceinline__ void wxb_partial(const float* s_hown, const float* W, int ldw, int nu,
                                            int NB, const float* dst, unsigned bar, int N,
                                            int warp, int gq, int l8) {
  for (int q0 = warp * 4; q0 < NB / 4; q0 += 4 * kWarps) {
    const int qq = q0 + gq;
    const bool on = qq < NB / 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
#pragma unroll 4
      for (int k = l8; k < nu; k += 8) fma4(acc, s_hown[k], load4<kShared>(W + k * ldw + 4 * qq));
    }
    acc.x = lanes_sum(acc.x, 8);
    acc.y = lanes_sum(acc.y, 8);
    acc.z = lanes_sum(acc.z, 8);
    acc.w = lanes_sum(acc.w, 8);
    if (on && l8 < N) send(dst + 4 * qq, bar, l8, acc);
  }
}

// This block's levels of the S dual heads, by the front warps.  Its columns hold a level's
// two halves side by side, so a quad of columns is two levels.  After the product each of
// the quad's four lanes finishes one column (tanh, gain); shuffles pair the halves, and
// lane group rg sends both logits to the ranks rg and rg + 4.
template <bool kShared>
__device__ __forceinline__ void head_logits(const float* s_hb, const float* W, int GB, int NO,
                                            const float* s_ibout, const float* s_gout,
                                            const float* s_bout, const float* dst,
                                            unsigned bar, int N, int warp, int gq, int l8) {
  for (int q0 = warp * 8; q0 < NO / 4; q0 += 8 * kFrontWarps) {
    const int qq = q0 + l8;
    const bool on = qq < NO / 4;
    const float4 acc = quad_product<kShared>(s_hb, W, GB, NO, qq, gq, on);
    const int c = on ? 4 * qq + gq : 0;
    const float p = (gq & 2) ? ((gq & 1) ? acc.w : acc.z) : ((gq & 1) ? acc.y : acc.x);
    const float th = tanhf(p + s_ibout[c]) * s_gout[c];
    const float v0 = __shfl_sync(kFull, th, l8) + __shfl_sync(kFull, th, 8 + l8);
    const float v1 = __shfl_sync(kFull, th, 16 + l8) + __shfl_sync(kFull, th, 24 + l8);
    if (on)
      for (int rr = gq; rr < N; rr += 4) {
        send(dst + 2 * qq, bar, rr, v0 + s_bout[2 * qq]);
        send(dst + 2 * qq + 1, bar, rr, v1 + s_bout[2 * qq + 1]);
      }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads) lpcnet_sampler_kernel(const Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int N = kCluster;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 3, l8 = lane & 7;
  constexpr int nt = kThreads;
  const int T = a.T, F = a.F, B = a.B, GA = a.GA, GB = a.GB, CD = a.CD, P = a.P;
  const int NA = 3 * GA;
  const int GAp = (GA + 15) / 16 * 16;  // h_a padded to whole tiles: the edge reads zeros
  const int NB = 3 * GB;
  const int nuM = a.nuM;
  const int NAl = 3 * nuM;              // local gate columns, padded to the widest block
  const int nl = S * kLevels / N;       // levels whose logits this block computes
  const int NO = 2 * nl;
  const int ua = a.u0[rank];
  const int nu = a.u0[rank + 1] - ua;
  const int nwork = a.nwork[rank];

  extern __shared__ __align__(16) float smem[];
  const Smem& L = a.L;
  float* s_part = smem + L.part;    // split-K partial sums
  float* s_whb = smem + L.whb;      // [(GB + 1) * NB] wh_b, then bh_b
  float* s_gout = smem + L.gout;    // [NO]
  float* s_ibout = smem + L.ibout;  // [NO]
  float* s_bout = smem + L.bout;    // [nl]
  int* s_cnt = (int*)(smem + L.cnt);  // [NAl]
  float* s_bha = smem + L.bha;      // [NAl] bh_a at the local columns
  float* s_gh = smem + L.gh;        // [NAl] GRU-A recurrent projection, bias in
  float* s_gxc = smem + L.gxc;      // [NAl] per-frame conditioning part of gx_a, bias in
  float* s_gxbc = smem + L.gxbc;    // [NB] per-frame conditioning part of gx_b, bias in
  float* s_ghb = smem + L.ghb;      // [NB] GRU-B recurrent projection, bias in
  float* s_pb = smem + L.pb;        // [N * NB] every block's partial of h_a @ wx_b[:GA]
  float* s_ha = smem + L.ha;        // [2 * GAp] h_a, double-buffered by step parity
  float* s_hown = smem + L.hown;    // [nuM] this block's slice of the new h_a, written locally
  float* s_hb = smem + L.hb;        // [GB]
  float* s_cond = smem + L.cond;    // [CD]
  float* s_dec = smem + L.dec;      // [256] mu-law decode table
  float* s_logit = smem + L.logit;  // [S * 256] logits of the S heads, outer bias in
  float* s_noise = smem + L.noise;  // [S * 256] the step's Gumbel noise, fetched ahead
  const unsigned bar1 = smem_addr(smem + L.bars);      // h_a slices and gru_b_wx partials in
  const unsigned bar2 = smem_addr(smem + L.bars + 2);  // logits in
  const int bytes1 = 4 * (GA + N * NB), bytes2 = 4 * S * kLevels;
  int* s_sidx = (int*)(smem + L.sidx);  // [S] mu-law index of sample lag j
  int* s_exc = (int*)(smem + L.exc);    // [S] excitation lag j
  int* s_pidx = (int*)(smem + L.pidx);  // [1] mu-law index of pred_0 of the next step

  // This block's share of the dense weights: staged once, or left in global memory.
  const float* tiles = a.tiles + (size_t)rank * a.wmax * 16;
  const int2* work = a.work + (size_t)rank * a.wmax;
  if (a.resA) {
    float4* dst = reinterpret_cast<float4*>(smem + L.tiles);
    const float4* src = reinterpret_cast<const float4*>(tiles);
    for (int i = tid; i < (nwork + 31) / 32 * 128; i += nt) dst[i] = src[i];
    int2* wdst = reinterpret_cast<int2*>(smem + L.work);
    for (int i = tid; i < nwork; i += nt) wdst[i] = work[i];
    tiles = smem + L.tiles;
    work = wdst;
  }
  const float* wxb = a.wx_b + (size_t)ua * NB;  // the rows of this block's units
  if (a.resB) {  // rows padded to Kx floats
    float* dst = smem + L.wxb;
    for (int i = tid; i < nu * NB; i += nt) dst[(i / NB) * a.Kx + i % NB] = wxb[i];
    wxb = dst;
  }
  const float* wout = a.w_out + (size_t)rank * GB * NO;
  if (a.resH) {
    float* dst = smem + L.wout;
    for (int i = tid; i < GB * NO; i += nt) dst[i] = wout[i];
    wout = dst;
  }
  for (int i = tid; i < GB * NB; i += nt) s_whb[i] = a.wh_b[i];
  for (int i = tid; i < NB; i += nt) s_whb[GB * NB + i] = a.bh_b[i];
  for (int i = tid; i < NO; i += nt) {
    s_gout[i] = a.g_out[(size_t)rank * NO + i];
    s_ibout[i] = a.ib_out[(size_t)rank * NO + i];
  }
  for (int i = tid; i < nl; i += nt) s_bout[i] = a.b_out[(size_t)rank * nl + i];
  for (int i = tid; i < NAl; i += nt) s_cnt[i] = a.cnt[(size_t)rank * NAl + i];
  for (int lc = tid; lc < NAl; lc += nt) {
    const int q = lc / nuM, ul = lc - q * nuM;
    s_bha[lc] = ul < nu ? a.bh_a[q * GA + ua + ul] : 0.f;
  }
  for (int u = tid; u < 2 * GAp; u += nt) s_ha[u] = u < GA ? a.h_a0[b * GA + u] : 0.f;
  for (int u = tid; u < GB; u += nt) s_hb[u] = a.h_b0[b * GB + u];
  for (int k = tid; k < kLevels; k += nt) s_dec[k] = mulaw_decode(k);
  if (tid < S) {
    s_exc[tid] = a.exc0[b * S + tid];
    s_sidx[tid] = mulaw_encode(a.sig_mem0[b * P + tid]);
  }
  if (tid == 0) {
    barrier_init(bar1);
    barrier_init(bar2);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  int phase = 0;  // parity of the barriers' current phase: one phase a step
  // The tail's warp keeps the sample history in registers, lane k the sample of lag k, and
  // carries the next prediction and the frame's filter tap k the same way.
  float hist = warp == 0 && lane < P ? a.sig_mem0[b * P + lane] : 0.f;
  float tap = 0.f, tap0 = 0.f, pred = 0.f;
  int cur = 0;  // which half of s_ha holds the current h_a
  // No block may write into another's shared memory before that block has set it up.
  cluster.sync();
  if (tid >= kFrontThreads) {
    if (a.resA)
      gru_a_recurrent<true>(s_ha, tiles, work, nwork, s_cnt, s_bha, s_part, s_gh, NAl,
                            tid - kFrontThreads);
    else
      gru_a_recurrent<false>(s_ha, tiles, work, nwork, s_cnt, s_bha, s_part, s_gh, NAl,
                             tid - kFrontThreads);
  } else if (warp >= 1 && warp <= 3) {
    gru_b_recurrent(s_hb, s_whb, s_ghb, GB, warp, gq, l8);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B + b;
    for (int k = tid; k < CD; k += nt) s_cond[k] = a.cond[tb * CD + k];
    const float tmp = a.temp[tb];
    const bool greedy = tmp < 0.f;
    __syncthreads();
    // The frame's first prediction, from the carried history and this frame's filter.
    if (warp == 0) {
      tap = lane < P ? a.lpc[tb * P + lane] : 0.f;
      tap0 = __shfl_sync(kFull, tap, 0);
      pred = -warp_sum(tap * hist);
      if (lane == 0) s_pidx[0] = mulaw_encode(pred);
    }
    // The conditioning vector is constant over the frame: its share of both GRUs' input
    // projections is computed once per frame, GRU-A's at this block's columns only.
    {
      const int KS = (CD + a.gC - 1) / a.gC;
      for (int j = tid; j < NAl * a.gC; j += nt) {
        const int g = j / NAl, lc = j - g * NAl;
        const int q = lc / nuM, ul = lc - q * nuM;
        float acc = 0.f;
        if (ul < nu) {
          const float* col = a.wx_a_cond + q * GA + ua + ul;
          const int k1 = min(CD, (g + 1) * KS);
#pragma unroll 4
          for (int k = g * KS; k < k1; ++k) acc = fmaf(s_cond[k], __ldg(col + (size_t)k * NA), acc);
        }
        s_part[j] = acc;
      }
    }
    __syncthreads();
    for (int lc = tid; lc < NAl; lc += nt) {
      const int q = lc / nuM, ul = lc - q * nuM;
      s_gxc[lc] = reduce_part(s_part, a.gC, NAl, lc) + (ul < nu ? a.bx_a[q * GA + ua + ul] : 0.f);
    }
    __syncthreads();
    matvec_partial(s_cond, a.wx_b + (size_t)GA * NB, CD, NB, a.gBc, s_part, tid, nt);
    __syncthreads();
    for (int c = tid; c < NB; c += nt) s_gxbc[c] = reduce_part(s_part, a.gBc, NB, c) + a.bx_b[c];
    __syncthreads();

    for (int i = 0; i < F / S; ++i) {
      float* ha_cur = s_ha + cur * GAp;
      float* ha_nxt = s_ha + (cur ^ 1) * GAp;
      TRACE(0, 0);
      if (tid == 0) {
        barrier_expect(bar1, bytes1);
        barrier_expect(bar2, bytes2);
      }
      // The step's S rows of noise, fetched asynchronously by the last warp; awaited
      // before the tail.
      if (warp == kWarps - 1 && a.noise && !greedy) {
        const float4* src = reinterpret_cast<const float4*>(
            a.noise + ((size_t)(t * F + i * S) * B + b) * kLevels);
        float4* dst = reinterpret_cast<float4*>(s_noise);
        for (int j = 0; j < S; ++j)
          for (int x = lane; x < kLevels / 4; x += 32)
            __pipeline_memcpy_async(dst + j * (kLevels / 4) + x,
                                    src + (size_t)j * B * (kLevels / 4) + x, 16);
        __pipeline_commit();
      }
      // GRU-A, this block's units: a warp takes 8 units (lane & 7), one lane per gate
      // column (lane >> 3) gathers the 2S+1 rows there and adds the conditioning share;
      // gru_unit joins the gates.  The lanes of group gq send the 8 new states to the
      // ranks gq and gq + 4; the block's own copy for the product below is written
      // directly.
      for (int ub = warp * 8; ub < nu; ub += 8 * kWarps) {
        const int ul = ub + l8;
        const bool on = gq < 3 && ul < nu;
        float pre = 0.f, gh = 0.f;
        if (on) {
          const int lc = gq * nuM + ul;
          const float* col = a.emb + gq * GA + ua + ul;
          float acc = __ldg(col + ((size_t)S * kLevels + s_pidx[0]) * NA);
#pragma unroll
          for (int j = 0; j < S; ++j) {
            acc += __ldg(col + ((size_t)j * kLevels + s_sidx[j]) * NA);
            acc += __ldg(col + ((size_t)(S + 1 + j) * kLevels + s_exc[j]) * NA);
          }
          pre = acc + s_gxc[lc];
          gh = s_gh[lc];
        }
        float hn = gru_unit(gq, l8, 8 + l8, pre, gh, on ? ha_cur[ua + ul] : 0.f);
        hn = __shfl_sync(kFull, hn, 16 + l8);
        if (ul < nu) {
          if (gq == 0) s_hown[ul] = hn;
          for (int rr = gq; rr < N; rr += 4) send(ha_nxt + ua + ul, bar1, rr, hn);
        }
      }
      __syncthreads();
      TRACE(1, 0);
      if (a.resB)
        wxb_partial<true>(s_hown, wxb, a.Kx, nu, NB, s_pb + rank * NB, bar1, N, warp, gq, l8);
      else
        wxb_partial<false>(s_hown, wxb, NB, nu, NB, s_pb + rank * NB, bar1, N, warp, gq, l8);
      TRACE(2, 0);
      barrier_wait(bar1, phase);
      TRACE(3, 0);
      if (warp >= kFrontWarps) {
        // The upper warps: the next step's GRU-A recurrent projection needs only the new
        // h_a, which is complete now.
        if (a.resA)
          gru_a_recurrent<true>(ha_nxt, tiles, work, nwork, s_cnt, s_bha, s_part, s_gh, NAl,
                                tid - kFrontThreads);
        else
          gru_a_recurrent<false>(ha_nxt, tiles, work, nwork, s_cnt, s_bha, s_part, s_gh, NAl,
                                 tid - kFrontThreads);
        TRACE(12, kFrontThreads);
      } else {
        // The lower warps.  GRU-B in every block: a warp takes 8 units, one lane per gate
        // column adds the N partials in rank order.
        for (int ub = warp * 8; ub < GB; ub += 8 * kFrontWarps) {
          const int u = ub + l8;
          const bool on = gq < 3 && u < GB;
          float pre = 0.f, gh = 0.f;
          if (on) {
            const int c = gq * GB + u;
            float p[N];  // loaded together, added in rank order
#pragma unroll
            for (int rr = 0; rr < N; ++rr) p[rr] = s_pb[rr * NB + c];
            float acc = p[0];
#pragma unroll
            for (int rr = 1; rr < N; ++rr) acc += p[rr];
            pre = acc + s_gxbc[c];
            gh = s_ghb[c];
          }
          const float hn = gru_unit(gq, l8, 8 + l8, pre, gh, on ? s_hb[u] : 0.f);
          if (on && gq == 2) s_hb[u] = hn;
        }
        front_barrier();
        TRACE(4, 0);
        if (a.resH)
          head_logits<true>(s_hb, wout, GB, NO, s_ibout, s_gout, s_bout, s_logit + rank * nl,
                            bar2, N, warp, gq, l8);
        else
          head_logits<false>(s_hb, wout, GB, NO, s_ibout, s_gout, s_bout, s_logit + rank * nl,
                             bar2, N, warp, gq, l8);
        TRACE(5, 0);
      }
      __pipeline_wait_prior(0);
      __syncthreads();  // the fetched noise and the new s_gh, to every warp
      barrier_wait(bar2, phase);
      phase ^= 1;
      TRACE(6, 0);

      if (warp == 0) {
        // The tail: S dependent rounds on one warp, lane l holding levels 8l .. 8l+7, with
        // no barrier and no shared-memory traffic between rounds: the warp's reductions
        // leave every lane with the winner, and each lane derives excitation, sample and
        // next prediction itself.
        int p_idx = s_pidx[0];
        int prev = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          // What the samples before this round's give to the next prediction: lane k's tap
          // times the sample that the shift below moves to lag k, summed by shuffles.
          const float moved = __shfl_up_sync(kFull, hist, 1);
          const float older = warp_sum(lane == 0 ? 0.f : tap * moved);
          float l[8];
          {
            const float4* lp = reinterpret_cast<const float4*>(s_logit + j * kLevels + 8 * lane);
            const float4 x0 = lp[0], x1 = lp[1];
            l[0] = x0.x; l[1] = x0.y; l[2] = x0.z; l[3] = x0.w;
            l[4] = x1.x; l[5] = x1.y; l[6] = x1.z; l[7] = x1.w;
          }
          if (j > 0) {
            const float* ce = a.corr + (size_t)(j - 1) * 2 * kLevels * kLevels + 8 * lane;
            const float4* e4 = reinterpret_cast<const float4*>(ce + (size_t)prev * kLevels);
            const float4* p4 =
                reinterpret_cast<const float4*>(ce + (size_t)(kLevels + p_idx) * kLevels);
            const float4 e0 = __ldg(e4), e1 = __ldg(e4 + 1), p0 = __ldg(p4), p1 = __ldg(p4 + 1);
            l[0] = l[0] + e0.x + p0.x; l[1] = l[1] + e0.y + p0.y;
            l[2] = l[2] + e0.z + p0.z; l[3] = l[3] + e0.w + p0.w;
            l[4] = l[4] + e1.x + p1.x; l[5] = l[5] + e1.y + p1.y;
            l[6] = l[6] + e1.z + p1.z; l[7] = l[7] + e1.w + p1.w;
          }
          if (!greedy) {
            const float4* np = reinterpret_cast<const float4*>(s_noise + j * kLevels + 8 * lane);
            const float4 n0 = np[0], n1 = np[1];
            l[0] = l[0] * tmp + n0.x; l[1] = l[1] * tmp + n0.y;
            l[2] = l[2] * tmp + n0.z; l[3] = l[3] * tmp + n0.w;
            l[4] = l[4] * tmp + n1.x; l[5] = l[5] * tmp + n1.y;
            l[6] = l[6] * tmp + n1.z; l[7] = l[7] * tmp + n1.w;
          }
          if (j == 0) TRACE(7, 0);
          // The exact lowest-index argmax: within the lane in index order; across the warp
          // one integer max over order-preserving keys of the values, then one integer min
          // over the indices of the lanes that hold that maximum.
          float v = l[0];
          int ix = 8 * lane;
#pragma unroll
          for (int q = 1; q < 8; ++q)
            if (l[q] > v) { v = l[q]; ix = 8 * lane + q; }
          int key = __float_as_int(v + 0.f);  // -0 becomes +0: equal values, equal keys
          key ^= (key >> 31) & 0x7fffffff;
          const int best = __reduce_max_sync(kFull, key);
          ix = __reduce_min_sync(kFull, key == best ? ix : 0x7fffffff);
          if (j == 0) TRACE(8, 0);
          const float sample = fminf(fmaxf(pred + s_dec[ix], -1.f), 1.f);
          hist = lane == 0 ? sample : moved;
          pred = -fmaf(tap0, sample, older);
          // One mu-law encoding per lane serves both indices the next gathers need: the
          // lower half-warp encodes the next prediction, the upper the new sample.
          const int enc = mulaw_encode(lane < 16 ? pred : sample);
          p_idx = __shfl_sync(kFull, enc, 0);
          const int s_idx = __shfl_sync(kFull, enc, 16);
          if (j == 0) TRACE(9, 0);
          if (lane == 0) {
            if (rank == 0) a.sig_out[(size_t)b * T * F + (size_t)t * F + i * S + j] = sample;
            s_exc[S - 1 - j] = ix;
            s_sidx[S - 1 - j] = s_idx;
            if (j == S - 1) s_pidx[0] = p_idx;
          }
          prev = ix;
        }
      } else if (warp <= 3) {
        // Beside the tail: the next step's GRU-B recurrent projection.
        gru_b_recurrent(s_hb, s_whb, s_ghb, GB, warp, gq, l8);
      }
      TRACE(10, 0);
      __syncthreads();
      TRACE(11, 0);
      cur ^= 1;
    }
  }
  if (rank == 0) {
    for (int u = tid; u < GA; u += nt) a.h_a1[b * GA + u] = s_ha[cur * GAp + u];
    for (int u = tid; u < GB; u += nt) a.h_b1[b * GB + u] = s_hb[u];
    if (tid < P) a.sig_mem1[b * P + tid] = hist;
    if (tid < S) a.exc1[b * S + tid] = s_exc[tid];
  }
  // No block may exit while another can still write into its shared memory.
  cluster.sync();
}

struct Plan {
  int gC, gBc, Kx, part_floats;
  int resA, resB, resH;
  long long resident;  // bytes of weights resident in one block's shared memory
  Smem L;
};

// Split-K group counts, residency and the shared-memory map for these widths.
Plan plan(int S, int GA, int GB, int CD, int P, int nuM, int wmax, int maxslots) {
  constexpr int N = kCluster;
  const int NB = 3 * GB, NAl = 3 * nuM, nl = S * kLevels / N, NO = 2 * nl;
  Plan p{};
  p.gC = min(8, max(1, kThreads / NAl));
  p.gBc = min(16, max(1, kThreads / (NB / 4)));
  p.Kx = NB + 4;  // 8 consecutive rows of a column quad: 32 different banks
  p.part_floats = max(max(maxslots, p.gC) * NAl, p.gBc * NB);

  // What stays on chip: the smallest arrays first, while the block's 227 KB hold them.
  const long long szA = 72LL * wmax, szB = 4LL * nuM * p.Kx, szH = 4LL * GB * NO;
  auto layout = [&](bool rA, bool rB, bool rH) {
    Smem L{};
    int o = 0;
    auto take = [&](long long n) {
      const int at = o;
      o += (int)((n + 3) / 4 * 4);
      return at;
    };
    L.part = take(p.part_floats);
    L.whb = take((long long)(GB + 1) * NB);
    L.tiles = take(rA ? 16LL * wmax : 0);
    L.work = take(rA ? 2LL * wmax : 0);
    L.wxb = take(rB ? (long long)nuM * p.Kx : 0);
    L.wout = take(rH ? (long long)GB * NO : 0);
    L.gout = take(NO);
    L.ibout = take(NO);
    L.bout = take(nl);
    L.cnt = take(NAl);
    L.bha = take(NAl);
    L.gh = take(NAl);
    L.gxc = take(NAl);
    L.gxbc = take(NB);
    L.ghb = take(NB);
    L.pb = take((long long)N * NB);
    L.ha = take(2 * ((GA + 15) / 16 * 16));
    L.hown = take(nuM);
    L.hb = take(GB);
    L.cond = take(CD);
    L.dec = take(kLevels);
    L.logit = take(S * kLevels);
    L.noise = take(S * kLevels);
    L.bars = take(4);
    L.sidx = take(S);
    L.exc = take(S);
    L.pidx = take(1);
    L.total = o;
    return L;
  };
  const long long base = 4LL * layout(false, false, false).total;
  long long sizes[3] = {szA, szB, szH};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (sizes[order[j]] < sizes[order[i]]) { const int t = order[i]; order[i] = order[j]; order[j] = t; }
  bool res[3] = {false, false, false};
  long long used = base + 64;  // the rounding of three more regions
  for (int i = 0; i < 3; ++i) {
    if (used + sizes[order[i]] <= kMaxSmem) {
      res[order[i]] = true;
      used += sizes[order[i]];
    }
  }
  p.resA = res[0];
  p.resB = res[1];
  p.resH = res[2];
  p.L = layout(res[0], res[1], res[2]);
  p.resident = 4LL * NB * (GB + 1) + (res[0] ? szA : 0) + (res[1] ? szB : 0) + (res[2] ? szH : 0);
  return p;
}

bool supported(int S, int F, int GA, int GB, int P, int nuM, int wmax) {
  return (S == 1 || S == 2 || S == 4 || S == 8) && GA % 4 == 0 && GB % 4 == 0 && nuM % 4 == 0 && wmax % 32 == 0 && F % S == 0 && P >= S &&
         P >= 2 && P <= kMaxOrder;
}

// Raises the kernel's shared-memory limit and asks the card how many such clusters it can
// run at once; the answer for a (device, cluster size, bytes) triple is kept, so that a
// launch with a triple seen before costs no query of the CUDA runtime.
template <int S>
int clusters_that_fit(const cudaLaunchConfig_t& cfg, int* clusters) {
  static std::mutex lock;
  static std::map<std::tuple<int, unsigned, size_t>, int> seen;
  std::lock_guard<std::mutex> hold(lock);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  const auto key =
      std::make_tuple(device, cfg.attrs[0].val.clusterDim.x, cfg.dynamicSmemBytes);
  const auto hit = seen.find(key);
  if (hit != seen.end()) {
    *clusters = hit->second;
    return 0;
  }
  e = cudaFuncSetAttribute(lpcnet_sampler_kernel<S>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveClusters(clusters, lpcnet_sampler_kernel<S>, &cfg);
  if (e != cudaSuccess) return (int)e;
  // The limit only grows: a smaller request seen later must not lower it.
  size_t most = cfg.dynamicSmemBytes;
  for (const auto& kv : seen)
    if (std::get<0>(kv.first) == device) most = std::max(most, std::get<2>(kv.first));
  if (most != cfg.dynamicSmemBytes) {
    e = cudaFuncSetAttribute(lpcnet_sampler_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    if (e != cudaSuccess) return (int)e;
  }
  seen[key] = *clusters;
  return 0;
}

template <int S>
int launch(Args& a, const Plan& p, cudaStream_t stream, int* max_clusters) {
  const long long smem = 4LL * p.L.total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const int rc = clusters_that_fit<S>(cfg, &clusters);
  if (rc != 0) return rc;
  if (max_clusters) {  // a query: nothing is launched
    *max_clusters = clusters;
    return 0;
  }
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, lpcnet_sampler_kernel<S>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int dispatch(int S, Args& a, const Plan& p, cudaStream_t stream, int* max_clusters) {
  switch (S) {
    case 1: return launch<1>(a, p, stream, max_clusters);
    case 2: return launch<2>(a, p, stream, max_clusters);
    case 4: return launch<4>(a, p, stream, max_clusters);
    case 8: return launch<8>(a, p, stream, max_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

void fill(Args& a, const Plan& p) {
  a.gC = p.gC;
  a.gBc = p.gBc;
  a.Kx = p.Kx;
  a.resA = p.resA;
  a.resB = p.resB;
  a.resH = p.resH;
  a.L = p.L;
#ifdef DSS_SAMPLER_TRACE
  a.trace = g_trace;
#endif
}

}  // namespace

// All tensors f32 contiguous and 16-byte aligned except the int32 ones: exc0/exc1 [B, S]
// (most recent first), work, nwork, cnt, u0.  Shapes: cond [T,B,CD], lpc [T,B,P], temp
// [T,B], noise [T,F,B,256] (may be null when every temp < 0), sig_out [B, T*F], state
// [B, .]; weights and the per-block layout as in `Args` above (ops/sampler.py,
// cluster_layout, builds the layout for the cluster size).  S in {1, 2, 4, 8} dividing F;
// GA, GB, nuM multiples of 4; wmax a multiple of 32; max(S, 2) <= P <= 32.
// Returns a cudaError_t value (0 = launched).
extern "C" int dss_lpcnet_sampler_bunched(
    const float* cond, const float* lpc, const float* temp, const float* noise,
    const float* emb, const float* wx_a_cond, const float* bx_a, const float* bh_a,
    const float* wx_b, const float* bx_b, const float* wh_b, const float* bh_b,
    const float* corr, const float* tiles, const int* work, const int* nwork, const int* cnt,
    const int* u0, const float* w_out, const float* g_out, const float* ib_out,
    const float* b_out, const float* h_a0, const float* h_b0, const float* sig_mem0,
    const int* exc0, float* sig_out, float* h_a1, float* h_b1, float* sig_mem1, int* exc1,
    int S, int T, int F, int B, int GA, int GB, int CD, int P, int nuM, int wmax, int maxslots,
    void* stream) {
  if (!supported(S, F, GA, GB, P, nuM, wmax) || (S > 1 && !corr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(S, GA, GB, CD, P, nuM, wmax, maxslots);
  Args a{cond, lpc, temp, noise, emb, wx_a_cond, bx_a, bh_a, wx_b, bx_b, wh_b, bh_b, corr,
         tiles, reinterpret_cast<const int2*>(work), nwork, cnt, u0, w_out, g_out, ib_out,
         b_out, h_a0, h_b0, sig_mem0, exc0, sig_out, h_a1, h_b1, sig_mem1, exc1,
         T, F, B, GA, GB, CD, P, nuM, wmax, maxslots};
  fill(a, p);
  return dispatch(S, a, p, (cudaStream_t)stream, nullptr);
}

// What a launch at these widths would use: out[0] shared-memory bytes per block, out[1]
// bytes of weights resident per block, out[2..4] whether GRU-A's tiles, the gru_b_wx rows
// and the head columns are resident, out[5] how many clusters the card can run at once,
// out[6] the cluster size.  Returns a cudaError_t value.
extern "C" int dss_lpcnet_sampler_plan(int S, int F, int GA, int GB, int CD, int P, int nuM,
                                       int wmax, int maxslots, int* out) {
  if (!supported(S, F, GA, GB, P, nuM, wmax)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(S, GA, GB, CD, P, nuM, wmax, maxslots);
  Args a{};
  a.B = 1;
  fill(a, p);
  out[6] = kCluster;
  out[0] = 4 * p.L.total;
  out[1] = (int)p.resident;
  out[2] = p.resA;
  out[3] = p.resB;
  out[4] = p.resH;
  return dispatch(S, a, p, nullptr, &out[5]);
}

#ifdef DSS_SAMPLER_TRACE
// The buffer of 13 int64 on the card that later launches stamp (null: none).
extern "C" void dss_lpcnet_sampler_set_trace(long long* trace) { g_trace = trace; }
#endif
