// Device helpers of the LPCNet sampler kernel (lpcnet_sampler_bunched.cu, bunch
// 1/2/4/8): mu-law companding and the split-K matrix-vector product of its
// per-frame projections.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

namespace dss {

constexpr int kLevels = 256;
constexpr float kMu = 255.f;
constexpr float kLog1pMu = 5.545177444479562f;  // log1p(255)

// One block size: __launch_bounds__ caps the build at 64 registers per thread, which
// is what lets 1024 threads launch (96 registers refuse with cudaError 701).
constexpr int kThreads = 1024;

// The most dynamic shared memory one block may ask for on sm_90.
constexpr long long kMaxSmem = 232448;

__device__ __forceinline__ float sgn(float x) { return (float)((x > 0.f) - (x < 0.f)); }

__device__ __forceinline__ int mulaw_encode(float x) {
  x = fminf(fmaxf(x, -1.f), 1.f);
  const float y = sgn(x) * log1pf(kMu * fabsf(x)) / kLog1pMu;
  const float v = rintf((y + 1.f) * 0.5f * (float)(kLevels - 1));
  return (int)fminf(fmaxf(v, 0.f), (float)(kLevels - 1));
}

// The level in double precision, rounded once: the float32 nearest the exact value, which
// is vocoder/mulaw.py's table (powf put some levels a unit in the last place off it).
__device__ __forceinline__ float mulaw_decode(int idx) {
  const double y = (double)idx / (double)(kLevels - 1) * 2.0 - 1.0;
  return (float)(copysign(pow(1.0 + (double)kMu, fabs(y)) - 1.0, y) / (double)kMu);
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// part[g*N + c] = sum over k in group g of x[k] * W[k*N + c], for c < N (N % 4 == 0).
// One work item is a quad of 4 adjacent columns (one 16-byte load per row, so a warp
// reads 512 contiguous bytes) times one of G slices of the K rows: short per-thread
// load chains, many loads in flight.  W may lie in shared or in global memory: the loads
// are plain generic loads.
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
      const float4 w = W4[(size_t)k * NQ + q];
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

}  // namespace dss
