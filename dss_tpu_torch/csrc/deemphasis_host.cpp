// The neural vocoder's de-emphasis on the host: y[t] = s[t] + 0.85 y[t-1] per stream, a
// multiply and an add a sample, each rounded once (built with -ffp-contract=off), in the order
// of ops/deemphasis.py::deemphasis_plain and of csrc/deemphasis.cu.  So it equals both bit for
// bit.  Called through ctypes by ops/deemphasis.py::deemphasis for tensors on the CPU.

extern "C" int dss_deemphasis_host(const float* sig, long long s_row, const float* y0,
                                   float* out, long long o_row, float* last, int B,
                                   long long n, float a) {
  if (B < 0 || n < 0) return 1;
  for (int b = 0; b < B; ++b) {
    const float* in = sig + b * s_row;
    float* y_out = out + b * o_row;
    float y = y0[b];
    for (long long t = 0; t < n; ++t) {
      const float p = a * y;
      y = in[t] + p;
      y_out[t] = y;
    }
    last[b] = y;
  }
  return 0;
}
