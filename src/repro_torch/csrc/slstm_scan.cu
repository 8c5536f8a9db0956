// slstm_scan: xLSTM's scalar-memory cell with exponential gating over a
// whole sequence. Per (batch row, unit), from c = n = 0, m = -inf:
//   lf = logsigmoid(f_t);  m' = max(lf + m, i_t)
//   fg = exp(lf + m - m');  ig = exp(i_t - m')
//   c = fg c + ig tanh(z_t);  n = fg n + ig
//   h_t = sigmoid(o_t) c / max(n, 1)
//
// Stands in for the JAX package's lax.scan of
// src/repro/models/recurrent.py::_slstm_step inside chunked_scan (no
// Pallas kernel: XLA runs the scan there). That sLSTM has no recurrent
// weight matrix, so every unit is its own recurrence. Plain version:
// repro_torch/kernels/slstm_scan/ref.py::slstm_scan_ref.
//
// Inputs: z, i, f, o (B, S, d) fp32 gate pre-activations (f with its
// bias), contiguous; output h (B, S, d) fp32.
//
// Bound on an H100 SXM: bytes, 20 per (b, t, unit) (four inputs read,
// one output written): at xlstm_1_3b's width (d = 2048), B = 2, S = 4096,
// 336 MB, 0.100 ms at 3.35 TB/s.
//
// Design: one thread per (batch row, unit) walks the sequence with its
// state in registers; neighbouring threads take neighbouring units, so
// every access of a time step is coalesced; the next U steps' inputs are
// loaded into registers before they are run. B * d threads (4,096 at
// xlstm_1_3b's width with B = 2) fill only part of the card.
// Parity: every product and sum rounds as the plain version's separate
// torch ops (__fmul_rn / __fadd_rn / __fdiv_rn, no contraction);
// logsigmoid, sigmoid and tanh are written as torch's CUDA kernels write
// them (min(x, 0) - log1p(exp(-|x|)), 1 / (1 + exp(-x)), tanhf), and
// max/clamp propagate NaN as torch's do. No fast math. The libm calls
// need not round as torch's build does, so h is held to the plain version
// within a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;                     // time steps prefetched per batch

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;      // torch.maximum
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(0.0f, x), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_fwd(const float* __restrict__ z, const float* __restrict__ ip,
               const float* __restrict__ fp, const float* __restrict__ op,
               float* __restrict__ h, int B, int S, int d) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * d) return;
  const long long row = idx / d, u0 = idx % d;
  const long long base = row * S * d + u0;
  float c = 0.0f, n = 0.0f, m = -INFINITY;
  for (int t0 = 0; t0 < S; t0 += U) {
    float zv[U], iv[U], fv[U], ov[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const long long o = base + (long long)(t0 + u) * d;
        zv[u] = z[o];
        iv[u] = ip[o];
        fv[u] = fp[o];
        ov[u] = op[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const float lm = __fadd_rn(log_sigmoid(fv[u]), m);
        const float m_new = tmax(lm, iv[u]);
        const float fg = expf(__fsub_rn(lm, m_new));
        const float ig = expf(__fsub_rn(iv[u], m_new));
        c = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, tanhf(zv[u])));
        n = __fadd_rn(__fmul_rn(fg, n), ig);
        m = m_new;
        const float den = n != n ? n : fmaxf(n, 1.0f);   // clamp_min
        h[base + (long long)(t0 + u) * d] =
            __fdiv_rn(__fmul_rn(sigmoid(ov[u]), c), den);
      }
    }
  }
}

}  // namespace

extern "C" int slstm_scan_launch(const void* z, const void* i, const void* f,
                                 const void* o, void* h, int B, int S, int d,
                                 void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  const int blocks = (int)(((long long)B * d + THREADS - 1) / THREADS);
  slstm_scan_fwd<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)z, (const float*)i, (const float*)f, (const float*)o,
      (float*)h, B, S, d);
  return (int)cudaGetLastError();
}
