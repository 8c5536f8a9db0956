// rglru_scan: the RG-LRU's linear recurrence over a whole sequence,
// h[b, t, c] = a[b, t, c] * h[b, t-1, c] + b[b, t, c] from h[b, -1, c] = 0,
// and its backward,
//   g_t = dh_t + a_{t+1} * g_{t+1}   (from g_{S-1} = dh_{S-1}),
//   da_t = g_t * h_{t-1} (h_{-1} = 0),  db_t = g_t.
//
// Stands in for the JAX package's jax.lax.associative_scan in
// src/repro/models/recurrent.py::rglru_block (no Pallas kernel: XLA runs
// the scan there). Plain versions:
// repro_torch/kernels/rglru_scan/ref.py::rglru_scan_ref and
// rglru_scan_bwd_ref, the sequential loops the port ran before.
//
// Inputs: a, b, h, dh, da, db are (B, S, d) fp32, contiguous.
//
// Bound on an H100 SXM: bytes. The forward reads a and b and writes h,
// 12 bytes per (b, t, channel): at recurrentgemma_2b's width (d = 2560),
// B = 2, S = 4096, 252 MB, 0.075 ms at 3.35 TB/s; the backward moves 20
// bytes per element (a, h, dh in; da, db out). Two flops per element is
// nothing beside that.
//
// Design: one thread per (batch row, channel) walks the sequence, so the
// recurrence needs no communication at all; neighbouring threads take
// neighbouring channels, so every load and store of a time step is
// coalesced. Each thread loads the next U steps' inputs into registers
// before it runs them, so U independent loads per array are in flight
// behind the dependent multiply-add chain. B * d threads (5,120 at
// recurrentgemma_2b's width with B = 2) fill only part of the card: a
// chunked parallel scan over time is the next step, not this one.
// Parity: __fmul_rn / __fadd_rn keep nvcc from contracting a*h + b into
// one fused multiply-add, so every step rounds twice, as the plain loop
// does, and the outputs equal it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 16;                   // time steps prefetched per batch

__global__ void __launch_bounds__(THREADS)
rglru_scan_fwd(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ h, int B, int S, int d) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * d) return;
  const long long row = idx / d, c = idx % d;
  const long long base = row * S * d + c;
  float ht = 0.0f;
  for (int t0 = 0; t0 < S; t0 += U) {
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        const long long o = base + (long long)(t0 + u) * d;
        av[u] = a[o];
        bv[u] = b[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < S) {
        ht = __fadd_rn(__fmul_rn(av[u], ht), bv[u]);
        h[base + (long long)(t0 + u) * d] = ht;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
rglru_scan_bwd(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ dh, float* __restrict__ da,
               float* __restrict__ db, int B, int S, int d) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * d) return;
  const long long row = idx / d, c = idx % d;
  const long long base = row * S * d + c;
  float g = 0.0f;
  for (int t0 = S - 1; t0 >= 0; t0 -= U) {
    // step t = t0 - u reads dh_t, a_{t+1} (t < S-1) and h_{t-1} (t > 0)
    float dv[U], an[U], hp[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        const long long o = base + (long long)t * d;
        dv[u] = dh[o];
        an[u] = t + 1 < S ? a[o + d] : 0.0f;
        hp[u] = t > 0 ? h[o - d] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        g = t + 1 < S ? __fadd_rn(dv[u], __fmul_rn(an[u], g)) : dv[u];
        const long long o = base + (long long)t * d;
        da[o] = __fmul_rn(g, hp[u]);
        db[o] = g;
      }
    }
  }
}

int blocks(int B, int d) {
  return (int)(((long long)B * d + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int rglru_scan_fwd_launch(const void* a, const void* b, void* h,
                                     int B, int S, int d, void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  rglru_scan_fwd<<<blocks(B, d), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)h, B, S, d);
  return (int)cudaGetLastError();
}

extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* dh, void* da, void* db,
                                     int B, int S, int d, void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  rglru_scan_bwd<<<blocks(B, d), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)dh, (float*)da,
      (float*)db, B, S, d);
  return (int)cudaGetLastError();
}
