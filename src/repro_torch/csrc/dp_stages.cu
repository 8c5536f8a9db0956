// dp_stages: the Algorithm-1 stage tables of every (variant, cluster) of
// a LUT build, plus the gather of each cluster's consulted final-stage
// rows.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   * src/repro/kernels/knapsack_dp/kernel.py::_dp_kernel - one storage
//     space per launch, K-panels chained through a (T+1, 1) carry column;
//   * the stage part of src/repro/kernels/lut_pipeline/kernel.py::
//     _fused_kernel - the per-(v, c) n-space recurrence seeded from the
//     k=0 base and the gather of rows[v] into G.
// Plain version: repro_torch/kernels/knapsack_dp/ref.py::dp_stages_ref.
//
// Recurrence, per space i with item cost (t_i >= 1 ticks, e_i):
//   out_i[t, k] = min(out_{i-1}[t, k],
//                     t >= t_i && k > 0 ? out_i[t - t_i, k - 1] + e_i : inf)
//
// Bound: the (V, C, n+1, T+1, K+1) fp32 stage tensor is written once, one
// add and one min per element, so the bound is bytes: 532 MB at the
// gpu-pool clock-grid shape (V=6, C=2, n=2, T=14376, K=256), 0.16 ms at
// 3.35 TB/s.
// Design: the recurrence is serial in t and row t, column k reads row
// t - t_i, column k - 1 of the stage being written - a value another
// thread wrote. One block owns one (v, c) table, its threads stride over
// k (any K), and a __syncthreads() after every row publishes that row
// before any thread can read it. That walks n (T+1) barrier-separated
// rows in each of only V*C blocks, so this first version is bound by the
// latency of one row step, far above the byte bound; the stage 0 base is
// written here, in place, so no concatenate copy follows.
// Parity: fp32 add and min only, no multiply to contract and no fast
// math, so the tables are bitwise equal to the plain version.

#include <cuda_runtime.h>
#include <math.h>

__global__ void dp_stages_kernel(const int* __restrict__ t_items,
                                 const float* __restrict__ e_items,
                                 const int* __restrict__ rows,
                                 float* stages, float* gathered, int C,
                                 int n, int T, int K, int R) {
  const int b = blockIdx.x;  // (v, c) flattened
  const int v = b / C;
  const int K1 = K + 1;
  const size_t plane = (size_t)(T + 1) * K1;
  float* tab = stages + (size_t)b * (n + 1) * plane;

  for (int t = 0; t <= T; ++t)
    for (int k = threadIdx.x; k < K1; k += blockDim.x)
      tab[(size_t)t * K1 + k] = k == 0 ? 0.0f : INFINITY;
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const float* prev = tab + (size_t)i * plane;
    float* out = tab + (size_t)(i + 1) * plane;
    const int ti = t_items[b * n + i];
    const float ei = e_items[b * n + i];
    for (int t = 0; t <= T; ++t) {
      const size_t row = (size_t)t * K1;
      for (int k = threadIdx.x; k < K1; k += blockDim.x) {
        const float keep = prev[row + k];
        float take = INFINITY;
        if (t >= ti && k > 0) take = out[row - (size_t)ti * K1 + k - 1] + ei;
        out[row + k] = take < keep ? take : keep;
      }
      __syncthreads();
    }
  }

  if (R > 0) {
    const float* last = tab + (size_t)n * plane;
    float* g = gathered + (size_t)b * R * K1;
    for (int r = 0; r < R; ++r) {
      const size_t src = (size_t)rows[v * R + r] * K1;
      for (int k = threadIdx.x; k < K1; k += blockDim.x)
        g[(size_t)r * K1 + k] = last[src + k];
    }
  }
}

// t_items, e_items: (V, C, n) int32 / fp32; rows: (V, R) int32 or null
// when R == 0; stages: (V, C, n+1, T+1, K+1) fp32; gathered: (V, C, R,
// K+1) fp32 or null when R == 0. Returns cudaGetLastError() after the
// launch on `stream`.
extern "C" int dp_stages_launch(const void* t_items, const void* e_items,
                                const void* rows, void* stages,
                                void* gathered, int V, int C, int n, int T,
                                int K, int R, void* stream) {
  if (V * C == 0) return (int)cudaSuccess;
  int threads = ((K + 1 + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  dp_stages_kernel<<<V * C, threads, 0, (cudaStream_t)stream>>>(
      (const int*)t_items, (const float*)e_items, (const int*)rows,
      (float*)stages, (float*)gathered, C, n, T, K, R);
  return (int)cudaGetLastError();
}
