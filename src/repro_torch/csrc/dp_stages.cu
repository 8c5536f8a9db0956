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
// 3.35 TB/s. Each stage here also reads the one before it.
//
// Design: the only dependency inside stage i is (t, k) <- (t - t_i,
// k - 1). For a residue rho = t mod t_i the rows t = rho + u t_i form a
// (u, k) grid in which (u, k) needs only (u - 1, k - 1), so the stage
// splits into independent diagonal chains m = u - k, each serial in k
// with at most K + 1 elements. One thread owns one chain and carries its
// running value in a register: no barrier, and no read of a value
// another thread wrote. Lanes are skewed so accesses coalesce: lane j of
// a warp owns chains m0 - j - 32 q (q < Q = 4), so at wavefront step u
// the warp sits on row rho + u t_i at the 128 consecutive columns
// k = u - m0 + j + 32 q: 512 contiguous bytes per step, where one chain
// per lane (128 bytes) ran 25 % slower at the gpu-pool grid, the writes
// being scattered over the planes. A warp is (table, rho, m0), m0
// stepping by 128; the wrapper (kernels/knapsack_dp/ops.py::chain_plan)
// lays the warps of every table out in one grid per stage (about 150
// warps per table at the gpu-pool grid, where the first version ran one
// block per table). The loads of the previous stage do not depend on the
// carry, so each lane issues UNROLL steps of them ahead of the chain.
// Stages are sequential (stage i + 1 reads all of stage i on other
// chains): one launch per stage, after a parallel fill of the k=0 base
// plane, and a gather launch at the end. Stage 1 takes the base values
// from their formula instead of reading the plane back.
// Parity: every element gets exactly the one add and the one min of the
// recurrence, fp32, no multiply to contract and no fast math, so the
// tables are bitwise equal to the plain version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHAIN_THREADS = 256;        // eight warps
constexpr int Q = 4;                      // chains per lane
constexpr int CHAINS = 32 * Q;            // chains per warp
constexpr int UNROLL = 4;                 // steps loaded ahead of the chain
constexpr int FILL_THREADS = 256;

// stage 0 of every table: 0 at k = 0, +inf elsewhere; blockIdx.y is the
// table, so the index math stays 32-bit
__global__ void dp_stages_base_kernel(float* __restrict__ stages, int n,
                                      int plane, int K1) {
  float* base = stages + (size_t)blockIdx.y * (n + 1) * plane;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < plane;
       p += gridDim.x * blockDim.x)
    base[p] = p % K1 == 0 ? 0.0f : INFINITY;
}

// stage i + 1 of every table from stage i. warp_off: (VC + 1) prefix sums
// of the tables' warp counts; wpr: (VC) warps per residue of each table
__global__ void __launch_bounds__(CHAIN_THREADS)
    dp_stages_chain_kernel(const int* __restrict__ t_items,
                           const float* __restrict__ e_items,
                           const int* __restrict__ warp_off,
                           const int* __restrict__ wpr,
                           float* __restrict__ stages, int VC, int n, int i,
                           int T, int K) {
  const int gw = (int)((blockIdx.x * (unsigned)CHAIN_THREADS + threadIdx.x)
                       >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= warp_off[VC]) return;
  int lo = 0, hi = VC - 1;                // table b: warp_off[b] <= gw
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (warp_off[mid] <= gw) lo = mid; else hi = mid - 1;
  }
  const int b = lo;
  const int ti = t_items[b * n + i];
  const float ei = e_items[b * n + i];
  const int local = gw - warp_off[b];
  const int rho = local / wpr[b];
  const int U = (T - rho) / ti;           // last u of this residue
  const int m0 = U - CHAINS * (local % wpr[b]);  // this warp's top chain
  // lane j, slot q owns chain m0 - j - 32 q: at step (u =) s it sits at
  // column k = s - m0 + j + 32 q, so a warp covers CHAINS consecutive
  // columns of row rho + s t_i
  const int s_lo = max(0, m0 - CHAINS + 1);
  const int s_hi = min(U, m0 + K);
  const int K1 = K + 1;
  const size_t plane = (size_t)(T + 1) * K1;
  float* out = stages + ((size_t)b * (n + 1) + i + 1) * plane;
  const float* prev = out - plane;
  const int k_lane = lane - m0;

  float carry[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) carry[q] = 0.0f;
  for (int s0 = s_lo; s0 <= s_hi; s0 += UNROLL) {
    float p[UNROLL][Q];
#pragma unroll
    for (int a = 0; a < UNROLL; ++a)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = s0 + a, k = s + k_lane + 32 * q;
        if (i == 0)                       // the base stage, not re-read
          p[a][q] = k == 0 ? 0.0f : INFINITY;
        else
          p[a][q] = (s <= s_hi && k >= 0 && k <= K)
                        ? __ldg(prev + (size_t)(rho + s * ti) * K1 + k)
                        : 0.0f;
      }
#pragma unroll
    for (int a = 0; a < UNROLL; ++a)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int s = s0 + a, k = s + k_lane + 32 * q;
        if (s > s_hi || k < 0 || k > K) continue;
        float v = p[a][q];                // u = 0 or k = 0: no take
        if (s > 0 && k > 0) {
          const float take = carry[q] + ei;  // out[t - t_i, k - 1] + e_i
          v = take < v ? take : v;
        }
        out[(size_t)(rho + s * ti) * K1 + k] = v;
        carry[q] = v;
      }
  }
}

// gathered[v, c, r] = final stage row rows[v, r] of table (v, c)
__global__ void dp_stages_gather_kernel(const int* __restrict__ rows,
                                        const float* __restrict__ stages,
                                        float* __restrict__ gathered, int VC,
                                        int C, int n, int T, int K, int R) {
  const int K1 = K + 1;
  const size_t plane = (size_t)(T + 1) * K1;
  const size_t total = (size_t)VC * R * K1;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int k = (int)(idx % K1);
    const size_t br = idx / K1;
    const int r = (int)(br % R), b = (int)(br / R);
    const float* last = stages + ((size_t)b * (n + 1) + n) * plane;
    gathered[idx] = last[(size_t)rows[(b / C) * R + r] * K1 + k];
  }
}

unsigned fill_blocks(size_t total, size_t cap) {
  const size_t blocks = (total + FILL_THREADS - 1) / FILL_THREADS;
  return (unsigned)(blocks < cap ? (blocks ? blocks : 1) : cap);
}

}  // namespace

// t_items, e_items: (V, C, n) int32 / fp32; rows: (V, R) int32 or null
// when R == 0; warp_off: (n, V C + 1) int32 and wpr: (n, V C) int32 on
// the card, and stage_warps: (n) int32 on the host - the launch geometry
// of kernels/knapsack_dp/ops.py::chain_plan; stages: (V, C, n+1, T+1,
// K+1) fp32; gathered: (V, C, R, K+1) fp32 or null when R == 0. Launches
// the base fill, one chain kernel per stage and the gather on `stream`;
// returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int dp_stages_launch(const void* t_items, const void* e_items,
                                const void* rows, const void* warp_off,
                                const void* wpr, const int* stage_warps,
                                void* stages, void* gathered, int V, int C,
                                int n, int T, int K, int R, void* stream) {
  const int VC = V * C;
  if (VC == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int plane = (T + 1) * (K + 1);     // < 2^31: the wrapper checks
  const dim3 base_grid(fill_blocks(plane, 2048 / VC + 1), VC);
  dp_stages_base_kernel<<<base_grid, FILL_THREADS, 0, s>>>(
      (float*)stages, n, plane, K + 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n; ++i) {
    const int warps = stage_warps[i];
    const int blocks = (warps + CHAIN_THREADS / 32 - 1) / (CHAIN_THREADS / 32);
    dp_stages_chain_kernel<<<blocks, CHAIN_THREADS, 0, s>>>(
        (const int*)t_items, (const float*)e_items,
        (const int*)warp_off + (size_t)i * (VC + 1),
        (const int*)wpr + (size_t)i * VC, (float*)stages, VC, n, i, T, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (R > 0) {
    dp_stages_gather_kernel<<<fill_blocks((size_t)VC * R * (K + 1), 2048),
                              FILL_THREADS, 0, s>>>(
        (const int*)rows, (const float*)stages, (float*)gathered, VC, C, n,
        T, K, R);
    err = cudaGetLastError();
  }
  return (int)err;
}
