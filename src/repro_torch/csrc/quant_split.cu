// quant_split: re-tier M same-shaped fp32 (d_in, d_out) matrices in one
// launch. Each matrix's columns are cut into tiers in split order, tier
// k holding columns [off_k, off_k + n_k); an int8 tier stores
//   scale[m, j] = max(max_r |w[m, r, off + j]|, 1e-8) / 127,
//   q[m, r, j]  = clamp(rint(w[m, r, off + j] / scale[m, j]), -127, 127),
// a bf16 tier w[m, r, j] = bf16(w[m, r, off + j]) (round to nearest
// even); each output is stacked over the M matrices, (M, d_in, n_k).
//
// Replaces no TPU kernel: the JAX package's split_weight
// (src/repro/models/hetero_linear.py) is plain jnp, which XLA fuses. The
// port's plain version, split_weight of each matrix
// (repro_torch/models/hetero_linear.py), runs about
// nine PyTorch kernels per int8 tier (abs, amax, clamp, the scale
// division, the division, round, clamp, cast), each reading a whole fp32
// column slice: about 41 bytes of traffic per int8 element and 6 per
// bf16 element, 859 launches a migration of internlm2's 48 FFN matrices.
//
// Inputs: `table`, a device array of M base pointers, each of a
// contiguous (d_in, d_out) fp32 matrix (the matrices are the engine's
// params, so the wrapper builds the table once); the tier plan by value.
//
// Bound on an H100 SXM: bytes. Every fp32 element is read once and each
// tier's output written once: 4 d_in d_out M bytes in and 1 (int8) or 2
// (bf16) bytes out per element. At internlm2_1_8b's 48 x (2048, 8192),
// 3.22 GB in and 0.81-1.61 GB out, 1.20-1.44 ms at 3.35 TB/s.
//
// Design: one pass over HBM. The grid is (8 x strips, M): a strip is 32
// consecutive columns of one matrix on the global 32-column grid, every
// strip of every matrix one unit, each unit a thread block cluster of 8
// blocks (__cluster_dims__). A column's scale needs every row of the
// column before any of its q can be written, so the pass cannot stream
// a column; the rows of a strip are spread over the cluster and held on
// chip until the scales are known. Block k of the cluster owns rows
// [k R, k R + R), R = ceil(d_in / 8): 256 rows x 128 bytes = 32 KB of
// shared memory a block at d_in = 2048, six blocks an SM, 256 x 48
// clusters at internlm2's shape. The block stages its rows with
// cp.async, 16 bytes a thread (8 threads a row, a warp 4 whole 128-byte
// lines) where d_out % 4 == 0 and every matrix is 16-byte aligned, else
// 4 bytes a thread, so its whole 32 KB is in flight at once. Each lane
// owns one column and takes the tier that holds it, so a strip may
// straddle tiers of either format and the widths (fractions_to_counts,
// arbitrary) need no alignment. An int8 lane's warp rows give a
// per-lane max, the block's 8 warps one max per column in shared
// memory, and after a cluster barrier (release / acquire) warp 0 reads
// the 8 blocks' maxima through distributed shared memory (mapa), so the
// scale is known in every block without a second read of HBM. A second
// arrive lets the blocks go on; each waits at its end until its peers
// have read its maxima. A bf16 lane casts its staged column. Lane j
// stores column j of a row: 32 consecutive bytes (int8) or 64 (bf16) a
// warp store, whole sectors only where the tier's rows and offset fall
// on sectors (on an H100, 48 x (2048, 8192) all int8 take 1.43 ms at
// 32-column multiples, 1.85 ms at 3999 | 4193 columns; all bf16 1.65 ms
// at 4000 | 4192 and 2.60 ms at 3999 | 4193).
// Parity: the max is exact in any order; the scale and the quotient are
// IEEE divisions (__fdiv_rn: a multiply by the reciprocal can differ in
// the last bit, see repro_torch/quant/int8.py), rintf rounds half to
// even as torch.round does, __float2bfloat16_rn is PyTorch's bf16 cast;
// no fast math. So for finite weights the outputs equal split_weight's
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CLUSTER = 8;              // blocks a unit
constexpr int COLS = 32;                // columns a strip, one a lane
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_TIERS = 8;
constexpr int MAX_SMEM = 232448;        // bytes a block can have (H100)
constexpr int STATIC_SMEM = (WARPS + 2) * COLS * 4;

struct Tier {
  void* out;                            // (M, d_in, n) int8 or bf16
  float* scale;                         // (M, n) fp32 of an int8 tier
  int off, n, int8;
};

struct Plan {
  Tier t[MAX_TIERS];
  int tiers;
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// the float at `p` in the shared memory of block `rank` of the cluster
__device__ __forceinline__ float peer_load(const float* p, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  unsigned remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");   // release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");      // acquire
}

// strip blockIdx.x / CLUSTER of matrix blockIdx.y: this block's rows
// staged, the int8 columns' scales agreed over the cluster, each lane's
// column written in its tier's format
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    quant_split_kernel(const float* const* __restrict__ table,
                       const __grid_constant__ Plan p, int d_in, int d_out,
                       int rows_blk, int vec) {
  extern __shared__ __align__(16) float tile[];   // rows_blk x COLS
  __shared__ float red[WARPS][COLS];
  __shared__ float blk[COLS];                     // read by the peers
  __shared__ float scl[COLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cluster_rank();
  const size_t m = blockIdx.y;
  const float* __restrict__ w = table[m];
  const int c0 = blockIdx.x / CLUSTER * COLS, r0 = rank * rows_blk;
  const int rows = max(0, min(rows_blk, d_in - r0));
  if (vec) {
    for (int k = tid; k < rows * (COLS / 4); k += THREADS) {
      const int r = k >> 3, col = c0 + 4 * (k & 7);
      if (col < d_out)                  // d_out % 4 == 0: whole chunks
        cp16(tile + 4 * k, w + (size_t)(r0 + r) * d_out + col);
    }
  } else {
    for (int k = tid; k < rows * COLS; k += THREADS) {
      const int col = c0 + (k & 31);
      if (col < d_out)
        cp4(tile + k, w + (size_t)(r0 + (k >> 5)) * d_out + col);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // this lane's column and its tier: the last tier starting at or before
  // it (an empty tier starts where the next one does)
  const int c = c0 + lane;
  Tier my = p.t[0];
#pragma unroll
  for (int j = 1; j < MAX_TIERS; ++j)
    if (j < p.tiers && c >= p.t[j].off) my = p.t[j];
  const bool is8 = c < d_out && my.int8;
  __syncthreads();

  float a = 0.0f;
  if (is8)
    for (int r = warp; r < rows; r += WARPS)
      a = fmaxf(a, fabsf(tile[r * COLS + lane]));
  red[warp][lane] = a;
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int v = 1; v < WARPS; ++v) a = fmaxf(a, red[v][lane]);
    blk[lane] = a;
  }
  cluster_arrive();                     // this block's maxima are written
  cluster_wait();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < CLUSTER; ++k) a = fmaxf(a, peer_load(blk + lane, k));
    const float s = __fdiv_rn(fmaxf(a, 1e-8f), 127.0f);
    scl[lane] = s;
    if (rank == 0 && is8) my.scale[m * my.n + (c - my.off)] = s;
  }
  cluster_arrive();                     // done reading the peers' maxima
  __syncthreads();
  const size_t at = (m * d_in + r0) * my.n + (c - my.off);
  if (is8) {
    const float s = scl[lane];
    int8_t* q = static_cast<int8_t*>(my.out) + at;
    for (int r = warp; r < rows; r += WARPS) {
      const float v = rintf(__fdiv_rn(tile[r * COLS + lane], s));
      q[(size_t)r * my.n] =
          (int8_t)__float2int_rn(fminf(fmaxf(v, -127.0f), 127.0f));
    }
  } else if (c < d_out) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(my.out) + at;
    for (int r = warp; r < rows; r += WARPS)
      o[(size_t)r * my.n] = __float2bfloat16_rn(tile[r * COLS + lane]);
  }
  cluster_wait();                       // the peers have read `blk`
}

}  // namespace

// The plan comes from kernels/quant_split/ops.py::split_plan: `tiers`
// tiers in split order, tier k at column offs[k] with widths[k] columns
// (contiguous, covering [0, d_out)), int8s[k] != 0 for int8, outs[k] its
// stacked output, scales[k] its stacked scales (int8 tiers); `rows_blk`
// = ceil(d_in / 8) rows a block; vec: d_out % 4 == 0 and every matrix
// 16-byte aligned. Returns cudaGetLastError() after the launch on
// `stream`.
extern "C" int quant_split_launch(const void* table, int m, int d_in,
                                  int d_out, int tiers, const int* offs,
                                  const int* widths, const int* int8s,
                                  void* const* outs, void* const* scales,
                                  int rows_blk, int vec, void* stream) {
  if (m == 0 || d_in == 0 || d_out == 0) return (int)cudaSuccess;
  const long long smem = (long long)rows_blk * COLS * 4;
  if (tiers < 1 || tiers > MAX_TIERS || m > 65535 || d_in < 0 ||
      d_out < 0 || (long long)rows_blk * CLUSTER < d_in ||
      smem + STATIC_SMEM > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Plan p = {};
  p.tiers = tiers;
  int end = 0;
  for (int k = 0; k < tiers; ++k) {
    if (offs[k] != end || widths[k] < 0 || widths[k] > d_out - end)
      return (int)cudaErrorInvalidValue;
    p.t[k] = Tier{outs[k], (float*)scales[k], offs[k], widths[k], int8s[k]};
    end += widths[k];
  }
  if (end != d_out) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        quant_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long strips = (d_out + COLS - 1) / COLS;
  const dim3 grid((unsigned)(strips * CLUSTER), m);
  quant_split_kernel<<<grid, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      (const float* const*)table, p, d_in, d_out, rows_blk, vec);
  return (int)cudaGetLastError();
}
