// minplus_combine: the Algorithm-2 K-cluster combine of a LUT build - the
// min-plus fold with int32 argmin traces, the final k=K combine with its
// first-minimum argmin, and the split backtrace - for every consulted row
// of every variant.
//
// Replaces the fold/combine/backtrace part of the Pallas TPU kernel
// src/repro/kernels/lut_pipeline/kernel.py::_fused_kernel (its
// _fold_init/_fold_middle/_fold_final/_combine_single steps, which run
// repro/core/multipool.py's minplus_fold_jnp and backtrace_splits_jnp).
// Plain version: repro_torch/core/multipool.py::combine_rows_torch.
//
// Input: gathered (V, C, R, K+1) fp32, the consulted rows of each
// cluster's final stage table (written by dp_stages on the same stream).
// For every row (v, r), with G[c] = gathered[v, c, r, :]:
//   F <- G[0]
//   for c = 1 .. C-2:  F'[k] = min_{i <= k} F[i] + G[c][k - i]
//                      (ascending i, strict <, argmin i kept in A[c-1])
//   cand[i] = F[i] + G[C-1][K - i];  i_opt = first argmin
//   min_e = cand[i_opt]; splits backtraced through A.
//
// Bound: R (C-2) (K+1)(K+2)/2 adds and compares per variant for the
// folds plus R (K+1) for the final combine; the bytes (read G once, write
// min_e and splits) are small. At the main-path shapes (R=33, K=256,
// C<=3) that is well under a microsecond at the fp32 rate or the HBM
// rate: the kernel is bound by its launch and its first loads.
// Design: one block per row (v, r) - V R blocks, 198 at the main-path
// grids - so the rows run on all SMs and no block waits on another. The
// block stages its C rows in shared memory with coalesced loads; every
// fold reads only shared memory. A fold is a chain of k+1 dependent
// compare steps per output, each waiting on a shared-memory load, so
// the block is as wide as K+1 (at most 1024 threads; wrapper's
// combine_plan): each thread owns outputs k (striding by blockDim when
// K+1 exceeds it) and scans i = 0..k in order with a strict <
// from (+inf, 0), the numpy fold's own order, so values and argmin traces
// match it with no tie logic; warps read F[i] as a broadcast and
// G[c][k - i] on consecutive banks. F is double buffered in shared
// memory, one barrier per fold, and the C-2 argmin traces stay there.
// The final combine gives each thread the candidates i = tid, tid +
// blockDim, ... (first minimum by a strict < scan), then a block-wide
// lexicographic (value, i) minimum - warp shuffles, one pair per warp
// through shared memory, the last warp's shuffles - picks the smallest
// i among the minimal values, which is the serial first minimum on
// inputs without NaN (energies >= 0, +inf padding). One thread walks the
// traces for the splits. Dynamic shared memory is (C + 2 + max(C-2, 0))
// (K+1) 4 bytes, sized by the wrapper (lut_pipeline/ops.py::
// combine_plan), opted in above 48 KB.
// Parity: fp32 add and compare only, no fast math; each candidate is one
// add of two loaded values, as in the plain version.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

// (v, i) <- the lexicographic minimum of (v, i) and (ov, oi)
__device__ __forceinline__ void lex_min(float& v, int& i, float ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_lex_min(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    lex_min(v, i, ov, oi);
  }
}

__global__ void __launch_bounds__(1024)
minplus_combine_kernel(const float* __restrict__ gathered,
                       float* __restrict__ min_e, int* __restrict__ splits,
                       int C, int R, int K) {
  extern __shared__ float smem[];
  __shared__ float warp_v[32];
  __shared__ int warp_i[32];
  const int row = blockIdx.x;             // v R + r
  const int v = row / R;
  const int r = row - v * R;
  const int K1 = K + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;              // a multiple of 32
  const size_t RK = (size_t)R * K1;
  const float* G = gathered + (size_t)v * C * RK + (size_t)r * K1;
  int* sp = splits + (size_t)row * C;

  if (C == 1) {
    if (tid == 0) {
      const float m = G[K];
      min_e[row] = m;
      sp[0] = isfinite(m) ? K : -1;
    }
    return;
  }

  float* Gs = smem;                       // (C, K+1) rows
  float* Fb = smem + C * K1;              // (2, K+1) fold accumulators
  int* As = (int*)(Fb + 2 * K1);          // (C-2, K+1) argmin traces
  for (int c = 0; c < C; ++c) {
    for (int k = tid; k < K1; k += nt) Gs[c * K1 + k] = G[c * RK + k];
  }
  __syncthreads();

  const float* F = Gs;
  for (int c = 1; c < C - 1; ++c) {
    float* Fn = Fb + ((c - 1) & 1) * K1;
    const float* Gc = Gs + c * K1;
    int* Ac = As + (c - 1) * K1;
    for (int k = tid; k < K1; k += nt) {
      float best = INFINITY;
      int arg = 0;
      for (int i = 0; i <= k; ++i) {
        const float cand = F[i] + Gc[k - i];
        if (cand < best) {
          best = cand;
          arg = i;
        }
      }
      Fn[k] = best;
      Ac[k] = arg;
    }
    __syncthreads();
    F = Fn;
  }

  // final combine at k = K: each thread's first minimum over its i ...
  const float* GL = Gs + (C - 1) * K1;
  float bv = INFINITY;
  int bi = INT_MAX;
  if (tid <= K) {
    bv = F[tid] + GL[K - tid];
    bi = tid;
    for (int i = tid + nt; i <= K; i += nt) {
      const float cand = F[i] + GL[K - i];
      if (cand < bv) {
        bv = cand;
        bi = i;
      }
    }
  }
  // ... then the block's lexicographic (value, i) minimum
  warp_lex_min(bv, bi);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    warp_v[warp] = bv;
    warp_i[warp] = bi;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool held = lane < (nt >> 5);
  bv = held ? warp_v[lane] : INFINITY;
  bi = held ? warp_i[lane] : INT_MAX;
  warp_lex_min(bv, bi);
  if (lane != 0) return;

  min_e[row] = bv;
  if (!isfinite(bv)) {
    for (int c = 0; c < C; ++c) sp[c] = -1;
    return;
  }
  sp[C - 1] = K - bi;
  int k = bi;
  for (int c = C - 2; c >= 1; --c) {
    const int ip = As[(c - 1) * K1 + k];
    sp[c] = k - ip;
    k = ip;
  }
  sp[0] = k;
}

// gathered: (V, C, R, K+1) fp32; min_e: (V, R) fp32; splits: (V, R, C)
// int32. One block of `threads` (a multiple of 32, at most 1024) per row
// (v, r), `shared_bytes` of dynamic shared memory. Returns the error of
// the shared-memory opt-in, else cudaGetLastError() after the launch on
// `stream`.
extern "C" int minplus_combine_launch(const void* gathered, void* min_e,
                                      void* splits, int V, int C, int R,
                                      int K, int threads, int shared_bytes,
                                      void* stream) {
  if (V == 0 || R == 0) return (int)cudaSuccess;
  if (shared_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        minplus_combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)V * (unsigned)R;
  minplus_combine_kernel<<<blocks, threads, shared_bytes,
                           (cudaStream_t)stream>>>(
      (const float*)gathered, (float*)min_e, (int*)splits, C, R, K);
  return (int)cudaGetLastError();
}
