// minplus_combine: the Algorithm-2 K-cluster combine of a LUT build - the
// min-plus fold with int32 argmin traces, the final k=K combine with its
// first-minimum argmin, and the split backtrace - for every variant.
//
// Replaces the fold/combine/backtrace part of the Pallas TPU kernel
// src/repro/kernels/lut_pipeline/kernel.py::_fused_kernel (its
// _fold_init/_fold_middle/_fold_final/_combine_single steps, which run
// repro/core/multipool.py's minplus_fold_jnp and backtrace_splits_jnp).
// Plain version: repro_torch/core/multipool.py::combine_rows_torch.
//
// Input: gathered (V, C, R, K+1) fp32, the consulted rows of each
// cluster's final stage table (written by dp_stages on the same stream).
//   F <- G[0]
//   for c = 1 .. C-2:  F'[r, k] = min_{i <= k} F[r, i] + G[c][r, k - i]
//                      (ascending i, strict <, argmin i kept in args)
//   cand[r, i] = F[r, i] + G[C-1][r, K - i];  i_opt = first argmin
//   min_e[r] = cand[r, i_opt]; splits backtraced through args.
//
// Bound: R (C-2) (K+1)(K+2)/2 adds and compares for the folds plus R (K+1)
// for the final combine; the bytes (read G once, write min_e and splits)
// are small. At the main-path shapes (R=33, K=256, C<=3) the work is ~1e6
// operations, microseconds at the fp32 rate.
// Design: one block per variant. In a fold each thread owns output
// elements (r, k) and scans i = 0..k in order with a strict <, the numpy
// fold's own order, so values and argmin traces match it exactly; warps
// read F[r, i] as a broadcast and G[c][r, k - i] coalesced. F is double
// buffered in wrapper-allocated scratch, a barrier between folds. The
// final combine and backtrace take one thread per row, scanning i in
// order with a strict < from i = 0: the first minimum, as np.argmin.
// Parity: fp32 add and compare only, no fast math.

#include <cuda_runtime.h>
#include <math.h>

__global__ void minplus_combine_kernel(const float* __restrict__ gathered,
                                       float* fbuf, int* args, float* min_e,
                                       int* splits, int C, int R, int K) {
  const int v = blockIdx.x;
  const int K1 = K + 1;
  const size_t RK = (size_t)R * K1;
  const float* G = gathered + (size_t)v * C * RK;
  int* A = args + (size_t)v * (C > 2 ? C - 2 : 1) * RK;
  float* bufs[2] = {fbuf + (size_t)v * 2 * RK, fbuf + (size_t)v * 2 * RK + RK};
  float* me = min_e + (size_t)v * R;
  int* sp = splits + (size_t)v * R * C;

  if (C == 1) {
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      const float m = G[(size_t)r * K1 + K];
      me[r] = m;
      sp[r] = isfinite(m) ? K : -1;
    }
    return;
  }

  const float* F = G;
  for (int c = 1; c < C - 1; ++c) {
    float* Fn = bufs[(c - 1) & 1];
    const float* Gc = G + (size_t)c * RK;
    int* Ac = A + (size_t)(c - 1) * RK;
    for (size_t idx = threadIdx.x; idx < RK; idx += blockDim.x) {
      const int r = (int)(idx / K1);
      const int k = (int)(idx - (size_t)r * K1);
      const float* Fr = F + (size_t)r * K1;
      const float* Gr = Gc + (size_t)r * K1;
      float best = INFINITY;
      int arg = 0;
      for (int i = 0; i <= k; ++i) {
        const float cand = Fr[i] + Gr[k - i];
        if (cand < best) {
          best = cand;
          arg = i;
        }
      }
      Fn[idx] = best;
      Ac[idx] = arg;
    }
    __syncthreads();
    F = Fn;
  }

  const float* GL = G + (size_t)(C - 1) * RK;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const float* Fr = F + (size_t)r * K1;
    const float* Gr = GL + (size_t)r * K1;
    float best = Fr[0] + Gr[K];
    int iopt = 0;
    for (int i = 1; i <= K; ++i) {
      const float cand = Fr[i] + Gr[K - i];
      if (cand < best) {
        best = cand;
        iopt = i;
      }
    }
    me[r] = best;
    int* s = sp + (size_t)r * C;
    if (!isfinite(best)) {
      for (int c = 0; c < C; ++c) s[c] = -1;
      continue;
    }
    s[C - 1] = K - iopt;
    int k = iopt;
    for (int c = C - 2; c >= 1; --c) {
      const int ip = A[(size_t)(c - 1) * RK + (size_t)r * K1 + k];
      s[c] = k - ip;
      k = ip;
    }
    s[0] = k;
  }
}

// gathered: (V, C, R, K+1) fp32; fbuf: (V, 2, R, K+1) fp32 scratch; args:
// (V, max(C-2, 1), R, K+1) int32 scratch; min_e: (V, R) fp32; splits:
// (V, R, C) int32. Returns cudaGetLastError() after the launch on
// `stream`.
extern "C" int minplus_combine_launch(const void* gathered, void* fbuf,
                                      void* args, void* min_e, void* splits,
                                      int V, int C, int R, int K,
                                      void* stream) {
  if (V == 0 || R == 0) return (int)cudaSuccess;
  minplus_combine_kernel<<<V, 256, 0, (cudaStream_t)stream>>>(
      (const float*)gathered, (float*)fbuf, (int*)args, (float*)min_e,
      (int*)splits, C, R, K);
  return (int)cudaGetLastError();
}
