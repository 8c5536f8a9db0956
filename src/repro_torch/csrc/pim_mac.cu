// pim_mac: W8A8 matmul with an exact int32 accumulator and the fused
// dequantizing epilogue, out[m, n] = (acc[m, n] * sx[m]) * sw[n].
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/pim_mac/kernel.py::_pim_mac_kernel (launched by
// pim_matmul_pallas). Plain version:
// repro_torch/kernels/pim_mac/ref.py::pim_matmul_ref.
//
// Inputs: x (M, K) int8 row-major, w (K, N) int8 row-major, sx (M,) and
// sw (N,) fp32; output (M, N) fp32 or bf16. Any M, K, N: the ragged edges
// are masked in the kernel (out-of-range loads read as 0, which adds
// nothing to an integer sum; out-of-range outputs are not stored).
//
// Bound on an H100 SXM: max(bytes / 3.35e12, 2 M K N / 1.979e15) seconds
// with bytes = M K + K N + 4 (M + N) + out_bytes M N. At decode (M <= 16,
// K = 2048) the weight bytes dominate: a whole 2048 x 8192 w_up at M = 16
// is ~16.8 MB, ~5 us, byte-bound by three orders of magnitude over the
// int8 tensor-core rate.
//
// Design: the TPU kernel ran K as a sequential grid axis with a VMEM int32
// accumulator. Here one block of four warps owns a 16 x 64 output tile,
// walks K itself in 64-deep steps, and keeps the int32 accumulators in
// registers; each warp issues mma.sync m16n8k32 (s8 x s8 -> s32) on two
// n8 tiles. w is (K, N) with n contiguous, while the .col B fragment wants
// four consecutive k of one column in a register, so each tile is
// transposed while it is staged: a thread gathers four k-rows of one
// column (byte loads, coalesced along n across the warp), packs them into
// one 32-bit word and stores it to shared memory as Bs[n][k / 4]. The
// x tile is staged the same way, k-contiguous already. Rows of both tiles
// are padded by four words so the fragment reads hit 32 distinct banks.
// A simple kernel that is right: no cp.async/TMA ring, no wgmma.
// Parity: the int32 sum is exact (|acc| <= 128^2 K < 2^31 for K < 131072);
// the epilogue is two separate round-to-nearest multiplies in the
// reference's order and a round-to-nearest-even bf16 cast. No fast math,
// so the output equals the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;                  // one m16 tile: decode's M
constexpr int BN = 64;                  // four warps x two n8 tiles
constexpr int BK = 64;                  // k bytes staged per step
constexpr int KW = BK / 4;              // 32-bit words per staged row
constexpr int LD = KW + 4;              // padded row stride in words
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four int8 at p[0], p[stride], p[2 stride], p[3 stride] packed low byte
// first; entries at or past `left` (k out of range) read as 0.
__device__ __forceinline__ uint32_t pack4(const int8_t* p, size_t stride,
                                          int left) {
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < left) word |= (uint32_t)(uint8_t)p[j * stride] << (8 * j);
  return word;
}

template <bool kBf16>
__global__ void __launch_bounds__(THREADS)
    pim_mac_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   void* __restrict__ out, int M, int K, int N) {
  __shared__ uint32_t As[BM][LD];       // As[m][k/4]
  __shared__ uint32_t Bs[BN][LD];       // Bs[n][k/4]: the transposed w tile
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int it = 0; it < BM * KW / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / KW, q = i % KW;
      const int m = m0 + r, k = k0 + 4 * q;
      As[r][q] = (m < M && k < K)
                     ? pack4(x + (size_t)m * K + k, 1, K - k) : 0u;
    }
#pragma unroll
    for (int it = 0; it < BN * KW / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int n = i % BN, q = i / BN;   // lanes walk n along one row
      const int col = n0 + n, k = k0 + 4 * q;
      Bs[n][q] = (col < N && k < K)
                     ? pack4(w + (size_t)k * N + col, (size_t)N, K - k) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KW; kk += 8) {  // one k32 step = eight words
      const uint32_t a[4] = {As[g][kk + t], As[g + 8][kk + t],
                             As[g][kk + 4 + t], As[g + 8][kk + 4 + t]};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nb = warp * 16 + j * 8 + g;
        const uint32_t b[2] = {Bs[nb][kk + t], Bs[nb][kk + 4 + t]};
        mma_s8(acc[j], a, b);
      }
    }
    __syncthreads();
  }

  // accumulator element i of n8 tile j sits at row g (+8 for i >= 2),
  // column 2 t + (i & 1) of the tile
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + warp * 16 + j * 8 + 2 * t + (i & 1);
      if (m >= M || n >= N) continue;
      const float v =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[j][i]), sx[m]), sw[n]);
      const size_t o = (size_t)m * N + n;
      if (kBf16)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
      else
        static_cast<float*>(out)[o] = v;
    }
  }
}

}  // namespace

extern "C" int pim_mac_launch(const void* x, const void* w, const void* sx,
                              const void* sw, void* out, int M, int K, int N,
                              int out_bf16, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_bf16)
    pim_mac_kernel<true><<<grid, THREADS, 0, s>>>(
        (const int8_t*)x, (const int8_t*)w, (const float*)sx,
        (const float*)sw, out, M, K, N);
  else
    pim_mac_kernel<false><<<grid, THREADS, 0, s>>>(
        (const int8_t*)x, (const int8_t*)w, (const float*)sx,
        (const float*)sw, out, M, K, N);
  return (int)cudaGetLastError();
}
