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
// with bytes = M K + K N + 4 (M + N) + out_bytes M N. At decode (M <= 32,
// K = 2048) the weight bytes dominate: a whole 2048 x 8192 w_up is
// ~16.8 MB, ~5 us, byte-bound by three orders of magnitude over the int8
// tensor-core rate. So the design keeps enough weight bytes in flight to
// fill the card; mma.sync m16n8k32 (s8 x s8 -> s32) is rate enough.
//
// Design:
//  * Split K. A block of four warps owns a (16 MT) x 128 output tile and
//    one chunk of K; grid = (N tiles, M tiles, splits). The wrapper
//    (kernels/pim_mac/ops.py::split_plan) picks the split count so every
//    shape gives about two blocks per SM, at most 8 splits (N = 8192 at
//    decode: 64 tiles x 5 splits; N = 128: 8 splits where one block ran
//    before). Each block stores its int32 partial tile to a workspace;
//    the last block of a tile to arrive (a per-tile counter, reset by
//    that block, so no memset per call) adds the others' partials to its
//    own, four splits' loads in flight at a time, and runs the epilogue.
//    Integer sums are exact in any order.
//  * 16-byte cp.async loads of w rows and x rows into a 4-stage
//    shared-memory ring: the next chunks' loads are in flight while this
//    chunk's mma run, with one barrier per 64-deep step. At an unaligned
//    N or K (rows not 16-byte aligned) the same chunks are staged with
//    byte loads instead; rows past K and M are zero-filled.
//  * w stays (K, N) with n contiguous, while the .col B fragment needs
//    four consecutive k of one column in a register. A thread reads a
//    4 x 4 byte block (four k-rows, four columns) as four words and
//    transposes it with eight __byte_perm; the four words feed four n8
//    mma whose fragment column g stands for global column 4 g + j. The
//    w tile's 16-byte chunks are XOR-swizzled by row so those reads hit
//    32 distinct banks; x rows are padded by 16 bytes for the same.
// Parity: the int32 sum is exact (|acc| <= 128^2 K < 2^31 for K < 131072);
// the epilogue is two separate round-to-nearest multiplies in the
// reference's order and a round-to-nearest-even bf16 cast. No fast math,
// so the output equals the plain version bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                 // four warps x 32 columns
constexpr int BK = 64;                  // k rows staged per step
constexpr int NST = 4;                  // ring stages
constexpr int XLD = BK + 16;            // padded x row stride in bytes
constexpr int THREADS = 128;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; bytes past `valid` (0 or 16) are zero-filled
__device__ __forceinline__ void cp16(void* dst, const void* src, int valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of row `p` starting at column `c` of a row of `len` bytes,
// byte by byte (unaligned rows): columns at or past `len` read as 0
__device__ __forceinline__ void ld16_bytes(void* dst, const int8_t* p, int c,
                                           int len) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (c + b < len) w[b >> 2] |= (uint32_t)(uint8_t)p[c + b] << (8 * (b & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// byte offset of the 16-byte chunk `c` (0..7) of w-tile row `r`: chunks
// are XOR-swizzled by bits 2-3 of the row, so the B-fragment reads of a
// warp (rows 4t + i, columns 4g..4g+3) fall on 32 distinct banks
__device__ __forceinline__ int w_off(int r, int c) {
  return r * BN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

template <int MT>
struct Stage {
  int8_t w[BK * BN];                    // w rows k0..k0+63, swizzled
  int8_t x[16 * MT * XLD];              // x rows m0.., columns k0..k0+63
};

template <int MT>
__device__ __forceinline__ void load_stage(Stage<MT>& st,
                                           const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int M, int K, int N, int m0,
                                           int n0, int k0, bool x_vec,
                                           bool w_vec, int tid) {
#pragma unroll
  for (int it = 0; it < BK * BN / 16 / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i >> 3, c = i & 7;      // row of the tile, 16-byte chunk
    const int k = k0 + r, col = n0 + 16 * c;
    int8_t* dst = st.w + w_off(r, c);
    if (w_vec) {
      const bool in = k < K && col < N;   // N % 16 == 0: whole chunks
      cp16(dst, in ? w + (size_t)k * N + col : w, in ? 16 : 0);
    } else if (k < K) {
      ld16_bytes(dst, w + (size_t)k * N, col, N);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (tid < 16 * MT * BK / 16) {
    const int r = tid >> 2, c = tid & 3;  // row, 16-byte chunk of the row
    const int m = m0 + r, k = k0 + 16 * c;
    int8_t* dst = st.x + r * XLD + 16 * c;
    if (x_vec) {
      const bool in = m < M && k < K;     // K % 16 == 0: whole chunks
      cp16(dst, in ? x + (size_t)m * K + k : x, in ? 16 : 0);
    } else if (m < M) {
      ld16_bytes(dst, x + (size_t)m * K, k, K);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// four words r[i] = bytes (c0, c1, c2, c3) of k-row i -> four words, one
// per column j, holding that column's four k (low byte = row 0)
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // a0 b0 a1 b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // a2 b2 a3 b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);  // c0 d0 c1 d1
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);  // c2 d2 c3 d3
  o[0] = __byte_perm(t0, t2, 0x5410);                   // a0 b0 c0 d0
  o[1] = __byte_perm(t0, t2, 0x7632);
  o[2] = __byte_perm(t1, t3, 0x5410);
  o[3] = __byte_perm(t1, t3, 0x7632);
}

template <int MT, bool kBf16>
__global__ void __launch_bounds__(THREADS)
    pim_mac_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   void* __restrict__ out, int* __restrict__ partial,
                   int* __restrict__ arrivals, int M, int K, int N,
                   int k_chunk, int x_vec, int w_vec) {
  __shared__ __align__(16) Stage<MT> ring[NST];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma group / thread in group
  const int m0 = blockIdx.y * 16 * MT, n0 = blockIdx.x * BN;
  const int kb = blockIdx.z * k_chunk;
  const int ke = min(K, kb + k_chunk);
  const int steps = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  int acc[MT][4][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][j][i] = 0;

  // k_chunk is a multiple of BK, so only the last split has k rows past
  // its end in a step, and those are past K (zero-filled)
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps)
      load_stage<MT>(ring[s], x, w, M, K, N, m0, n0, kb + s * BK,
                     x_vec, w_vec, tid);
    cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_wait<NST - 2>();
    __syncthreads();                      // stage `step` landed everywhere;
    const int nxt = step + NST - 1;       // slot of step - 1 is free
    if (nxt < steps)
      load_stage<MT>(ring[nxt % NST], x, w, M, K, N, m0, n0,
                     kb + nxt * BK, x_vec, w_vec, tid);
    cp_commit();
    const Stage<MT>& st = ring[step % NST];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int8_t* xr = st.x + (mi * 16 + g) * XLD + kk + 4 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(xr);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * XLD);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(xr + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * XLD + 16);
      }
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // k rows kk + 16 h + 4 t + i
        uint32_t r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = kk + 16 * h + 4 * t + i;
          const int q = warp * 8 + g;       // word of the 128-byte row
          r[i] = *reinterpret_cast<const uint32_t*>(
              st.w + w_off(row, q >> 2) + 4 * (q & 3));
        }
        transpose4x4(r, b[h]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[mi][j], a[mi], b[0][j], b[1][j]);
    }
  }
  cp_wait<0>();

  if (gridDim.z > 1) {
    // this block's partial, in register order so every store and load of
    // a warp is 32 consecutive ints
    const size_t tile = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t per = (size_t)MT * 16 * THREADS;
    const size_t tiles = (size_t)gridDim.x * gridDim.y;
    int* mine = partial + ((size_t)blockIdx.z * tiles + tile) * per;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          mine[((mi * 4 + j) * 4 + i) * THREADS + tid] = acc[mi][j][i];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(arrivals + tile, 1) == (int)gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the other splits' partials, ZU splits' loads in flight at a time
    constexpr int ZU = 4 / MT;
    for (int z0 = 0; z0 < (int)gridDim.z; z0 += ZU) {
      int part[ZU][MT * 16];
#pragma unroll
      for (int u = 0; u < ZU; ++u) {
        const int z = z0 + u;
        const bool use = z < (int)gridDim.z && z != (int)blockIdx.z;
        const int* other = partial + ((size_t)z * tiles + tile) * per;
#pragma unroll
        for (int r = 0; r < MT * 16; ++r)
          part[u][r] = use ? __ldcg(other + r * THREADS + tid) : 0;
      }
#pragma unroll
      for (int u = 0; u < ZU; ++u)
#pragma unroll
        for (int r = 0; r < MT * 16; ++r)
          acc[r / 16][(r / 4) % 4][r % 4] += part[u][r];
    }
    if (tid == 0) arrivals[tile] = 0;     // ready for the next call
  }

  // accumulator element i of n8 tile j sits at row g (+8 for i >= 2) and
  // fragment column 2 t + (i & 1), i.e. global column
  // n0 + 32 warp + 4 (2 t + (i & 1)) + j: tiles j = 0..3 are four
  // consecutive columns, stored together where they are all in range
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + mi * 16 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + warp * 32 + 4 * (2 * t + (i & 1));
      if (m >= M || n >= N) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][j][i]), sx[m]),
                         sw[min(n + j, N - 1)]);
      const size_t o = (size_t)m * N + n;
      if (kBf16) {
        __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
        if ((N & 3) == 0) {               // n + 3 < N and 8-byte aligned
          __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          uint2 pk;
          pk.x = *reinterpret_cast<uint32_t*>(&lo);
          pk.y = *reinterpret_cast<uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(p) = pk;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) p[j] = __float2bfloat16_rn(v[j]);
        }
      } else {
        float* p = static_cast<float*>(out) + o;
        if ((N & 3) == 0) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) p[j] = v[j];
        }
      }
    }
  }
}

template <int MT, bool kBf16>
cudaError_t launch(dim3 grid, cudaStream_t s, const void* x, const void* w,
                   const void* sx, const void* sw, void* out, void* partial,
                   void* arrivals, int M, int K, int N, int k_chunk,
                   int x_vec, int w_vec) {
  pim_mac_kernel<MT, kBf16><<<grid, THREADS, 0, s>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)sx, (const float*)sw,
      out, (int*)partial, (int*)arrivals, M, K, N, k_chunk, x_vec, w_vec);
  return cudaGetLastError();
}

}  // namespace

// The launch geometry comes from kernels/pim_mac/ops.py::split_plan:
// `mt` m16 tiles per block (1 or 2), grid (n_tiles, m_tiles, splits),
// `k_chunk` (a multiple of 64) k rows per split. With splits > 1,
// `partial` holds splits x m_tiles x n_tiles x 16 mt x 128 int32 and
// `arrivals` m_tiles x n_tiles int32 that are 0 on entry (and on exit).
// x_vec / w_vec: the rows of x / w are 16-byte aligned (K % 16 == 0 /
// N % 16 == 0 and aligned base pointers), so they load by cp.async.
// Returns cudaGetLastError() after the launch on `stream`.
extern "C" int pim_mac_launch(const void* x, const void* w, const void* sx,
                              const void* sw, void* out, void* partial,
                              void* arrivals, int M, int K, int N,
                              int out_bf16, int mt, int m_tiles, int n_tiles,
                              int splits, int k_chunk, int x_vec, int w_vec,
                              void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const dim3 grid(n_tiles, m_tiles, splits);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (mt == 1)
    err = out_bf16 ? launch<1, true>(grid, s, x, w, sx, sw, out, partial,
                                     arrivals, M, K, N, k_chunk, x_vec, w_vec)
                   : launch<1, false>(grid, s, x, w, sx, sw, out, partial,
                                      arrivals, M, K, N, k_chunk, x_vec,
                                      w_vec);
  else if (mt == 2)
    err = out_bf16 ? launch<2, true>(grid, s, x, w, sx, sw, out, partial,
                                     arrivals, M, K, N, k_chunk, x_vec, w_vec)
                   : launch<2, false>(grid, s, x, w, sx, sw, out, partial,
                                      arrivals, M, K, N, k_chunk, x_vec,
                                      w_vec);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
