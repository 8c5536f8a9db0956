// mlstm_scan: xLSTM's stabilized matrix-memory recurrence over a whole
// sequence. Per (batch row b, head), from C = 0, n = 0, m = -inf:
//   m' = max(f_t + m, i_t);  fg = exp(f_t + m - m');  ig = exp(i_t - m')
//   C  = fg C + ig (k_t v_t^T)        (hd x hd)
//   n  = fg n + ig k_t                (hd)
//   h_t[j] = (sum_i C[i, j] q_t[i]) / max(|n . q_t|, 1)
//
// Stands in for the JAX package's lax.scan of
// src/repro/models/recurrent.py::_mlstm_step inside chunked_scan (no
// Pallas kernel: XLA runs the scan there). Plain version:
// repro_torch/kernels/mlstm_scan/ref.py::mlstm_scan_ref.
//
// Inputs: q, k, v (B, S, H, hd) fp32 (k already scaled by 1/sqrt(hd)),
// i, f (B, S, H) fp32 (f the log forget gate), all contiguous; output
// h (B, S, H, hd) fp32.
//
// Bound on an H100 SXM: operations. Each step updates and reads the whole
// hd x hd state, 5 B S H hd^2 fp32 operations (launch/roofline.py): at
// xlstm_1_3b's width (H = 4, hd = 512), B = 2, S = 4096, 4.3e10, 0.64 ms
// at 67 TFLOP/s, against 0.08 ms for its 268 MB of q, k, v and h.
//
// Design: the state never leaves the chip. One block per (column tile of
// 32 columns of C, head, batch row) holds its hd x 32 slice of C in
// registers across all S steps: warp w owns rows [w RPT, (w+1) RPT), lane
// j column j of the tile, RPT entries a thread. Every block recomputes
// the stabilizer m and the normalizer n (hd) itself, so blocks never
// synchronize with one another. A step stages q_t and k_t in shared
// memory (read as broadcasts: every lane of a warp reads the same row),
// updates the thread's entries of C, and sums C[i, j] q_t[i] over its
// rows; the warps' partial sums, and n . q_t, reduced across the block,
// give h_t. The next step's inputs are loaded into registers while this
// step runs. At hd = 512 that is 16 tiles x 4 heads x B blocks (128 at
// B = 2) of 8 warps, each thread keeping 64 entries of C.
// Parity: the updates of C and n round as the plain version's separate
// products and sums (__fmul_rn / __fadd_rn, no contraction); exp is
// expf, with no fast math, and max/clamp propagate NaN as torch's do.
// The sums over i are taken in another order than torch's einsum, so h
// agrees with the plain version to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;                 // columns of C per block

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <int RPT>
__global__ void __launch_bounds__(256)
mlstm_scan_fwd(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ ipre,
               const float* __restrict__ lf, float* __restrict__ h, int S,
               int H, int hd) {
  constexpr int LPT = (RPT + 31) / 32;   // q, k elements a thread stages
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5, nt = blockDim.x;
  const int j = blockIdx.x * TILE + lane;
  const bool jok = j < hd;
  const int hh = blockIdx.y, bb = blockIdx.z;

  extern __shared__ float sm[];
  float* q_s = sm;
  float* k_s = q_s + hd;
  float* part = k_s + hd;                // (W, 32) partial sums of C q
  float* nqp = part + W * TILE;          // (W) partial sums of n . q

  const long long tstride = (long long)H * hd;        // one time step
  const long long vbase = ((long long)bb * S * H + hh) * hd;
  const long long gbase = (long long)bb * S * H + hh;

  float C[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) C[r] = 0.0f;
  float n[LPT];
#pragma unroll
  for (int l = 0; l < LPT; ++l) n[l] = 0.0f;
  float m = -INFINITY;

  // step 0's inputs
  float qr[LPT], kr[LPT], vr = 0.0f, ir, fr;
#pragma unroll
  for (int l = 0; l < LPT; ++l) {
    const int e = threadIdx.x + l * nt;
    qr[l] = e < hd ? q[vbase + e] : 0.0f;
    kr[l] = e < hd ? k[vbase + e] : 0.0f;
  }
  if (jok) vr = v[vbase + j];
  ir = ipre[gbase];
  fr = lf[gbase];

  for (int t = 0; t < S; ++t) {
    __syncthreads();                     // last step's readers are done
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int e = threadIdx.x + l * nt;
      if (e < hd) {
        q_s[e] = qr[l];
        k_s[e] = kr[l];
      }
    }
    const float vj = vr, it = ir, ft = fr;
    if (t + 1 < S) {                     // prefetch step t + 1
      const long long o = vbase + (long long)(t + 1) * tstride;
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int e = threadIdx.x + l * nt;
        if (e < hd) {
          qr[l] = q[o + e];
          kr[l] = k[o + e];
        }
      }
      if (jok) vr = v[o + j];
      ir = ipre[gbase + (long long)(t + 1) * H];
      fr = lf[gbase + (long long)(t + 1) * H];
    }
    __syncthreads();

    const float fm = __fadd_rn(ft, m);
    const float m_new = tmax(fm, it);
    const float fg = expf(__fsub_rn(fm, m_new));
    const float ig = expf(__fsub_rn(it, m_new));
    m = m_new;

    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = w * RPT + r;
      if (row < hd) {
        const float kq = k_s[row];
        const float kv = __fmul_rn(kq, vj);
        C[r] = __fadd_rn(__fmul_rn(fg, C[r]), __fmul_rn(ig, kv));
        acc = fmaf(C[r], q_s[row], acc);
      }
    }
    float nq = 0.0f;
#pragma unroll
    for (int l = 0; l < LPT; ++l) {
      const int r = lane + 32 * l;
      const int row = w * RPT + r;
      if (r < RPT && row < hd) {
        n[l] = __fadd_rn(__fmul_rn(fg, n[l]), __fmul_rn(ig, k_s[row]));
        nq = fmaf(n[l], q_s[row], nq);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      nq += __shfl_xor_sync(0xffffffffu, nq, off);
    part[w * TILE + lane] = acc;
    if (lane == 0) nqp[w] = nq;
    __syncthreads();

    if (w == 0) {
      float num = 0.0f, den = 0.0f;
      for (int x = 0; x < W; ++x) {
        num += part[x * TILE + lane];
        den += nqp[x];
      }
      den = fabsf(den);
      den = den != den ? den : fmaxf(den, 1.0f);   // clamp_min(., 1)
      if (jok) h[vbase + (long long)t * tstride + j] = __fdiv_rn(num, den);
    }
  }
}

template <int RPT>
cudaError_t launch(dim3 grid, int warps, cudaStream_t s,
                   const void* const* in, void* h, int S, int H, int hd) {
  // at most 2 x 512 + 8 x 33 floats: below the 48 KB default
  const size_t smem = sizeof(float) * (2 * hd + warps * (TILE + 1));
  mlstm_scan_fwd<RPT><<<grid, warps * 32, smem, s>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2],
      (const float*)in[3], (const float*)in[4], (float*)h, S, H, hd);
  return cudaGetLastError();
}

}  // namespace

// rpt: rows of C per thread (1, 2, 4, ..., 64); warps: warps per block
// (at most 8), warps * rpt >= hd; tiles: ceil(hd / 32). Chosen by
// kernels/mlstm_scan/ops.py::mlstm_plan.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v,
                                 const void* i, const void* f, void* h,
                                 int B, int S, int H, int hd, int rpt,
                                 int warps, int tiles, void* stream) {
  if (B == 0 || S == 0 || H == 0 || hd == 0) return (int)cudaSuccess;
  const dim3 grid(tiles, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[5] = {q, k, v, i, f};
  cudaError_t err;
  switch (rpt) {
    case 1: err = launch<1>(grid, warps, s, in, h, S, H, hd); break;
    case 2: err = launch<2>(grid, warps, s, in, h, S, H, hd); break;
    case 4: err = launch<4>(grid, warps, s, in, h, S, H, hd); break;
    case 8: err = launch<8>(grid, warps, s, in, h, S, H, hd); break;
    case 16: err = launch<16>(grid, warps, s, in, h, S, H, hd); break;
    case 32: err = launch<32>(grid, warps, s, in, h, S, H, hd); break;
    case 64: err = launch<64>(grid, warps, s, in, h, S, H, hd); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
