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
// repro_torch/kernels/mlstm_scan/ref.py::mlstm_scan_ref; the chunkwise
// algorithm below is modelled step for step, for the CPU tests, by
// tests/torch_mlstm_chunked.py.
//
// Inputs: q, k, v (B, S, H, hd) fp32 (k already scaled by 1/sqrt(hd)),
// i, f (B, S, H) fp32 (f the log forget gate), all contiguous; output
// h (B, S, H, hd) fp32; scratch from the wrapper.
//
// Bound on an H100 SXM: operations. The model's count is 5 B S H hd^2
// fp32 operations (launch/roofline.py): at xlstm_1_3b's width (H = 4,
// hd = 512), B = 2, S = 4096, 4.3e10, 0.64 ms at 67 TFLOP/s, against
// 0.08 ms for its 268 MB of q, k, v and h.
//
// Design: chunkwise. The sequence is cut into chunks of L = 32 steps;
// a chunk's contribution is a few small matrix products instead of L
// rank-1 updates, and the barriers fall from three a step to four a
// chunk. Three kernels:
//  1. mlstm_scan_fwd_gates, one warp per (row, head): the stabilizer m
//     by the loop's own recurrence, serially, in fp32 and the loop's
//     order (the clamp makes h depend on m itself, so it must be the
//     loop's m); b_t, the sum of f from the chunk's start to t (never a
//     sum over the whole sequence: over 4,096 steps its fp32 difference
//     would lose the exponent's low digits); s_t = exp(b_t + (m_prev -
//     m_t)), the decay of the chunk's incoming state to step t; w_s =
//     exp((i_s - m_e) + (b_e - b_s)), input s's weight at the chunk's
//     end e. Both are formed and exponentiated in double and rounded
//     once to fp32: the chunk's last s decays the whole state, once a
//     chunk, so its error compounds over every chunk a term stays live,
//     and expf (within 2 ulp, not correctly rounded) is not enough
//     where the forget gate is near 1. Off the serial chain.
//  2. mlstm_scan_fwd_intra, one block per (chunk, head, row), all in
//     parallel: P[t, s] = (q_t . k_s) exp((i_s - m_t) + (b_t - b_s)) for
//     s <= t, 0 above the diagonal (L x L).
//  3. mlstm_scan_fwd_inter, one block per (32 columns of C, head, row),
//     its hd x 32 slice of C (kept as C^T) and n in shared memory, walks
//     the chunks: num = s_t (Q C) + P V, den = s_t (Q n) + rowsum(P),
//     h = num / max(|den|, 1); then C <- s_e C + K^T diag(w) V and
//     n <- s_e n + K^T w. Warp w owns rows [w XW, (w + 1) XW) of C
//     and n (XW = 16, 32 or 64; hd padded with zeros to 8 XW) and the
//     same columns of the chunk's q and k, so those are private to it:
//     it sums Q C over its rows (a split of the reduction across the 8
//     warps, summed in fp32 through shared memory once a chunk) and
//     updates its own rows with no block barrier. The next chunk's q
//     (after Q C), k (after the sums are read) and P, s, w
//     (double-buffered) load by cp.async while this chunk computes; V
//     goes through registers into V^T and (diag(w) V)^T. The last
//     chunk's state is never used, so it is not updated.
// The products Q C, K^T diag(w) V and Q K^T run on the tensor cores,
// mma.sync m16n8k8 in 3xTF32: each fp32 operand is split into a TF32
// value and a TF32 remainder, and big x big + big x small + small x big
// (the small terms first) keep fp32's accuracy, where plain TF32 keeps
// about three digits. The tensor core's own fp32 accumulation rounds
// toward zero, a bias of up to an ulp of the running sum per product, so
// no accumulator outlives one 8-deep step: each step's three products go
// into a fresh one, which is added to the sum (of Q C, Q K^T, or C
// itself) in fp32 with round-to-nearest. Each truncation is then of one
// step's size, and a sum's relative bias stays that of one step, however
// many steps or chunks it spans. Likewise n's update sums the chunk's
// K^T w apart (on the FMA units) and adds it to s_e n once, as C's adds
// whole 8-deep steps: the state rounds a few times a chunk, not once a
// term. Strides make every fragment read and every C^T access free of
// bank conflicts (C^T and q rows: 4 mod 32 floats; k rows: 8 mod 32).
// P V (32 terms a row) stays on the FMA units, so that it can skip
// s > t.
// Shared memory at hd = 512: 228,864 of the 232,448 bytes a block can
// have, so one block (8 warps) a SM: 16 tiles x 4 heads x B blocks,
// 128 at B = 2.
// Parity: sums and the other products are fp32 fmaf/__fmul_rn/
// __fadd_rn, exp is expf, with no fast math; max/clamp propagate NaN as
// torch's do; a chunk's P V sums only s <= t, so a non-finite v_s
// reaches no earlier h_t. The sums run in another order than torch's,
// so h agrees with the plain version to a tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int L = 32;                    // steps per chunk (one warp)
constexpr int T = 32;                    // columns of C per inter block
constexpr int W = 8;                     // warps per inter block
constexpr int NT = W * 32;               // inter threads
constexpr int PS = L + 4;                // row stride of P and V^T
constexpr int RS = T + 8;                // row stride of the partial sums
constexpr int SMALLS = L * PS + 2 * T * PS + 2 * L;      // one buffer
constexpr int XS = 64;                   // hd columns a slice (intra)
static_assert(XS == 4 << 4, "the intra loads take 16 vectors a row");
static_assert(L * T / 4 == NT, "one output vector per thread");
static_assert(L * L / 4 == NT, "one P vector per thread");

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src,
                                    int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 3xTF32: x = big + small, each a TF32 value; a product of two such
// sums without the small x small term keeps fp32's accuracy
__device__ __forceinline__ void split(float x, unsigned& big,
                                      unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;"
      : "=r"(small) : "f"(__fsub_rn(x, __uint_as_float(big))));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment (16 x 8, element (row, col) at p[row * ldr + col * ldc]) of
// m16n8k8, split
__device__ __forceinline__ void frag_a(const float* p, int ldr, int ldc,
                                       int g, int q, unsigned (&ab)[4],
                                       unsigned (&as)[4]) {
  split(p[g * ldr + q * ldc], ab[0], as[0]);
  split(p[(g + 8) * ldr + q * ldc], ab[1], as[1]);
  split(p[g * ldr + (q + 4) * ldc], ab[2], as[2]);
  split(p[(g + 8) * ldr + (q + 4) * ldc], ab[3], as[3]);
}

// B fragment (8 x 8, element (k, n) at p[n * ldn + k * ldk]), split
__device__ __forceinline__ void frag_b(const float* p, int ldn, int ldk,
                                       int g, int q, unsigned (&bb)[2],
                                       unsigned (&bs)[2]) {
  split(p[g * ldn + q * ldk], bb[0], bs[0]);
  split(p[g * ldn + (q + 4) * ldk], bb[1], bs[1]);
}

// ---- 1. gates: m (serial), b, s, w ----------------------------------------
// Every lane runs the same serial recurrence over the chunk's gates,
// read as broadcasts from shared memory, and keeps step (chunk start +
// lane)'s values. The gates arrive by cp.async GD chunks ahead. m is
// fmaxf, one instruction on the serial chain; torch.maximum's NaN (once m
// is NaN it stays NaN) is tracked off the chain. Steps past the sequence
// read f = 0 and i = -inf: they leave m and b as they are.
constexpr int GD = 8;                    // chunks of gates in flight
__device__ __forceinline__ void gates_pass(const float* __restrict__ ipre,
                                           const float* __restrict__ lf,
                                           float* __restrict__ mo,
                                           float* __restrict__ bo,
                                           float* __restrict__ so,
                                           float* __restrict__ wo, int S,
                                           int H, int NC) {
  __shared__ float is[GD][L], fs[GD][L];
  const int bh = blockIdx.x, bb = bh / H, hh = bh % H;
  const int lane = threadIdx.x;
  const long long g0 = (long long)bb * S * H + hh;
  const long long o0 = (long long)bh * NC * L;
  auto fetch = [&](int c) {              // chunk c's gates into slot c % GD
    const int t = c * L + lane;
    const bool ok = c < NC && t < S;
    const long long o = g0 + (long long)(ok ? t : 0) * H;
    cp4(&is[c % GD][lane], ipre + o, ok ? 4 : 0);
    cp4(&fs[c % GD][lane], lf + o, ok ? 4 : 0);
    cp_commit();
  };
  for (int c = 0; c < GD; ++c) fetch(c);
  float m = -INFINITY;
  bool nan = false;
  for (int c = 0; c < NC; ++c) {
    const int c0 = c * L, t = c0 + lane, Lc = min(L, S - c0);
    cp_wait<GD - 1>();
    __syncwarp();
    const float* ic = is[c % GD];
    const float* fc = fs[c % GD];
    const float it = ic[lane];
    const float m_prev = nan ? NAN : m;
    float b = 0.0f, my_m = 0.0f, my_b = 0.0f;
#pragma unroll
    for (int u = 0; u < L; ++u) {
      const float fu = fc[u], iu = u < Lc ? ic[u] : -INFINITY;
      const float a = __fadd_rn(fu, m);
      m = fmaxf(a, iu);
      nan = nan || a != a || iu != iu;
      b = u == 0 ? fu : __fadd_rn(b, fu);
      const bool mine = lane == u;
      my_m = mine ? (nan ? NAN : m) : my_m;
      my_b = mine ? b : my_b;
    }
    __syncwarp();                        // before the slot is refilled
    fetch(c + GD);
    const float me = nan ? NAN : m;      // the chunk's last step e
    float s = 0.0f, w = 0.0f;
    if (t < S) {
      s = (float)exp((double)my_b + ((double)m_prev - (double)my_m));
      w = (float)exp(((double)it - (double)me) +
                     ((double)b - (double)my_b));
    }
    const long long o = o0 + c0 + lane;
    mo[o] = my_m;
    bo[o] = my_b;
    so[o] = s;
    wo[o] = w;
  }
  cp_wait<0>();
}

__global__ void __launch_bounds__(32)
mlstm_scan_fwd_gates(const float* __restrict__ ipre,
                     const float* __restrict__ lf, float* __restrict__ mo,
                     float* __restrict__ bo, float* __restrict__ so,
                     float* __restrict__ wo, int S, int H, int NC) {
  gates_pass(ipre, lf, mo, bo, so, wo, S, H, NC);
}

// rows [0, L) x columns [x0, x1) of a chunk of q or k into dst (row
// stride st, column x at x - dx), by threads [0, nthr) of which this is
// thread id: thread id takes the 4 columns (id % cols) * 4 of every
// (nthr / cols)-th row, cols = 1 << lcols vectors a row, a power of two
// that divides nthr; zeros past the sequence and past hd
template <bool VEC>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long row0, int H, int hd,
                                          int st, int Lc, int x0, int x1,
                                          int dx, int id, int nthr,
                                          int lcols) {
  const int x = x0 + ((id & ((1 << lcols) - 1)) << 2);
  if (x >= x1) return;
  const int rstep = nthr >> lcols;
  int row = id >> lcols;
  const float* g = src + (row0 + (long long)row * H) * hd + x;
  const long long gstep = (long long)rstep * H * hd;
  float* d = dst + row * st + x - dx;
  for (; row < L; row += rstep, g += gstep, d += rstep * st) {
    if (VEC) {
      const bool ok = row < Lc && x < hd;
      cp16(d, ok ? g : src, ok ? 16 : 0);
    } else {
      for (int u = 0; u < 4; ++u) {
        const bool ok = row < Lc && x + u < hd;
        cp4(d + u, ok ? g + u : src, ok ? 4 : 0);
      }
    }
  }
}

// ---- 2. intra: P of every chunk --------------------------------------------
// Four warps; warp w computes the 16 x 16 quarter (rows 16 (w / 2),
// columns 16 (w % 2)) of Q K^T in 3xTF32, from hd-slices of the
// chunk's q and k staged in shared memory, the next slice loading by
// cp.async while this one is summed; then gates it.
constexpr int IT = 128;                  // intra threads
template <bool VEC>
__global__ void __launch_bounds__(IT)
mlstm_scan_fwd_intra(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ ipre,
                     const float* __restrict__ mo,
                     const float* __restrict__ bo, float* __restrict__ P,
                     int S, int H, int hd, int NC) {
  __shared__ __align__(16) float qs[2][L][XS + 4];
  __shared__ __align__(16) float ks[2][L][XS + 4];
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int bh = bb * H + hh, c0 = c * L, Lc = min(L, S - c0);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int t0 = 16 * (wid >> 1), s0 = 16 * (wid & 1);
  const int hd8 = (hd + 7) & ~7;
  const long long row0 = (long long)(bb * S + c0) * H + hh;
  auto load = [&](int x0, int u) {
    const int x1 = min(x0 + XS, hd8);
    load_rows<VEC>(&qs[u][0][0], q, row0, H, hd, XS + 4, Lc, x0, x1, x0,
                   tid, IT, 4);
    load_rows<VEC>(&ks[u][0][0], k, row0, H, hd, XS + 4, Lc, x0, x1, x0,
                   tid, IT, 4);
    cp_commit();
  };
  float acc[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0.0f;
  load(0, 0);
  for (int x0 = 0, u = 0; x0 < hd8; x0 += XS, u ^= 1) {
    if (x0 + XS < hd8) {
      load(x0 + XS, u ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int xn = min(XS, hd8 - x0);
    for (int x = 0; x < xn; x += 8) {
      unsigned ab[4], as[4], bb2[2][2], bs2[2][2];
      frag_a(&qs[u][t0][x], XS + 4, 1, g, tq, ab, as);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        frag_b(&ks[u][s0 + 8 * ni][x], XS + 4, 1, g, tq, bb2[ni], bs2[ni]);
      // each step's three products in a fresh accumulator, added in
      // fp32: the tensor core's own fp32 accumulation rounds toward
      // zero, a bias that over hd / 8 steps would exceed the tolerance
      float d[2][4] = {};
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma(d[ni], as, bb2[ni]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma(d[ni], ab, bs2[ni]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma(d[ni], ab, bb2[ni]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[ni][r] = __fadd_rn(acc[ni][r], d[ni][r]);
    }
    __syncthreads();                     // before the buffer is refilled
  }
  const long long o = (long long)bh * NC * L + c0;
  float* out = P + ((long long)bh * NC + c) * L * L;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + g + 8 * hf;
    const float mt = mo[o + t], bt = bo[o + t];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
      for (int cj = 0; cj < 2; ++cj) {
        const int s = s0 + 8 * ni + 2 * tq + cj;
        float p = 0.0f;
        if (s <= t && t < Lc) {
          const float is = ipre[(long long)(bb * S + c0 + s) * H + hh];
          const float gt = expf(__fadd_rn(__fsub_rn(is, mt),
                                          __fsub_rn(bt, bo[o + s])));
          p = __fmul_rn(acc[ni][2 * hf + cj], gt);
        }
        out[t * L + s] = p;
      }
    }
  }
}

// ---- 3. inter: the state, chunk after chunk --------------------------------
struct Smem {
  float *ct, *qb, *kb, *nv, *sb;         // C^T (T x st), q, k, n, smalls
};

// one buffer of a chunk's smalls: P (L x PS), V^T and (diag(w) V)^T
// (T x PS), s and w (L each)
struct Smalls {
  float *pb, *vt, *vwt, *sv, *wv;
};

__device__ __forceinline__ Smem carve(float* sm, int st, int kbn, int hp) {
  Smem s;
  s.ct = sm;
  s.qb = s.ct + T * st;
  s.kb = s.qb + L * st;
  s.nv = s.kb + kbn;
  s.sb = s.nv + hp;
  return s;
}

__device__ __forceinline__ Smalls smalls(const Smem& sh, int u) {
  Smalls b;
  b.pb = sh.sb + u * SMALLS;
  b.vt = b.pb + L * PS;
  b.vwt = b.vt + T * PS;
  b.sv = b.vwt + T * PS;
  b.wv = b.sv + L;
  return b;
}

template <bool VEC, int XW>
__global__ void __launch_bounds__(NT, 1)
mlstm_scan_fwd_inter(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ P,
                     const float* __restrict__ so,
                     const float* __restrict__ wo, float* __restrict__ h,
                     int S, int H, int hd, int NC, int st, int sk, int kbn) {
  constexpr int HP = W * XW;             // hd padded to the warps' rows
  constexpr int LXW = XW == 16 ? 2 : XW == 32 ? 3 : 4;
  constexpr int MT = XW / 16;            // m16 tiles of this warp's rows
  static_assert(XW == 4 << LXW, "XW is 16, 32 or 64");
  extern __shared__ __align__(16) float sm[];
  const Smem sh = carve(sm, st, kbn, HP);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int j0 = blockIdx.x * T, hh = blockIdx.y, bb = blockIdx.z;
  const int bh = bb * H + hh;
  const int xbase = wid * XW, xend = xbase + XW;
  const long long brow = (long long)bb * S * H + hh;  // (b, t=0, h) row
  const long long g0 = (long long)bh * NC * L;         // gates, P

  for (int e = tid; e < T * st; e += NT) sh.ct[e] = 0.0f;
  for (int e = tid; e < HP; e += NT) sh.nv[e] = 0.0f;

  // the smalls of chunk c into buffer u: P, s, w by cp.async; V into
  // registers (stored by store_v once the loads have landed)
  const int vs = tid >> 3, vj = (tid & 7) * 4;         // V element (s, j)
  float vr[4], wr = 0.0f;
  auto load_smalls = [&](int c, int u) {
    const Smalls b = smalls(sh, u);
    const float* pg = P + ((long long)bh * NC + c) * L * L;
    cp16(b.pb + (tid >> 3) * PS + (tid & 7) * 4,
         pg + (tid >> 3) * L + (tid & 7) * 4, 16);
    if (tid < L / 4) cp16(b.sv + tid * 4, so + g0 + c * L + tid * 4, 16);
    else if (tid < L / 2)
      cp16(b.wv + (tid - L / 4) * 4, wo + g0 + c * L + (tid - L / 4) * 4,
           16);
    const int s = c * L + vs;
    wr = wo[g0 + c * L + vs];
#pragma unroll
    for (int u2 = 0; u2 < 4; ++u2) {
      const int j = j0 + vj + u2;
      vr[u2] = (s < S && j < hd) ? v[(brow + (long long)s * H) * hd + j]
                                 : 0.0f;
    }
  };
  auto store_v = [&](int u) {
    const Smalls b = smalls(sh, u);
#pragma unroll
    for (int u2 = 0; u2 < 4; ++u2) {
      b.vt[(vj + u2) * PS + vs] = vr[u2];
      b.vwt[(vj + u2) * PS + vs] = __fmul_rn(wr, vr[u2]);
    }
  };
  auto load_q = [&](int c) {
    load_rows<VEC>(sh.qb, q, brow + (long long)c * L * H, H, hd, st,
                   min(L, S - c * L), xbase, xend, 0, lane, 32, LXW);
  };
  auto load_k = [&](int c) {
    load_rows<VEC>(sh.kb, k, brow + (long long)c * L * H, H, hd, sk,
                   min(L, S - c * L), xbase, xend, 0, lane, 32, LXW);
  };

  load_smalls(0, 0);
  store_v(0);
  cp_commit();
  load_q(0);
  cp_commit();
  load_k(0);
  cp_commit();

  float cc[MT][4][4];                    // this warp's rows of C
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) cc[mi][ni][r] = 0.0f;
  for (int c = 0; c < NC; ++c) {
    const int u = c & 1, c0 = c * L, Lc = min(L, S - c0);
    const bool more = c + 1 < NC;
    cp_wait<1>();                        // smalls(c), q(c)
    __syncthreads();
    if (more) load_smalls(c + 1, u ^ 1);
    cp_commit();
    const Smalls sb = smalls(sh, u);

    // Q C over this warp's rows of C: Y (L x T) as 2 x 4 m16n8 tiles,
    // each 8-deep step's three products in a fresh accumulator d, added
    // to acc in fp32
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;
#pragma unroll
    for (int x = xbase; x < xend; x += 8) {
      unsigned ab[2][4], as[2][4], bb2[4][2], bs2[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        frag_a(sh.qb + 16 * mi * st + x, st, 1, g, tq, ab[mi], as[mi]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        frag_b(sh.ct + 8 * ni * st + x, st, 1, g, tq, bb2[ni], bs2[ni]);
      // the three products of every tile in turn, so that no mma waits
      // on the one before it
      float d[2][4][4] = {};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], as[mi], bb2[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], ab[mi], bs2[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], ab[mi], bb2[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], d[mi][ni][r]);
    }
    // Q n (lane t) over the same rows
    float dn = 0.0f;
#pragma unroll
    for (int x = xbase; x < xend; x += 4)
      dn = dot4(ld4(sh.qb + lane * st + x), ld4(sh.nv + x), dn);

    // times s_t, plus P V and rowsum(P) over this warp's steps s
    const int s0 = wid * (L / W);
    {
      const float4 p = ld4(sb.pb + lane * PS + s0);
      const float pe[4] = {p.x, p.y, p.z, p.w};
      dn = __fmul_rn(sb.sv[lane], dn);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + e <= lane) dn = __fadd_rn(dn, pe[e]);
    }
    {
      float4 pr[2][2], vc[4][2];         // P rows t, V^T rows j, read once
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          pr[mi][hf] = ld4(sb.pb + (16 * mi + g + 8 * hf) * PS + s0);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int cj = 0; cj < 2; ++cj)
          vc[ni][cj] = ld4(sb.vt + (8 * ni + 2 * tq + cj) * PS + s0);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {   // rows g and g + 8 of the tile
          const int t = 16 * mi + g + 8 * hf;
          const float st_ = sb.sv[t];
          const float pe[4] = {pr[mi][hf].x, pr[mi][hf].y, pr[mi][hf].z,
                               pr[mi][hf].w};
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
            for (int cj = 0; cj < 2; ++cj) {
              const float ve[4] = {vc[ni][cj].x, vc[ni][cj].y, vc[ni][cj].z,
                                   vc[ni][cj].w};
              float a = __fmul_rn(st_, acc[mi][ni][2 * hf + cj]);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (s0 + e <= t) a = fmaf(pe[e], ve[e], a);
              acc[mi][ni][2 * hf + cj] = a;
            }
          }
        }
      }
    }
    __syncwarp();
    if (more) load_q(c + 1);             // this warp's columns only
    cp_commit();
    if (more) store_v(u ^ 1);

    cp_wait<2>();                        // k(c), which the partial sums
    __syncwarp();                        // overwrite even in the last chunk
    if (more) {                          // this warp's rows of C and n
      const float a = sb.sv[Lc - 1];     // s at the chunk's end
      // C (XW x T) = a C + K^T diag(w) V over this warp's rows x, as
      // MT x 4 m16n8 tiles kept in registers from chunk to chunk, and
      // written to C^T for the next chunk's Q C (C^T's rows j are the
      // tiles' columns: every write is conflict-free at st = 4 mod 32);
      // diag(w) V and k are 0 past Lc
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cc[mi][ni][r] = __fmul_rn(a, cc[mi][ni][r]);
#pragma unroll
      for (int ks = 0; ks < L; ks += 8) {
        unsigned ab[MT][4], as[MT][4], b2[4][2], s2[4][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)   // K^T: row x, column s
          frag_a(sh.kb + ks * sk + xbase + 16 * mi, 1, sk, g, tq, ab[mi],
                 as[mi]);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          frag_b(sb.vwt + 8 * ni * PS + ks, PS, 1, g, tq, b2[ni], s2[ni]);
        // per m16 tile, the step's three products in a fresh
        // accumulator, added to the state in fp32: accumulated in the
        // state itself, each product's truncation would be of C's size,
        // and they would add up over every chunk whose terms are still
        // live (hundreds where the forget gate is near 1)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float d[4][4] = {};
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)   // small terms first
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma(d[ni], pass == 0 ? as[mi] : ab[mi],
                  pass == 1 ? s2[ni] : b2[ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              cc[mi][ni][r] = __fadd_rn(cc[mi][ni][r], d[ni][r]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int x = xbase + 16 * mi + g + 8 * (r >> 1);
            sh.ct[(8 * ni + 2 * tq + (r & 1)) * st + x] =
                x < hd ? cc[mi][ni][r] : 0.0f;
          }
      {                                  // rows x0 + 32 e of n
        constexpr int NX = XW < 32 ? 1 : XW / 32;
        const int x0 = xbase + lane;
        const bool ok = x0 < xend;
        // the chunk's K^T w in a fresh sum, then added to a n: summed
        // into n itself, each of the L terms would round at n's size,
        // thousands of roundings carried where the forget gate is near 1
        float nn[NX];
#pragma unroll
        for (int e = 0; e < NX; ++e) nn[e] = 0.0f;
#pragma unroll
        for (int s = 0; s < L; s += 4) {
          const float4 w4 = ld4(sb.wv + s);
          const float we[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int d = 0; d < 4; ++d)
#pragma unroll
            for (int e = 0; e < NX; ++e)
              if (ok) nn[e] = fmaf(we[d], sh.kb[(s + d) * sk + x0 + 32 * e],
                                   nn[e]);
        }
#pragma unroll
        for (int e = 0; e < NX; ++e)
          if (ok)
            sh.nv[x0 + 32 * e] =
                x0 + 32 * e < hd
                    ? __fadd_rn(__fmul_rn(a, sh.nv[x0 + 32 * e]), nn[e])
                    : 0.0f;
      }
    }
    __syncthreads();                     // every warp is done with k(c)

    // the warps' partial sums, through the k buffer
    float* red = sh.kb;
    float* dred = sh.kb + W * L * RS;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * mi + g + 8 * hf;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(red + (wid * L + t) * RS + 8 * ni +
                                     2 * tq) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
    dred[wid * L + lane] = dn;
    __syncthreads();
    {
      const int t = tid >> 3, jj = (tid & 7) * 4;
      float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float den = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float4 p = ld4(red + (w * L + t) * RS + jj);
        num.x = __fadd_rn(num.x, p.x);
        num.y = __fadd_rn(num.y, p.y);
        num.z = __fadd_rn(num.z, p.z);
        num.w = __fadd_rn(num.w, p.w);
        den = __fadd_rn(den, dred[w * L + t]);
      }
      den = fabsf(den);
      den = den != den ? den : fmaxf(den, 1.0f);   // clamp_min(., 1)
      if (t < Lc) {
        float* out = h + (brow + (long long)(c0 + t) * H) * hd + j0 + jj;
        const float o4[4] = {__fdiv_rn(num.x, den), __fdiv_rn(num.y, den),
                             __fdiv_rn(num.z, den), __fdiv_rn(num.w, den)};
        if (VEC && j0 + jj < hd) {
          *reinterpret_cast<float4*>(out) =
              make_float4(o4[0], o4[1], o4[2], o4[3]);
        } else if (!VEC) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j0 + jj + e < hd) out[e] = o4[e];
        }
      }
    }
    __syncthreads();                     // the partial sums are read
    if (more) load_k(c + 1);
    cp_commit();
  }
  cp_wait<0>();
}

template <bool VEC, int XW>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* i, const float* f, float* h, float* scratch,
                   int B, int S, int H, int hd, int NC, int tiles, int st,
                   int sk, int kbn, int smem, cudaStream_t s) {
  const long long n = (long long)B * H * NC * L;
  float *mo = scratch, *bo = mo + n, *so = bo + n, *wo = so + n;
  float* P = wo + n;
  mlstm_scan_fwd_gates<<<B * H, 32, 0, s>>>(i, f, mo, bo, so, wo, S, H, NC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_scan_fwd_intra<VEC><<<dim3(NC, H, B), IT, 0, s>>>(
      q, k, i, mo, bo, P, S, H, hd, NC);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlstm_scan_fwd_inter<VEC, XW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  mlstm_scan_fwd_inter<VEC, XW><<<dim3(tiles, H, B), NT, smem, s>>>(
      q, k, v, P, so, wo, h, S, H, hd, NC, st, sk, kbn);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_xw(int xw, const float* const* a, float* h,
                      float* scratch, int B, int S, int H, int hd, int NC,
                      int tiles, int st, int sk, int kbn, int smem,
                      cudaStream_t s) {
  switch (xw) {
    case 16: return launch<VEC, 16>(a[0], a[1], a[2], a[3], a[4], h, scratch,
                                    B, S, H, hd, NC, tiles, st, sk, kbn,
                                    smem, s);
    case 32: return launch<VEC, 32>(a[0], a[1], a[2], a[3], a[4], h, scratch,
                                    B, S, H, hd, NC, tiles, st, sk, kbn,
                                    smem, s);
    default: return launch<VEC, 64>(a[0], a[1], a[2], a[3], a[4], h,
                                    scratch, B, S, H, hd, NC, tiles, st, sk,
                                    kbn, smem, s);
  }
}

}  // namespace

// The launch plan comes from kernels/mlstm_scan/ops.py::mlstm_plan
// (whose chunk and warps are this file's L and W): tiles = ceil(hd /
// 32), xw (rows of C a warp: 16, 32 or 64; hd is padded to hp = 8 xw >=
// hd), st (row stride in floats of C^T and of a chunk of q: at least hp,
// 4 mod 8), sk (row stride of a chunk of k: at least hp, 8 mod 32), kbn
// (floats of the k buffer, which also holds the partial sums) and smem
// (bytes; checked against carve's layout here, so that a plan that
// disagrees is refused and never addresses past the block's shared
// memory). scratch: 4 B H NC 32 floats of gates, then B H NC 32 x 32 of
// P. vec: hd % 4 == 0 and every pointer 16-byte aligned.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v,
                                 const void* i, const void* f, void* h,
                                 void* scratch, int B, int S, int H, int hd,
                                 int tiles, int xw, int st, int sk,
                                 int kbn, int smem, int vec, void* stream) {
  if (B == 0 || S == 0 || H == 0 || hd == 0) return (int)cudaSuccess;
  const int hp = W * xw;
  const long long floats = (long long)(T + L) * st + kbn + hp + 2 * SMALLS;
  if (tiles * T < hd ||
      (xw != 16 && xw != 32 && xw != 64) || hp < hd ||
      st < hp || st % 8 != 4 || sk < hp || sk % 32 != 8 || kbn < L * sk ||
      kbn < W * L * (RS + 1) || floats * 4 != smem)
    return (int)cudaErrorInvalidValue;
  const int NC = (S + L - 1) / L;
  const float* a[5] = {(const float*)q, (const float*)k, (const float*)v,
                       (const float*)i, (const float*)f};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch_xw<true>(xw, a, (float*)h, (float*)scratch, B,
                                     S, H, hd, NC, tiles, st, sk, kbn, smem,
                                     s)
                   : launch_xw<false>(xw, a, (float*)h, (float*)scratch, B,
                                      S, H, hd, NC, tiles, st, sk, kbn,
                                      smem, s));
}

// ============================================================================
// mlstm_scan_bwd: the recurrence's backward. Plain version:
// repro_torch/kernels/mlstm_scan/ref.py::mlstm_scan_bwd_ref (a loop back in
// time); the chunkwise algorithm below is modelled step for step by
// tests/torch_mlstm_chunked.py::mlstm_chunked_bwd. Stands in
// for jax.grad of the JAX package's lax.scan of _mlstm_step.
//
// Inputs: q, k, v, i, f as the forward's, h its output and dh h's gradient
// (B, S, H, hd) fp32; outputs dq, dk, dv (B, S, H, hd), di, df (B, S, H).
//
// Bound on an H100 SXM: operations. The model counts a backward as two
// forwards, 10 B S H hd^2: at xlstm_1_3b's width, B = 2, S = 4096, 8.6e10,
// 1.28 ms at 67 TFLOP/s fp32.
//
// Design. In a chunk the state is a sum of decayed inputs: C_t = sum_s
// D_ts k_s v_s^T, log D_ts = F_t - F_s + i_s - m_t (F the sum of f), so the
// backward is that of P_ts = D_ts (q_t . k_s) plus the gates through log D.
// Given m (the forward's gates pass, rerun), seven kernels, nine launches:
//  1. mlstm_scan_bwd_gates, the forward's gates pass again: m, b, s, w;
//  2. n before every chunk, in two passes: mlstm_scan_bwd_nsum, a block per
//     (chunk, head, row), all chunks at once, writes the chunk's K^T w;
//     mlstm_scan_bwd_ncombine, a thread per (row, head, column x), runs
//     n_c = s_e n_{c-1} + (K^T w)_{c-1} over the chunks in place. n rounds
//     as the forward's does: the chunk's sum formed apart, one add a chunk;
//  3. mlstm_scan_bwd_intra, a block of 8 warps per (chunk, head, row): the
//     chunk's q, k and dh staged once in shared memory (hd-slices by
//     cp.async, the next slice loading while this one is summed), v a slice
//     at a time; warps 0-3 form Q K^T and warps 4-7 dH V^T, a 16 x 16
//     quarter each, on the tensor cores. Then d_t = s_t (q_t . n_prev) +
//     rowsum(P), den, dd_t = -(dh_t . h_t) / den d den/d d (both dots on
//     the FMA units, h read once); writes dq = dS K, dk = dS^T Q, dv = (P /
//     den)^T dH (dS = (dH V^T / den + dd) ⊙ D) from the staged chunk, and
//     per step s / den, s dd and R_t = (dh_t . h_t)(1 - d den/d|d|), the
//     row sum of G = dP ⊙ P (0 where the clamp does not bind);
//  4-6. mlstm_scan_bwd_walk, one generic kernel run three times: a block per
//     (32 rows of a hd x hd state M, head, row) walks the chunks, each
//     adding out_t[r] += alpha_t (M y_t)[r] + beta_t nv[r] for the chunk's
//     steps, then M <- s_e M + X^T diag(gamma) Z and nv <- s_e nv + X^T
//     gamma_n. Forward, M = C (rows of C): dq_t += (s_t / den_t) C dh_t +
//     s_t dd_t n. Backward in time, M = dC (rows): dk_s += w_s (dC v_s +
//     dn), dC <- s_e dC + Q^T diag(s / den) dH, dn <- s_e dn + Q^T (s dd);
//     and M = dC^T (rows of dC^T): dv_s += w_s dC^T k_s. Each sum a walk
//     forms runs over all of M's columns, so every output is the block's
//     own: no partial sums leave a block, and no state is stored (the
//     forward walk rebuilds C; storing C at every chunk boundary would take
//     1.07 GB at xlstm_1_3b, B = 2, S = 4096). It is the forward's inter
//     kernel with y for q, z for k and diag(gamma) X for diag(w) V: warp w
//     owns columns [w XW, (w + 1) XW) of M, kept in registers as the
//     accumulator tiles of the update (M^T: the warp's columns x the 32
//     rows) and copied to shared memory as M (rows r, stride st) for the
//     next chunk's product, whose B operand reads it there; the warps'
//     partial sums of M y_t meet once a chunk in shared memory. The next
//     chunk's y, z, out tile and per-step scalars load by cp.async while
//     this chunk computes (y after the product, z after the sums are read,
//     the rest double-buffered); X goes through registers into (diag(gamma)
//     X)^T and X^T;
//  7. mlstm_scan_bwd_dots, a warp per (row, step, head): Cs_t = k_t . dk_t,
//     the column sum of G;
//  8. mlstm_scan_bwd_dgates, a warp per (row, head), serially from the last
//     step: dF_t = R_t - Cs_t summed from the end in double (A_t; A_0 = 0,
//     no pair crosses step 0), m_t taking -R_t and handing it back through
//     m_t = max(f_t + m_{t-1}, i_t) (halves at a tie, as jnp.maximum):
//     df_t = A_t + da_t, di_t = Cs_t + (1 - sel_t)(dm - R_t).
// No hd^2 product per step forms a gate gradient.
// Tensor cores: the walks' M y_t (depth hd) and X^T diag(gamma) Z (depth L)
// and the intra's Q K^T and dH V^T (depth hd) run on mma.sync m16n8k8 in
// 3xTF32, with the forward's rules: each fp32 operand split into a TF32
// value and its TF32 remainder, the small terms first; each 8-deep step's
// three products in a fresh accumulator, added to the running sum with
// __fadd_rn (the tensor core's own accumulation truncates); each chunk's
// update of M summed apart over its four 8-deep steps and added to the
// decayed M once (s_e M + U, as the FMA walk rounded it), so M rounds twice
// a chunk, not once a term. No fast math.
// FMA units: the intra's three products against the causal matrices (dS K,
// dS^T Q, (P / den)^T dH; 32 terms a row, in the loop's order) skip the
// masked half (s > t), and P and dS are 0 there by a select, not by a
// product with D = 0: a masked 0 times a non-finite k_s or q_t would be
// NaN, and would reach gradients the loop leaves finite (dq at steps before
// a non-finite k_s). So do q_t . n and dh_t . h_t. A non-finite operand of
// a tensor-core product gives NaN where the loop may give inf (the split's
// remainder is inf - inf); such rows are NaN in the loop's gradients too.
// Shared memory at hd = 512: the walk 226,176 bytes (M and y at stride 516,
// z at 520 and its partial sums, two buffers of 3,424 floats of smalls),
// the intra 215,808 (q, k, dh at stride 516; v's two 64-column slices,
// reused for Q K^T, dH V^T, then dS, dS^T and (P / den)^T): one block a SM.
// Strides make every fragment read conflict-free (4 mod 32 floats; z's rows
// 8 mod 32). Scratch: m, b, s, w, s / den, s dd, R, Cs per step and n per
// chunk (B H NC hd): 3 MB at xlstm_1_3b, B = 2, S = 4096.

namespace {

constexpr int IB = 256;                  // bwd intra threads
constexpr int XB = 64;                   // hd columns a slice of v (intra)
constexpr int XBS = XB + 4;              // row stride of the v slices
constexpr int DS = L + 4;                // row stride of dS, dS^T, (P/den)^T
constexpr int NB = 128;                  // nsum / ncombine threads
constexpr int NU = 16;                   // chunks a batch of loads (ncombine)
// one buffer of a walk chunk's smalls: (diag(gamma) X)^T and X^T (T x PS),
// the out tile (L x T), alpha, beta, gamma_n (L each)
constexpr int WSMALLS = 2 * T * PS + L * T + 3 * L;
static_assert(XB == 4 << 4, "the intra loads take 16 vectors a row");
static_assert(2 * L * XBS >= 2 * L * (L + 1) && 2 * L * XBS >= 3 * L * DS,
              "the v slices hold Q K^T and dH V^T, then dS and (P/den)^T");
static_assert(IB == 2 * (512 / 4), "the intra's dq, dk, dv: 4 columns and "
              "every other row a thread, at hd <= 512");

__device__ __forceinline__ float half_at_ties(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// ---- 2. n before every chunk -----------------------------------------------
// nsum: thread id sums 4 columns of the chunk's K^T w, in the loop's order
template <bool VEC>
__global__ void __launch_bounds__(NB)
mlstm_scan_bwd_nsum(const float* __restrict__ k, const float* __restrict__ wo,
                    float* __restrict__ np, int S, int H, int hd, int NC) {
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int bh = bb * H + hh, c0 = c * L, Lc = min(L, S - c0);
  const long long g0 = (long long)bh * NC * L + c0;
  const long long row0 = (long long)(bb * S + c0) * H + hh;
  float* out = np + ((long long)bh * NC + c) * hd;
  for (int x = 4 * threadIdx.x; x < hd; x += 4 * NB) {
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int s = 0; s < Lc; ++s) {
      const float w = wo[g0 + s];
      const float* kr = k + (row0 + (long long)s * H) * hd + x;
      if (VEC) {
        const float4 kv = ld4(kr);
        a[0] = fmaf(w, kv.x, a[0]);
        a[1] = fmaf(w, kv.y, a[1]);
        a[2] = fmaf(w, kv.z, a[2]);
        a[3] = fmaf(w, kv.w, a[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x + e < hd) a[e] = fmaf(w, kr[e], a[e]);
      }
    }
    if (VEC) {
      *reinterpret_cast<float4*>(out + x) = make_float4(a[0], a[1], a[2],
                                                        a[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e < hd) out[x + e] = a[e];
    }
  }
}

// ncombine: in place, chunk sums in, n before each chunk out; the loads of
// NU chunks go out together, ahead of the chain
__global__ void __launch_bounds__(NB)
mlstm_scan_bwd_ncombine(const float* __restrict__ so, float* __restrict__ np,
                        int S, int H, int hd, int NC) {
  const int x = blockIdx.x * NB + threadIdx.x;
  if (x >= hd) return;
  const int bh = blockIdx.z * H + blockIdx.y;
  const long long g0 = (long long)bh * NC * L;
  float* p = np + (long long)bh * NC * hd + x;
  float n = 0.0f;
  for (int c = 0; c < NC; c += NU) {
    float u[NU], a[NU];
#pragma unroll
    for (int e = 0; e < NU; ++e) {
      const int cc = c + e;
      const bool ok = cc < NC;
      u[e] = ok ? p[(long long)cc * hd] : 0.0f;
      a[e] = ok ? so[g0 + (long long)cc * L + min(L, S - cc * L) - 1] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < NU; ++e) {
      if (c + e < NC) {
        p[(long long)(c + e) * hd] = n;
        n = __fadd_rn(__fmul_rn(a[e], n), u[e]);
      }
    }
  }
}

// ---- 3. intra ---------------------------------------------------------------
// dq, dk or dv of the chunk: out rows j' = 2 j + par (j < 16) of 4 columns
// at x, sum over the causal half of mat (row-major, stride DS; mat[j'][o]
// is 0 past it) times rows o of src (stride sx): LOWER sums o <= j' (dS K,
// dS read as [t][s]), else o >= j' (dS^T Q and (P/den)^T dH, read
// transposed as [s][t]); o ascending, fmaf, as the loop's order
template <bool LOWER, bool VEC>
__device__ __forceinline__ void causal_rows(const float* mat, const float* src,
                                            int sx, int x, int par,
                                            float* __restrict__ dst,
                                            long long row0, int H, int hd,
                                            int Lc) {
  float a[L / 2][4];
#pragma unroll
  for (int j = 0; j < L / 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.0f;
  for (int ob = 0; ob < L; ob += 4) {
    float4 sv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sv[e] = ld4(src + (ob + e) * sx + x);
#pragma unroll
    for (int j = 0; j < L / 2; ++j) {
      const int r = 2 * j + par;
      if (LOWER ? ob <= r : ob + 3 >= r) {
        const float4 w4 = ld4(mat + r * DS + ob);
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (LOWER ? ob + e <= r : ob + e >= r) {
            a[j][0] = fmaf(w[e], sv[e].x, a[j][0]);
            a[j][1] = fmaf(w[e], sv[e].y, a[j][1]);
            a[j][2] = fmaf(w[e], sv[e].z, a[j][2]);
            a[j][3] = fmaf(w[e], sv[e].w, a[j][3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L / 2; ++j) {
    const int r = 2 * j + par;
    if (r < Lc) {
      float* o = dst + (row0 + (long long)r * H) * hd + x;
      if (VEC) {
        *reinterpret_cast<float4*>(o) = make_float4(a[j][0], a[j][1],
                                                    a[j][2], a[j][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x + e < hd) o[e] = a[j][e];
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(IB, 1)
mlstm_scan_bwd_intra(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ h,
                     const float* __restrict__ dh,
                     const float* __restrict__ ipre,
                     const float* __restrict__ mo, const float* __restrict__ bo,
                     const float* __restrict__ so, const float* __restrict__ np,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ sdo,
                     float* __restrict__ sddo, float* __restrict__ Ro,
                     int S, int H, int hd, int NC, int sx) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // L x sx: the chunk's q
  float* ks = qs + L * sx;               // its k
  float* dhs = ks + L * sx;              // its dh
  float* vb = dhs + L * sx;              // 2 x L x XBS: v's slices, then
  float* sc = vb + 2 * L * XBS;          // q_t . n, dh_t . h_t (L each)
  const int c = blockIdx.x, hh = blockIdx.y, bb = blockIdx.z;
  const int bh = bb * H + hh, c0 = c * L, Lc = min(L, S - c0);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)(bb * S + c0) * H + hh;
  const long long o = (long long)bh * NC * L + c0;
  const int hd8 = (hd + 7) & ~7;

  // Q K^T (warps 0-3) and dH V^T (warps 4-7): quarter (t0, s0) each
  const int prod = wid >> 2, t0 = 16 * ((wid >> 1) & 1), s0 = 16 * (wid & 1);
  auto load = [&](int x0, int u) {
    const int x1 = min(x0 + XB, hd8);
    load_rows<VEC>(qs, q, row0, H, hd, sx, Lc, x0, x1, 0, tid, IB, 4);
    load_rows<VEC>(ks, k, row0, H, hd, sx, Lc, x0, x1, 0, tid, IB, 4);
    load_rows<VEC>(dhs, dh, row0, H, hd, sx, Lc, x0, x1, 0, tid, IB, 4);
    load_rows<VEC>(vb + u * L * XBS, v, row0, H, hd, XBS, Lc, x0, x1, x0,
                   tid, IB, 4);
    cp_commit();
  };
  float acc[2][4];
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0.0f;
  load(0, 0);
  for (int x0 = 0, u = 0; x0 < hd8; x0 += XB, u ^= 1) {
    if (x0 + XB < hd8) {
      load(x0 + XB, u ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int xn = min(XB, hd8 - x0);
    const float* as_ = (prod ? dhs : qs) + t0 * sx + x0;
    const float* bs_ = prod ? vb + u * L * XBS + s0 * XBS : ks + s0 * sx + x0;
    const int ldb = prod ? XBS : sx;
    for (int x = 0; x < xn; x += 8) {
      unsigned ab[4], as[4], bb2[2][2], bs2[2][2];
      frag_a(as_ + x, sx, 1, g, tq, ab, as);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        frag_b(bs_ + 8 * ni * ldb + x, ldb, 1, g, tq, bb2[ni], bs2[ni]);
      float d[2][4] = {};
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma(d[ni], as, bb2[ni]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma(d[ni], ab, bs2[ni]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma(d[ni], ab, bb2[ni]);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[ni][r] = __fadd_rn(acc[ni][r], d[ni][r]);
    }
    __syncthreads();                     // before the buffer is refilled
  }
  float* sqm = vb;                       // L x (L + 1): q_t . k_s
  float* dvm = vb + L * (L + 1);         // dh_t . v_s
  {
    float* outm = prod ? dvm : sqm;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int cj = 0; cj < 2; ++cj)
          outm[(t0 + g + 8 * hf) * (L + 1) + s0 + 8 * ni + 2 * tq + cj] =
              acc[ni][2 * hf + cj];
  }
  // q_t . n_prev and dh_t . h_t: warp w rows 4 w .. 4 w + 3
  const float* npc = np + ((long long)bh * NC + c) * hd;
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
    const int t = (L / 8) * wid + j;
    float qn = 0.0f, uu = 0.0f;
    if (t < Lc) {
      const float* hr = h + (row0 + (long long)t * H) * hd;
      for (int x = lane; x < hd; x += 32) {
        qn = fmaf(qs[t * sx + x], npc[x], qn);
        uu = fmaf(dhs[t * sx + x], hr[x], uu);
      }
    }
#pragma unroll
    for (int m = 16; m; m >>= 1) {
      qn = __fadd_rn(qn, __shfl_xor_sync(0xffffffffu, qn, m));
      uu = __fadd_rn(uu, __shfl_xor_sync(0xffffffffu, uu, m));
    }
    if (lane == 0) {
      sc[t] = qn;
      sc[L + t] = uu;
    }
  }
  __syncthreads();

  // D, P, the row sum of P, and the step's scalars: thread (t = tid / 8,
  // columns sb .. sb + 3); masked entries are 0 by a select
  {
    const int t = tid >> 3, sb = 4 * (tid & 7);
    const float mt = mo[o + t], bt = bo[o + t];
    float D[4], P[4], rs = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = sb + e;
      const bool in = s <= t && t < Lc;
      D[e] = 0.0f;
      P[e] = 0.0f;
      if (in) {
        const float is = ipre[row0 + (long long)s * H];
        D[e] = expf(__fadd_rn(__fsub_rn(is, mt), __fsub_rn(bt, bo[o + s])));
        P[e] = __fmul_rn(D[e], sqm[t * (L + 1) + s]);
      }
      rs = __fadd_rn(rs, P[e]);
    }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1)
      rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, m));
    const float st = t < Lc ? so[o + t] : 0.0f;
    const float u = sc[L + t];
    const float d = __fadd_rn(__fmul_rn(st, sc[t]), rs);
    const float ad = fabsf(d);
    const float den = ad != ad ? ad : fmaxf(ad, 1.0f);
    const float mu = half_at_ties(ad, 1.0f);
    const float sg = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    const float dd = t < Lc ? __fmul_rn(__fmul_rn(-__fdiv_rn(u, den), mu), sg)
                            : 0.0f;
    if ((tid & 7) == 0) {
      sdo[o + t] = t < Lc ? __fdiv_rn(st, den) : 0.0f;
      sddo[o + t] = __fmul_rn(st, dd);
      Ro[o + t] = t < Lc ? __fmul_rn(u, __fsub_rn(1.0f, mu)) : 0.0f;
    }
    float dsv[4], pdv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = sb + e;
      const bool in = s <= t && t < Lc;
      dsv[e] = in ? __fmul_rn(__fadd_rn(__fdiv_rn(dvm[t * (L + 1) + s], den),
                                        dd), D[e])
                  : 0.0f;
      pdv[e] = in ? __fdiv_rn(P[e], den) : 0.0f;
    }
    __syncthreads();                     // Q K^T and dH V^T are read
    float* dsm = vb;                     // L x DS: dS[t][s]
    float* dst = dsm + L * DS;           // dS^T[s][t]
    float* pdt = dst + L * DS;           // (P / den)^T[s][t]
    *reinterpret_cast<float4*>(dsm + t * DS + sb) =
        make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dst[(sb + e) * DS + t] = dsv[e];
      pdt[(sb + e) * DS + t] = pdv[e];
    }
  }
  __syncthreads();
  // dq = dS K, dk = dS^T Q, dv = (P / den)^T dH: thread (columns 4 (tid %
  // 128), rows of parity tid / 128)
  const int x = 4 * (tid & (IB / 2 - 1)), par = tid / (IB / 2);
  if (x < hd) {
    const float* dsm = vb;
    causal_rows<true, VEC>(dsm, ks, sx, x, par, dq, row0, H, hd, Lc);
    causal_rows<false, VEC>(dsm + L * DS, qs, sx, x, par, dk, row0, H, hd,
                            Lc);
    causal_rows<false, VEC>(dsm + 2 * L * DS, dhs, sx, x, par, dv, row0, H,
                            hd, Lc);
  }
}

// ---- 4-6. the walks ---------------------------------------------------------
struct Walk {
  const float *y, *z, *x;                // (B, S, H, hd)
  const float *alpha, *beta, *gamma, *gamman;   // per step; beta, gamman
  float* out;                            // (B, S, H, hd), added to
  int rev;                               // walk the chunks back in time
};

// one buffer of a chunk's smalls
struct WSmalls {
  float *xgt, *xt, *ob, *al, *be, *gn;
};

__device__ __forceinline__ WSmalls wsmalls(float* base, int u) {
  WSmalls b;
  b.xgt = base + u * WSMALLS;
  b.xt = b.xgt + T * PS;
  b.ob = b.xt + T * PS;
  b.al = b.ob + L * T;
  b.be = b.al + L;
  b.gn = b.be + L;
  return b;
}

template <bool VEC, int XW>
__global__ void __launch_bounds__(NT, 1)
mlstm_scan_bwd_walk(Walk wk, const float* __restrict__ so, int S, int H,
                    int hd, int NC, int st, int sk, int kbn) {
  constexpr int LXW = XW == 16 ? 2 : XW == 32 ? 3 : 4;
  constexpr int MT = XW / 16;            // m16 tiles of this warp's columns
  static_assert(XW == 4 << LXW, "XW is 16, 32 or 64");
  extern __shared__ __align__(16) float sm[];
  float* mt = sm;                        // T x st: M's 32 rows
  float* ys = mt + T * st;               // L x st: the chunk's y
  float* zs = ys + L * st;               // L x sk: its z; the partial sums
  float* nv = zs + kbn;                  // T
  float* smb = nv + T;                   // 2 x WSMALLS
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = blockIdx.x * T, hh = blockIdx.y, bb = blockIdx.z;
  const int bh = bb * H + hh;
  const int xbase = wid * XW, xend = xbase + XW;
  const long long brow = (long long)bb * S * H + hh;
  const long long g0 = (long long)bh * NC * L;
  const bool nvec = wk.beta != nullptr;

  for (int e = tid; e < T * st; e += NT) mt[e] = 0.0f;
  if (tid < T) nv[tid] = 0.0f;

  // the smalls of chunk c into buffer u: the scalars and the out tile by
  // cp.async; X into registers (stored by store_x once Y is formed)
  const int xs_ = tid >> 3, xj = (tid & 7) * 4;        // X element (t, r)
  float xr[4], gr = 0.0f;
  auto load_smalls = [&](int c, int u) {
    const WSmalls b = wsmalls(smb, u);
    const long long gc = g0 + (long long)c * L;
    if (tid < L / 4) cp16(b.al + 4 * tid, wk.alpha + gc + 4 * tid, 16);
    else if (tid < L / 2 && nvec)
      cp16(b.be + 4 * (tid - L / 4), wk.beta + gc + 4 * (tid - L / 4), 16);
    else if (tid >= L / 2 && tid < 3 * L / 4 && nvec)
      cp16(b.gn + 4 * (tid - L / 2), wk.gamman + gc + 4 * (tid - L / 2), 16);
    const int t = c * L + xs_;
    const bool row_ok = t < S;
    const float* og = wk.out + (brow + (long long)(row_ok ? t : 0) * H) * hd;
    float* od = b.ob + xs_ * T + xj;
    if (VEC) {
      const bool ok = row_ok && r0 + xj < hd;
      cp16(od, ok ? og + r0 + xj : wk.out, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && r0 + xj + e < hd;
        cp4(od + e, ok ? og + r0 + xj + e : wk.out, ok ? 4 : 0);
      }
    }
    gr = wk.gamma[gc + xs_];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + xj + e;
      xr[e] = (row_ok && r < hd)
                  ? wk.x[(brow + (long long)t * H) * hd + r] : 0.0f;
    }
  };
  auto store_x = [&](int u) {
    const WSmalls b = wsmalls(smb, u);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      b.xt[(xj + e) * PS + xs_] = xr[e];
      b.xgt[(xj + e) * PS + xs_] = __fmul_rn(gr, xr[e]);
    }
  };
  auto load_y = [&](int c) {
    load_rows<VEC>(ys, wk.y, brow + (long long)c * L * H, H, hd, st,
                   min(L, S - c * L), xbase, xend, 0, lane, 32, LXW);
  };
  auto load_z = [&](int c) {
    load_rows<VEC>(zs, wk.z, brow + (long long)c * L * H, H, hd, sk,
                   min(L, S - c * L), xbase, xend, 0, lane, 32, LXW);
  };
  auto chunk = [&](int it) { return wk.rev ? NC - 1 - it : it; };

  load_smalls(chunk(0), 0);
  store_x(0);
  cp_commit();
  load_y(chunk(0));
  cp_commit();
  load_z(chunk(0));
  cp_commit();

  float cc[MT][4][4];                    // this warp's columns of M, as M^T
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) cc[mi][ni][r] = 0.0f;
  for (int it = 0; it < NC; ++it) {
    const int c = chunk(it), u = it & 1, c0 = c * L, Lc = min(L, S - c0);
    const bool more = it + 1 < NC;
    const float a = so[g0 + c0 + Lc - 1];  // the chunk's decay s_e
    cp_wait<1>();                        // smalls(c), y(c)
    __syncthreads();
    if (more) load_smalls(chunk(it + 1), u ^ 1);
    cp_commit();
    const WSmalls sb = wsmalls(smb, u);

    // Y = y M^T over this warp's columns of M: L x T as 2 x 4 m16n8
    // tiles, each 8-deep step's three products in a fresh accumulator d,
    // added to acc in fp32
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;
#pragma unroll
    for (int x = xbase; x < xend; x += 8) {
      unsigned ab[2][4], as[2][4], bb2[4][2], bs2[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        frag_a(ys + 16 * mi * st + x, st, 1, g, tq, ab[mi], as[mi]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        frag_b(mt + 8 * ni * st + x, st, 1, g, tq, bb2[ni], bs2[ni]);
      float d[2][4][4] = {};
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], as[mi], bb2[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], ab[mi], bs2[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(d[mi][ni], ab[mi], bb2[ni]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], d[mi][ni][r]);
    }
    __syncwarp();
    if (more) load_y(chunk(it + 1));     // this warp's columns only
    cp_commit();
    if (more) store_x(u ^ 1);

    cp_wait<2>();                        // z(c), which the partial sums
    __syncwarp();                        // overwrite even in the last chunk
    if (more) {                          // this warp's columns of M
      // U = X^T diag(gamma) Z over the chunk's four 8-deep steps, each in
      // a fresh accumulator, summed in fp32; then M <- a M + U, added once.
      // (diag(gamma) X) and z are 0 past Lc
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        float up[4][4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) up[ni][r] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < L; ks += 8) {
          unsigned ab[4], as[4], b2[4][2], s2[4][2];
          frag_a(zs + ks * sk + xbase + 16 * mi, 1, sk, g, tq, ab, as);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            frag_b(sb.xgt + 8 * ni * PS + ks, PS, 1, g, tq, b2[ni], s2[ni]);
          float d[4][4] = {};
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)   // small terms first
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mma(d[ni], pass == 0 ? as : ab, pass == 1 ? s2[ni] : b2[ni]);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              up[ni][r] = __fadd_rn(up[ni][r], d[ni][r]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            cc[mi][ni][r] = __fadd_rn(__fmul_rn(a, cc[mi][ni][r]),
                                      up[ni][r]);
            // M's rows r are the tiles' columns: conflict-free at st = 4
            // mod 32
            const int x = xbase + 16 * mi + g + 8 * (r >> 1);
            mt[(8 * ni + 2 * tq + (r & 1)) * st + x] =
                x < hd ? cc[mi][ni][r] : 0.0f;
          }
      }
    }
    __syncthreads();                     // every warp is done with z(c)

    // the warps' partial sums, through the z buffer
    float* red = zs;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int t = 16 * mi + g + 8 * hf;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(red + (wid * L + t) * RS + 8 * ni +
                                     2 * tq) =
              make_float2(acc[mi][ni][2 * hf], acc[mi][ni][2 * hf + 1]);
      }
    __syncthreads();
    {                                    // out_t[r] += alpha_t Y + beta_t nv
      const int t = tid >> 3, jj = (tid & 7) * 4;
      float s4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float4 p = ld4(red + (w * L + t) * RS + jj);
        s4[0] = __fadd_rn(s4[0], p.x);
        s4[1] = __fadd_rn(s4[1], p.y);
        s4[2] = __fadd_rn(s4[2], p.z);
        s4[3] = __fadd_rn(s4[3], p.w);
      }
      const float al = sb.al[t], be = nvec ? sb.be[t] : 0.0f;
      const float4 prev = ld4(sb.ob + t * T + jj);
      const float pv[4] = {prev.x, prev.y, prev.z, prev.w};
      float o4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = __fmul_rn(al, s4[e]);
        if (nvec) val = __fadd_rn(val, __fmul_rn(be, nv[jj + e]));
        o4[e] = __fadd_rn(pv[e], val);
      }
      if (t < Lc) {
        float* out = wk.out + (brow + (long long)(c0 + t) * H) * hd + r0 + jj;
        if (VEC && r0 + jj < hd) {
          *reinterpret_cast<float4*>(out) =
              make_float4(o4[0], o4[1], o4[2], o4[3]);
        } else if (!VEC) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (r0 + jj + e < hd) out[e] = o4[e];
        }
      }
    }
    __syncthreads();                     // the partial sums and nv are read
    if (nvec && more && wid == 0) {      // nv <- a nv + X^T gamma_n
      float acc_n = 0.0f;
#pragma unroll
      for (int t = 0; t < L; t += 4) {
        const float4 x4 = ld4(sb.xt + lane * PS + t);
        const float4 g4 = ld4(sb.gn + t);
        acc_n = fmaf(x4.x, g4.x, acc_n);
        acc_n = fmaf(x4.y, g4.y, acc_n);
        acc_n = fmaf(x4.z, g4.z, acc_n);
        acc_n = fmaf(x4.w, g4.w, acc_n);
      }
      nv[lane] = __fadd_rn(__fmul_rn(a, nv[lane]), acc_n);
    }
    if (more) load_z(chunk(it + 1));
    cp_commit();
  }
  cp_wait<0>();
}

// ---- 7. Cs_t = k_t . dk_t --------------------------------------------------
__global__ void __launch_bounds__(256)
mlstm_scan_bwd_dots(const float* __restrict__ k, const float* __restrict__ dk,
                    float* __restrict__ cso, int B, int S, int H, int hd,
                    int NC) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * S * H) return;
  const int hh = (int)(row % H), t = (int)((row / H) % S);
  const int bb = (int)(row / ((long long)S * H));
  float acc = 0.0f;
  for (int x = lane; x < hd; x += 32)
    acc = fmaf(k[row * hd + x], dk[row * hd + x], acc);
#pragma unroll
  for (int m = 16; m; m >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
  if (lane == 0) cso[((long long)(bb * H + hh) * NC) * L + t] = acc;
}

// ---- 1. the forward's gates pass, under the backward's name ----------------
__global__ void __launch_bounds__(32)
mlstm_scan_bwd_gates(const float* __restrict__ ipre,
                     const float* __restrict__ lf, float* __restrict__ mo,
                     float* __restrict__ bo, float* __restrict__ so,
                     float* __restrict__ wo, int S, int H, int NC) {
  gates_pass(ipre, lf, mo, bo, so, wo, S, H, NC);
}

// ---- 8. the gates' gradients, serially from the last step ------------------
__global__ void __launch_bounds__(32)
mlstm_scan_bwd_dgates(const float* __restrict__ ipre,
                     const float* __restrict__ lf, const float* __restrict__ mo,
                     const float* __restrict__ Ro,
                     const float* __restrict__ cso, float* __restrict__ di,
                     float* __restrict__ df, int S, int H, int NC) {
  const int bh = blockIdx.x, bb = bh / H, hh = bh % H, lane = threadIdx.x;
  const long long g0 = (long long)bh * NC * L;
  double acc = 0.0, dm = 0.0;
  for (int c = NC - 1; c >= 0; --c) {
    const int t = c * L + lane;
    float r = 0.0f, cs = 0.0f, sel = 0.0f;
    if (t < S) {
      const long long gi = (long long)(bb * S + t) * H + hh;
      r = Ro[g0 + t];
      cs = cso[g0 + t];
      const float m_prev = t ? mo[g0 + t - 1] : -INFINITY;
      sel = half_at_ties(__fadd_rn(lf[gi], m_prev), ipre[gi]);
    }
    double my_df = 0.0, my_di = 0.0;
    for (int u = L - 1; u >= 0; --u) {   // every lane runs the chain
      const double ru = __shfl_sync(0xffffffffu, r, u);
      const double cu = __shfl_sync(0xffffffffu, cs, u);
      const double su = __shfl_sync(0xffffffffu, sel, u);
      if (c * L + u >= S) continue;
      const double dA = c * L + u ? ru - cu : -acc;
      acc += dA;
      const double gg = dm - ru, da = su * gg;
      if (lane == u) {
        my_df = acc + da;
        my_di = (ru - dA) + (gg - da);
      }
      dm = da;
    }
    if (t < S) {
      const long long gi = (long long)(bb * S + t) * H + hh;
      df[gi] = (float)my_df;
      di[gi] = (float)my_di;
    }
  }
}

// the walk's layout for warps of xw columns (as mlstm_plan's inter layout:
// st 4 mod 8 for M and y, sk 8 mod 32 for z, whose buffer also holds the
// warps' partial sums) and its dynamic shared bytes
struct WalkPlan {
  int st, sk, kbn, smem;
};

WalkPlan walk_plan(int xw) {
  const int hp = W * xw;
  WalkPlan p;
  p.st = 4 * ((hp / 4) | 1);
  p.sk = hp + 8;
  p.kbn = L * p.sk > W * L * RS ? L * p.sk : W * L * RS;
  p.smem = 4 * ((T + L) * p.st + p.kbn + T + 2 * WSMALLS);
  return p;
}

template <bool VEC, int XW>
cudaError_t walk(const Walk& wk, const float* so, int B, int S, int H,
                 int hd, int NC, cudaStream_t s) {
  const WalkPlan p = walk_plan(XW);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_bwd_walk<VEC, XW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  mlstm_scan_bwd_walk<VEC, XW><<<dim3((hd + T - 1) / T, H, B), NT, p.smem,
                                  s>>>(wk, so, S, H, hd, NC, p.st, p.sk,
                                       p.kbn);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t walk_xw(int xw, const Walk& wk, const float* so, int B, int S,
                    int H, int hd, int NC, cudaStream_t s) {
  switch (xw) {
    case 16: return walk<VEC, 16>(wk, so, B, S, H, hd, NC, s);
    case 32: return walk<VEC, 32>(wk, so, B, S, H, hd, NC, s);
    default: return walk<VEC, 64>(wk, so, B, S, H, hd, NC, s);
  }
}

template <bool VEC>
cudaError_t bwd(const float* q, const float* k, const float* v,
                const float* ip, const float* fp, const float* h,
                const float* dh, float* dq, float* dk, float* dv, float* di,
                float* df, float* scratch, int B, int S, int H, int hd,
                int xw, cudaStream_t s) {
  const int NC = (S + L - 1) / L;
  const long long n = (long long)B * H * NC * L;
  float *mo = scratch, *bo = mo + n, *so = bo + n, *wo = so + n;
  float *sd = wo + n, *sdd = sd + n, *R = sdd + n, *Cs = R + n, *np = Cs + n;
  mlstm_scan_bwd_gates<<<B * H, 32, 0, s>>>(ip, fp, mo, bo, so, wo, S, H, NC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_scan_bwd_nsum<VEC><<<dim3(NC, H, B), NB, 0, s>>>(k, wo, np, S, H,
                                                         hd, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_scan_bwd_ncombine<<<dim3((hd + NB - 1) / NB, H, B), NB, 0, s>>>(
      so, np, S, H, hd, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int sx = 32 * ((hd + 31) / 32) + 4;
  const int ismem = 4 * (3 * L * sx + 2 * L * XBS + 2 * L);
  err = cudaFuncSetAttribute(mlstm_scan_bwd_intra<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ismem);
  if (err != cudaSuccess) return err;
  mlstm_scan_bwd_intra<VEC><<<dim3(NC, H, B), IB, ismem, s>>>(
      q, k, v, h, dh, ip, mo, bo, so, np, dq, dk, dv, sd, sdd, R, S, H, hd,
      NC, sx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (NC > 1) {                          // one chunk: nothing crosses one
    const Walk walks[3] = {
        {dh, v, k, sd, sdd, wo, wo, dq, 0},          // dq: C, forward
        {v, dh, q, wo, wo, sd, sdd, dk, 1},          // dk: dC, backward
        {k, q, dh, wo, nullptr, sd, nullptr, dv, 1}};  // dv: dC^T
    for (const Walk& wk : walks)
      if ((err = walk_xw<VEC>(xw, wk, so, B, S, H, hd, NC, s)) != cudaSuccess)
        return err;
  }
  const long long rows = (long long)B * S * H;
  mlstm_scan_bwd_dots<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      k, dk, Cs, B, S, H, hd, NC);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mlstm_scan_bwd_dgates<<<B * H, 32, 0, s>>>(ip, fp, mo, R, Cs, di, df, S, H,
                                             NC);
  return cudaGetLastError();
}

}  // namespace

// xw: columns of M a walk warp, as the forward's plan has its rows of C
// (16, 32 or 64, hd <= 8 xw); scratch: 8 B H NC 32 floats of per-step
// values, then B H NC hd of n (each chunk's K^T w, then n before it); vec:
// hd % 4 == 0 and every pointer 16-byte aligned.
extern "C" int mlstm_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* i, const void* f,
    const void* h, const void* dh, void* dq, void* dk, void* dv, void* di,
    void* df, void* scratch, int B, int S, int H, int hd, int xw, int vec,
    void* stream) {
  if (B == 0 || S == 0 || H == 0 || hd == 0) return (int)cudaSuccess;
  if ((xw != 16 && xw != 32 && xw != 64) || W * xw < hd || hd > 512 ||
      walk_plan(xw).smem > 232448)
    return (int)cudaErrorInvalidValue;
  const float* in[7] = {(const float*)q, (const float*)k, (const float*)v,
                        (const float*)i, (const float*)f, (const float*)h,
                        (const float*)dh};
  float* out[5] = {(float*)dq, (float*)dk, (float*)dv, (float*)di,
                   (float*)df};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? bwd<true>(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                               out[0], out[1], out[2], out[3], out[4],
                               (float*)scratch, B, S, H, hd, xw, s)
                   : bwd<false>(in[0], in[1], in[2], in[3], in[4], in[5],
                                in[6], out[0], out[1], out[2], out[3], out[4],
                                (float*)scratch, B, S, H, hd, xw, s));
}
