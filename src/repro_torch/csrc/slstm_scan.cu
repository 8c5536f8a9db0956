// slstm_scan: xLSTM's scalar-memory cell with exponential gating over a
// whole sequence. Per (batch row, unit), from c = n = 0, m = -inf:
//   lf = logsigmoid(f_t);  m' = max(lf + m, i_t)
//   fg = exp(lf + m - m');  ig = exp(i_t - m')
//   c = fg c + ig tanh(z_t);  n = fg n + ig
//   h_t = sigmoid(o_t) c / max(n, 1)
//
// Stands in for the JAX package's lax.scan of
// src/repro/models/recurrent.py::_slstm_step inside chunked_scan (no
// Pallas kernel: XLA runs the scan there). That sLSTM has no recurrent
// weight matrix, so every unit is its own recurrence. Plain version:
// repro_torch/kernels/slstm_scan/ref.py::slstm_scan_ref; the chunked
// scan below is modelled step for step, for the CPU tests, by
// repro_torch/kernels/slstm_scan/chunked.py.
//
// Inputs: z, i, f, o (B, S, d) fp32 gate pre-activations (f with its
// bias), contiguous; output h (B, S, d) fp32; scratch from the wrapper.
//
// Bound on an H100 SXM: bytes, 20 per (b, t, unit) (four inputs read,
// one output written): at xlstm_1_3b's width (d = 2048), B = 2, S = 4096,
// 336 MB, 0.100 ms at 3.35 TB/s.
//
// Design: a chunked scan over time. One thread per (row, unit) walking
// all S steps (the first version) gives B d threads, 4,096 at xlstm_1_3b
// with B = 2, each on a dependent chain of transcendentals: latency, not
// bytes, bounded it. Given m the step is linear in (c, n), and m is a
// max-plus scan, so time is cut into chunks of L steps and each
// (row, chunk, unit) is a thread (B d S / L: 262,144 at L = 64):
//  1. slstm_scan_fwd_local: each chunk from the zero state with the
//     step's own arithmetic; writes its end (c, n, m) and G, the sum of
//     logsigmoid(f) over the chunk.
//  2. slstm_scan_fwd_combine, one thread per (row, unit), serial over
//     the S / L chunks: each chunk's incoming state, by the step's own
//     update (m = max(G + m_prev, m_loc); c = exp((G + m_prev) - m)
//     c_prev + exp(m_loc - m) c_loc; n likewise), written over the
//     chunk's local state.
//  3. slstm_scan_fwd_apply: each chunk again from its incoming state
//     (the zero state for the first), writing h.
// With one chunk (S <= L) only pass 3 runs. Passes 1 and 3 read the
// gates twice (z, i, f, then all four): 32 bytes an element instead of
// 20. Neighbouring threads take neighbouring units, so every access of
// a step is coalesced; the next U steps' inputs are loaded into
// registers before they are run.
// Parity: every product and sum rounds as the plain version's separate
// torch ops (__fmul_rn / __fadd_rn / __fdiv_rn, no contraction);
// logsigmoid, sigmoid and tanh are written as torch's CUDA kernels write
// them (min(x, 0) - log1p(exp(-|x|)), 1 / (1 + exp(-x)), tanhf), and
// max/clamp propagate NaN as torch's do. No fast math. The first chunk
// runs exactly as the plain loop; later chunks start from a state that
// differs from the loop's by rounding (from a chunk's first step on
// n >= 1, so the clamp does not bind and a boundary m off by rounding
// rescales c and n alike), and the libm calls need not round as
// torch's build does, so h is held to the plain version within a
// tolerance, not bitwise.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 8;                     // time steps prefetched per batch

__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || a > b) ? a : b;      // torch.maximum
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return __fsub_rn(fminf(0.0f, x), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

struct State {
  float c, n, m;
};

// one step of the cell; returns log-sigmoid(f) for the chunk's sum
__device__ __forceinline__ float step(State& st, float z, float i, float f) {
  const float lsf = log_sigmoid(f);
  const float lm = __fadd_rn(lsf, st.m);
  const float m_new = tmax(lm, i);
  const float fg = expf(__fsub_rn(lm, m_new));
  const float ig = expf(__fsub_rn(i, m_new));
  st.c = __fadd_rn(__fmul_rn(fg, st.c), __fmul_rn(ig, tanhf(z)));
  st.n = __fadd_rn(__fmul_rn(fg, st.n), ig);
  st.m = m_new;
  return lsf;
}

// thread -> (row b, chunk k, unit u) with units fastest; steps [t0, t1)
struct Place {
  long long base;                        // element (b, t0, u)
  long long idx;                         // (b, k, u) in the scratch
  int t0, t1;
};

__device__ __forceinline__ bool place(Place& p, int B, int S, int d,
                                      int NC, int chunk) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * NC * d) return false;
  const long long u = idx % d, bk = idx / d;
  const int k = (int)(bk % NC);
  const long long b = bk / NC;
  p.idx = idx;
  p.t0 = k * chunk;
  p.t1 = min(p.t0 + chunk, S);
  p.base = (b * S + p.t0) * d + u;
  return true;
}

__device__ __forceinline__ void local_pass(const float* __restrict__ z,
                                           const float* __restrict__ ip,
                                           const float* __restrict__ fp,
                                           float* __restrict__ sc, int B,
                                           int S, int d, int NC, int chunk) {
  Place p;
  if (!place(p, B, S, d, NC, chunk)) return;
  State st{0.0f, 0.0f, -INFINITY};
  float G = 0.0f;
  const int n = p.t1 - p.t0;
  for (int t0 = 0; t0 < n; t0 += U) {
    float zv[U], iv[U], fv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < n) {
        const long long o = p.base + (long long)(t0 + u) * d;
        zv[u] = z[o];
        iv[u] = ip[o];
        fv[u] = fp[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (t0 + u < n) G = __fadd_rn(G, step(st, zv[u], iv[u], fv[u]));
  }
  const long long plane = (long long)B * NC * d;
  sc[p.idx] = st.c;
  sc[plane + p.idx] = st.n;
  sc[2 * plane + p.idx] = st.m;
  sc[3 * plane + p.idx] = G;
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_fwd_local(const float* __restrict__ z, const float* __restrict__ ip,
                     const float* __restrict__ fp, float* __restrict__ sc,
                     int B, int S, int d, int NC, int chunk) {
  local_pass(z, ip, fp, sc, B, S, d, NC, chunk);
}

// chunks' local states are read U at a time, before the serial updates
// that need them
__device__ __forceinline__ void combine_pass(float* __restrict__ sc, int B,
                                             int d, int NC) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * d) return;
  const long long b = idx / d, u = idx % d;
  const long long plane = (long long)B * NC * d;
  float c = 0.0f, n = 0.0f, m = -INFINITY;
  for (int k0 = 0; k0 < NC; k0 += U) {
    float cl[U], nl[U], ml[U], G[U];
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (k0 + e < NC) {
        const long long o = (b * NC + k0 + e) * d + u;
        cl[e] = sc[o];
        nl[e] = sc[plane + o];
        ml[e] = sc[2 * plane + o];
        G[e] = sc[3 * plane + o];
      }
    }
#pragma unroll
    for (int e = 0; e < U; ++e) {
      if (k0 + e < NC) {
        const long long o = (b * NC + k0 + e) * d + u;
        sc[o] = c;                       // the chunk's incoming state
        sc[plane + o] = n;
        sc[2 * plane + o] = m;
        const float gm = __fadd_rn(G[e], m);
        const float m_new = tmax(gm, ml[e]);
        const float a = expf(__fsub_rn(gm, m_new));
        const float x = expf(__fsub_rn(ml[e], m_new));
        c = __fadd_rn(__fmul_rn(a, c), __fmul_rn(x, cl[e]));
        n = __fadd_rn(__fmul_rn(a, n), __fmul_rn(x, nl[e]));
        m = m_new;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_fwd_combine(float* __restrict__ sc, int B, int d, int NC) {
  combine_pass(sc, B, d, NC);
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_fwd_apply(const float* __restrict__ z,
                     const float* __restrict__ ip,
                     const float* __restrict__ fp,
                     const float* __restrict__ op,
                     const float* __restrict__ sc, float* __restrict__ h,
                     int B, int S, int d, int NC, int chunk) {
  Place p;
  if (!place(p, B, S, d, NC, chunk)) return;
  State st{0.0f, 0.0f, -INFINITY};
  if (p.t0 > 0) {
    const long long plane = (long long)B * NC * d;
    st = State{sc[p.idx], sc[plane + p.idx], sc[2 * plane + p.idx]};
  }
  const int n = p.t1 - p.t0;
  for (int t0 = 0; t0 < n; t0 += U) {
    float zv[U], iv[U], fv[U], ov[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < n) {
        const long long o = p.base + (long long)(t0 + u) * d;
        zv[u] = z[o];
        iv[u] = ip[o];
        fv[u] = fp[o];
        ov[u] = op[o];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u < n) {
        step(st, zv[u], iv[u], fv[u]);
        const float den = st.n != st.n ? st.n : fmaxf(st.n, 1.0f);
        h[p.base + (long long)(t0 + u) * d] =
            __fdiv_rn(__fmul_rn(sigmoid(ov[u]), st.c), den);
      }
    }
  }
}

}  // namespace

// chunk: steps per chunk (kernels/slstm_scan/ops.py::CHUNK);
// scratch: 4 B NC d floats, NC = ceil(S / chunk) (unused when NC = 1).
extern "C" int slstm_scan_launch(const void* z, const void* i, const void* f,
                                 const void* o, void* h, void* scratch, int B,
                                 int S, int d, int chunk, void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int NC = (S + chunk - 1) / chunk;
  cudaStream_t s = (cudaStream_t)stream;
  const float *zp = (const float*)z, *ip = (const float*)i,
              *fp = (const float*)f, *opp = (const float*)o;
  float* sc = (float*)scratch;
  const long long work = (long long)B * NC * d;
  const int blocks = (int)((work + THREADS - 1) / THREADS);
  if (NC > 1) {
    slstm_scan_fwd_local<<<blocks, THREADS, 0, s>>>(zp, ip, fp, sc, B, S, d,
                                                    NC, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int cb = (int)(((long long)B * d + THREADS - 1) / THREADS);
    slstm_scan_fwd_combine<<<cb, THREADS, 0, s>>>(sc, B, d, NC);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  slstm_scan_fwd_apply<<<blocks, THREADS, 0, s>>>(zp, ip, fp, opp, sc,
                                                  (float*)h, B, S, d, NC,
                                                  chunk);
  return (int)cudaGetLastError();
}

// ============================================================================
// slstm_scan_bwd: the recurrence's backward. Plain version:
// repro_torch/kernels/slstm_scan/ref.py::slstm_scan_bwd_ref (a loop back in
// time, one step of it ref.py::slstm_bwd_step); the chunked scan below is
// modelled step for step by repro_torch/kernels/slstm_scan/chunked.py::
// slstm_chunked_bwd. Stands in for jax.grad of the JAX package's lax.scan
// of _slstm_step.
//
// Inputs: z, i, f, o as the forward's and dh, h's gradient (B, S, d) fp32;
// outputs dz, di, df, do (B, S, d).
//
// Bound on an H100 SXM: bytes, 36 per (b, t, unit) (five inputs read, four
// outputs written): at xlstm_1_3b's width, B = 2, S = 4096, 604 MB, 0.180
// ms at 3.35 TB/s.
//
// Design: given the states, a step of the backward is linear in the
// gradients it carries back, (dc, dn, dm), so the forward's chunked scan
// over time runs backwards, in chunks of BC = 16 steps, a thread per
// (row, chunk, unit):
//  1. slstm_scan_bwd_states and slstm_scan_bwd_incoming, the forward's
//     local pass and combine at BC: each chunk's incoming (c, n, m);
//  2. slstm_scan_bwd_local: each chunk's states rerun from its incoming
//     state into registers, then walked back from a zero carry with dh
//     (b) and from each unit carry without it (the columns of A): the
//     chunk maps the carry x at its end to A x + b at its start;
//  3. slstm_scan_bwd_combine, a thread per (row, unit), serial from the
//     last chunk: x_{c-1} = A_c x_c + b_c from x = 0, each chunk's x kept;
//  4. slstm_scan_bwd_apply: each chunk rerun and walked back from its x,
//     writing the gradients.
// With one chunk only pass 4 runs. The inputs are read from device memory
// three times (passes 1, 2 and 4): 13 floats an element in, 4 out.
// Arithmetic as the forward's (no contraction, no fast math); ties of
// max(a, i) and of max(n, 1) split the gradient in halves, as
// jnp.maximum does. The chunks' carries differ from the loop's by
// rounding, so the gradients are held to the plain version within a
// tolerance.

namespace {

constexpr int BC = 16;                   // steps per backward chunk

__device__ __forceinline__ float half_at_ties(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// 1. the forward's passes at BC, under the backward's names
__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_states(const float* __restrict__ z,
                      const float* __restrict__ ip,
                      const float* __restrict__ fp, float* __restrict__ sc,
                      int B, int S, int d, int NC) {
  local_pass(z, ip, fp, sc, B, S, d, NC, BC);
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_incoming(float* __restrict__ sc, int B, int d, int NC) {
  combine_pass(sc, B, d, NC);
}

// one step's coefficients, from its incoming state p and new state s
struct Coef {
  float fg, ig, tz, so, nd, mu, sel, sgf, cp, np, c;
};

__device__ __forceinline__ Coef coef(const State& p, const State& s, float z,
                                     float i, float f, float o) {
  Coef k;
  const float a = __fadd_rn(log_sigmoid(f), p.m);
  k.fg = expf(__fsub_rn(a, s.m));
  k.ig = expf(__fsub_rn(i, s.m));
  k.tz = tanhf(z);
  k.so = sigmoid(o);
  k.nd = s.n != s.n ? s.n : fmaxf(s.n, 1.0f);
  k.mu = half_at_ties(s.n, 1.0f);
  k.sel = half_at_ties(a, i);
  k.sgf = sigmoid(-f);
  k.cp = p.c;
  k.np = p.n;
  k.c = s.c;
  return k;
}

struct Carry {
  float dc, dn, dm;
};

// one step back: the carry of the incoming state from the new state's;
// the gradients (dz, di, df, do) into g
__device__ __forceinline__ void back(const Coef& k, float dh, Carry& x,
                                     float (&g)[4]) {
  const float dhs = __fmul_rn(dh, k.so);
  g[3] = __fmul_rn(__fmul_rn(__fdiv_rn(__fmul_rn(dh, k.c), k.nd), k.so),
                   __fsub_rn(1.0f, k.so));
  const float dc = __fadd_rn(x.dc, __fdiv_rn(dhs, k.nd));
  const float dn = __fsub_rn(
      x.dn, __fmul_rn(__fdiv_rn(__fmul_rn(dhs, k.c), __fmul_rn(k.nd, k.nd)),
                      k.mu));
  g[0] = __fmul_rn(__fmul_rn(dc, k.ig),
                   __fsub_rn(1.0f, __fmul_rn(k.tz, k.tz)));
  const float ga = __fmul_rn(k.fg, __fadd_rn(__fmul_rn(dc, k.cp),
                                             __fmul_rn(dn, k.np)));
  const float gi = __fmul_rn(k.ig, __fadd_rn(__fmul_rn(dc, k.tz), dn));
  const float dmt = __fsub_rn(__fsub_rn(x.dm, ga), gi);
  const float da = __fadd_rn(ga, __fmul_rn(k.sel, dmt));
  g[1] = __fadd_rn(gi, __fmul_rn(__fsub_rn(1.0f, k.sel), dmt));
  g[2] = __fmul_rn(da, k.sgf);
  x = Carry{__fmul_rn(k.fg, dc), __fmul_rn(k.fg, dn), da};
}

// a chunk's states into registers: st[u] before step t0 + u
__device__ __forceinline__ void rerun(const Place& p, const float* sc,
                                      long long plane, const float* z,
                                      const float* ip, const float* fp,
                                      int d, State (&st)[BC + 1],
                                      float (&zv)[BC], float (&iv)[BC],
                                      float (&fv)[BC]) {
  st[0] = State{0.0f, 0.0f, -INFINITY};
  if (p.t0 > 0)
    st[0] = State{sc[p.idx], sc[plane + p.idx], sc[2 * plane + p.idx]};
  const int n = p.t1 - p.t0;
#pragma unroll
  for (int u = 0; u < BC; ++u) {
    st[u + 1] = st[u];
    if (u < n) {
      const long long o = p.base + (long long)u * d;
      zv[u] = z[o];
      iv[u] = ip[o];
      fv[u] = fp[o];
      step(st[u + 1], zv[u], iv[u], fv[u]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_local(const float* __restrict__ z, const float* __restrict__ ip,
                     const float* __restrict__ fp, const float* __restrict__ op,
                     const float* __restrict__ dh,
                     const float* __restrict__ sc, float* __restrict__ mp,
                     int B, int S, int d, int NC) {
  Place p;
  if (!place(p, B, S, d, NC, BC)) return;
  const long long plane = (long long)B * NC * d;
  State st[BC + 1];
  float zv[BC], iv[BC], fv[BC];
  rerun(p, sc, plane, z, ip, fp, d, st, zv, iv, fv);
  Carry b{0.0f, 0.0f, 0.0f}, cols[3] = {{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                                       {0.0f, 0.0f, 1.0f}};
  float g[4];
  const int n = p.t1 - p.t0;
#pragma unroll
  for (int u = BC - 1; u >= 0; --u) {
    if (u < n) {
      const long long o = p.base + (long long)u * d;
      const Coef k = coef(st[u], st[u + 1], zv[u], iv[u], fv[u], op[o]);
      back(k, dh[o], b, g);
#pragma unroll
      for (int j = 0; j < 3; ++j) back(k, 0.0f, cols[j], g);
    }
  }
  const float m[12] = {cols[0].dc, cols[0].dn, cols[0].dm,
                       cols[1].dc, cols[1].dn, cols[1].dm,
                       cols[2].dc, cols[2].dn, cols[2].dm, b.dc, b.dn, b.dm};
#pragma unroll
  for (int e = 0; e < 12; ++e) mp[e * plane + p.idx] = m[e];
}

// each chunk's carry at its end into ce (3 planes), from the last chunk
__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_combine(const float* __restrict__ mp, float* __restrict__ ce,
                       int B, int d, int NC) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * d) return;
  const long long b = idx / d, u = idx % d;
  const long long plane = (long long)B * NC * d;
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  for (int c = NC - 1; c >= 0; --c) {
    const long long o = (b * NC + c) * d + u;
    ce[o] = x0;
    ce[plane + o] = x1;
    ce[2 * plane + o] = x2;
    float m[12];
#pragma unroll
    for (int e = 0; e < 12; ++e) m[e] = mp[e * plane + o];
    const float y0 = __fadd_rn(__fadd_rn(__fadd_rn(m[9], __fmul_rn(m[0], x0)),
                                         __fmul_rn(m[3], x1)),
                               __fmul_rn(m[6], x2));
    const float y1 = __fadd_rn(__fadd_rn(__fadd_rn(m[10], __fmul_rn(m[1], x0)),
                                         __fmul_rn(m[4], x1)),
                               __fmul_rn(m[7], x2));
    const float y2 = __fadd_rn(__fadd_rn(__fadd_rn(m[11], __fmul_rn(m[2], x0)),
                                         __fmul_rn(m[5], x1)),
                               __fmul_rn(m[8], x2));
    x0 = y0;
    x1 = y1;
    x2 = y2;
  }
}

__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_apply(const float* __restrict__ z, const float* __restrict__ ip,
                     const float* __restrict__ fp, const float* __restrict__ op,
                     const float* __restrict__ dh,
                     const float* __restrict__ sc, const float* __restrict__ ce,
                     float* __restrict__ dz, float* __restrict__ di,
                     float* __restrict__ df, float* __restrict__ dout, int B,
                     int S, int d, int NC) {
  Place p;
  if (!place(p, B, S, d, NC, BC)) return;
  const long long plane = (long long)B * NC * d;
  State st[BC + 1];
  float zv[BC], iv[BC], fv[BC];
  rerun(p, sc, plane, z, ip, fp, d, st, zv, iv, fv);
  Carry x{0.0f, 0.0f, 0.0f};
  if (NC > 1) x = Carry{ce[p.idx], ce[plane + p.idx], ce[2 * plane + p.idx]};
  float g[4];
  const int n = p.t1 - p.t0;
#pragma unroll
  for (int u = BC - 1; u >= 0; --u) {
    if (u < n) {
      const long long o = p.base + (long long)u * d;
      back(coef(st[u], st[u + 1], zv[u], iv[u], fv[u], op[o]), dh[o], x, g);
      dz[o] = g[0];
      di[o] = g[1];
      df[o] = g[2];
      dout[o] = g[3];
    }
  }
}

}  // namespace

// scratch: 19 B NC d floats, NC = ceil(S / 16): the forward's 4 planes,
// the chunks' maps (12) and carries (3); unused when NC = 1.
extern "C" int slstm_scan_bwd_launch(const void* z, const void* i,
                                     const void* f, const void* o,
                                     const void* dh, void* dz, void* di,
                                     void* df, void* dout, void* scratch,
                                     int B, int S, int d, void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  const int NC = (S + BC - 1) / BC;
  cudaStream_t s = (cudaStream_t)stream;
  const float *zp = (const float*)z, *ip = (const float*)i,
              *fp = (const float*)f, *opp = (const float*)o,
              *dhp = (const float*)dh;
  const long long plane = (long long)B * NC * d;
  float* sc = (float*)scratch;
  float *mp = sc + 4 * plane, *ce = mp + 12 * plane;
  const int blocks = (int)((plane + THREADS - 1) / THREADS);
  cudaError_t err;
  if (NC > 1) {
    slstm_scan_bwd_states<<<blocks, THREADS, 0, s>>>(zp, ip, fp, sc, B, S,
                                                     d, NC);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int cb = (int)(((long long)B * d + THREADS - 1) / THREADS);
    slstm_scan_bwd_incoming<<<cb, THREADS, 0, s>>>(sc, B, d, NC);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    slstm_scan_bwd_local<<<blocks, THREADS, 0, s>>>(zp, ip, fp, opp, dhp, sc,
                                                    mp, B, S, d, NC);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    slstm_scan_bwd_combine<<<cb, THREADS, 0, s>>>(mp, ce, B, d, NC);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  slstm_scan_bwd_apply<<<blocks, THREADS, 0, s>>>(
      zp, ip, fp, opp, dhp, sc, ce, (float*)dz, (float*)di, (float*)df,
      (float*)dout, B, S, d, NC);
  return (int)cudaGetLastError();
}
