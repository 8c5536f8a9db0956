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
// tests/torch_slstm_chunked.py.
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
#include <stdint.h>

#include <atomic>

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
// modelled step for step by tests/torch_slstm_chunked.py::
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
// gradients it carries back, x = (dc, dn, dm). It sends the carry of its
// new state to that of its incoming state by the matrix
//   [[fg, 0, 0], [0, fg, 0], [P, Q, sel]],
//   P = (1 - sel) fg c_{t-1} - sel ig tanh(z),
//   Q = (1 - sel) fg n_{t-1} - sel ig,
// plus an offset from dh. Products of such matrices keep the form
// [[a, 0, 0], [0, a, 0], [p, q, s]], so a span of steps maps the carry at
// its end to A x + b at its start by 7 numbers (a, p, q, s, b), found in
// one walk back from a zero carry (a <- fg a, p <- P a + sel p, q <- Q a +
// sel q, s <- sel s, with the old a) and no division. Time is cut into
// chunks of L = SUB W steps, each chunk into W spans of SUB steps:
//  1. slstm_scan_bwd_states, a thread per (row, chunk, unit): the chunk
//     from the zero state with the forward's step, writing its local
//     (c, n, m, G) after every SUB steps (z, i, f read once);
//  2. slstm_scan_bwd_incoming, a thread per (row, unit), serial over the
//     chunks: the forward's combine, each chunk's incoming (c, n, m);
//  3. slstm_scan_bwd_chain, a block of W warps per (row, 32 units, chunk),
//     one lane per unit and one warp per span. A block takes its chunk
//     from an atomic ticket, the last chunks in time first, so that it
//     only ever waits on blocks already resident. It copies the chunk's
//     z, i, f, o and dh into shared memory by cp.async (16-byte copies
//     where d % 4 == 0 and every pointer is aligned, else 4-byte), each
//     read from device memory once. Each warp reruns its span from its
//     incoming state (the chunk's, combined with the local state at the
//     span's start) keeping c, n, fg, ig, tanh z and sel in registers,
//     and walks it back once from a zero carry for b and (a, p, q, s),
//     writing dh's terms and do over the inputs it no longer needs. Warp
//     0 waits for the next chunk's carry at its start (zero past the
//     last), applies the W span maps from the last span (each span's end
//     carry into shared memory), and publishes the chunk's start carry:
//     the carries stored and fenced before a release of the chunk's flag,
//     the flag acquired before the carry is read. Then every warp walks
//     its span back from its end carry, the gradients staged over the
//     inputs in shared memory and stored coalesced.
// Each chunk composes only with its direct successor's published carry,
// so the order of every sum is fixed and two launches agree bit for bit.
// Three blocks share an SM (80 registers, 51 KB of shared memory each):
// the chain kernel is held by latency and bytes together, and of the
// builds tried on an H100 (PERF.md) two blocks an SM, persistent blocks
// copying the next chunk while walking one, warps copying their own rows
// and storing from registers, spans of 4 or chunks of 32 steps were all
// slower.
// The launch plan (W, copy width, scratch) comes from
// kernels/slstm_scan/ops.py::slstm_bwd_plan; the states pass zeroes the
// ticket counter and the flags on the stream every call, so the op's
// device work is its three kernels. HBM: 12 + 4 bytes an element
// (states), 36 (chain), the incoming states besides.
// Arithmetic as the forward's (no contraction, no fast math; the walks'
// fg, ig, tanh z and sel are the rerun's own values); ties of max(a, i)
// and of max(n, 1) split the gradient in halves, as jnp.maximum does. The
// spans' carries differ from the loop's by rounding, so the gradients are
// held to the plain version within a tolerance.

namespace {

constexpr int SUB = 8;                   // steps a warp walks (a span)
constexpr int WARPS_MAX = 8;             // spans a chunk, at most
constexpr int LANES = 32;                // units a block
// dynamic shared bytes of the largest plan (WARPS_MAX spans)
constexpr int MAX_SMEM = (5 * SUB + 10) * WARPS_MAX * LANES * 4;
constexpr int MAX_DEVICES = 64;          // prepare() remembers this many
// a chain wait this long (about 10 s of the SM clock) is a fault: trap
// rather than hang
constexpr long long SPIN_CYCLES = 20000000000LL;

__device__ __forceinline__ float half_at_ties(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

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

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// 1. each chunk from the zero state; its local (c, n, m, G) after every
// SUB steps into plane group j (state after min((j + 1) SUB, n) steps).
// It also zeroes the chain's nflags flags and ticket counter, which the
// chain kernel reads after it on the stream.
__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_states(const float* __restrict__ z,
                      const float* __restrict__ ip,
                      const float* __restrict__ fp, float* __restrict__ sc,
                      int* __restrict__ flags, long long nflags, int B,
                      int S, int d, int NC, int L, int W) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < nflags; e += (long long)gridDim.x * blockDim.x)
    flags[e] = 0;
  Place p;
  if (!place(p, B, S, d, NC, L)) return;
  const long long plane = (long long)B * NC * d;
  State st{0.0f, 0.0f, -INFINITY};
  float G = 0.0f;
  const int n = p.t1 - p.t0;
  for (int j = 0; j < W; ++j) {
    const int t0 = j * SUB;
    float zv[SUB], iv[SUB], fv[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      if (t0 + u < n) {
        const long long o = p.base + (long long)(t0 + u) * d;
        zv[u] = z[o];
        iv[u] = ip[o];
        fv[u] = fp[o];
      }
    }
#pragma unroll
    for (int u = 0; u < SUB; ++u)
      if (t0 + u < n) G = __fadd_rn(G, step(st, zv[u], iv[u], fv[u]));
    float* out = sc + 4LL * j * plane + p.idx;
    out[0] = st.c;
    out[plane] = st.n;
    out[2 * plane] = st.m;
    out[3 * plane] = G;
  }
}

// 2. the forward's combine over the chunks' ends (group W - 1), in place:
// each chunk's incoming (c, n, m)
__global__ void __launch_bounds__(THREADS)
slstm_scan_bwd_incoming(float* __restrict__ sc, int B, int d, int NC) {
  combine_pass(sc, B, d, NC);
}

// The incoming state of span w of chunk k: the zero state (k = w = 0),
// the chunk's incoming state X (w = 0), the local state after w SUB
// steps (k = 0: the chunk starts from the zero state), or X carried
// through that local state by the combine's update.
__device__ __forceinline__ State span_start(const float* sc, long long plane,
                                            long long idx, int k, int w,
                                            int W) {
  const float* x = sc + 4LL * (W - 1) * plane + idx;
  if (w == 0)
    return k == 0 ? State{0.0f, 0.0f, -INFINITY}
                  : State{x[0], x[plane], x[2 * plane]};
  const float* l = sc + 4LL * (w - 1) * plane + idx;
  const State loc{l[0], l[plane], l[2 * plane]};
  if (k == 0) return loc;
  const float gm = __fadd_rn(l[3 * plane], x[2 * plane]);
  const float m = tmax(gm, loc.m);
  const float a = expf(__fsub_rn(gm, m));
  const float e = expf(__fsub_rn(loc.m, m));
  return State{__fadd_rn(__fmul_rn(a, x[0]), __fmul_rn(e, loc.c)),
               __fadd_rn(__fmul_rn(a, x[plane]), __fmul_rn(e, loc.n)), m};
}

// Rows [0, n) of a chunk's 32 units of one input into a plane of L x 32
// floats (row r: step t0 + r), or the same plane back to an output;
// units past d are not copied. VEC: 16-byte copies, 8 threads a row.
template <bool VEC>
__device__ __forceinline__ void stage(float* plane, const float* x,
                                      long long base, int n, int d, int du) {
  if (VEC) {
    for (int e = threadIdx.x; e < n * 8; e += blockDim.x) {
      const int r = e >> 3, c = (e & 7) * 4;
      if (c < du) cp16(plane + r * LANES + c, x + base + (long long)r * d + c);
    }
  } else {
    for (int e = threadIdx.x; e < n * LANES; e += blockDim.x) {
      const int r = e >> 5, c = e & 31;
      if (c < du) cp4(plane + r * LANES + c, x + base + (long long)r * d + c);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void unstage(float* y, const float* plane,
                                        long long base, int n, int d,
                                        int du) {
  if (VEC) {
    for (int e = threadIdx.x; e < n * 8; e += blockDim.x) {
      const int r = e >> 3, c = (e & 7) * 4;
      if (c < du)
        *reinterpret_cast<float4*>(y + base + (long long)r * d + c) =
            *reinterpret_cast<const float4*>(plane + r * LANES + c);
    }
  } else {
    for (int e = threadIdx.x; e < n * LANES; e += blockDim.x) {
      const int r = e >> 5, c = e & 31;
      if (c < du) y[base + (long long)r * d + c] = plane[r * LANES + c];
    }
  }
}

// 3. One block of W warps per ticket; shared: the planes of z, i, f, o
// and dh (L x 32 each), then the spans' maps (7 x W x 32) and end carries
// (3 x W x 32). Scratch: sc the states (4 W planes of B NC d), carry the
// chunks' start carries (3 x 32 per (row, group, chunk)), flags one per
// (row, group, chunk), ticket the counter.
template <bool VEC>
__global__ void __launch_bounds__(LANES * WARPS_MAX, 3)
slstm_scan_bwd_chain(const float* __restrict__ z,
                     const float* __restrict__ ip,
                     const float* __restrict__ fp,
                     const float* __restrict__ op,
                     const float* __restrict__ dhp,
                     const float* __restrict__ sc, float* carry, int* flags,
                     int* ticket, float* __restrict__ dz,
                     float* __restrict__ di, float* __restrict__ df,
                     float* __restrict__ dout, int B, int S, int d, int NC,
                     int W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int tk;
  const int L = W * SUB, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // one chunk: no chain, so no ticket (nor a states pass to zero it)
  if (threadIdx.x == 0) tk = NC > 1 ? atomicAdd(ticket, 1) : (int)blockIdx.x;
  __syncthreads();
  const int G = (d + LANES - 1) / LANES;
  const long long cols = (long long)B * G, col = tk % cols;
  const int k = NC - 1 - (int)(tk / cols);
  const int b = (int)(col / G), u0 = (int)(col % G) * LANES;
  const int t0 = k * L, n = min(L, S - t0), du = d - u0;
  const long long base = ((long long)b * S + t0) * d + u0;
  float* const pz = smem;
  float* const pi = pz + L * LANES;
  float* const pf = pi + L * LANES;
  float* const po = pf + L * LANES;
  float* const pdh = po + L * LANES;
  float* const maps = pdh + L * LANES;   // field e of span v: e W + v
  float* const ends = maps + 7 * W * LANES;
  stage<VEC>(pz, z, base, n, d, du);
  stage<VEC>(pi, ip, base, n, d, du);
  stage<VEC>(pf, fp, base, n, d, du);
  cp_commit();
  stage<VEC>(po, op, base, n, d, du);
  stage<VEC>(pdh, dhp, base, n, d, du);
  cp_commit();

  const int s0 = w * SUB, ns = max(0, min(SUB, n - s0));
  State st{0.0f, 0.0f, -INFINITY};
  if (ns > 0 && lane < du)
    st = span_start(sc, (long long)B * NC * d,
                    ((long long)b * NC + k) * d + u0 + lane, k, w, W);
  float c[SUB + 1], nn[SUB + 1], fg[SUB], ig[SUB], tz[SUB], sel[SUB];
  c[0] = st.c;
  nn[0] = st.n;
  cp_wait<1>();                          // z, i, f
  __syncthreads();
#pragma unroll
  for (int u = 0; u < SUB; ++u) {        // the rerun
    fg[u] = ig[u] = tz[u] = sel[u] = 0.0f;
    if (u < ns) {
      const int r = (s0 + u) * LANES + lane;
      const float it = pi[r];
      const float lm = __fadd_rn(log_sigmoid(pf[r]), st.m);
      const float m_new = tmax(lm, it);
      fg[u] = expf(__fsub_rn(lm, m_new));
      ig[u] = expf(__fsub_rn(it, m_new));
      tz[u] = tanhf(pz[r]);
      sel[u] = half_at_ties(lm, it);
      st.c = __fadd_rn(__fmul_rn(fg[u], st.c), __fmul_rn(ig[u], tz[u]));
      st.n = __fadd_rn(__fmul_rn(fg[u], st.n), ig[u]);
      st.m = m_new;
    }
    c[u + 1] = st.c;
    nn[u + 1] = st.n;
  }
  cp_wait<0>();                          // o, dh
  __syncthreads();
  // the span's map from one walk back: (a, p, q, s) and b from a zero
  // carry; dh's terms over z and i, do over o
  float a = 1.0f, p = 0.0f, q = 0.0f, s = 1.0f, x0 = 0.0f, x1 = 0.0f,
        x2 = 0.0f;
#pragma unroll
  for (int u = SUB - 1; u >= 0; --u) {
    if (u < ns) {
      const int r = (s0 + u) * LANES + lane;
      const float so = sigmoid(po[r]), dh = pdh[r], ct = c[u + 1],
                  nt = nn[u + 1];
      const float nd = nt != nt ? nt : fmaxf(nt, 1.0f);
      const float dhs = __fmul_rn(dh, so);
      po[r] = __fmul_rn(__fmul_rn(__fdiv_rn(__fmul_rn(dh, ct), nd), so),
                        __fsub_rn(1.0f, so));
      const float e1 = __fdiv_rn(dhs, nd);
      const float e2 = __fmul_rn(__fdiv_rn(__fmul_rn(dhs, ct),
                                           __fmul_rn(nd, nd)),
                                 half_at_ties(nt, 1.0f));
      pz[r] = e1;
      pi[r] = e2;
      const float dc = __fadd_rn(x0, e1), dn = __fsub_rn(x1, e2);
      const float ga = __fmul_rn(fg[u], __fadd_rn(__fmul_rn(dc, c[u]),
                                                  __fmul_rn(dn, nn[u])));
      const float gi = __fmul_rn(ig[u], __fadd_rn(__fmul_rn(dc, tz[u]), dn));
      const float dmt = __fsub_rn(__fsub_rn(x2, ga), gi);
      x2 = __fadd_rn(ga, __fmul_rn(sel[u], dmt));
      x0 = __fmul_rn(fg[u], dc);
      x1 = __fmul_rn(fg[u], dn);
      const float fgk = __fmul_rn(__fsub_rn(1.0f, sel[u]), fg[u]);
      const float sig = __fmul_rn(sel[u], ig[u]);
      const float P = __fsub_rn(__fmul_rn(fgk, c[u]), __fmul_rn(sig, tz[u]));
      const float Q = __fsub_rn(__fmul_rn(fgk, nn[u]), sig);
      p = __fadd_rn(__fmul_rn(P, a), __fmul_rn(sel[u], p));
      q = __fadd_rn(__fmul_rn(Q, a), __fmul_rn(sel[u], q));
      s = __fmul_rn(sel[u], s);
      a = __fmul_rn(fg[u], a);
    }
  }
  {
    float* m = maps + w * LANES + lane;
    const int F = W * LANES;
    m[0] = a;
    m[F] = p;
    m[2 * F] = q;
    m[3 * F] = s;
    m[4 * F] = x0;
    m[5 * F] = x1;
    m[6 * F] = x2;
  }
  __syncthreads();
  if (w == 0) {                          // the chain
    const long long at = col * NC + k;
    float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f;
    if (k + 1 < NC) {
      const long long t_start = clock64();
      while (load_acquire(flags + at + 1) == 0)
        if (clock64() - t_start > SPIN_CYCLES) __trap();
      const float* cx = carry + (at + 1) * 3 * LANES + lane;
      y0 = __ldcg(cx);
      y1 = __ldcg(cx + LANES);
      y2 = __ldcg(cx + 2 * LANES);
    }
    const int F = W * LANES;
    for (int v = W - 1; v >= 0; --v) {
      float* e = ends + v * LANES + lane;
      e[0] = y0;
      e[F] = y1;
      e[2 * F] = y2;
      const float* m = maps + v * LANES + lane;
      const float z2 = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(m[F], y0), __fmul_rn(m[2 * F], y1)),
                    __fmul_rn(m[3 * F], y2)),
          m[6 * F]);
      y0 = __fadd_rn(__fmul_rn(m[0], y0), m[4 * F]);
      y1 = __fadd_rn(__fmul_rn(m[0], y1), m[5 * F]);
      y2 = z2;
    }
    if (k > 0) {                         // publish the chunk's start carry
      float* cx = carry + at * 3 * LANES + lane;
      __stcg(cx, y0);
      __stcg(cx + LANES, y1);
      __stcg(cx + 2 * LANES, y2);
      __threadfence();
      __syncwarp();
      if (lane == 0) store_release(flags + at, 1);
    }
  }
  __syncthreads();
  {                                      // the walk from the span's end
    const float* e = ends + w * LANES + lane;
    x0 = e[0];
    x1 = e[W * LANES];
    x2 = e[2 * W * LANES];
  }
#pragma unroll
  for (int u = SUB - 1; u >= 0; --u) {
    if (u < ns) {
      const int r = (s0 + u) * LANES + lane;
      const float dc = __fadd_rn(x0, pz[r]), dn = __fsub_rn(x1, pi[r]);
      pz[r] = __fmul_rn(__fmul_rn(dc, ig[u]),
                        __fsub_rn(1.0f, __fmul_rn(tz[u], tz[u])));
      const float ga = __fmul_rn(fg[u], __fadd_rn(__fmul_rn(dc, c[u]),
                                                  __fmul_rn(dn, nn[u])));
      const float gi = __fmul_rn(ig[u], __fadd_rn(__fmul_rn(dc, tz[u]), dn));
      const float dmt = __fsub_rn(__fsub_rn(x2, ga), gi);
      const float da = __fadd_rn(ga, __fmul_rn(sel[u], dmt));
      pi[r] = __fadd_rn(gi, __fmul_rn(__fsub_rn(1.0f, sel[u]), dmt));
      pf[r] = __fmul_rn(da, sigmoid(-pf[r]));
      x0 = __fmul_rn(fg[u], dc);
      x1 = __fmul_rn(fg[u], dn);
      x2 = da;
    }
  }
  __syncthreads();
  unstage<VEC>(dz, pz, base, n, d, du);
  unstage<VEC>(di, pi, base, n, d, du);
  unstage<VEC>(df, pf, base, n, d, du);
  unstage<VEC>(dout, po, base, n, d, du);
}

// The largest plan's dynamic shared memory (above the default 48 KB),
// set once a device for each instance of the chain kernel (`done`, one
// flag a device, is its own).
template <typename K>
cudaError_t prepare(K kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_release);
  return err;
}

std::atomic<bool> chain_vec_done[MAX_DEVICES], chain_done[MAX_DEVICES];

}  // namespace

// The plan of kernels/slstm_scan/ops.py::slstm_bwd_plan: warps spans a
// chunk, 1 <= warps <= WARPS_MAX, so chunks of SUB x warps steps and (5
// chunk + 10 warps) x 32 floats of dynamic shared memory; vec only where
// d % 4 == 0 and every pointer is 16-byte aligned. Anything else is
// refused. Scratch, in floats: the states (4 warps B NC d), the chunks'
// start carries (96 B G NC, G = ceil(d / 32)), then B G NC + 1 ints: the
// flags and the ticket counter, zeroed by the states pass every call
// (with one chunk the chain reads neither).
extern "C" int slstm_scan_bwd_launch(const void* z, const void* i,
                                     const void* f, const void* o,
                                     const void* dh, void* dz, void* di,
                                     void* df, void* dout, void* scratch,
                                     int B, int S, int d, int warps, int vec,
                                     void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  if (warps < 1 || warps > WARPS_MAX) return (int)cudaErrorInvalidValue;
  const int W = warps, L = SUB * W, NC = (S + L - 1) / L;
  const int smem = (5 * L + 10 * W) * LANES * 4;
  const int G = (d + LANES - 1) / LANES;
  const long long tickets = (long long)B * G * NC;
  if (tickets > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const void* ptrs[9] = {z, i, f, o, dh, dz, di, df, dout};
  if (vec) {
    if (d % 4 != 0) return (int)cudaErrorInvalidValue;
    for (const void* p : ptrs)
      if ((uintptr_t)p % 16 != 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const float *zp = (const float*)z, *ip = (const float*)i,
              *fp = (const float*)f, *opp = (const float*)o,
              *dhp = (const float*)dh;
  const long long plane = (long long)B * NC * d;
  float* sc = (float*)scratch;
  float* carry = sc + 4LL * W * plane;
  int* flags = (int*)(carry + 3LL * LANES * tickets);
  cudaError_t err = cudaSuccess;
  if (S > SUB) {                         // else span 0 alone, from zero
    const int blocks = (int)((plane + THREADS - 1) / THREADS);
    slstm_scan_bwd_states<<<blocks, THREADS, 0, s>>>(
        zp, ip, fp, sc, flags, tickets + 1, B, S, d, NC, L, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (NC > 1) {
    const int cb = (int)(((long long)B * d + THREADS - 1) / THREADS);
    slstm_scan_bwd_incoming<<<cb, THREADS, 0, s>>>(
        sc + 4LL * (W - 1) * plane, B, d, NC);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (vec) {
    if ((err = prepare(slstm_scan_bwd_chain<true>, chain_vec_done)) !=
        cudaSuccess)
      return (int)err;
    slstm_scan_bwd_chain<true><<<(unsigned)tickets, LANES * W, smem, s>>>(
        zp, ip, fp, opp, dhp, sc, carry, flags, flags + tickets, (float*)dz,
        (float*)di, (float*)df, (float*)dout, B, S, d, NC, W);
  } else {
    if ((err = prepare(slstm_scan_bwd_chain<false>, chain_done)) !=
        cudaSuccess)
      return (int)err;
    slstm_scan_bwd_chain<false><<<(unsigned)tickets, LANES * W, smem, s>>>(
        zp, ip, fp, opp, dhp, sc, carry, flags, flags + tickets, (float*)dz,
        (float*)di, (float*)df, (float*)dout, B, S, d, NC, W);
  }
  return (int)cudaGetLastError();
}
