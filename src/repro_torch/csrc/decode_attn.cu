// decode_attn: one decode token of grouped-query attention over a bf16
// KV ring, in one launch a layer: RoPE of q and k, the write of k and v
// to slot pos % C of the caches (in place), fp32 scores over the valid
// slots, an fp32 softmax whose probabilities are rounded to bf16, and the
// value product accumulated in fp32 and rounded once to bf16, in the
// (B, H hd) layout the output product takes.
//
// Replaces no TPU kernel: the JAX package's attention_decode
// (src/repro/models/attention.py) is plain jnp, which XLA fuses. The
// port's plain version, decode_attn_plain in
// repro_torch/models/attention.py (apply_rope of q and k, the cache
// write, the mask and _sdpa), launches about 52 PyTorch kernels a layer
// at one token, most of them a few kilobytes: RoPE rebuilds its
// frequencies and runs cos, sin, the strided halves' products, stack,
// cat and casts; the caches are cast to fp32 whole for the scores.
//
// Semantics, as the plain version computes them:
//   q', k' = bf16(rope(q)), bf16(rope(k)): the pair (x[2i], x[2i + 1]),
//     i < rot / 2, turns by the angle float(pos) * freqs[i] (fp32), each
//     product rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn: no
//     contraction into an fma, as the unfused PyTorch ops), cosf and sinf
//     as torch.cos and torch.sin; elements from rot on pass through (rot
//     = hd for "full", hd / 2 for "2d", 0 for "none");
//   cache_k[b, pos % C, kh] = k', cache_v[b, pos % C, kh] = v;
//   s[j, t] = (sum_h q'[j, h] k[t, h]) * scale in fp32, for the n =
//     min(pos + 1, C) valid slots t < n: the full-attention rule
//     (t <= pos) and the local-window rule ((t <= pos % C) | (pos >= C))
//     both keep exactly those, and a masked slot adds exp(-1e30 - m) = 0
//     to the plain version's sums;
//   p[j, t] = bf16(exp(s - max) / sum exp(s - max)) as _sdpa's
//     softmax(...).to(v.dtype);
//   out[j, h] = bf16(sum_t p[j, t] v[t, h]), the sum in fp32.
// Only the order of the fp32 sums differs from the plain version.
//
// Bound on an H100 SXM: bytes. Each valid slot's K and V rows are read
// once: at internlm2_1_8b's decode (B=16, 8 KV heads of 128, ring 128)
// 8.4 MB a layer, 2.5 us at 3.35 TB/s; the rest is a few kilobytes.
//
// Design: a block of 128 threads per (row, KV head, chunk of the ring).
// It stages its slots' K and V rows in shared memory with cp.async, 16
// bytes a thread, every row in flight at once (the new slot's row is not
// staged: the block writes k' and v there itself), while it rotates the
// group's queries into shared memory. Scores: a row's hd / 8 threads
// each hold 16 bytes of it, dot them with the group's queries held in
// registers (TILE heads at a time) and reduce by shuffles, so each K row
// is read once for all the group's heads. The scores and probabilities
// stay in shared memory. The value product: each thread owns 8 columns
// of a slice of the slots, accumulates TILE heads in registers, and the
// slices are summed by shuffles and then across warps in a fixed order.
// A ring of up to 256 slots that fits in shared memory takes one block
// per (row, KV head) and one launch. A longer ring is cut into chunks
// (decode_plan in kernels/decode_attn/ops.py): the first pass writes
// each chunk's scores with their max and sum of exp, the second takes
// the global max and sum, rounds each chunk's probabilities, sums its
// value rows, and the last chunk's block of each (row, KV head) to
// finish (by an atomic ticket, which the first pass resets) adds the
// chunks' fp32 sums in chunk order. Every sum is taken in a fixed order:
// the kernel is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 16;            // query heads a KV head
constexpr int MAX_SMEM = 232448;         // bytes a block can have (H100)
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* q;          // (B, H, hd): the step's queries, before RoPE
  const bf16* k;          // (B, KV, hd): its keys, before RoPE
  const bf16* v;          // (B, KV, hd)
  bf16* cache_k;          // (B, C, KV, hd)
  bf16* cache_v;          // (B, C, KV, hd)
  const long long* pos;   // pos[b * pos_stride]
  const float* freqs;     // (rot / 2,); unused at rot 0
  bf16* out;              // (B, H hd)
  float* scores;          // chunked: (B, KV, g, C) scaled scores
  float* stats;           // chunked: (B, KV, n_chunks, g, 2) max, sum
  float* partial;         // chunked: (B, KV, n_chunks, g, hd) value sums
  unsigned* tickets;      // chunked: (B, KV) chunks done
  int pos_stride, kv, g, c, rot, chunk, n_chunks;
  float scale;
};

// The block's row b, KV head kh, the slot it writes, the n valid slots
// and its chunk's share [t0, t1) of them.
struct Span {
  int b, kh, slot, n, t0, t1;
  float pf;               // the position in fp32, as positions.float()
};

__device__ __forceinline__ Span span_of(const Args& a) {
  Span s;
  s.b = blockIdx.z;
  s.kh = blockIdx.y;
  const long long p = a.pos[(long long)s.b * a.pos_stride];
  s.slot = (int)(p % a.c);
  s.n = p + 1 < a.c ? (int)(p + 1) : a.c;
  s.t0 = blockIdx.x * a.chunk;
  s.t1 = min(s.t0 + a.chunk, s.n);
  s.pf = __ll2float_rn(p);
  return s;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Rows [t0, t1) of one (row, KV head) ring, whose rows lie kv * HD
// elements apart from `ring`, into `dst` (rows of HD), but `skip`.
template <int HD>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* ring,
                                           int kv, int t0, int t1,
                                           int skip) {
  constexpr int VEC = HD / 8;            // 16-byte vectors a row
  const int n = (t1 - t0) * VEC;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / VEC, c = i - r * VEC;
    if (t0 + r != skip)
      cp16(dst + r * HD + c * 8, ring + (long long)(t0 + r) * kv * HD + c * 8);
  }
}

// apply_rope's turn of the pair (x0, x1) = (x[2i], x[2i + 1]) by the
// angle pf * f, each product rounded on its own, both results rounded to
// bf16 (yr.to(x.dtype)).
__device__ __forceinline__ void rope_pair(float pf, float f, float& x0,
                                          float& x1) {
  const float ang = __fmul_rn(pf, f);
  const float c = cosf(ang), s = sinf(ang);
  const float y0 = __fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s));
  const float y1 = __fadd_rn(__fmul_rn(x1, c), __fmul_rn(x0, s));
  x0 = bf16_round(y0);
  x1 = bf16_round(y1);
}

// The group's g queries rotated, in fp32, into qs (g rows of HD).
template <int HD>
__device__ __forceinline__ void rope_queries(const Args& a, const Span& s,
                                             float* qs) {
  const bf16* q = a.q + ((long long)s.b * a.kv + s.kh) * a.g * HD;
  for (int i = threadIdx.x; i < a.g * HD / 2; i += THREADS) {
    const int e = 2 * i, d = e % HD;
    float2 x = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(q + e));
    if (d < a.rot) rope_pair(s.pf, a.freqs[d / 2], x.x, x.y);
    qs[e] = x.x;
    qs[e + 1] = x.y;
  }
}

// k' and v into slot pos % C of the caches and, where given, into the
// block's staged rows of that slot.
template <int HD>
__device__ __forceinline__ void write_slot(const Args& a, const Span& s,
                                           bf16* ks, bf16* vs) {
  const long long src = ((long long)s.b * a.kv + s.kh) * HD;
  const long long dst = (((long long)s.b * a.c + s.slot) * a.kv + s.kh) * HD;
  for (int i = threadIdx.x; i < HD / 2; i += THREADS) {
    const int e = 2 * i;
    __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(a.k + src + e);
    if (e < a.rot) {
      float2 x = __bfloat1622float2(y);
      rope_pair(s.pf, a.freqs[e / 2], x.x, x.y);
      y = __floats2bfloat162_rn(x.x, x.y);   // exact: both are bf16 values
    }
    const __nv_bfloat162 w =
        *reinterpret_cast<const __nv_bfloat162*>(a.v + src + e);
    *reinterpret_cast<__nv_bfloat162*>(a.cache_k + dst + e) = y;
    *reinterpret_cast<__nv_bfloat162*>(a.cache_v + dst + e) = w;
    if (ks) *reinterpret_cast<__nv_bfloat162*>(ks + e) = y;
    if (vs) *reinterpret_cast<__nv_bfloat162*>(vs + e) = w;
  }
}

// ss[j, t] = (q'[j] . k[t]) * scale for the n staged rows, j < g, ss's
// rows `chunk` apart. A row's HD / 8 threads hold 16 bytes of it each.
template <int HD, int TILE>
__device__ __forceinline__ void score_rows(const Args& a, const bf16* ks,
                                           const float* qs, float* ss,
                                           int n) {
  constexpr int TPR = HD / 8, RPP = THREADS / TPR;
  const int lr = threadIdx.x % TPR, r0 = threadIdx.x / TPR;
  const int passes = (n + RPP - 1) / RPP;  // the same in every thread
  for (int j0 = 0; j0 < a.g; j0 += TILE) {
    float qr[TILE][8];
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj) {
      const bool on = j0 + jj < a.g;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qr[jj][e] = on ? qs[(j0 + jj) * HD + lr * 8 + e] : 0.f;
    }
    for (int it = 0; it < passes; ++it) {
      const int r = it * RPP + r0;
      float kf[8];
      if (r < n) {
        unpack8(*reinterpret_cast<const uint4*>(ks + r * HD + lr * 8), kf);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
      float d[TILE];
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        d[jj] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d[jj] = fmaf(qr[jj][e], kf[e], d[jj]);
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int jj = 0; jj < TILE; ++jj)
          d[jj] += __shfl_xor_sync(FULL, d[jj], off);
      }
      if (lr == 0 && r < n) {
#pragma unroll
        for (int jj = 0; jj < TILE; ++jj)
          if (j0 + jj < a.g)
            ss[(j0 + jj) * a.chunk + r] = __fmul_rn(d[jj], a.scale);
      }
    }
  }
}

// out[j, h] = sum over the n staged rows t of p[j, t] v[t, h] in fp32,
// j < g; emit(j, h, sum) takes each. Thread (sg, cg) owns columns
// [8 cg, 8 cg + 8) of the rows t = sg mod NSG; red holds the warps'
// sums (WARPS x TILE x HD fp32), added in warp order.
template <int HD, int TILE, typename Emit>
__device__ __forceinline__ void value_rows(const bf16* vs, const float* ss,
                                           int chunk, int g, int n,
                                           float* red, Emit emit) {
  constexpr int NCG = HD / 8, NSG = THREADS / NCG;
  const int cg = threadIdx.x % NCG, sg = threadIdx.x / NCG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j0 = 0; j0 < g; j0 += TILE) {
    float acc[TILE][8];
#pragma unroll
    for (int jj = 0; jj < TILE; ++jj)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[jj][e] = 0.f;
    for (int t = sg; t < n; t += NSG) {
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(vs + t * HD + cg * 8), vf);
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        const float p = j0 + jj < g ? ss[(j0 + jj) * chunk + t] : 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[jj][e] = fmaf(p, vf[e], acc[jj][e]);
      }
    }
    // the warp's slices of the slots: lanes NCG apart share columns
#pragma unroll
    for (int off = 16; off >= NCG; off >>= 1) {
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[jj][e] += __shfl_xor_sync(FULL, acc[jj][e], off);
    }
    if (lane < NCG) {
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          red[(warp * TILE + jj) * HD + cg * 8 + e] = acc[jj][e];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TILE * HD; i += THREADS) {
      const int jj = i / HD, h = i - jj * HD;
      if (j0 + jj < g) {
        float sum = red[jj * HD + h];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += red[(w * TILE + jj) * HD + h];
        emit(j0 + jj, h, sum);
      }
    }
    __syncthreads();
  }
}

// One (row, KV head, chunk). Alone (n_chunks == 1): the whole decode
// attention of the group. Chunked: the first pass, the chunk's scores
// with their max and sum of exp.
template <int HD, int TILE>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Span s = span_of(a);
  const bool chunked = a.n_chunks > 1;
  const long long bk = (long long)s.b * a.kv + s.kh;
  if (chunked && blockIdx.x == 0 && threadIdx.x == 0) a.tickets[bk] = 0u;
  if (s.t0 >= s.n) return;               // a chunk past the valid slots
  const int n = s.t1 - s.t0;
  const int rows = a.chunk * HD;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + rows;                  // alone only
  float* qs = reinterpret_cast<float*>(vs + (chunked ? 0 : rows));
  float* red = qs + a.g * HD;            // alone only
  float* ss = red + (chunked ? 0 : WARPS * TILE * HD);
  const long long ring = ((long long)s.b * a.c * a.kv + s.kh) * HD;
  stage_rows<HD>(ks, a.cache_k + ring, a.kv, s.t0, s.t1, s.slot);
  cp_commit();
  if (!chunked) stage_rows<HD>(vs, a.cache_v + ring, a.kv, s.t0, s.t1, s.slot);
  cp_commit();
  rope_queries<HD>(a, s, qs);
  if (s.slot >= s.t0 && s.slot < s.t1)
    write_slot<HD>(a, s, ks + (s.slot - s.t0) * HD,
                   chunked ? nullptr : vs + (s.slot - s.t0) * HD);
  cp_wait<1>();                          // the K rows
  __syncthreads();
  score_rows<HD, TILE>(a, ks, qs, ss, n);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (chunked) {
    float* sc = a.scores + bk * a.g * a.c + s.t0;
    for (int i = threadIdx.x; i < a.g * n; i += THREADS) {
      const int j = i / n, r = i - j * n;
      sc[(long long)j * a.c + r] = ss[j * a.chunk + r];
    }
    for (int j = warp; j < a.g; j += WARPS) {
      const float* x = ss + j * a.chunk;
      float m = -INFINITY;
      for (int t = lane; t < n; t += 32) m = fmaxf(m, x[t]);
      m = warp_max(m);
      float l = 0.f;
      for (int t = lane; t < n; t += 32) l += expf(__fsub_rn(x[t], m));
      l = warp_sum(l);
      if (lane == 0) {
        float* st = a.stats + ((bk * a.n_chunks + blockIdx.x) * a.g + j) * 2;
        st[0] = m;
        st[1] = l;
      }
    }
    return;
  }
  // softmax over the n slots, one warp a head, probabilities in bf16
  for (int j = warp; j < a.g; j += WARPS) {
    float* x = ss + j * a.chunk;
    float m = -INFINITY;
    for (int t = lane; t < n; t += 32) m = fmaxf(m, x[t]);
    m = warp_max(m);
    float l = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float e = expf(__fsub_rn(x[t], m));
      x[t] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int t = lane; t < n; t += 32) x[t] = bf16_round(__fdiv_rn(x[t], l));
  }
  cp_wait<0>();                          // the V rows
  __syncthreads();
  bf16* out = a.out + bk * a.g * HD;
  value_rows<HD, TILE>(vs, ss, a.chunk, a.g, n, red,
                       [&](int j, int h, float x) {
                         out[j * HD + h] = __float2bfloat16_rn(x);
                       });
}

// The second pass of a chunked ring: the global max and sum of each
// head, the chunk's probabilities and value sums; the last of the (row,
// KV head)'s chunks to finish adds the chunks' sums in chunk order.
template <int HD, int TILE>
__global__ void __launch_bounds__(THREADS)
decode_attn_values_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float ml[2 * MAX_GROUP];
  __shared__ bool last;
  const Span s = span_of(a);
  if (s.t0 >= s.n) return;
  const int n = s.t1 - s.t0;
  const int active = (s.n + a.chunk - 1) / a.chunk;
  const long long bk = (long long)s.b * a.kv + s.kh;
  bf16* vs = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(vs + a.chunk * HD);
  float* ss = red + WARPS * TILE * HD;
  stage_rows<HD>(vs, a.cache_v + ((long long)s.b * a.c * a.kv + s.kh) * HD,
                 a.kv, s.t0, s.t1, -1);
  cp_commit();
  if (threadIdx.x < a.g) {
    const int j = threadIdx.x;
    const float* st = a.stats + bk * a.n_chunks * a.g * 2;
    float m = -INFINITY;
    for (int c = 0; c < active; ++c) m = fmaxf(m, st[(c * a.g + j) * 2]);
    float l = 0.f;
    for (int c = 0; c < active; ++c)
      l = __fadd_rn(l, __fmul_rn(st[(c * a.g + j) * 2 + 1],
                                 expf(__fsub_rn(st[(c * a.g + j) * 2], m))));
    ml[2 * j] = m;
    ml[2 * j + 1] = l;
  }
  __syncthreads();
  const float* sc = a.scores + bk * a.g * a.c + s.t0;
  for (int i = threadIdx.x; i < a.g * n; i += THREADS) {
    const int j = i / n, r = i - j * n;
    const float e = expf(__fsub_rn(sc[(long long)j * a.c + r], ml[2 * j]));
    ss[j * a.chunk + r] = bf16_round(__fdiv_rn(e, ml[2 * j + 1]));
  }
  cp_wait<0>();
  __syncthreads();
  float* part = a.partial + (bk * a.n_chunks + blockIdx.x) * a.g * HD;
  value_rows<HD, TILE>(vs, ss, a.chunk, a.g, n, red,
                       [&](int j, int h, float x) { part[j * HD + h] = x; });
  __threadfence();                       // the sums, before the ticket
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(a.tickets + bk, 1u) == (unsigned)active - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* all = a.partial + bk * a.n_chunks * a.g * HD;
  bf16* out = a.out + bk * a.g * HD;
  for (int i = threadIdx.x; i < a.g * HD; i += THREADS) {
    float sum = 0.f;
    for (int c = 0; c < active; ++c)
      sum += __ldcg(all + (long long)c * a.g * HD + i);
    out[i] = __float2bfloat16_rn(sum);
  }
}

// Dynamic shared memory of the first kernel, of the second (0 alone);
// mirrored by decode_plan's smem in kernels/decode_attn/ops.py.
template <int HD, int TILE>
void smem_bytes(const Args& a, long long* first, long long* second) {
  const long long rows = (long long)a.chunk * HD * 2;
  const long long scores = (long long)a.g * a.chunk * 4;
  const long long red = (long long)WARPS * TILE * HD * 4;
  if (a.n_chunks == 1) {
    *first = 2 * rows + (long long)a.g * HD * 4 + red + scores;
    *second = 0;
  } else {
    *first = rows + (long long)a.g * HD * 4 + scores;
    *second = rows + red + scores;
  }
}

// Raise a kernel's dynamic shared memory limit once per device.
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes, int* done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = (int)bytes;
  return err;
}

template <int HD, int TILE>
int launch(const Args& a, int batch, cudaStream_t stream) {
  static int done_first[MAX_DEVICES], done_second[MAX_DEVICES];
  long long first, second;
  smem_bytes<HD, TILE>(a, &first, &second);
  if (first > MAX_SMEM || second > MAX_SMEM - 256)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(decode_attn_kernel<HD, TILE>, first, done_first);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)a.n_chunks, (unsigned)a.kv, (unsigned)batch);
  decode_attn_kernel<HD, TILE><<<grid, THREADS, (size_t)first, stream>>>(a);
  if (a.n_chunks == 1) return (int)cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(decode_attn_values_kernel<HD, TILE>, second, done_second);
  if (err != cudaSuccess) return (int)err;
  decode_attn_values_kernel<HD, TILE>
      <<<grid, THREADS, (size_t)second, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const Args& a, int batch, cudaStream_t stream) {
  if (a.g <= 2) return launch<HD, 2>(a, batch, stream);
  if (a.g <= 4) return launch<HD, 4>(a, batch, stream);
  return launch<HD, 8>(a, batch, stream);
}

}  // namespace

// One decode_attn call (kernels/decode_attn/ops.py): B rows, H query
// heads over KV heads of width hd, a ring of C slots cut into n_chunks
// chunks of `chunk` slots (one chunk: a single launch). `pos` holds B
// int64 positions pos_stride apart (0: one for every row). The scratch
// pointers are read only when n_chunks > 1. Returns cudaGetLastError()
// after the launches on `stream`.
extern "C" int decode_attn_launch(
    const void* q, const void* k, const void* v, void* cache_k,
    void* cache_v, const void* pos, int pos_stride, const void* freqs,
    void* out, void* scores, void* stats, void* partial, void* tickets,
    int batch, int heads, int kv, int hd, int c, int rot, float scale,
    int chunk, int n_chunks, void* stream) {
  if (batch < 1 || kv < 1 || heads < kv || heads % kv || c < 1 ||
      chunk < 1 || batch > 65535 || kv > 65535 ||
      n_chunks != (c + chunk - 1) / chunk || (n_chunks == 1 && chunk != c) ||
      rot < 0 || rot > hd || rot % 2 || (rot && !freqs) ||
      (pos_stride != 0 && pos_stride != 1))
    return (int)cudaErrorInvalidValue;
  const int g = heads / kv;
  if (g > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (n_chunks > 1 && (!scores || !stats || !partial || !tickets))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.cache_k = (bf16*)cache_k;
  a.cache_v = (bf16*)cache_v;
  a.pos = (const long long*)pos;
  a.freqs = (const float*)freqs;
  a.out = (bf16*)out;
  a.scores = (float*)scores;
  a.stats = (float*)stats;
  a.partial = (float*)partial;
  a.tickets = (unsigned*)tickets;
  a.pos_stride = pos_stride;
  a.kv = kv;
  a.g = g;
  a.c = c;
  a.rot = rot;
  a.chunk = chunk;
  a.n_chunks = n_chunks;
  a.scale = scale;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64: return launch_hd<64>(a, batch, st);
    case 128: return launch_hd<128>(a, batch, st);
    case 256: return launch_hd<256>(a, batch, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
