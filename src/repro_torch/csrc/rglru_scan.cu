// rglru_scan: the RG-LRU's linear recurrence over a whole sequence,
// h[b, t, c] = a[b, t, c] * h[b, t-1, c] + b[b, t, c] from h[b, -1, c] = 0,
// and its backward,
//   g_t = dh_t + a_{t+1} * g_{t+1}   (from g_{S-1} = dh_{S-1}),
//   da_t = g_t * h_{t-1} (h_{-1} = 0),  db_t = g_t.
//
// Stands in for the JAX package's jax.lax.associative_scan in
// src/repro/models/recurrent.py::rglru_block (no Pallas kernel: XLA runs
// the scan there). Plain versions:
// repro_torch/kernels/rglru_scan/ref.py::rglru_scan_ref and
// rglru_scan_bwd_ref, the sequential loops the port ran before.
//
// Inputs: a, b, h, dh, da, db are (B, S, d) fp32, contiguous.
//
// Bound on an H100 SXM: bytes. The forward reads a and b and writes h,
// 12 bytes per (b, t, channel): at recurrentgemma_2b's width (d = 2560),
// B = 2, S = 4096, 252 MB, 0.075 ms at 3.35 TB/s; the backward moves 20
// bytes per element (a, h, dh in; da, db out). Two flops per element is
// nothing beside that.
//
// Design: a pipelined walk per channel. One block of one warp per (batch
// row, 32 channels), one lane per channel: ceil(d / 32) B blocks, 160 at
// recurrentgemma_2b's width with B = 2, over all 132 SMs (grid (B,
// groups): the batch on grid.x, so B has no limit of its own; a grid of
// one dimension, dividing the block index, ran 4-7 % slower on an H100).
// Each lane walks its channel through every step in order, so the
// recurrence needs no communication and no reassociation. The chain
// itself is cheap (two rounded operations a step); what bounds the
// kernel is moving the bytes. So the inputs reach the lanes through a
// ring of `stages` tiles in shared memory, each `tile` steps x 32
// channels of every input, filled by cp.async (16-byte copies, 8 lanes
// to a step's 128 bytes; 4-byte copies, a lane's own channel, where
// d % 4 != 0 or a pointer is not 16-byte aligned): while one tile is
// walked, the next stages - 1 are in flight. The walk writes its outputs
// into tiles in shared memory, which the warp then stores as it loaded,
// 16 bytes a lane; whole groups of U steps run unpredicated. Blocks fit
// two to an SM (113 KB at most). The backward walks the tiles from the
// end of time; its tiles of a and h are loaded shifted by one step (row
// r of a tile at t0 holds a_{t0+r+1} and h_{t0+r-1}), so each step finds
// its neighbours in its own row, every input row is read once, and the
// edges (t = S-1 has no a_{t+1}, t = 0 no h_{-1}) are rows never copied
// and never used. The launch plan (grid, tile, stages, shared bytes,
// copy width) comes from kernels/rglru_scan/ops.py::rglru_plan: 128 x 3
// forward, 112 x 2 backward (a tile no longer than S rounded up to 4),
// within 2 % of the fastest rings of a sweep of variant builds.
// Parity: __fmul_rn / __fadd_rn keep nvcc from contracting a*h + b into
// one fused multiply-add, so every step rounds twice, as the plain loop
// does, and the outputs equal it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int LANES = 32;               // channels a block, one a lane
constexpr int U = 16;                   // steps read into registers at once
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 232448;        // bytes a block can have (H100)
constexpr int MAX_DEVICES = 64;         // prepare() remembers this many

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

// wait until at most n of this thread's groups are pending; wait_group
// takes an immediate, and n = stages - 2 is the same for every lane
__device__ __forceinline__ void cp_wait(int n) {
#define RGLRU_WAIT(k) \
  case k: asm volatile("cp.async.wait_group " #k ";\n" ::: "memory"); break;
  switch (n) {
    RGLRU_WAIT(0) RGLRU_WAIT(1) RGLRU_WAIT(2) RGLRU_WAIT(3)
    RGLRU_WAIT(4) RGLRU_WAIT(5)
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory");
  }
#undef RGLRU_WAIT
}

// Steps [t0, t0 + L) of one input's channels [c0, c0 + 32) in batch row
// `row0` (= row * S for the inputs' S) into a tile of L x 32 floats, row
// r holding step t0 + r. Steps outside [0, S) and channels past d are
// not copied: the walk never uses them. VEC: lane l copies channels
// c0 + 4 (l % 8) .. +3 of rows l / 8, l / 8 + 4, ... (d % 4 == 0, so a
// 16-byte group lies wholly inside or past d); else lane l copies its
// own channel.
template <bool VEC>
__device__ __forceinline__ void load_tile(float* tile, const float* x,
                                          long long row0, int t0, int L,
                                          int S, int d, int c0, int lane) {
  if (VEC) {
    const int col = (lane & 7) * 4;
    if (c0 + col >= d) return;
    for (int r = lane >> 3; r < L; r += 4) {
      const int t = t0 + r;
      if (t >= 0 && t < S)
        cp16(tile + r * LANES + col, x + (row0 + t) * d + c0 + col);
    }
  } else {
    if (c0 + lane >= d) return;
    for (int r = 0; r < L; ++r) {
      const int t = t0 + r;
      if (t >= 0 && t < S)
        cp4(tile + r * LANES + lane, x + (row0 + t) * d + c0 + lane);
    }
  }
}

// The first n rows of a tile (L x 32 floats, row r step t0 + r) to
// channels [c0, c0 + 32) of one output, as load_tile reads: 16-byte
// stores, a warp instruction four whole rows, or a lane's own channel.
template <bool VEC>
__device__ __forceinline__ void store_tile(float* y, const float* tile,
                                           long long row0, int t0, int n,
                                           int d, int c0, int lane) {
  if (VEC) {
    const int col = (lane & 7) * 4;
    if (c0 + col >= d) return;
    for (int r = lane >> 3; r < n; r += 4)
      *reinterpret_cast<float4*>(y + (row0 + t0 + r) * d + c0 + col) =
          *reinterpret_cast<const float4*>(tile + r * LANES + col);
  } else {
    if (c0 + lane >= d) return;
    for (int r = 0; r < n; ++r)
      y[(row0 + t0 + r) * d + c0 + lane] = tile[r * LANES + lane];
  }
}

// grid (B, ceil(d / 32)), one warp; shared: stages x {a, b} x L x 32,
// then h's tile (L x 32)
template <bool VEC>
__global__ void __launch_bounds__(LANES)
rglru_scan_fwd(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ h, int S, int d, int L, int NS) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x, c0 = blockIdx.y * LANES, c = c0 + lane;
  const long long row0 = (long long)blockIdx.x * S;
  const int nt = (S + L - 1) / L, sf = 2 * L * LANES;   // floats a stage
  auto fetch = [&](int k, int stage) {  // tile k into a stage
    if (k < nt) {
      float* st = ring + stage * sf;
      load_tile<VEC>(st, a, row0, k * L, L, S, d, c0, lane);
      load_tile<VEC>(st + L * LANES, b, row0, k * L, L, S, d, c0, lane);
    }
    cp_commit();                        // one group a tile, empty past nt
  };
  for (int k = 0; k < NS - 1; ++k) fetch(k, k);
  float* const th = ring + NS * sf;     // h's tile
  float ht = 0.0f;
  for (int k = 0, ws = 0; k < nt; ++k, ws = ws + 1 == NS ? 0 : ws + 1) {
    cp_wait(NS - 2);                    // this lane's copies of tile k
    __syncwarp();                       // everyone's; tile k - 1 read and
    fetch(k + NS - 1, ws == 0 ? NS - 1 : ws - 1);  // stored: its stage
    const int n = min(L, S - k * L);
    if (c < d) {
      const float* ta = ring + ws * sf + lane;
      const float* tb = ta + L * LANES;
      float* to = th + lane;
      int r = 0;
      for (; r + U <= n; r += U) {      // whole groups, unpredicated
        float av[U], bv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          av[u] = ta[(r + u) * LANES];
          bv[u] = tb[(r + u) * LANES];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          ht = __fadd_rn(__fmul_rn(av[u], ht), bv[u]);
          to[(r + u) * LANES] = ht;
        }
      }
      for (; r < n; ++r) {
        ht = __fadd_rn(__fmul_rn(ta[r * LANES], ht), tb[r * LANES]);
        to[r * LANES] = ht;
      }
    }
    __syncwarp();
    store_tile<VEC>(h, th, row0, k * L, n, d, c0, lane);
  }
}

// grid (B, ceil(d / 32)), one warp; shared: stages x {dh, a, h} x L x
// 32, then da's and db's tiles.
// The j-th tile walked is tile k = nt - 1 - j, steps [t0, t0 + L) with
// t0 = k L: its dh rows are steps t0 + r, its a rows t0 + r + 1, its h
// rows t0 + r - 1 (a_0 and h_{S-1} are never copied).
template <bool VEC>
__global__ void __launch_bounds__(LANES)
rglru_scan_bwd(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ dh, float* __restrict__ da,
               float* __restrict__ db, int S, int d, int L, int NS) {
  extern __shared__ __align__(16) float ring[];
  const int lane = threadIdx.x, c0 = blockIdx.y * LANES, c = c0 + lane;
  const long long row0 = (long long)blockIdx.x * S;
  const int nt = (S + L - 1) / L, sf = 3 * L * LANES;
  auto fetch = [&](int j, int stage) {
    if (j < nt) {
      const int t0 = (nt - 1 - j) * L;
      float* st = ring + stage * sf;
      load_tile<VEC>(st, dh, row0, t0, L, S, d, c0, lane);
      load_tile<VEC>(st + L * LANES, a, row0, t0 + 1, L, S, d, c0, lane);
      load_tile<VEC>(st + 2 * L * LANES, h, row0, t0 - 1, L, S - 1, d, c0,
                     lane);             // h_{S-1} is never used
    }
    cp_commit();
  };
  for (int j = 0; j < NS - 1; ++j) fetch(j, j);
  float* const tda = ring + NS * sf;
  float* const tdb = tda + L * LANES;
  float g = 0.0f;
  for (int j = 0, ws = 0; j < nt; ++j, ws = ws + 1 == NS ? 0 : ws + 1) {
    cp_wait(NS - 2);
    __syncwarp();
    fetch(j + NS - 1, ws == 0 ? NS - 1 : ws - 1);
    const int t0 = (nt - 1 - j) * L, n = min(L, S - t0);
    if (c < d) {
      const float* tdh = ring + ws * sf + lane;
      const float* tnext = tdh + L * LANES;   // a_{t+1}
      const float* tprev = tnext + L * LANES;  // h_{t-1}
      float* oa = tda + lane;
      float* ob = tdb + lane;
      int r = n - 1;
      if (t0 + r + 1 == S) {            // step S - 1: g = dh, no a_S
        g = tdh[r * LANES];
        oa[r * LANES] = __fmul_rn(g, t0 + r > 0 ? tprev[r * LANES] : 0.0f);
        ob[r * LANES] = g;
        --r;
      }
      for (; r + 1 >= U; r -= U) {      // whole groups r, r - 1, ...
        float dv[U], an[U], hp[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          dv[u] = tdh[(r - u) * LANES];
          an[u] = tnext[(r - u) * LANES];
          hp[u] = tprev[(r - u) * LANES];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          g = __fadd_rn(dv[u], __fmul_rn(an[u], g));
          oa[(r - u) * LANES] = __fmul_rn(g, t0 + r - u > 0 ? hp[u] : 0.0f);
          ob[(r - u) * LANES] = g;
        }
      }
      for (; r >= 0; --r) {
        g = __fadd_rn(tdh[r * LANES], __fmul_rn(tnext[r * LANES], g));
        oa[r * LANES] = __fmul_rn(g, t0 + r > 0 ? tprev[r * LANES] : 0.0f);
        ob[r * LANES] = g;
      }
    }
    __syncwarp();
    store_tile<VEC>(da, tda, row0, t0, n, d, c0, lane);
    store_tile<VEC>(db, tdb, row0, t0, n, d, c0, lane);
  }
}

// A plan from ops.py::rglru_plan that this file cannot run is refused
// here, so that it never addresses past the block's shared memory:
// groups = ceil(d / 32), tile a positive multiple of 4, 2 <= stages <=
// MAX_STAGES, smem = (stages x ins + outs) x tile x 32 floats within the
// block's limit, groups within grid.y, and vec only where d % 4 == 0
// and every pointer is 16-byte aligned.
bool plan_ok(int B, int d, int groups, int tile, int stages, int smem,
             int vec, int ins, int outs, const void* const* ptrs,
             int nptrs) {
  if (groups != (d + LANES - 1) / LANES || tile < 4 || tile % 4 != 0 ||
      stages < 2 || stages > MAX_STAGES || groups > 65535 ||
      ((long long)stages * ins + outs) * tile * LANES * 4 != smem ||
      smem > MAX_SMEM)
    return false;
  if (vec) {
    if (d % 4 != 0) return false;
    for (int i = 0; i < nptrs; ++i)
      if ((uintptr_t)ptrs[i] % 16 != 0) return false;
  }
  return true;
}

// Up to a block's whole dynamic shared memory, and the largest carveout,
// so that two blocks of up to 113 KB share an SM: set once a device for
// each kernel (`done`, one flag a device, is the kernel's own), since the
// attributes never change; a launch's own smem sets its occupancy.
template <typename K>
cudaError_t prepare(K kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_release);
  return err;
}

std::atomic<bool> fwd_vec_done[MAX_DEVICES], fwd_done[MAX_DEVICES];
std::atomic<bool> bwd_vec_done[MAX_DEVICES], bwd_done[MAX_DEVICES];

}  // namespace

extern "C" int rglru_scan_fwd_launch(const void* a, const void* b, void* h,
                                     int B, int S, int d, int groups,
                                     int tile, int stages, int smem,
                                     int vec, void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  const void* ptrs[3] = {a, b, h};
  if (!plan_ok(B, d, groups, tile, stages, smem, vec, 2, 1, ptrs, 3))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, groups);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (vec) {
    err = prepare(rglru_scan_fwd<true>, fwd_vec_done);
    if (err != cudaSuccess) return (int)err;
    rglru_scan_fwd<true><<<grid, LANES, smem, s>>>(
        (const float*)a, (const float*)b, (float*)h, S, d, tile, stages);
  } else {
    err = prepare(rglru_scan_fwd<false>, fwd_done);
    if (err != cudaSuccess) return (int)err;
    rglru_scan_fwd<false><<<grid, LANES, smem, s>>>(
        (const float*)a, (const float*)b, (float*)h, S, d, tile, stages);
  }
  return (int)cudaGetLastError();
}

extern "C" int rglru_scan_bwd_launch(const void* a, const void* h,
                                     const void* dh, void* da, void* db,
                                     int B, int S, int d, int groups,
                                     int tile, int stages, int smem,
                                     int vec, void* stream) {
  if (B == 0 || S == 0 || d == 0) return (int)cudaSuccess;
  const void* ptrs[5] = {a, h, dh, da, db};
  if (!plan_ok(B, d, groups, tile, stages, smem, vec, 3, 2, ptrs, 5))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, groups);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (vec) {
    err = prepare(rglru_scan_bwd<true>, bwd_vec_done);
    if (err != cudaSuccess) return (int)err;
    rglru_scan_bwd<true><<<grid, LANES, smem, s>>>(
        (const float*)a, (const float*)h, (const float*)dh, (float*)da,
        (float*)db, S, d, tile, stages);
  } else {
    err = prepare(rglru_scan_bwd<false>, bwd_done);
    if (err != cudaSuccess) return (int)err;
    rglru_scan_bwd<false><<<grid, LANES, smem, s>>>(
        (const float*)a, (const float*)h, (const float*)dh, (float*)da,
        (float*)db, S, d, tile, stages);
  }
  return (int)cudaGetLastError();
}
