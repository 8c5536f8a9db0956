"""Launch geometry of the port's CUDA kernels, checked on the CPU.

The kernels themselves run only on the card (tests/test_torch_gpu.py),
but the geometry they follow is computed in Python by their wrappers:
``pim_mac``'s split-K plan (``kernels/pim_mac/ops.py::split_plan``),
``dp_stages``' diagonal-chain warp layout
(``kernels/knapsack_dp/ops.py::chain_plan``) and ``minplus_combine``'s
block per row (``kernels/lut_pipeline/ops.py::combine_plan``). These
tests hold them to what the kernels need: every output column and every
k row is covered exactly once, every stage element is visited once,
after the element it reads, and a combine's rows fit one block's shared
memory. Emulations of the chain kernel's schedule (warp decode, lane
skew, wavefront steps) and of the combine kernel's (per-thread folds,
the lexicographic block reduction, the backtrace) reproduce the plain
versions bit for bit. The RG-LRU scans' plan
(``kernels/rglru_scan/ops.py::rglru_plan``) puts every (row, channel) on
one lane and its ring in shared memory, and an emulation of the kernels'
tile schedule (the ring's stages, each lane's copies, the backward's
shifted a and h tiles and its edge rules) copies every input element
once, writes every output once and equals the plain loops bit for bit.
``quant_split``'s plan (``kernels/quant_split/ops.py::split_plan``: tier
offsets, 32-column strips, rows a block) and an emulation of its blocks
stage every input element once and write every output element once,
equal to ``split_weight`` of each matrix.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.multipool import combine_many  # noqa: E402
from repro_torch.core.multipool import combine_rows_torch  # noqa: E402
from repro_torch.kernels.decode_attn import ops as daops  # noqa: E402
from repro_torch.kernels.knapsack_dp import ops as kops  # noqa: E402
from repro_torch.kernels.knapsack_dp.ref import dp_stages_ref  # noqa: E402
from repro_torch.kernels.lut_pipeline import ops as lops  # noqa: E402
from repro_torch.kernels.lut_pipeline.ref import tie_heavy_rows  # noqa: E402
from repro_torch.kernels.pim_mac import ops as pops  # noqa: E402
from repro_torch.kernels.quant_split import ops as qops  # noqa: E402
from repro_torch.kernels.rglru_scan import ops as rops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.kernels.slstm_scan import ops as sops  # noqa: E402
from repro_torch.models.hetero_linear import (  # noqa: E402
    split_weight as hl_split_weight)
from torch_decode_attn_controls import bf16_sums, over_limit  # noqa: E402

# M, K, N: decode shapes, the library-call shape, prefill, the ragged
# shapes of the card tests, and K around the 64-row step
PIM_SHAPES = [
    (16, 2048, 8192), (32, 2048, 8192), (1, 2048, 8192), (256, 2048, 8192),
    (16, 2048, 128), (16, 2048, 928), (17, 2047, 7264), (16, 4096, 2560),
    (16, 129, 37), (37, 129, 255), (100, 70, 50), (8, 8, 8), (1, 0, 1),
    (16, 64, 1), (16, 65, 16), (300, 96, 129), (16, 131071, 64),
    # recurrentgemma_2b's FFN (d_model 2560, d_ff 7680): decode tiers
    (16, 2560, 7680), (16, 2560, 5120), (16, 2560, 3839), (16, 2560, 1),
    (4, 2560, 640), (32, 2560, 7680),
]


@pytest.mark.parametrize("M,K,N", PIM_SHAPES)
def test_pim_split_plan_covers_every_column_and_k_row_once(M, K, N):
    p = pops.split_plan(M, K, N, sms=132)
    bm = 16 * p.mt
    # output tiles: every row and column in exactly one tile
    assert p.m_tiles == math.ceil(M / bm) and p.n_tiles == math.ceil(
        N / pops.BN)
    assert p.mt == (1 if M <= 16 else 2)
    # k chunks: whole BK steps, the splits cover K and none is empty
    assert p.k_chunk % pops.BK == 0 and p.k_chunk > 0
    assert p.splits * p.k_chunk >= K
    assert (p.splits - 1) * p.k_chunk < max(K, 1)
    cover = np.zeros(K, dtype=int)
    for z in range(p.splits):
        cover[z * p.k_chunk:min(K, (z + 1) * p.k_chunk)] += 1
    assert (cover == 1).all()
    # CUDA's grid limits, and no more blocks than the target unless the
    # output tiles alone exceed it
    assert p.n_tiles <= 2 ** 31 - 1 and p.m_tiles <= 65535
    assert p.splits <= min(65535, pops.MAX_SPLITS)
    target = pops.BLOCKS_PER_SM * 132
    assert p.splits == 1 or p.m_tiles * p.n_tiles * (p.splits - 1) < target
    assert p.partial_ints == (0 if p.splits == 1 else
                              p.blocks * bm * pops.THREADS)


def test_pim_split_plan_fills_the_card_at_decode():
    # the decode shape gives about two blocks per SM; a narrow tier is
    # split as far as MAX_SPLITS allows instead of running on one block
    wide = pops.split_plan(16, 2048, 8192, sms=132)
    assert (wide.n_tiles, wide.splits, wide.k_chunk) == (64, 5, 448)
    assert 2 * 132 <= wide.blocks <= 3 * 132
    narrow = pops.split_plan(16, 2048, 128, sms=132)
    assert (narrow.blocks, narrow.k_chunk) == (pops.MAX_SPLITS,
                                               2048 // pops.MAX_SPLITS)
    assert pops.split_plan(16, 64, 8192, sms=132).splits == 1


def test_pim_split_plan_at_the_recurrentgemma_width():
    # K = 2560 is 40 BK steps: the widest tier (all 7680 columns) splits
    # K in 5 chunks of 8 steps, about two blocks per SM; narrower tiers
    # split further, up to MAX_SPLITS chunks of 5 steps
    wide = pops.split_plan(16, 2560, 7680, sms=132)
    assert (wide.n_tiles, wide.splits, wide.k_chunk) == (60, 5, 512)
    assert 2 * 132 <= wide.blocks <= 3 * 132
    for n in (128, 1000, 3840):
        p = pops.split_plan(16, 2560, n, sms=132)
        assert (p.splits, p.k_chunk) == (pops.MAX_SPLITS, 320)
    assert pops.split_plan(16, 2560, 5120, sms=132).splits == 7


def test_pim_split_plan_rejects_what_the_grid_cannot_hold():
    with pytest.raises(ValueError, match="M, N >= 1"):
        pops.split_plan(0, 64, 8)
    with pytest.raises(ValueError, match="CUDA's limits"):
        pops.split_plan(65536 * 32, 64, 8)


def _emulate_chain_kernel(t, e, T, K):
    """The chain kernel's schedule, lane for lane: per stage, every warp
    of ``chain_plan`` decodes (table, residue, m0) as the kernel does and
    walks its wavefront steps, its lanes (32 lanes x Q chains each)
    vectorized. Returns the stage tables and, per stage, the (warp, step)
    stamp of every element's visit (-1 where never visited)."""
    V, C, n = t.shape
    VC = V * C
    plan = kops.chain_plan(t, T, K)
    tt, ee = t.reshape(VC, n), e.reshape(VC, n)
    K1 = K + 1
    stages = np.empty((VC, n + 1, T + 1, K1), dtype=np.float32)
    stages[:, 0] = np.inf
    stages[:, 0, :, 0] = 0.0
    stamps = np.full((n, VC, T + 1, K1, 2), -1, dtype=np.int64)
    chains = kops.CHAINS_PER_WARP
    # lane j, slot q owns chain m0 - j - 32 q
    slot = (np.arange(32)[None, :] + 32 * np.arange(chains // 32)[:, None])
    slot = slot.reshape(-1)
    for i in range(n):
        off, wpr = plan.warp_off[i], plan.warps_per_residue[i]
        for gw in range(int(off[-1])):
            b = int(np.searchsorted(off, gw, side="right") - 1)
            ti, ei = int(tt[b, i]), np.float32(ee[b, i])
            local = gw - int(off[b])
            rho = local // int(wpr[b])
            U = (T - rho) // ti
            m0 = U - chains * (local % int(wpr[b]))
            m = m0 - slot
            s_lo, s_hi = max(0, m0 - chains + 1), min(U, m0 + K)
            carry = np.zeros(chains, dtype=np.float32)
            for s in range(s_lo, s_hi + 1):
                k = s - m
                act = (k >= 0) & (k <= K)
                row, ka = rho + s * ti, k[act]
                v = stages[b, i, row, ka].copy()
                if s > 0:
                    take = carry[act] + ei
                    upd = (ka > 0) & (take < v)
                    v[upd] = take[upd]
                assert (stamps[i, b, row, ka, 0] == -1).all(), "revisited"
                stages[b, i + 1, row, ka] = v
                stamps[i, b, row, ka] = (gw, s)
                carry[act] = v
    return stages.reshape(V, C, n + 1, T + 1, K1), stamps


# (T, K, t_i per table): the schedule cases of the kernel's design, then
# tables whose t_i differ within one call, and an inert pad (e = +inf)
CHAIN_CASES = [
    (50, 7, [[3]]), (40, 40, [[1]]), (10, 5, [[20]]), (100, 70, [[18]]),
    (33, 0, [[2]]), (0, 4, [[1]]),
    (60, 9, [[18, 18], [1, 61], [7, 3]]),
]


@pytest.mark.parametrize("T,K,ts", CHAIN_CASES)
def test_chain_schedule_visits_each_element_once_after_its_source(T, K, ts):
    t = np.array(ts, dtype=np.int32).reshape(len(ts), 1, -1)
    rng = np.random.default_rng(T * 131 + K)
    e = rng.integers(1, 40, size=t.shape).astype(np.float32)
    e[-1, 0, -1] = np.inf                                # inert pad
    stages, stamps = _emulate_chain_kernel(t, e, T, K)
    n = t.shape[2]
    # every element of every stage once
    assert (stamps[..., 0] >= 0).all()
    # (t, k) after (t - t_i, k - 1): the same warp (lane) one step before
    tt = t.reshape(-1, n)
    for i in range(n):
        for b in range(tt.shape[0]):
            ti = int(tt[b, i])
            if ti > T or K == 0:
                continue
            src = stamps[i, b, :T + 1 - ti, :K]
            dst = stamps[i, b, ti:, 1:]
            assert (dst[..., 0] == src[..., 0]).all()
            assert (dst[..., 1] == src[..., 1] + 1).all()
    ref = dp_stages_ref(torch.as_tensor(t), torch.as_tensor(e), T, K)
    assert np.array_equal(stages, ref.numpy())


def test_chain_plan_counts_chains_and_warps_per_table():
    t = np.array([[[18, 1]], [[500, 7]]], dtype=np.int32)   # (V=2, C=1, n=2)
    T, K = 100, 40
    p = kops.chain_plan(t, T, K)
    assert p.residues.tolist() == [[18, 101], [1, 7]]
    # chains m = u - k in [-K, T // t_i], CHAINS_PER_WARP per warp
    expect = [[math.ceil((T // ti + K + 1) / kops.CHAINS_PER_WARP)
               for ti in row]
              for row in ([18, 500], [1, 7])]
    assert p.warps_per_residue.tolist() == expect
    warps = p.residues * p.warps_per_residue
    assert p.warp_off[:, 0].tolist() == [0, 0]
    assert (np.diff(p.warp_off, axis=1) == warps).all()
    assert p.stage_warps.tolist() == warps.sum(axis=1).tolist()
    # the wrapper hands the rows of each plan to the kernel by pointer
    assert p.warps_per_residue.flags.c_contiguous
    assert p.warp_off.flags.c_contiguous
    # t_i > T: every row its own residue, (T + 1) ceil((K + 1) / 32)
    # warps per table, summed over the tables of a stage
    with pytest.raises(ValueError, match="grid limit"):
        kops.chain_plan(np.full((16, 1, 1), 2 ** 30, dtype=np.int32),
                        2 ** 20 - 1, 2 ** 10)
    with pytest.raises(ValueError, match=r"\(T\+1\)\(K\+1\) <="):
        kops.chain_plan(np.ones((1, 1, 1), dtype=np.int32), 2 ** 26, 2 ** 10)


INT_MAX = 2 ** 31 - 1


def _warp_lex_min(v, i):
    """``warp_lex_min`` over (warps, 32) lanes: five ``__shfl_down_sync``
    steps (a lane past the end reads its own pair), each keeping the
    lexicographic (value, index) minimum. Lane 0 holds the warp's."""
    v, i = v.copy(), i.copy()
    for off in (16, 8, 4, 2, 1):
        ov, oi = v.copy(), i.copy()
        ov[:, :32 - off], oi[:, :32 - off] = v[:, off:], i[:, off:]
        take = (ov < v) | ((ov == v) & (oi < i))
        v[take], i[take] = ov[take], oi[take]
    return v, i


def _emulate_combine_kernel(gathered):
    """The combine kernel's schedule, block by block: one block per row
    (v, r) of ``combine_plan``; its threads (vectorized) own outputs
    k = tid + j blockDim of each fold and scan i ascending with a strict
    <; the final candidates are scanned per thread, reduced across the
    lanes of each warp, then across warps in warp 0; one thread
    backtraces. Returns min_e (V, R) float32 and splits (V, R, C)."""
    V, C, R, K1 = gathered.shape
    K = K1 - 1
    plan = lops.combine_plan(V, C, R, K)
    nt = plan.threads
    tid = np.arange(nt)
    min_e = np.empty((V, R), np.float32)
    splits = np.empty((V, R, C), np.int32)
    for row in range(plan.blocks):
        v, r = divmod(row, R)
        G = gathered[v, :, r]                    # the staged rows
        if C == 1:
            min_e[v, r] = G[0, K]
            splits[v, r] = K if np.isfinite(G[0, K]) else -1
            continue
        F, traces = G[0], []
        for c in range(1, C - 1):
            Fn = np.empty(K1, np.float32)
            A = np.empty(K1, np.int32)
            for j in range(-(-K1 // nt)):
                k = tid + j * nt
                k = k[k < K1]
                best = np.full(k.shape, np.inf, np.float32)
                arg = np.zeros(k.shape, np.int32)
                for i in range(int(k.max()) + 1):  # lanes with k < i idle
                    act = np.flatnonzero(i <= k)
                    cand = F[i] + G[c, k[act] - i]
                    take = cand < best[act]
                    best[act[take]] = cand[take]
                    arg[act[take]] = i
                Fn[k], A[k] = best, arg
            F = Fn
            traces.append(A)
        bv = np.full(nt, np.inf, np.float32)
        bi = np.full(nt, INT_MAX, np.int64)
        own = tid[tid <= K]
        bv[own] = F[own] + G[C - 1, K - own]
        bi[own] = own
        for i0 in range(nt, K1, nt):
            i = tid + i0
            act = np.flatnonzero(i <= K)
            cand = F[i[act]] + G[C - 1, K - i[act]]
            take = cand < bv[act]
            bv[act[take]], bi[act[take]] = cand[take], i[act[take]]
        wv, wi = _warp_lex_min(bv.reshape(-1, 32), bi.reshape(-1, 32))
        lv = np.full((1, 32), np.inf, np.float32)
        li = np.full((1, 32), INT_MAX, np.int64)
        lv[0, :nt // 32], li[0, :nt // 32] = wv[:, 0], wi[:, 0]
        lv, li = _warp_lex_min(lv, li)
        best, i_opt = lv[0, 0], int(li[0, 0])
        min_e[v, r] = best
        if not np.isfinite(best):
            splits[v, r] = -1
            continue
        splits[v, r, C - 1] = K - i_opt
        k = i_opt
        for c in range(C - 2, 0, -1):
            ip = int(traces[c - 1][k])
            splits[v, r, c] = k - ip
            k = ip
        splits[v, r, 0] = k
    return min_e, splits


# V, C, R, K: C = 1..5; K = 0; K+1 < 32; K+1 not a multiple of 32; K+1
# a multiple of 32; the main-path K; K+1 > blockDim (1024): the block's
# threads own two outputs of a fold and two final candidates each
COMBINE_CASES = [
    (2, 1, 6, 6), (1, 1, 6, 0), (2, 2, 6, 0), (1, 3, 6, 0), (1, 5, 6, 0),
    (2, 2, 7, 20), (2, 3, 6, 40), (1, 4, 6, 63), (1, 5, 6, 100),
    (1, 3, 6, 256), (1, 2, 6, 1100), (1, 3, 6, 1100), (1, 5, 6, 1100),
]


@pytest.mark.parametrize("V,C,R,K", COMBINE_CASES)
def test_combine_schedule_matches_plain_and_reference_folds(V, C, R, K):
    g = tie_heavy_rows(V, C, R, K, seed=V * 1000 + C * 100 + K).numpy()
    min_e, splits = _emulate_combine_kernel(g)
    ref_e, ref_s = combine_rows_torch(torch.from_numpy(g))
    assert np.array_equal(min_e.view(np.uint32), ref_e.numpy().view(np.uint32))
    assert np.array_equal(splits, ref_s.numpy())
    for v in range(V):
        np_e, np_s = combine_many(list(g[v]))
        assert np.array_equal(min_e[v].view(np.uint32),
                              np_e.astype(np.float32).view(np.uint32))
        assert np.array_equal(splits[v], np_s)
    # the rows hold what the cases promise: infeasible rows, and a first
    # minimum tied across lanes and warps at i = K // 3 (kind 3)
    assert (splits[:, 0] == -1).all()
    if C > 1:
        assert (splits[:, 3, C - 1] == K - K // 3).all()
        # kind 5: all K groups before the last cluster; each middle
        # fold's tie at k = K goes to its first minimum i = 0, so the
        # last middle cluster takes them all
        expect = [0] * C
        expect[max(C - 2, 0)] = K
        assert splits[:, 5].tolist() == [expect] * V


def test_combine_tie_rows_tie_across_lanes_warps_and_threads():
    # kind 3 at K=1200 (s = 400): the final candidates are minimal at
    # i = 400, 401 (lanes 16, 17 of warp 12), 432 (warp 13), 464 (warp
    # 14) and 1424 > K; at K=1600 (s = 533) also at 1557, the second
    # candidate of thread 533
    for K, s, ties in ((1200, 400, [400, 401, 432, 464]),
                       (1600, 533, [533, 534, 565, 597, 1557])):
        g = tie_heavy_rows(1, 2, 5, K).numpy()
        cand = g[0, 0, 3] + g[0, 1, 3, ::-1]
        assert np.flatnonzero(cand == cand.min()).tolist() == ties
        assert lops.combine_plan(1, 2, 5, K).threads == 1024
        min_e, splits = _emulate_combine_kernel(g)
        assert splits[0, 3].tolist() == [s, K - s]
    assert np.array_equal(splits, combine_rows_torch(
        torch.from_numpy(g))[1].numpy())


@pytest.mark.parametrize("V,C,R,K", [(6, 2, 33, 256), (6, 3, 33, 256),
                                     (2, 5, 33, 256), (1, 5, 1, 2047),
                                     (3, 1, 7, 0), (4, 4, 9, 40)])
def test_combine_plan_gives_one_block_per_row(V, C, R, K):
    p = lops.combine_plan(V, C, R, K)
    assert p.blocks == V * R
    assert p.threads % 32 == 0 and 32 <= p.threads <= lops.MAX_THREADS
    assert p.threads == min(32 * -(-(K + 1) // 32), lops.MAX_THREADS)
    assert p.shared_bytes == (C + 2 + max(C - 2, 0)) * (K + 1) * 4


def test_combine_plan_shared_memory_and_its_limit():
    assert lops.combine_plan(6, 2, 33, 256).shared_bytes == 4112
    assert lops.combine_plan(2, 5, 33, 256).shared_bytes == 10280
    # K=2047, C=5 takes the opt-in above 48 KB
    assert lops.combine_plan(1, 5, 1, 2047).shared_bytes == 81920 > 48 * 1024
    # the largest K whose C=5 rows fit beside the static reduction pairs
    assert lops.combine_plan(1, 5, 1, 5803).shared_bytes \
        + lops.STATIC_SHARED <= lops.SHARED_MAX
    with pytest.raises(ValueError, match=r"\(1, 5, 1, 5805\) needs 232200"):
        lops.combine_plan(1, 5, 1, 5804)
    with pytest.raises(ValueError, match="shared memory"):
        lops.combine_plan(2, 2, 33, 2 ** 16)
    with pytest.raises(ValueError, match="C >= 1"):
        lops.combine_plan(1, 0, 3, 4)


# -- the RG-LRU scans: one lane per (row, channel), a ring of tiles -------

SM_SMEM = 233472                         # bytes of an H100 SM's shared memory
BLOCK_RESERVED = 1024                    # of it the card keeps per block
BLOCK_SMEM = 232448                      # bytes a block can have


@pytest.mark.parametrize("B,S,d", [(2, 4096, 2560), (1, 65, 33),
                                   (2, 1000, 100), (3, 1, 1), (1, 7, 64),
                                   (5, 300, 2048)])
@pytest.mark.parametrize("backward", [False, True])
def test_rglru_plan_covers_every_row_and_channel_once(B, S, d, backward):
    p = rops.rglru_plan(B, S, d, backward=backward)
    assert p.rows == B and p.groups == math.ceil(d / rops.LANES)
    cover = np.zeros((B, p.groups * rops.LANES), dtype=int)
    for x in range(p.rows):                  # grid (rows, groups)
        for y in range(p.groups):
            cover[x, y * rops.LANES:(y + 1) * rops.LANES] += 1
    # lanes past d copy and write nothing
    assert (cover[:, :d] == 1).all() and p.groups * rops.LANES - d < 32


def test_rglru_plan_fills_the_card_and_fits_shared_memory():
    fwd = rops.rglru_plan(2, 4096, 2560)
    bwd = rops.rglru_plan(2, 4096, 2560, backward=True)
    # recurrentgemma_2b's width at B = 2: 160 blocks over the 132 SMs
    assert fwd.groups * fwd.rows == bwd.groups * bwd.rows == 160 >= 132
    assert (fwd.tile, fwd.stages) == rops.FWD_RING == (128, 3)
    assert (bwd.tile, bwd.stages) == rops.BWD_RING == (112, 2)
    # the ring of a and b and h's tile; the ring of dh, a, h, da's and
    # db's tiles
    assert fwd.smem == (3 * 2 + 1) * 128 * 32 * 4 == 114688
    assert bwd.smem == (2 * 3 + 2) * 112 * 32 * 4 == 114688
    assert fwd.smem > 48 * 1024 and bwd.smem > 48 * 1024
    # two blocks fit an SM beside the card's reserve, each direction
    for p in (fwd, bwd):
        assert p.smem <= BLOCK_SMEM
        assert 2 * (p.smem + BLOCK_RESERVED) <= SM_SMEM
    assert fwd.vec and bwd.vec


@pytest.mark.parametrize("d", [1, 2, 3, 33, 63, 64, 100, 2560])
def test_rglru_plan_copies_16_bytes_only_where_they_are_aligned(d):
    assert rops.rglru_plan(2, 100, d).vec == (d % 4 == 0)
    assert not rops.rglru_plan(2, 100, d, aligned=False).vec
    assert not rops.rglru_plan(2, 100, d, backward=True,
                               aligned=False).vec


def test_rglru_plan_rejects_what_the_kernels_cannot_hold():
    for shape in [(2, 0, 64), (0, 10, 64), (2, 10, 0)]:
        with pytest.raises(ValueError, match="B, S, d >= 1"):
            rops.rglru_plan(*shape)
    # grid (B, groups): B past grid.y's 65535 is held, d up to 65535
    # groups of 32 channels
    p = rops.rglru_plan(65536, 10, 64)
    assert (p.rows, p.groups) == (65536, 2)
    assert rops.rglru_plan(1, 10, 65535 * 32).groups == 65535
    with pytest.raises(ValueError, match="CUDA's limit"):
        rops.rglru_plan(1, 10, 65535 * 32 + 1)


@pytest.mark.parametrize("backward", [False, True])
def test_rglru_plan_fits_the_tile_to_short_sequences(backward):
    """A tile no longer than S rounded up to 4 steps: a short prefill
    reserves the shared memory of its own steps, not a whole ring's."""
    L, stages = rops.BWD_RING if backward else rops.FWD_RING
    ins, outs = (3, 2) if backward else (2, 1)
    for S, tile in [(1, 4), (4, 4), (5, 8), (L - 1, L), (L, L),
                    (L + 1, L), (4096, L)]:
        p = rops.rglru_plan(2, S, 64, backward=backward)
        assert (p.tile, p.stages) == (tile, stages)
        assert p.smem == (stages * ins + outs) * tile * 32 * 4
        assert p.tile >= S or p.tile == L


def _copy_counts(p, d):
    """How many of one block's lanes copy each float of a tile (tile rows
    x the groups' channels), as ``load_tile`` copies them, before the
    steps outside [0, S) are dropped."""
    n = np.zeros((p.tile, p.groups * 32), dtype=int)
    for x in range(p.groups):
        c0 = 32 * x
        for lane in range(32):
            if p.vec:
                col = c0 + (lane & 7) * 4
                if col < d:
                    n[lane >> 3::4, col:col + 4] += 1
            elif c0 + lane < d:
                n[:, c0 + lane] += 1
    return n


def _load(stage, x, t0, end, counts, copied):
    """One input's tile at step t0 into a stage (B, tile, W): row r holds
    step t0 + r where the lanes copy it and 0 <= t0 + r < end;
    ``copied`` (S, W) counts the copies of each element."""
    for r in range(counts.shape[0]):
        t = t0 + r
        if 0 <= t < end:
            m = counts[r] > 0
            stage[:, r, torch.from_numpy(m)] = x[:, t, torch.from_numpy(m)]
            copied[t] += counts[r]


def _store(tile, y, t0, n, counts, written):
    """``store_tile``: the first n rows of an output tile (B, tile, W) to
    steps t0 .. t0 + n - 1 of ``y`` (B, S, W), where the lanes copy;
    ``written`` (S, W) counts the writes of each element."""
    for r in range(n):
        m = torch.from_numpy(counts[r] > 0)
        y[:, t0 + r, m] = tile[:, r, m]
        written[t0 + r] += counts[r]


def _pad(x, W):
    return torch.nn.functional.pad(x, (0, W - x.shape[2]),
                                   value=float("nan"))


def _emulate_rglru(p, ins, arrays_at, walk):
    """The kernels' ring: ``stages`` stages of len(ins) tiles, NaN until
    copied, the j-th tile fetched at ``arrays_at(j)`` (one (t0, end) per
    input: steps [t0, t0 + tile) clipped to [0, end)) before the walk of
    tile j - stages + 1 and after that of the tile before it;
    ``walk(j, tiles, counts)`` runs the j-th tile and stores it. Returns
    each input's copy counts within d and past it."""
    B, S, d = ins[0].shape
    W = p.groups * 32
    counts = _copy_counts(p, d)
    xs = [_pad(x, W) for x in ins]
    ring = torch.full((p.stages, len(ins), B, p.tile, W), float("nan"))
    copied = np.zeros((len(ins), S, W), dtype=int)
    nt = -(-S // p.tile)

    def fetch(j):
        if j < nt:
            for i, (x, (t0, end)) in enumerate(zip(xs, arrays_at(j))):
                _load(ring[j % p.stages, i], x, t0, end, counts, copied[i])
    for j in range(p.stages - 1):
        fetch(j)
    for j in range(nt):
        fetch(j + p.stages - 1)                # into tile j - 1's stage
        walk(j, ring[j % p.stages], counts)
    return copied[:, :, :d], copied[:, :, d:]


def _emulate_rglru_fwd(a, b, p):
    """The forward: each tile walked lane by lane into h's tile (kept
    from tile to tile, NaN at first), then stored."""
    B, S, d = a.shape
    L, W = p.tile, p.groups * 32
    h = torch.full((B, S, W), float("nan"))
    th = torch.full((B, L, W), float("nan"))
    written = np.zeros((S, W), dtype=int)
    live = torch.arange(W) < d
    state = {"h": torch.zeros(B, W)}

    def walk(k, tiles, counts):
        ta, tb = tiles
        n = min(L, S - k * L)
        for r in range(n):
            state["h"] = ta[:, r] * state["h"] + tb[:, r]
            th[:, r, live] = state["h"][:, live]
        _store(th, h, k * L, n, counts, written)
    copied, past = _emulate_rglru(p, [a, b], lambda k: [(k * L, S)] * 2,
                                  walk)
    return h[..., :d], copied, past, written


def _emulate_rglru_bwd(a, h, dh, p):
    """The backward: tiles from the end of time, each walked from its
    last row into da's and db's tiles, then stored."""
    B, S, d = a.shape
    L, W = p.tile, p.groups * 32
    nt = -(-S // L)
    da = torch.full((B, S, W), float("nan"))
    db = torch.full((B, S, W), float("nan"))
    tda = torch.full((B, L, W), float("nan"))
    tdb = torch.full((B, L, W), float("nan"))
    written = np.zeros((S, W), dtype=int)
    live = torch.arange(W) < d
    state = {"g": torch.zeros(B, W)}

    def walk(j, tiles, counts):
        tdh, tnext, tprev = tiles              # dh_t, a_{t+1}, h_{t-1}
        t0 = (nt - 1 - j) * L
        n = min(L, S - t0)
        for r in range(n - 1, -1, -1):
            t = t0 + r
            g = (tdh[:, r] + tnext[:, r] * state["g"] if t + 1 < S
                 else tdh[:, r])
            state["g"] = g
            hp = tprev[:, r] if t > 0 else torch.zeros(B, W)
            tda[:, r, live] = (g * hp)[:, live]
            tdb[:, r, live] = g[:, live]
        _store(tda, da, t0, n, counts, written)
        _store(tdb, db, t0, n, counts, written)

    def at(j):
        t0 = (nt - 1 - j) * L
        return (t0, S), (t0 + 1, S), (t0 - 1, S - 1)
    copied, past = _emulate_rglru(p, [dh, a, h], at, walk)
    return da[..., :d], db[..., :d], copied, past, written


# S = 1, one step short of a tile, a tile, one step past it (either
# direction's tile), many tiles
_LS = sorted({rops.FWD_RING[0], rops.BWD_RING[0]})
RGLRU_EMULATION_CASES = [(S, d) for S in sorted({1, 1000} | {
                             L + e for L in _LS for e in (-1, 0, 1)})
                         for d in (1, 33, 64, 100)]


@pytest.mark.parametrize("S,d", RGLRU_EMULATION_CASES)
def test_rglru_tile_schedule_equals_the_plain_loops_bitwise(S, d):
    rng = np.random.default_rng(S * 7 + d)
    B = 2
    a = torch.from_numpy(rng.uniform(0.005, 0.995, (B, S, d))
                         .astype(np.float32))
    b, dh = (torch.from_numpy(rng.standard_normal((B, S, d))
                              .astype(np.float32)) for _ in range(2))
    h_ref = rglru_scan_ref(a, b)
    da_ref, db_ref = rglru_scan_bwd_ref(a, h_ref, dh)
    plans = {(rops.rglru_plan(B, S, d, backward=bw, aligned=al), bw)
             for bw in (False, True) for al in (True, False)}
    if S == 1000:                             # the shallowest ring too
        for bw in (False, True):
            p = rops.rglru_plan(B, S, d, backward=bw)
            ins, outs = (3, 2) if bw else (2, 1)
            plans.add((rops.RglruPlan(p.groups, p.rows, p.tile, 2,
                                      (2 * ins + outs) * p.tile * 32 * 4,
                                      p.vec), bw))
    for p, backward in sorted(plans):
        if not backward:
            h, copied, past, written = _emulate_rglru_fwd(a, b, p)
            assert torch.equal(h, h_ref), p
            assert (copied == 1).all()        # a and b, every element once
        else:
            da, db, copied, past, written = _emulate_rglru_bwd(a, h_ref,
                                                               dh, p)
            assert torch.equal(da, da_ref) and torch.equal(db, db_ref), p
            assert (copied[0] == 1).all()     # dh
            # a_{t+1} from t = 1 on; h_{t-1} up to t = S - 2
            assert (copied[1, 1:] == 1).all() and (copied[1, :1] == 0).all()
            assert (copied[2, :-1] == 1).all() and (copied[2, -1] == 0).all()
        assert (past == 0).all()              # nothing past d is copied
        outs = 2 if backward else 1           # every output once, within d
        assert (written[:, :d] == outs).all() and (written[:, d:] == 0).all()


# -- the sLSTM backward: a block of warps per (row, 32 units, chunk) ------

SLSTM_BWD_SHAPES = [(2, 4096, 2048), (1, 4096, 100), (2, 1, 64), (2, 7, 33),
                    (2, 63, 64), (2, 64, 64), (2, 65, 33), (3, 200, 1),
                    (1, 1000, 24)]


def _slstm_bwd_blocks(B, S, d, p):
    """Each ticket's (chunk, row, group), as the chain kernel reads it."""
    cols = B * p.groups
    for t in range(p.tickets):
        col = t % cols
        yield t, p.chunks - 1 - t // cols, col // p.groups, col % p.groups


@pytest.mark.parametrize("B,S,d", SLSTM_BWD_SHAPES)
def test_slstm_bwd_plan_covers_every_row_step_and_unit_once(B, S, d):
    p = sops.slstm_bwd_plan(B, S, d)
    assert p.chunk == sops.BWD_SPAN * p.warps
    assert p.groups == math.ceil(d / 32) and p.chunks == math.ceil(S / p.chunk)
    cover = np.zeros((B, S, p.groups * 32), dtype=int)
    ticket_of = {}
    for t, k, b, g in _slstm_bwd_blocks(B, S, d, p):
        ticket_of[b, g, k] = t
        for w in range(p.warps):             # warp w: its span of steps
            t0 = k * p.chunk + w * sops.BWD_SPAN
            cover[b, t0:min(t0 + sops.BWD_SPAN, S),
                  g * 32:(g + 1) * 32] += 1
    # lanes past d copy and write nothing
    assert (cover[:, :, :d] == 1).all() and p.groups * 32 - d < 32
    # every chunk waits only on its successor, which took an earlier
    # ticket: a block never waits on one that is not yet resident
    for (b, g, k), t in ticket_of.items():
        if k + 1 < p.chunks:
            assert ticket_of[b, g, k + 1] < t
    assert sorted(ticket_of.values()) == list(range(p.tickets))


@pytest.mark.parametrize("B,S,d,resident", [(2, 1000, 100, 1),
                                            (2, 1000, 100, 3),
                                            (1, 4096, 64, 2),
                                            (3, 200, 33, 5), (2, 65, 64, 7)])
def test_slstm_bwd_blocks_never_wait_forever(B, S, d, resident):
    """A block takes its ticket when the card starts it, and a chunk
    waits for its successor's carry: whichever resident blocks the card
    runs first, some block can always go on, however few fit."""
    p = sops.slstm_bwd_plan(B, S, d)
    cols = B * p.groups
    rng = np.random.default_rng(B * S + d + resident)
    counter, done, running = 0, set(), []
    while len(done) < p.tickets:
        while len(running) < resident and counter < p.tickets:
            running.append(counter)          # a block starts, takes one
            counter += 1
        ready = [t for t in running
                 if t // cols == 0 or t - cols in done]
        assert ready, "every resident block waits: the chain is stuck"
        t = ready[rng.integers(len(ready))]
        done.add(t)
        running.remove(t)
    assert done == set(range(p.tickets))


def test_slstm_bwd_plan_fills_the_card_and_fits_shared_memory():
    p = sops.slstm_bwd_plan(2, 4096, 2048)
    # xlstm_1_3b's sLSTM at B = 2, S = 4096: 64-step chunks of 8 spans
    assert (p.chunk, sops.BWD_SPAN, p.warps) == (64, 8, 8) == (
        sops.BWD_CHUNK, sops.BWD_SPAN, sops.BWD_WARPS)
    assert p.tickets == 2 * 64 * 64 >= 4 * 132
    # z, i, f, o and dh staged, the spans' maps (7) and end carries (3)
    assert p.smem == (5 * 64 + 10 * 8) * 32 * 4 == 51200 > 48 * 1024
    # three blocks an SM (the kernel's launch bounds) beside the reserve
    assert p.smem <= BLOCK_SMEM and 3 * (p.smem + BLOCK_RESERVED) <= SM_SMEM
    assert p.vec
    # the states (4 planes a span), 96 carry floats and a flag a ticket,
    # the ticket counter
    assert p.scratch == (4 * 8 * 2 * 64 * 2048 + 96 * p.tickets
                         + p.tickets + 1)
    assert sops.bwd_scratch_floats(2, 4096, 2048) == p.scratch


@pytest.mark.parametrize("S", [1, 7, 8, 9, 63, 64, 65, 4096])
def test_slstm_bwd_plan_fits_the_chunk_to_short_sequences(S):
    p = sops.slstm_bwd_plan(2, S, 64)
    assert p.warps == min(sops.BWD_WARPS, math.ceil(S / sops.BWD_SPAN))
    assert p.smem == (5 * p.chunk + 10 * p.warps) * 32 * 4
    assert p.chunk >= S or p.chunk == sops.BWD_CHUNK


@pytest.mark.parametrize("d", [1, 2, 3, 33, 63, 64, 100, 2048])
def test_slstm_bwd_plan_copies_16_bytes_only_where_they_are_aligned(d):
    assert sops.slstm_bwd_plan(2, 100, d).vec == (d % 4 == 0)
    assert not sops.slstm_bwd_plan(2, 100, d, aligned=False).vec


def test_slstm_bwd_plan_rejects_what_the_kernels_cannot_hold():
    for shape in [(2, 0, 64), (0, 10, 64), (2, 10, 0)]:
        with pytest.raises(ValueError, match="B, S, d >= 1"):
            sops.slstm_bwd_plan(*shape)
    # one block a ticket on grid.x: at most 2^31 - 1 of them
    assert sops.slstm_bwd_plan(2 ** 20, 64, 2047 * 32).tickets < 2 ** 31
    with pytest.raises(ValueError, match="grid limit"):
        sops.slstm_bwd_plan(2 ** 20, 128, 2048 * 32)


# -- quant_split ---------------------------------------------------------

# the serve engine's three tier plans: the legacy bf16/int8 pools, the
# cxl substrates' int8/int8 pairs and cxl-tier-3's three int8 pools
QS_PLANS = {
    "legacy": (("hp_bf16", "bf16"), ("hp_int8", "int8"),
               ("lp_bf16", "bf16"), ("lp_int8", "int8")),
    "cxl": (("hp_ddr_int8", "int8"), ("hp_cxl_int8", "int8"),
            ("lp_ddr_int8", "int8"), ("lp_cxl_int8", "int8")),
    "cxl3": (("hbm_int8", "int8"), ("ddr_int8", "int8"),
             ("cxl_int8", "int8")),
}
# (d_in, d_out, plan, columns per tier): widths 1, 15 and 17, empty
# tiers, a tier over every column, d_in below the cluster's 8 blocks,
# tiers straddling strips, and d_out off the 32-column grid
QS_CASES = [
    (37, 100, "legacy", (1, 15, 17, 67)),
    (64, 96, "legacy", (0, 96, 0, 0)),
    (64, 96, "legacy", (96, 0, 0, 0)),
    (9, 70, "cxl", (17, 0, 15, 38)),
    (300, 129, "cxl3", (40, 1, 88)),
    (5, 33, "cxl3", (0, 0, 33)),
    (16, 64, "cxl", (32, 0, 0, 32)),
]


def _qs_plan(d_in, d_out, plan, widths):
    tiers = tuple((name, fmt == "int8", n)
                  for (name, fmt), n in zip(QS_PLANS[plan], widths))
    return qops.split_plan(d_in, d_out, tiers)


def _qs_tier_of(plan, col):
    """The kernel's lane rule: a column's tier is the last one starting
    at or before it (an empty tier starts where the next one does)."""
    mine = plan.tiers[0]
    for t in plan.tiers[1:]:
        if col >= t.off:
            mine = t
    return mine


def _qs_inputs(M, d_in, d_out, seed):
    """M random matrices with an all-zero column (the 1e-8 scale floor)
    and a column of exact .5 quotients: its max 127 gives scale 1, so
    w / scale ties between two integers (round half to even)."""
    g = torch.Generator().manual_seed(seed)
    ws = [torch.randn((d_in, d_out), generator=g) for _ in range(M)]
    ties = torch.arange(d_in, dtype=torch.float32) % 9 - 4.5
    ties[0] = 127.0
    for w in ws:
        w[:, d_out // 3] = 0.0
        w[:, d_out - 1] = ties
    return ws


def _emulate_quant_split(ws, plan, vec):
    """The quant_split kernel's schedule on the CPU, block for block: for
    every matrix, strip and cluster rank, the rows the block stages (16
    bytes a thread if ``vec``, else 4) into its tile, each lane's column
    and tier, the int8 lanes' block maxima combined over the cluster, and
    each warp's rows written at the kernel's flat output index. Returns
    ``{tier: {field: (flat values, writes per element)}}``."""
    M, (d_in, d_out) = len(ws), ws[0].shape
    C = qops.COLS
    flat = {}
    for t in plan.tiers:
        if t.n == 0:
            continue
        size = M * d_in * t.n
        dt = torch.int8 if t.int8 else torch.bfloat16
        flat[t.name] = {("q" if t.int8 else "w"): (
            torch.zeros(size, dtype=dt), torch.zeros(size, dtype=torch.int64))}
        if t.int8:
            flat[t.name]["scale"] = (torch.zeros(M * t.n),
                                     torch.zeros(M * t.n, dtype=torch.int64))
    for m, w in enumerate(ws):
        for g in range(plan.strips):
            c0 = g * C
            lanes = [(c0 + j, _qs_tier_of(plan, c0 + j))
                     for j in range(C) if c0 + j < d_out]
            blocks = []
            for rank in range(qops.CLUSTER):
                r0 = rank * plan.rows
                rows = max(0, min(plan.rows, d_in - r0))
                tile = torch.full((rows * C,), float("nan"))
                staged = torch.zeros(rows * C, dtype=torch.int64)
                if vec:
                    for k in range(rows * C // 4):
                        col = c0 + 4 * (k & 7)
                        if col < d_out:
                            tile[4 * k:4 * k + 4] = w[r0 + (k >> 3),
                                                      col:col + 4]
                            staged[4 * k:4 * k + 4] += 1
                else:
                    for k in range(rows * C):
                        col = c0 + (k & 31)
                        if col < d_out:
                            tile[k] = w[r0 + (k >> 5), col]
                            staged[k] += 1
                tile, staged = tile.view(rows, C), staged.view(rows, C)
                # every staged column a lane reads was copied once
                assert bool((staged[:, :len(lanes)] == 1).all())
                assert bool((staged[:, len(lanes):] == 0).all())
                # each warp's rows: warp, warp + 8, ... below `rows`
                mine = torch.cat([torch.arange(v, max(v, rows), qops.WARPS)
                                  for v in range(qops.WARPS)])
                blocks.append((rank, r0, mine, tile))
            amax = {}
            for _, _, mine, tile in blocks:
                for j, (c, t) in enumerate(lanes):
                    if t.int8 and mine.numel():
                        a = tile[mine, j].abs().amax()
                        amax[c] = torch.maximum(amax.get(c, a), a)
            for rank, r0, mine, tile in blocks:
                for j, (c, t) in enumerate(lanes):
                    idx = (m * d_in + r0 + mine) * t.n + (c - t.off)
                    if not t.int8:
                        vals, n_w = flat[t.name]["w"]
                        vals[idx] = tile[mine, j].to(torch.bfloat16)
                        n_w[idx] += 1
                        continue
                    a = amax.get(c, torch.tensor(0.0))
                    s = a.clamp_min(1e-8) / torch.tensor(127.0)
                    if rank == 0:
                        vals, n_w = flat[t.name]["scale"]
                        vals[m * t.n + c - t.off] = s
                        n_w[m * t.n + c - t.off] += 1
                    v = torch.round(tile[mine, j] / s).clamp(-127, 127)
                    vals, n_w = flat[t.name]["q"]
                    vals[idx] = v.to(torch.int8)
                    n_w[idx] += 1
    return flat


@pytest.mark.parametrize("d_in,d_out,plan,widths", QS_CASES)
def test_quant_split_plan_offsets_strips_and_rows(d_in, d_out, plan, widths):
    p = _qs_plan(d_in, d_out, plan, widths)
    # tiers in split order, contiguous from column 0 to d_out
    assert [t.name for t in p.tiers] == [n for n, _ in QS_PLANS[plan]]
    assert [t.n for t in p.tiers] == list(widths)
    assert [t.off for t in p.tiers] == [sum(widths[:k])
                                        for k in range(len(widths))]
    assert [t.int8 for t in p.tiers] == [f == "int8"
                                         for _, f in QS_PLANS[plan]]
    # every column in one strip, every row in one block of the cluster
    assert p.strips == math.ceil(d_out / qops.COLS)
    assert p.rows == math.ceil(d_in / qops.CLUSTER)
    assert p.smem == p.rows * qops.COLS * 4
    assert p.smem + qops.STATIC_SMEM <= qops.MAX_SMEM
    # the lane rule serves each column from the tier that holds it
    for c in range(d_out):
        t = _qs_tier_of(p, c)
        assert t.off <= c < t.off + t.n


def _split_weight_stacked(ws, counts, formats):
    """``split_weight`` of each matrix, each output stacked over them."""
    per = [hl_split_weight(w, dict(counts), formats=formats) for w in ws]
    return {name: (dict(seg) if seg.get("empty") else
                   {k: torch.stack([p[name][k] for p in per]) for k in seg})
            for name, seg in per[0].items()}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("d_in,d_out,plan,widths", QS_CASES)
def test_quant_split_schedule_writes_each_output_once_bitwise(
        d_in, d_out, plan, widths, aligned):
    """The kernel's schedule with 16-byte staging where the matrices
    allow it (``aligned`` and d_out % 4 == 0) and with 4-byte staging,
    which the kernel takes for matrices off 16-byte alignment."""
    ws = _qs_inputs(3, d_in, d_out, seed=d_in * 31 + d_out)
    p = _qs_plan(d_in, d_out, plan, widths)
    counts = dict(zip((n for n, _ in QS_PLANS[plan]), widths))
    formats = dict(QS_PLANS[plan])
    want = _split_weight_stacked(ws, counts, formats)
    got = _emulate_quant_split(ws, p, vec=aligned and d_out % 4 == 0)
    assert list(want) == list(counts)
    for t in p.tiers:
        if t.n == 0:
            assert want[t.name] == {"empty": True} and t.name not in got
            continue
        assert list(got[t.name]) == list(want[t.name])
        for f, (vals, writes) in got[t.name].items():
            assert (writes == 1).all(), (t.name, f)
            assert torch.equal(vals.reshape(want[t.name][f].shape),
                               want[t.name][f]), (t.name, f)


def test_quant_split_plan_at_the_fleet_shape():
    """internlm2_1_8b's 48 x (2048, 8192): 256 strips of 8 blocks
    whatever the placement, each block 256 rows in 32 KB, six blocks an
    SM by shared memory (228 KB an SM, 1 KB of it reserved a block)."""
    for widths in ((0, 1568, 0, 6624), (2100, 1900, 2200, 1992)):
        p = _qs_plan(2048, 8192, "legacy", widths)
        assert (p.strips, p.rows, p.smem) == (256, 256, 32768)
        assert 228 * 1024 // (p.smem + qops.STATIC_SMEM + 1024) == 6


def test_quant_split_plan_rejects_what_the_kernel_cannot_hold():
    ok = (("a", True, 8),)
    d_max = qops.CLUSTER * qops.MAX_ROWS
    assert qops.split_plan(d_max, 8, ok).rows == qops.MAX_ROWS
    with pytest.raises(ValueError, match="rows a block"):
        qops.split_plan(d_max + 1, 8, ok)
    with pytest.raises(ValueError, match="do not sum"):
        qops.split_plan(4, 9, ok)
    with pytest.raises(ValueError, match="-1 columns"):
        qops.split_plan(4, 8, (("a", True, 9), ("b", False, -1)))
    with pytest.raises(ValueError, match="1 to 8 tiers"):
        qops.split_plan(4, 9, tuple((f"t{k}", True, 1) for k in range(9)))
    with pytest.raises(ValueError, match="d_in, d_out >= 1"):
        qops.split_plan(0, 8, ok)


def test_quant_split_matrix_table_checks_and_alignment():
    ws = [torch.zeros((4, 8)), torch.ones((4, 8))]
    tab = qops.matrix_table(ws)
    assert tab.ws[0] is ws[0] and tab.ptrs is None and tab.vec
    assert not qops.matrix_table([torch.zeros((4, 6))]).vec   # d_out % 4
    odd = torch.zeros(40)[1:33].view(4, 8)                    # 4-byte offset
    assert not qops.matrix_table([odd]).vec
    for bad, err in [([], ValueError), ([torch.zeros((4, 8)).double()],
                                        TypeError),
                     ([torch.zeros((4, 8)), torch.zeros((4, 9))], ValueError),
                     ([torch.zeros((8, 4)).t()], ValueError),
                     ([torch.zeros((2, 4, 8))], ValueError)]:
        with pytest.raises(err):
            qops.matrix_table(bad)


def test_quant_split_takes_cuda_tensors_only():
    """No plain path inside the wrapper: CPU matrices raise, launch
    nothing, and the serve engine runs split_weight there itself."""
    ws = _qs_inputs(2, 24, 50, seed=7)
    n0 = qops.quant_split.launches
    with pytest.raises(ValueError, match="cuda tensors"):
        qops.quant_split(qops.matrix_table(ws), {"a": 50}, {"a": "int8"})
    assert qops.quant_split.launches == n0


# -- decode_attn: the plan and the chunked schedule ---------------------------

def _decode_attn_configs():
    """The registry's configs whose decode runs ``attention_decode``
    (attention blocks without MLA), by name."""
    from repro_torch.configs.registry import all_configs
    return {a: c for a, c in all_configs().items()
            if "attn" in c.pattern_for_depth() and not c.kv_lora_rank}


@pytest.mark.parametrize("C", [16, 128, 256, 257, 2048, 32768])
@pytest.mark.parametrize("arch", sorted(_decode_attn_configs()))
def test_decode_attn_plan_for_the_registry(arch, C):
    """At B=16: a ring of up to 256 slots whose rows fit one block's
    shared memory is one block per (row, KV head) and one launch; a
    longer ring is cut into power-of-two chunks that cover it once and
    give FILL blocks or the smallest chunk; shared memory fits. Head
    widths without a build raise (pixtral_12b's 160)."""
    cfg = _decode_attn_configs()[arch]
    C = min(C, cfg.local_window) if cfg.attn_kind == "local" else C
    B, H, KV, hd = 16, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if hd not in daops.HEAD_DIMS:
        with pytest.raises(ValueError, match="head widths"):
            daops.decode_plan(B, H, KV, hd, C)
        return
    plan = daops.decode_plan(B, H, KV, hd, C)
    assert plan.group == H // KV and plan.group <= plan.tile * 2
    assert plan.tile in (2, 4, 8) and (plan.tile >= plan.group
                                        or plan.tile == 8)
    assert (plan.n_chunks - 1) * plan.chunk < C <= plan.n_chunks * plan.chunk
    one = daops._smem(C, hd, plan.group, plan.tile, False)[0]
    if C <= daops.SHORT_RING and one <= daops.MAX_SMEM:
        assert plan == daops.DecodePlan(plan.group, plan.tile, C, 1, one, 0)
    else:
        assert plan.n_chunks >= 2 and plan.chunk & (plan.chunk - 1) == 0
        assert (B * KV * plan.n_chunks >= daops.FILL
                or plan.chunk == daops.MIN_CHUNK)
        assert (plan.smem, plan.smem_values) == daops._smem(
            plan.chunk, hd, plan.group, plan.tile, True)
    assert plan.smem <= daops.MAX_SMEM
    assert plan.smem_values + daops.STATIC_SMEM <= daops.MAX_SMEM


def test_decode_attn_plan_at_the_cells_shape():
    """internlm2_1_8b's decode in the benchmark's cells (B=16, 16 heads
    over 8 KV heads of 128, ring 128): 128 blocks of one launch, 70 KB of
    shared memory each."""
    plan = daops.decode_plan(16, 16, 8, 128, 128)
    assert plan == daops.DecodePlan(2, 2, 128, 1, 71680, 0)


@pytest.mark.parametrize("args", [
    (16, 16, 8, 160, 128), (16, 64, 2, 128, 128), (16, 12, 8, 128, 128),
    (0, 16, 8, 128, 128), (16, 16, 8, 128, 0), (70000, 16, 8, 128, 128)])
def test_decode_attn_plan_rejects_what_the_kernel_cannot_take(args):
    with pytest.raises(ValueError):
        daops.decode_plan(*args)


def _decode_attn_schedule(plan, q, ck, cv, pos):
    """The kernels' arithmetic on rotated q (B, 1, H, hd) and written
    caches, chunk by chunk as the blocks run it: scores of the valid
    slots in fp32, then alone a softmax, chunked each chunk's max and sum
    of exp, the global ones, and the chunks' value sums added in chunk
    order; probabilities and the output rounded to bf16. Also returns
    how many blocks read each (row, KV head, slot)."""
    B, _, H, hd = q.shape
    C, KV = ck.shape[1], ck.shape[2]
    g = H // KV
    out = torch.empty((B, 1, H * hd), dtype=torch.bfloat16)
    reads = torch.zeros((B, KV, C), dtype=torch.int64)
    scale = daops.score_scale(hd)
    for b in range(B):
        p = int(pos[b]) if pos.ndim else int(pos)
        n = min(p + 1, C)
        for kh in range(KV):
            qg = q[b, 0, kh * g:(kh + 1) * g].float()          # (g, hd)
            chunks = []
            for c in range(plan.n_chunks):
                t0, t1 = c * plan.chunk, min((c + 1) * plan.chunk, n)
                if t0 >= n:
                    continue
                reads[b, kh, t0:t1] += 1
                s = (qg @ ck[b, t0:t1, kh].float().T) * scale   # (g, t)
                chunks.append((t0, t1, s))
            if plan.n_chunks == 1:
                t0, t1, s = chunks[0]
                e = torch.exp(s - s.amax(dim=1, keepdim=True))
                pr = (e / e.sum(dim=1, keepdim=True)).bfloat16().float()
                acc = pr @ cv[b, t0:t1, kh].float()
            else:
                m = torch.stack([s.amax(dim=1) for _, _, s in chunks])
                ls = torch.stack([torch.exp(s - m[i][:, None]).sum(dim=1)
                                  for i, (_, _, s) in enumerate(chunks)])
                M = m.amax(dim=0)
                L = torch.zeros(g)
                for i in range(len(chunks)):
                    L = L + ls[i] * torch.exp(m[i] - M)
                acc = torch.zeros((g, hd))
                for t0, t1, s in chunks:
                    pr = (torch.exp(s - M[:, None]) / L[:, None]).bfloat16()
                    acc = acc + pr.float() @ cv[b, t0:t1, kh].float()
            out[b, 0, kh * g * hd:(kh + 1) * g * hd] = acc.reshape(-1)
    return out, reads


# B, H, KV, hd, C, positions: the cells' shape past its wrap, a
# recurrentgemma-like window cut into 64 chunks, seamless's groups of one
# head, chatglm's 16 query heads a KV head; rows take the positions in
# turn (below the ring, at its end, past it), then all take the last
DECODE_ATTN_SCHEDULES = [
    (2, 16, 8, 128, 128, [200, 3]),
    (4, 10, 1, 256, 2048, [5, 2047, 2048, 4097]),
    (3, 4, 4, 64, 300, [0, 299, 301]),
    (2, 32, 2, 128, 257, [256, 1000]),
]


@pytest.mark.parametrize("B,H,KV,hd,C,positions", DECODE_ATTN_SCHEDULES)
def test_decode_attn_schedule_reads_each_valid_slot_once(B, H, KV, hd, C,
                                                         positions):
    """The plan's blocks read every valid slot of every (row, KV head)
    once and no other; their arithmetic, one pass or chunked, comes
    within ``decode_attn_atol`` (one bf16 step of each element and a
    quarter of the largest |output|) of the plain version (``decode_attn_plain``, whose cache writes the
    schedule then reads)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.attention import decode_attn_plain
    from repro_torch.models.common import apply_rope
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), n_heads=H,
                              n_kv_heads=KV, head_dim=hd,
                              dtype=torch.bfloat16)
    assert cfg.hd == hd
    plan = daops.decode_plan(B, H, KV, hd, C)
    gen = torch.Generator().manual_seed(C)
    cache = {n: torch.randn((B, C, KV, hd), generator=gen).bfloat16()
             for n in ("k", "v")}
    per_row = torch.tensor([positions[b % len(positions)]
                            for b in range(B)])
    for pos in (per_row, torch.tensor(positions[-1])):
        q = torch.randn((B, 1, H, hd), generator=gen).bfloat16()
        k = torch.randn((B, 1, KV, hd), generator=gen).bfloat16()
        v = torch.randn((B, 1, KV, hd), generator=gen).bfloat16()
        want = decode_attn_plain(q, k, v, cfg, cache, pos)
        rows = pos.expand(B)
        qr = apply_rope(q, rows[:, None], cfg.rope_kind)
        got, reads = _decode_attn_schedule(plan, qr, cache["k"],
                                           cache["v"], rows)
        n = torch.clamp(rows + 1, max=C)
        assert torch.equal(reads, (torch.arange(C)[None, None, :]
                                   < n[:, None, None]).long()
                           .expand(B, KV, C))
        assert over_limit(got, want) <= 1.0, (pos, over_limit(got, want))


@pytest.mark.parametrize("which", ["scores", "values"])
@pytest.mark.parametrize("B,H,KV,hd,C,positions", DECODE_ATTN_SCHEDULES)
def test_decode_attn_limit_catches_bf16_sums(B, H, KV, hd, C, positions,
                                             which):
    """The same attention with the scores' dot products or the value
    product summed in bf16 (``bf16_sums``) lies beyond 1.5 times
    ``decode_attn_atol`` of the plain version somewhere, where the
    schedule's fp32 sums stay within it: the limit tells fp32 sums from
    bf16 ones."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.attention import decode_attn_plain
    from repro_torch.models.common import apply_rope
    cfg = dataclasses.replace(get_smoke_config("internlm2_1_8b"), n_heads=H,
                              n_kv_heads=KV, head_dim=hd,
                              dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(C + 1)
    cache = {n: torch.randn((B, C, KV, hd), generator=gen).bfloat16()
             for n in ("k", "v")}
    pos = torch.tensor([positions[b % len(positions)] for b in range(B)])
    q = torch.randn((B, 1, H, hd), generator=gen).bfloat16()
    k = torch.randn((B, 1, KV, hd), generator=gen).bfloat16()
    v = torch.randn((B, 1, KV, hd), generator=gen).bfloat16()
    want = decode_attn_plain(q, k, v, cfg, cache, pos)
    qr = apply_rope(q, pos[:, None], cfg.rope_kind)
    got = bf16_sums(qr, cache["k"], cache["v"], pos, which)
    assert over_limit(got, want) > 1.5, (which, over_limit(got, want))
