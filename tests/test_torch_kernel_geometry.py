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
versions bit for bit.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.multipool import combine_many  # noqa: E402
from repro_torch.core.multipool import combine_rows_torch  # noqa: E402
from repro_torch.kernels.knapsack_dp import ops as kops  # noqa: E402
from repro_torch.kernels.knapsack_dp.ref import dp_stages_ref  # noqa: E402
from repro_torch.kernels.lut_pipeline import ops as lops  # noqa: E402
from repro_torch.kernels.lut_pipeline.ref import tie_heavy_rows  # noqa: E402
from repro_torch.kernels.pim_mac import ops as pops  # noqa: E402

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
