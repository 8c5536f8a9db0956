"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card (the
check runs inside the test, so every worker collects the same tests).
The file imports neither JAX nor the JAX package, so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.multipool import combine_rows_torch  # noqa: E402
from repro_torch.kernels.knapsack_dp import ops as kops  # noqa: E402
from repro_torch.kernels.knapsack_dp.ref import dp_stages_ref  # noqa: E402
from repro_torch.kernels.lut_pipeline import ops as lops  # noqa: E402
from repro_torch.kernels.lut_pipeline.ref import (  # noqa: E402
    lut_pipeline_ref, tie_heavy_rows)
from repro_torch.kernels.pim_mac import ops as pops  # noqa: E402
from repro_torch.kernels.pim_mac.ref import pim_matmul_ref  # noqa: E402

SHAPES = [  # V, C, n, T, K, R
    (1, 2, 2, 24, 4, 6),           # the edge/pool topology
    (2, 3, 1, 30, 5, 7),           # cxl-tier-3-like, variant-batched
    (3, 1, 2, 16, 3, 4),           # single cluster (no fold)
    (2, 5, 1, 32, 6, 9),           # deep fold
    (2, 2, 2, 3000, 256, 33),      # main-path K, many rows
    (1, 1, 1, 500, 1100, 7),       # K wider than one block
]


def _problem(seed, V, C, n, T, K, R, dev):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, max(2, T // 3), size=(V, C, n))
    e = rng.integers(1, 40, size=(V, C, n)).astype(np.float32)
    rows = rng.integers(0, T + 1, size=(V, R))
    e[0, C - 1, n - 1], t[0, C - 1, n - 1] = np.inf, 1   # inert pad
    return (torch.as_tensor(t, dtype=torch.int32, device=dev),
            torch.as_tensor(e, dtype=torch.float32, device=dev),
            torch.as_tensor(rows, dtype=torch.int32, device=dev))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("V,C,n,T,K,R", SHAPES)
def test_cuda_kernels_match_plain_versions(V, C, n, T, K, R):
    dev = _card()
    t, e, rows = _problem(V * 7919 + C * 31 + n, V, C, n, T, K, R, dev)
    n0, m0 = kops.dp_stages.launches, lops.minplus_combine.launches
    stages, min_e, splits = lops.lut_build(t, e, T, K, rows, device=dev)
    torch.cuda.synchronize()
    assert (kops.dp_stages.launches, lops.minplus_combine.launches) == \
        (n0 + 1, m0 + 1)
    ref = lut_pipeline_ref(t, e, rows, T=T, K=K)
    assert torch.equal(stages, ref[0])
    assert torch.equal(min_e, ref[1])
    assert torch.equal(splits, ref[2])
    assert torch.equal(stages, dp_stages_ref(t, e, T, K))


@pytest.mark.gpu
def test_cuda_knapsack_dp_matches_plain_version():
    dev = _card()
    t_l, e_l, T, K = [18, 18], [3.25, 1.5], 2000, 256
    ours = kops.knapsack_dp(t_l, e_l, T, K, device=dev, return_stages=True)
    ref = kops.knapsack_dp(t_l, e_l, T, K, device="cpu", return_stages=True)
    assert torch.equal(ours.cpu(), ref)


# (V, C, n, T, K, t): t_i = 1 (a dependency every row), t_i > T (no take
# at all), K = 0, t_i differing per (v, c) in one call, and the gpu-pool
# shape of knapsack_dp
DP_EDGE_CASES = [
    (1, 1, 2, 300, 40, [[[1, 1]]]),
    (1, 2, 1, 50, 9, [[[51], [400]]]),
    (2, 1, 2, 70, 0, [[[2, 5]], [[1, 3]]]),
    (2, 3, 2, 900, 70, [[[18, 18], [1, 33], [7, 901]],
                        [[3, 2], [64, 1], [18, 5]]]),
    (1, 1, 2, 14376, 256, [[[18, 18]]]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("V,C,n,T,K,ts", DP_EDGE_CASES)
def test_cuda_dp_stages_chain_edge_cases(V, C, n, T, K, ts):
    dev = _card()
    rng = np.random.default_rng(T + K)
    t = torch.tensor(ts, dtype=torch.int32, device=dev)
    e = torch.as_tensor(rng.uniform(0.5, 40.0, size=(V, C, n)),
                        dtype=torch.float32, device=dev)
    rows = torch.as_tensor(rng.integers(0, T + 1, size=(V, 5)),
                           dtype=torch.int32, device=dev)
    n0 = kops.dp_stages.launches
    stages, g = kops.dp_stages(t, e, T, K, rows)
    torch.cuda.synchronize()
    assert kops.dp_stages.launches == n0 + 1
    ref = dp_stages_ref(t, e, T, K)
    assert torch.equal(stages, ref)
    vi = torch.arange(V, device=dev).view(V, 1, 1)
    ci = torch.arange(C, device=dev).view(1, C, 1)
    assert torch.equal(g, ref[:, :, -1][vi, ci, rows.long().unsqueeze(1)])


@pytest.mark.gpu
def test_cuda_wrappers_raise_instead_of_falling_back():
    dev = _card()
    t = torch.zeros((1, 1, 1), dtype=torch.int32, device=dev)
    e = torch.ones((1, 1, 1), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match=">= 1 tick"):
        kops.dp_stages(t, e, 8, 2)
    with pytest.raises(ValueError, match="share a device"):
        kops.dp_stages(t.cpu() + 1, e, 8, 2)


# V, C, R, K of the combine's tie-heavy rows: the gpu-pool and
# cxl-tier-3 grids, synthetic C=5, C=1, K=0, K+1 < 32, K+1 not a
# multiple of 32, K+1 > blockDim, and K=2047 at C=5 (80 KB of shared
# memory, above the 48 KB that needs the opt-in)
COMBINE_SHAPES = [
    (6, 2, 33, 256), (6, 3, 33, 256), (2, 5, 33, 256), (3, 1, 12, 256),
    (2, 3, 12, 0), (2, 4, 12, 20), (2, 3, 12, 40), (1, 5, 12, 1100),
    (1, 5, 6, 2047),
]


@pytest.mark.gpu
@pytest.mark.parametrize("V,C,R,K", COMBINE_SHAPES)
def test_cuda_minplus_combine_ties_infeasible_rows_and_shapes(V, C, R, K):
    dev = _card()
    g = tie_heavy_rows(V, C, R, K, seed=V * 1000 + C * 100 + K, device=dev)
    n0 = lops.minplus_combine.launches
    min_e, splits = lops.minplus_combine(g)
    torch.cuda.synchronize()
    assert lops.minplus_combine.launches == n0 + 1
    ref_e, ref_s = combine_rows_torch(g)
    assert torch.equal(min_e, ref_e)
    assert torch.equal(splits, ref_s)


@pytest.mark.gpu
def test_cuda_minplus_combine_raises_beyond_shared_memory():
    dev = _card()
    g = torch.zeros((1, 5, 1, 5805), dtype=torch.float32, device=dev)
    n0 = lops.minplus_combine.launches
    with pytest.raises(ValueError, match=r"\(1, 5, 1, 5805\) needs"):
        lops.minplus_combine(g)
    assert lops.minplus_combine.launches == n0
    min_e, _ = lops.minplus_combine(g[..., :5804].contiguous())
    assert lops.minplus_combine.launches == n0 + 1
    assert torch.equal(min_e, torch.zeros((1, 1), device=dev))


# M, K, N: decode with ragged tier widths, one token, the library-call
# shape, a prefill-sized M, and the ragged shapes of tests/test_kernels.py
PIM_SHAPES = [
    (16, 2048, 928), (16, 2048, 7264), (1, 2048, 8192), (32, 2048, 8192),
    (256, 2048, 8192),
    (16, 64, 14), (16, 64, 114), (37, 129, 255), (100, 70, 50), (8, 8, 8),
]


def _pim_case(seed, M, K, N, dev, lo=-128):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randint(lo, 128, (M, K), dtype=torch.int8, generator=g)
    w = torch.randint(lo, 128, (K, N), dtype=torch.int8, generator=g)
    sx = torch.rand(M, generator=g) * 0.2 + 1e-3
    sw = torch.rand(N, generator=g) * 0.2 + 1e-3
    return [t.to(dev) for t in (x, w, sx, sw)]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", PIM_SHAPES)
def test_cuda_pim_mac_matches_plain_version(M, K, N, out_dtype):
    dev = _card()
    x, w, sx, sw = _pim_case(M * 7 + K * 3 + N, M, K, N, dev)
    n0 = pops.pim_matmul.launches
    out = pops.pim_matmul(x, w, sx, sw, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert pops.pim_matmul.launches == n0 + 1
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert torch.equal(out, pim_matmul_ref(x, w, sx, sw, out_dtype))


# N at and around multiples of 16 (the vector-load rows) and of the
# 128-column tile, crossed with K around the 64-row step and M around the
# m16 tile and the two-tile block
PIM_BOUNDARY_N = [15, 16, 17, 127, 128, 129, 2560]


@pytest.mark.gpu
@pytest.mark.parametrize("K", [129, 2047, 2048, 4096])
@pytest.mark.parametrize("M", [1, 16, 17, 32, 256])
def test_cuda_pim_mac_split_and_vector_boundaries(M, K):
    dev = _card()
    for N in PIM_BOUNDARY_N:
        x, w, sx, sw = _pim_case(M * 131 + K * 7 + N, M, K, N, dev)
        for od in (torch.float32, torch.bfloat16):
            out = pops.pim_matmul(x, w, sx, sw, out_dtype=od)
            assert torch.equal(out, pim_matmul_ref(x, w, sx, sw, od)), \
                (M, K, N, od)


@pytest.mark.gpu
def test_cuda_pim_mac_every_split_count():
    # one call at each split count the wrapper can choose for K = 2048
    # (32 steps of 64 rows): widening N gives fewer splits
    dev = _card()
    sms = pops._sm_count(dev)
    K, steps = 2048, 32
    found = {}
    for tiles in range(1, 4 * sms + 2):
        p = pops.split_plan(16, K, tiles * pops.BN - 5, sms)
        found.setdefault(p.splits, tiles * pops.BN - 5)
    least = -(-steps // pops.MAX_SPLITS)          # steps per split
    assert set(found) == {-(-steps // per)
                          for per in range(least, steps + 1)}
    for splits, N in sorted(found.items()):
        x, w, sx, sw = _pim_case(splits, 16, K, N, dev)
        out = pops.pim_matmul(x, w, sx, sw)
        assert torch.equal(out, pim_matmul_ref(x, w, sx, sw)), (splits, N)


@pytest.mark.gpu
def test_cuda_pim_mac_ragged_n_sweep_and_scalar_scales():
    dev = _card()
    for N in list(range(1, 70)) + [127, 129, 191, 193, 1000]:
        x, w, sx, sw = _pim_case(N, 16, 96, N, dev)
        out = pops.pim_matmul(x, w, sx, sw)
        assert torch.equal(out, pim_matmul_ref(x, w, sx, sw)), N
    out = pops.pim_matmul(x, w, 0.03, torch.tensor(0.5, device=dev))
    assert torch.equal(out, pim_matmul_ref(x, w, 0.03, 0.5))


@pytest.mark.gpu
def test_cuda_pim_mac_worst_case_int32_accumulation():
    dev = _card()
    K = 2048
    x = torch.full((16, K), 127, dtype=torch.int8, device=dev)
    w = torch.full((K, 40), -127, dtype=torch.int8, device=dev)
    w[:, ::2] = 127
    one = torch.ones(16, device=dev), torch.ones(40, device=dev)
    out = pops.pim_matmul(x, w, *one)
    expect = torch.tensor([127 * 127 * K, -127 * 127 * K] * 20,
                          dtype=torch.float32, device=dev)
    assert torch.equal(out, expect.expand(16, 40))
    assert torch.equal(out, pim_matmul_ref(x, w, *one))


@pytest.mark.gpu
def test_cuda_pim_mac_raises_instead_of_falling_back():
    dev = _card()
    x, w, sx, sw = _pim_case(1, 4, 32, 8, dev)
    with pytest.raises(TypeError, match="int8"):
        pops.pim_matmul(x.float(), w, sx, sw)
    with pytest.raises(ValueError, match="contiguous"):
        pops.pim_matmul(x, w.t().contiguous().t(), sx, sw)
    with pytest.raises(ValueError, match="w_i8 on cpu"):
        pops.pim_matmul(x, w.cpu(), sx, sw)


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 640, 3839, 5120, 7680])
@pytest.mark.parametrize("M", [4, 16])
def test_cuda_pim_mac_at_the_recurrentgemma_width(M, N):
    # K = d_model = 2560 and tier widths up to d_ff = 7680: the int8 tiers
    # of recurrentgemma_2b's FFN matrices
    dev = _card()
    x, w, sx, sw = _pim_case(M + N, M, 2560, N, dev)
    for od in (torch.float32, torch.bfloat16):
        out = pops.pim_matmul(x, w, sx, sw, out_dtype=od)
        assert torch.equal(out, pim_matmul_ref(x, w, sx, sw, od)), od


# -- the model families, CUDA against the CPU --------------------------------

# fp32 logits of the smoke models, CUDA against the CPU: sums of at most a
# few hundred terms taken in another order, through at most 16 blocks
FAMILY_ATOL = 1e-4
FAMILIES = ["arctic_480b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
            "xlstm_1_3b", "seamless_m4t_medium", "pixtral_12b"]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _family_run(cfg, params, dev, toks, extra):
    """forward, prefill and three decode steps (the last with per-row
    positions) on ``dev``; every logits tensor, on the CPU."""
    from repro_torch.models import lm
    p = _to(params, dev)
    toks = toks.to(dev)
    extra = _to(extra, dev)
    outs = [lm.forward(p, cfg, toks, **extra)[0]]
    logits, st = lm.prefill(p, cfg, toks, max_len=16, **extra)
    outs.append(logits)
    n = toks.shape[1] + cfg.n_prefix_embeds
    for i, pos in enumerate((n, n + 1, torch.tensor([n + 2, 3]))):
        logits, st = lm.decode_step(p, cfg, st, toks[:, i],
                                    _to(torch.as_tensor(pos), dev))
        outs.append(logits)
    return [o.cpu() for o in outs]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_cuda_families_match_cpu(arch):
    """Every family's smoke model (fp32, TF32 off) on the card against the
    same params and inputs on the CPU: forward with its prefix embeddings
    or encoder frames, prefill, and decode steps."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    dev = _card()
    cfg = get_smoke_config(arch)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 6), generator=g)
    extra = {}
    if cfg.n_prefix_embeds:
        extra["prefix_embeds"] = torch.randn(
            (2, cfg.n_prefix_embeds, cfg.d_model), generator=g)
    if cfg.is_encdec:
        extra["enc_frames"] = torch.randn((2, 5, cfg.d_model), generator=g)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ours = _family_run(cfg, params, dev, toks, extra)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ref = _family_run(cfg, params, torch.device("cpu"), toks, extra)
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert a.shape == b.shape
        err = float((a - b).abs().max())
        assert err <= FAMILY_ATOL, (arch, i, err)


# -- the serving fleet, CUDA against the CPU ---------------------------------


def _fleet_run(dev, params, cfg):
    """A 2-engine gpu-pool-mixed smoke fleet (dp LUTs, DVFS grid,
    decode=True) on ``dev`` over 8 slices of an mmpp trace."""
    from repro_torch import api
    from repro_torch.fleet import make_trace, summarize
    pc = api.compiler(device=dev)
    fl = api.fleet("gpu-pool-mixed", cfg, n_engines=2, params=_to(params, dev),
                   decode=True, solver="dp", dvfs=True, forecaster="holt",
                   max_batch=4, compiler=pc, device=dev)
    res = fl.run(make_trace("mmpp", n_slices=8, seed=0))
    return fl, res, summarize(res), pc


@pytest.mark.gpu
def test_cuda_fleet_matches_cpu():
    """The fleet's LUTs built by the two placement kernels and its
    workers' tiers: the same reports, summary and build counts as on the
    CPU, every int8 tier and scale bitwise, and ``tiered_forward``'s
    int8 columns through ``pim_mac`` bitwise to the same segments
    composed on the CPU."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.models.hetero_linear import tiered_matmul
    dev = _card()
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    n0, m0 = kops.dp_stages.launches, lops.minplus_combine.launches
    ours = _fleet_run(dev, params, cfg)
    assert kops.dp_stages.launches > n0
    assert lops.minplus_combine.launches > m0
    ref = _fleet_run(torch.device("cpu"), params, cfg)
    assert dataclasses.asdict(ours[1]) == dataclasses.asdict(ref[1])
    assert ours[2] == ref[2]
    a, b = ours[3].stats(), ref[3].stats()
    assert a.pop("builds_by_backend") == {"cuda": a["builds"]}
    assert b.pop("builds_by_backend") == {"cpu": b["builds"]}
    assert a == b
    x = torch.randn((16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    p0 = pops.pim_matmul.launches
    for wt, wr in zip(ours[0].workers, ref[0].workers, strict=True):
        assert list(wt.hetero._tiered) == list(wr.hetero._tiered)
        for key, segs in wr.hetero._tiered.items():
            for tier, seg in segs.items():
                for f in ("q", "scale"):
                    if f in seg:
                        assert torch.equal(wt.hetero._tiered[key][tier][f]
                                           .cpu(), seg[f]), (key, tier, f)
        segs = wt.hetero._tiered[next(iter(wt.hetero._tiered))]
        y = wt.hetero.tiered_forward(x.to(dev)).cpu()
        cpu_segs = {k: {f: (v.cpu() if isinstance(v, torch.Tensor) else v)
                        for f, v in s.items()} for k, s in segs.items()}
        y_cpu = tiered_matmul(x, cpu_segs)
        off = 0
        for s in segs.values():
            if s.get("empty"):
                continue
            n = (s["q"] if "q" in s else s["w"]).shape[1]
            if "q" in s:
                assert torch.equal(y[:, off:off + n], y_cpu[:, off:off + n])
            off += n
    assert pops.pim_matmul.launches > p0


# -- training, CUDA against the CPU -------------------------------------------

# fp32 smoke training (TF32 off): a loss is a mean of O(100)
# log-probabilities, each a sum of a few hundred terms in another order
TRAIN_LOSS_RTOL = 1e-5
# a gradient leaf against its own largest entry; a leaf whose CPU
# gradient is below GRAD_NOISE_SHARE of the tree's largest |g| is
# cancellation noise and held to that level on the card too
TRAIN_GRAD_RTOL = 1e-4
GRAD_NOISE_SHARE = 1e-7
# three Trainer steps: each AdamW update is about lr * sign(g), so an
# entry whose gradient is rounding noise moves by up to 2 * lr on one
# device against the other; the loss feels that far below 1e-4
TRAINER_RTOL = 1e-4


def _smoke_trainer(dev, params, steps, compression=False):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import OptimizerConfig
    from repro_torch.optim.compression import init_error_state
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("internlm2_1_8b")
    t = Trainer(cfg, OptimizerConfig(lr=3e-3, warmup_steps=2,
                                     total_steps=steps),
                DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8),
                TrainerConfig(steps=steps, grad_compression=compression),
                device=dev)
    # a copy: the optimizer writes the params in place
    t.params = tree_map(lambda x: x.to(dev, copy=True), params)
    t.opt_state = t.opt.init(t.params)
    if compression:
        t.error_state = init_error_state(t.params)
    t.run()
    return [m["loss"] for m in t.metrics_log]


@pytest.mark.gpu
@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "compressed"])
def test_cuda_training_matches_cpu(compression):
    """The dense smoke model's loss gradients and three Trainer steps on
    the card against the same params and batches on the CPU, in fp32
    with TF32 off, launching none of the port's kernels."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.models import lm
    from repro_torch.train.step import make_loss_fn, value_and_grad
    from repro_torch.tree import flatten_with_path
    dev = _card()
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        cfg.vocab_size, 32, 8)).batch(0).items()}
    counts = (kops.dp_stages.launches, lops.minplus_combine.launches,
              pops.pim_matmul.launches)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        (lc, _), gc = value_and_grad(make_loss_fn(cfg), _to(params, dev),
                                     _to(batch, dev))
        ours = _smoke_trainer(dev, params, 3, compression)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (lr, _), gr = value_and_grad(make_loss_fn(cfg), params, batch)
    ref = _smoke_trainer(torch.device("cpu"), params, 3, compression)
    assert abs(float(lc) - float(lr)) <= TRAIN_LOSS_RTOL * abs(float(lr))
    top = max(float(g.abs().max()) for _, g in flatten_with_path(gr))
    for (path, a), (_, b) in zip(flatten_with_path(gc),
                                 flatten_with_path(gr)):
        leaf = float(b.abs().max())
        if leaf <= GRAD_NOISE_SHARE * top:
            assert float(a.abs().max()) <= GRAD_NOISE_SHARE * top, path
        else:
            err = float((a.cpu() - b).abs().max())
            assert err <= TRAIN_GRAD_RTOL * leaf, (path, err, leaf)
    np.testing.assert_allclose(ours, ref, rtol=TRAINER_RTOL)
    assert (kops.dp_stages.launches, lops.minplus_combine.launches,
            pops.pim_matmul.launches) == counts


# -- the recurrent scans (rglru_scan, mlstm_scan, slstm_scan) -----------------

# mLSTM and sLSTM against their plain versions on the card, relative to
# the output's largest |entry|: the kernel sums C q and n q over hd terms
# in another order than torch's einsum, and exp / tanh / log1p need not
# round as torch's build does (a few fp32 ulps, each carried through the
# state)
SCAN_RTOL = 4e-6
# (B, S, d): S = 1, S not a multiple of the kernels' 16- and 8-step
# prefetch, recurrentgemma_2b's and xlstm_1_3b's widths
ELEMENTWISE_SCAN_SHAPES = [(2, 1, 64), (3, 37, 64), (2, 300, 2560),
                           (2, 129, 2048)]
# (B, S, H, hd): the smoke head, ragged heads, xlstm_1_3b's full head
MLSTM_SHAPES = [(2, 1, 4, 16), (2, 37, 4, 16), (1, 20, 2, 100),
                (2, 5, 1, 33), (2, 200, 4, 512)]


def _scan_ops():
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.slstm_scan import ops as sops
    return rops, mops, sops


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d", ELEMENTWISE_SCAN_SHAPES)
def test_cuda_rglru_scan_forward_and_backward_bitwise(B, S, d):
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)
    rops, _, _ = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S * 31 + d)
    a = torch.rand((B, S, d), generator=g, device=dev) * 0.99 + 0.005
    b = torch.randn((B, S, d), generator=g, device=dev)
    dh = torch.randn((B, S, d), generator=g, device=dev)
    n0, m0 = rops.rglru_scan.launches, rops.rglru_scan_bwd.launches
    h = rops.rglru_scan(a, b)
    da, db = rops.rglru_scan_bwd(a, h, dh)
    torch.cuda.synchronize()
    assert (rops.rglru_scan.launches, rops.rglru_scan_bwd.launches) == \
        (n0 + 1, m0 + 1)
    assert torch.equal(h, rglru_scan_ref(a, b))
    rda, rdb = rglru_scan_bwd_ref(a, h, dh)
    assert torch.equal(da, rda) and torch.equal(db, rdb)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d", ELEMENTWISE_SCAN_SHAPES)
def test_cuda_slstm_scan_matches_plain_version(B, S, d):
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    _, _, sops = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S * 17 + d)
    z, i, f, o = (torch.randn((B, S, d), generator=g, device=dev)
                  for _ in range(4))
    f = f + 3.0                                   # the forget-open bias
    n0 = sops.slstm_scan.launches
    h = sops.slstm_scan(z, i, f, o)
    torch.cuda.synchronize()
    assert sops.slstm_scan.launches == n0 + 1
    assert _rel(h, slstm_scan_ref(z, i, f, o)) <= SCAN_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd", MLSTM_SHAPES)
def test_cuda_mlstm_scan_matches_plain_version(B, S, H, hd):
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
    _, mops, _ = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S * 13 + hd)
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device=dev)
               for _ in range(3))
    k = k / hd ** 0.5
    i = torch.randn((B, S, H), generator=g, device=dev)
    f = torch.nn.functional.logsigmoid(
        torch.randn((B, S, H), generator=g, device=dev) + 3.0)
    n0 = mops.mlstm_scan.launches
    h = mops.mlstm_scan(q, k, v, i, f)
    torch.cuda.synchronize()
    assert mops.mlstm_scan.launches == n0 + 1
    assert _rel(h, mlstm_scan_ref(q, k, v, i, f)) <= SCAN_RTOL


@pytest.mark.gpu
def test_cuda_scans_raise_instead_of_falling_back():
    rops, mops, sops = _scan_ops()
    dev = _card()
    x = torch.zeros((2, 5, 8), device=dev)
    counts = (rops.rglru_scan.launches, mops.mlstm_scan.launches,
              sops.slstm_scan.launches)
    with pytest.raises(TypeError, match="float32"):
        rops.rglru_scan(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        sops.slstm_scan(*(x.transpose(0, 1),) * 4)
    with pytest.raises(ValueError, match="operands on"):
        rops.rglru_scan(x, x.cpu())
    q = torch.zeros((2, 5, 1, 513), device=dev)
    gi = torch.zeros((2, 5, 1), device=dev)
    with pytest.raises(ValueError, match="hd <= 512"):
        mops.mlstm_scan(q, q, q, gi, gi)
    assert counts == (rops.rglru_scan.launches, mops.mlstm_scan.launches,
                      sops.slstm_scan.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_1_3b"])
def test_cuda_recurrent_blocks_launch_one_scan_each(arch):
    """Each recurrent block of the smoke model on the card: one scan
    launch per block without autograd; RG-LRU also while autograd
    records, with one backward launch; the outputs and the RG-LRU's
    gradients within FAMILY_ATOL of the CPU's (fp32, TF32 off)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm, recurrent
    rops, mops, sops = _scan_ops()
    dev = _card()
    cfg = get_smoke_config(arch)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    x = torch.randn((2, 37, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, kind in enumerate(cfg.pattern_for_depth()):
            if kind == "attn":
                continue
            mix = params["stack"][f"tail_{i}"]["mix"]
            block = getattr(recurrent, f"{kind}_block")
            op = {"rglru": rops.rglru_scan, "mlstm": mops.mlstm_scan,
                  "slstm": sops.slstm_scan}[kind]
            n0 = op.launches
            with torch.no_grad():
                y = block(_to(mix, dev), x.to(dev), cfg)
            assert op.launches == n0 + 1, kind
            assert float((y.cpu() - block(mix, x, cfg)).abs().max()) \
                <= FAMILY_ATOL
            if kind != "rglru":
                continue
            b0 = rops.rglru_scan_bwd.launches
            grads = []
            for d in (dev, torch.device("cpu")):
                live = {k: v.to(d).requires_grad_() for k, v in mix.items()}
                block(live, x.to(d), cfg).square().sum().backward()
                grads.append({k: v.grad.cpu() for k, v in live.items()})
            assert rops.rglru_scan_bwd.launches == b0 + 1
            for k, gr in grads[1].items():
                err = float((grads[0][k] - gr).abs().max())
                assert err <= 1e-4 * max(float(gr.abs().max()), 1e-30), k
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
