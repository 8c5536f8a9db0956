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


# the gpu-pool-mixed placements' columns of a (2048, 1408) expert matrix
# (all int8), and a split with every tier filled
QS_EXPERT = [("legacy", (0, 704, 0, 704)), ("legacy", (0, 1000, 0, 408)),
             ("legacy", (300, 400, 333, 375))]


@pytest.mark.gpu
def test_cuda_quant_split_of_expert_views_bitwise():
    """1,664 (2048, 1408) matrices, each the ``[i]`` view of one stacked
    (E, d, f) expert leaf as the serve engine hands them over (no copy):
    one launch per split, every tier of every view bitwise to
    split_weight of that view."""
    from repro_torch.kernels.quant_split import ops as qops
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(29)
    stack = torch.randn((1664, 2048, 1408), generator=g, device=dev)
    ws = list(stack.unbind(0))
    assert all(w.data_ptr() == stack[i].data_ptr() for i, w in
               enumerate(ws))
    assert qops.matrix_table(ws).vec
    for plan, widths in QS_EXPERT:
        _qs_check(ws, plan, widths)


# -- the model families, CUDA against the CPU --------------------------------

# fp32 logits of the smoke models, CUDA against the CPU: sums of at most a
# few hundred terms taken in another order, through at most 16 blocks
FAMILY_ATOL = 1e-4
FAMILIES = ["arctic_480b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
            "xlstm_1_3b", "seamless_m4t_medium", "pixtral_12b",
            "deepseek_v2_lite"]


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


# -- the decode's weights ------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch,over", [
    ("internlm2_1_8b", dict(n_layers=2)),
    ("deepseek_v2_lite", dict(n_layers=2, moe_held=(0, 16)))],
    ids=["internlm2_1_8b", "deepseek_v2_lite"])
def test_cuda_decode_step_casts_no_weight(arch, over):
    """A full-width bf16 engine of two layers (DeepSeek's second an MoE
    layer holding 16 experts), warmed up by two slices: one decode step
    allocates, above what is resident, less than the bf16 size of the
    model's largest matrix, so it casts no weight (it reads the compute
    copy, made once with the engine)."""
    import dataclasses

    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.hetero import _leaves
    dev = _card()
    cfg = dataclasses.replace(get_config(arch), **over)
    params = lm.init_lm(torch.Generator(device=dev).manual_seed(0), cfg)
    eng = api.engine("gpu-pool", cfg, params, max_batch=16, device=dev)
    for _ in range(2):
        eng.run_slice(16)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eng.decode(16)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    largest = max(t.numel() for t in _leaves(params)) * cfg.dtype.itemsize
    assert extra < largest, (arch, extra, largest)


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
# the RG-LRU's rings (tiles of 128 steps forward, 112 backward) besides:
# S around a tile of either, d not a multiple of 32 or of 4 (4-byte
# copies), many tiles at recurrentgemma_2b's width and length, and more
# rows than grid.y's 65535 (the grid has one dimension)
RGLRU_SHAPES = ELEMENTWISE_SCAN_SHAPES + [
    (2, 64, 64), (2, 65, 64), (1, 65, 33), (2, 1000, 100), (2, 4096, 2560),
    (2, 112, 64), (1, 113, 33), (2, 128, 64), (1, 129, 100),
    (70000, 3, 32)]
# the sLSTM's chunked scans (64-step chunks forward and backward, 8-step
# spans backward) besides: one step short of a chunk, one chunk exactly,
# one step past it, S not a multiple of it, d not a multiple of 32 or of
# 4 (4-byte copies), many chunks at full width, and one row of 4096
# steps (the longest chain beside the fewest blocks)
SLSTM_SHAPES = ELEMENTWISE_SCAN_SHAPES + [(2, 63, 64), (2, 64, 64),
                                          (2, 65, 33), (1, 65, 100),
                                          (2, 1000, 33), (2, 4096, 2048),
                                          (1, 4096, 100)]
# (B, S, H, hd): the smoke head, ragged heads, xlstm_1_3b's full head;
# against the mLSTM's 32-step chunks: S < 32, S = 32, S not a multiple
# of 32; hd of 16, 48 and 512, hd not a multiple of 4 or 8
MLSTM_SHAPES = [(2, 1, 4, 16), (2, 37, 4, 16), (1, 20, 2, 100),
                (2, 5, 1, 33), (2, 200, 4, 512), (2, 32, 2, 16),
                (2, 70, 3, 48), (1, 33, 1, 512), (1, 100, 1, 31),
                (2, 64, 2, 1), (1, 77, 2, 200)]


def _scan_ops():
    from repro_torch.kernels.mlstm_scan import ops as mops
    from repro_torch.kernels.rglru_scan import ops as rops
    from repro_torch.kernels.slstm_scan import ops as sops
    return rops, mops, sops


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d", RGLRU_SHAPES)
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
def test_cuda_rglru_scan_unaligned_operands_bitwise():
    """Operands one float into their buffers: d % 4 == 0, but the plan
    takes 4-byte copies."""
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)
    rops, _, _ = _scan_ops()
    dev = _card()
    B, S, d = 2, 130, 64
    g = torch.Generator(device=dev).manual_seed(5)

    def off(x):
        buf = torch.empty(x.numel() + 1, device=dev)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y
    a = off(torch.rand((B, S, d), generator=g, device=dev) * 0.99 + 0.005)
    b, dh = (off(torch.randn((B, S, d), generator=g, device=dev))
             for _ in range(2))
    assert not rops.rglru_plan(B, S, d, aligned=a.data_ptr() % 16 == 0).vec
    h = rops.rglru_scan(a, b)
    href = rglru_scan_ref(a, b)
    assert torch.equal(h, href)
    da, db = rops.rglru_scan_bwd(a, off(href), dh)
    rda, rdb = rglru_scan_bwd_ref(a, href, dh)
    assert torch.equal(da, rda) and torch.equal(db, rdb)


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d", SLSTM_SHAPES)
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


def _mlstm_case(B, S, H, hd, dev, spikes=0.0, offset=0, forget_bias=3.0):
    """q, k, v, i, f as ``mlstm_block`` draws them, f = logsigmoid(randn
    + ``forget_bias``); ``spikes`` added to the input gate at 3% of the
    steps; q, k, v at ``offset`` floats into their buffers (offset 1: not
    16-byte aligned)."""
    g = torch.Generator(device=dev).manual_seed(S * 13 + hd)

    def rnd(*shape):
        n = int(np.prod(shape))
        buf = torch.randn(n + offset, generator=g, device=dev)
        return buf[offset:].view(shape)
    q, k, v = (rnd(B, S, H, hd) for _ in range(3))
    k = k / hd ** 0.5
    i = torch.randn((B, S, H), generator=g, device=dev)
    if spikes:
        i = i + spikes * (torch.rand((B, S, H), generator=g, device=dev)
                          < 0.03)
    f = torch.nn.functional.logsigmoid(
        torch.randn((B, S, H), generator=g, device=dev) + forget_bias)
    return q, k, v, i, f


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd", MLSTM_SHAPES)
def test_cuda_mlstm_scan_matches_plain_version(B, S, H, hd):
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
    _, mops, _ = _scan_ops()
    args = _mlstm_case(B, S, H, hd, _card())
    n0 = mops.mlstm_scan.launches
    h = mops.mlstm_scan(*args)
    torch.cuda.synchronize()
    assert mops.mlstm_scan.launches == n0 + 1
    assert _rel(h, mlstm_scan_ref(*args)) <= SCAN_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("spikes,offset", [(6.0, 0), (0.0, 1)],
                         ids=["clamp-binds", "unaligned"])
def test_cuda_mlstm_scan_clamp_and_unaligned_operands(spikes, offset):
    """Input-gate spikes make |n . q| < 1 at most steps, where h depends
    on the stabilizer m itself; operands 4 bytes off 16-byte alignment
    take the kernel's scalar loads. Both at xlstm_1_3b's head, over many
    chunks."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref
    _, mops, _ = _scan_ops()
    args = _mlstm_case(2, 1024, 4, 512, _card(), spikes, offset)
    h = mops.mlstm_scan(*args)
    torch.cuda.synchronize()
    assert _rel(h, mlstm_scan_ref(*args)) <= SCAN_RTOL


# forget-gate biases of long memory: +6 is the top of the xLSTM paper's
# forget-gate init range (a decay of ~0.9975 a step), +10 keeps the gate
# within ~5e-5 of 1, so that the state sums hundreds to thousands of
# chunks whose terms are still live. There the plain fp32 mLSTM loop's
# own rounding, carried through thousands of steps of state, is of the
# order of SCAN_RTOL, so the mLSTM kernel is held to ref.mlstm_scan_exact
# (float64, the fp32 loop's stabilizer)
LONG_MEMORY_BIASES = [6.0, 10.0]


@pytest.mark.gpu
@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_cuda_mlstm_scan_long_memory(forget_bias):
    """Forget gates near 1 at xlstm_1_3b's head and the main path's
    S = 4096: the state carries every chunk's products, so a rounding
    bias of the C update that older terms' decay would hide adds up."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_exact
    _, mops, _ = _scan_ops()
    args = _mlstm_case(2, 4096, 4, 512, _card(), forget_bias=forget_bias)
    h = mops.mlstm_scan(*args)
    torch.cuda.synchronize()
    rel = _rel(h.double(), mlstm_scan_exact(*args))
    assert rel <= SCAN_RTOL, f"{rel} of the largest |h|"


@pytest.mark.gpu
@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_cuda_slstm_scan_long_memory(forget_bias):
    """The sLSTM's chunked scan where the forget gate is near 1: the
    boundary states the combine pass hands on carry most of c and n."""
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref
    _, _, sops = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(int(forget_bias))
    z, i, f, o = (torch.randn((2, 4096, 2048), generator=g, device=dev)
                  for _ in range(4))
    f = f + forget_bias
    h = sops.slstm_scan(z, i, f, o)
    torch.cuda.synchronize()
    rel = _rel(h, slstm_scan_ref(z, i, f, o))
    assert rel <= SCAN_RTOL, f"{rel} of the largest |h|"


# the mLSTM and sLSTM backward kernels against their plain versions,
# relative to each gradient's largest |entry|: the sums of the chunkwise
# products (over hd, the chunk's steps and the chunks) and of the chunked
# carries run in another order than the loops' (the gate gradients are
# differences of such sums), and exp / tanh / log1p need not round as
# torch's do
BWD_RTOL = 2e-5


def _grads_close(got, ref, rtol=BWD_RTOL):
    for name, a, b in zip("abcde", got, ref):
        assert a.shape == b.shape and a.is_contiguous(), name
        err = float((a.double() - b.double()).abs().max())
        assert err <= rtol * float(b.abs().max()), (name, err, float(
            b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,hd", MLSTM_SHAPES)
def test_cuda_mlstm_scan_bwd_matches_plain_version(B, S, H, hd):
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_bwd_ref
    _, mops, _ = _scan_ops()
    dev = _card()
    args = _mlstm_case(B, S, H, hd, dev)
    h = mops.mlstm_scan(*args)
    dh = torch.randn(h.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(S))
    n0 = mops.mlstm_scan_bwd.launches
    got = mops.mlstm_scan_bwd(*args, h, dh)
    torch.cuda.synchronize()
    assert mops.mlstm_scan_bwd.launches == n0 + 1
    _grads_close(got, mlstm_scan_bwd_ref(*args, h, dh))


@pytest.mark.gpu
@pytest.mark.parametrize("spikes,offset", [(6.0, 0), (0.0, 1)],
                         ids=["clamp-binds", "unaligned"])
def test_cuda_mlstm_scan_bwd_clamp_and_unaligned_operands(spikes, offset):
    """The backward where the clamp binds (m then has a gradient of its
    own) and with operands off 16-byte alignment, at xlstm_1_3b's head
    over many chunks."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_bwd_ref
    _, mops, _ = _scan_ops()
    dev = _card()
    args = _mlstm_case(2, 1024, 4, 512, dev, spikes, offset)
    h = mops.mlstm_scan(*args)
    dh = torch.randn(h.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    got = mops.mlstm_scan_bwd(*args, h, dh)
    _grads_close(got, mlstm_scan_bwd_ref(*args, h, dh))


@pytest.mark.gpu
@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_cuda_mlstm_scan_bwd_long_memory(forget_bias):
    """Forget gates near 1 at xlstm_1_3b's head and S = 4096: the kernel
    within BWD_RTOL of the float64 backward (given the fp32 loop's m), or
    no farther from it than the fp32 plain backward is."""
    from repro_torch.kernels.mlstm_scan.ref import (mlstm_scan_bwd_exact,
                                                    mlstm_scan_bwd_ref)
    _, mops, _ = _scan_ops()
    dev = _card()
    args = _mlstm_case(2, 4096, 4, 512, dev, forget_bias=forget_bias)
    h = mops.mlstm_scan(*args)
    dh = torch.randn(h.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(7))
    got = mops.mlstm_scan_bwd(*args, h, dh)
    loop = mlstm_scan_bwd_ref(*args, h, dh)
    for a, b, e in zip(got, loop, mlstm_scan_bwd_exact(*args, dh)):
        top = float(e.abs().max())
        ours = float((a.double() - e).abs().max()) / top
        plain = float((b.double() - e).abs().max()) / top
        assert ours <= max(BWD_RTOL, plain), (ours, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("operand", ["k", "q"])
def test_cuda_mlstm_scan_bwd_non_finite_step(operand):
    """k_s (or q_t) of one step set to inf in one (row, head), at
    xlstm_1_3b's head: the kernel's gradients are non-finite exactly where
    the plain backward's are (its products against the causal matrices
    skip the masked half, so no masked 0 meets the inf; dq before a
    non-finite k_s stays finite), and agree within BWD_RTOL elsewhere."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_bwd_ref
    _, mops, _ = _scan_ops()
    dev = _card()
    args = _mlstm_case(1, 100, 2, 512, dev)
    args["qk".index(operand)][0, 37, 0] = float("inf")
    h = mops.mlstm_scan(*args)
    dh = torch.randn(h.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(11))
    got = mops.mlstm_scan_bwd(*args, h, dh)
    ref = mlstm_scan_bwd_ref(*args, h, dh)
    assert not bool(torch.isfinite(ref[0]).all())
    for name, a, b in zip("qkvif", got, ref):
        fin = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), fin), name
        err = float((a[fin].double() - b[fin].double()).abs().max())
        assert err <= BWD_RTOL * float(b[fin].abs().max()), (name, err)


@pytest.mark.gpu
def test_cuda_mlstm_scan_bwd_fewer_blocks_than_sms():
    """B = 1, H = 1 at xlstm_1_3b's head and S = 4096: 16 blocks of each
    walk on the card's 132 SMs, each walking 128 chunks."""
    from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_bwd_ref
    _, mops, _ = _scan_ops()
    dev = _card()
    args = _mlstm_case(1, 4096, 1, 512, dev)
    h = mops.mlstm_scan(*args)
    dh = torch.randn(h.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))
    got = mops.mlstm_scan_bwd(*args, h, dh)
    _grads_close(got, mlstm_scan_bwd_ref(*args, h, dh))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,d", SLSTM_SHAPES)
def test_cuda_slstm_scan_bwd_matches_plain_version(B, S, d):
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref
    _, _, sops = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(S * 19 + d)
    z, i, f, o, dh = (torch.randn((B, S, d), generator=g, device=dev)
                      for _ in range(5))
    f = f + 3.0
    n0 = sops.slstm_scan_bwd.launches
    got = sops.slstm_scan_bwd(z, i, f, o, dh)
    torch.cuda.synchronize()
    assert sops.slstm_scan_bwd.launches == n0 + 1
    _grads_close(got, slstm_scan_bwd_ref(z, i, f, o, dh))


@pytest.mark.gpu
def test_cuda_slstm_scan_bwd_is_deterministic():
    """Each chunk composes only with its successor's published carry, so
    two launches on the same full-width inputs agree bit for bit."""
    _, _, sops = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(24)
    z, i, f, o, dh = (torch.randn((2, 4096, 2048), generator=g, device=dev)
                      for _ in range(5))
    first = sops.slstm_scan_bwd(z, i, f + 3.0, o, dh)
    second = sops.slstm_scan_bwd(z, i, f + 3.0, o, dh)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("forget_bias", LONG_MEMORY_BIASES)
def test_cuda_slstm_scan_bwd_long_memory(forget_bias):
    from repro_torch.kernels.slstm_scan.ref import slstm_scan_bwd_ref
    _, _, sops = _scan_ops()
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(int(forget_bias) + 1)
    z, i, f, o, dh = (torch.randn((2, 4096, 2048), generator=g, device=dev)
                      for _ in range(5))
    f = f + forget_bias
    _grads_close(sops.slstm_scan_bwd(z, i, f, o, dh),
                 slstm_scan_bwd_ref(z, i, f, o, dh))


@pytest.mark.gpu
def test_cuda_scans_raise_instead_of_falling_back():
    rops, mops, sops = _scan_ops()
    dev = _card()
    x = torch.zeros((2, 5, 8), device=dev)
    ops = (rops.rglru_scan, mops.mlstm_scan, sops.slstm_scan,
           mops.mlstm_scan_bwd, sops.slstm_scan_bwd)
    counts = [op.launches for op in ops]
    with pytest.raises(TypeError, match="float32"):
        rops.rglru_scan(x.half(), x.half())
    with pytest.raises(ValueError, match="contiguous"):
        sops.slstm_scan(*(x.transpose(0, 1),) * 4)
    with pytest.raises(ValueError, match="operands on"):
        rops.rglru_scan(x, x.cpu())
    with pytest.raises(TypeError, match="float32"):
        sops.slstm_scan_bwd(*(x,) * 4, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        sops.slstm_scan_bwd(*(x,) * 4, torch.zeros(
            (2, 8, 5), device=dev).transpose(1, 2))
    with pytest.raises(ValueError, match="operands on"):
        sops.slstm_scan_bwd(*(x,) * 4, x.cpu())
    q = torch.zeros((2, 5, 1, 513), device=dev)
    gi = torch.zeros((2, 5, 1), device=dev)
    with pytest.raises(ValueError, match="hd <= 512"):
        mops.mlstm_scan(q, q, q, gi, gi)
    with pytest.raises(ValueError, match="hd <= 512"):
        mops.mlstm_scan_bwd(q, q, q, gi, gi, q, q)
    q = torch.zeros((2, 5, 1, 8), device=dev)
    gi = torch.zeros((2, 5, 1), device=dev)
    with pytest.raises(ValueError, match="operands on"):
        mops.mlstm_scan_bwd(q, q, q, gi, gi, q, q.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mops.mlstm_scan_bwd(q, q, q, gi, gi, q, torch.zeros(
            (2, 8, 1, 5), device=dev).transpose(1, 3))
    assert counts == [op.launches for op in ops]


# an xLSTM block gradient leaf whose CPU value is below this share of the
# tree's largest |g| is cancellation noise and is held below that level
# (tests/test_torch_scan_grads.py's GRAD_NOISE_SHARE): the mLSTM
# input-gate bias, whose gradient is 0 but for rounding (h is invariant
# to a shift of every i), 1.5e-8 to 6e-8 of the tree's max on the CPU
BLOCK_NOISE_SHARE = 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_1_3b"])
def test_cuda_recurrent_blocks_launch_one_scan_each(arch):
    """Each recurrent block of the smoke model on the card: one scan
    launch per block without autograd, and while autograd records one
    scan and one backward launch; the outputs within FAMILY_ATOL of the
    CPU's and the gradients within 1e-4 of each leaf's largest entry
    (fp32, TF32 off)."""
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
            op, bwd = {"rglru": (rops.rglru_scan, rops.rglru_scan_bwd),
                       "mlstm": (mops.mlstm_scan, mops.mlstm_scan_bwd),
                       "slstm": (sops.slstm_scan, sops.slstm_scan_bwd)}[kind]
            n0 = op.launches
            with torch.no_grad():
                y = block(_to(mix, dev), x.to(dev), cfg)
            assert op.launches == n0 + 1, kind
            assert float((y.cpu() - block(mix, x, cfg)).abs().max()) \
                <= FAMILY_ATOL
            n0, b0 = op.launches, bwd.launches
            grads = []
            for d in (dev, torch.device("cpu")):
                live = {k: v.to(d).requires_grad_() for k, v in mix.items()}
                block(live, x.to(d), cfg).square().sum().backward()
                grads.append({k: v.grad.cpu() for k, v in live.items()})
            assert (op.launches, bwd.launches) == (n0 + 1, b0 + 1), kind
            noise = -1.0 if kind == "rglru" else BLOCK_NOISE_SHARE * max(
                float(g.abs().max()) for g in grads[1].values())
            for k, gr in grads[1].items():
                scale = float(gr.abs().max())
                if scale <= noise:           # held to the noise level
                    assert float(grads[0][k].abs().max()) <= noise, (kind, k)
                    continue
                err = float((grads[0][k] - gr).abs().max())
                assert err <= 1e-4 * max(scale, 1e-30), (kind, k, err, scale)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# -- quant_split, the migration's re-tiering --------------------------------

# (plan, columns per tier) at internlm2's (2048, 8192): the legacy
# bf16/int8 pools, the cxl substrates' int8/int8 pairs and cxl-tier-3's
# three int8 pools; widths 1, 15 and 17, empty tiers, one tier over
# every column, all int8 and all bf16
QS_PLANS = {
    "legacy": (("hp_bf16", "bf16"), ("hp_int8", "int8"),
               ("lp_bf16", "bf16"), ("lp_int8", "int8")),
    "cxl": (("hp_ddr_int8", "int8"), ("hp_cxl_int8", "int8"),
            ("lp_ddr_int8", "int8"), ("lp_cxl_int8", "int8")),
    "cxl3": (("hbm_int8", "int8"), ("ddr_int8", "int8"),
             ("cxl_int8", "int8")),
}
QS_FULL = [
    ("legacy", (2100, 1900, 2200, 1992)), ("legacy", (1, 15, 17, 8159)),
    ("legacy", (0, 8192, 0, 0)), ("legacy", (8192, 0, 0, 0)),
    ("legacy", (17, 0, 8160, 15)),
    ("cxl", (17, 0, 4095, 4080)), ("cxl", (0, 0, 0, 8192)),
    ("cxl3", (15, 1, 8176)), ("cxl3", (2731, 2730, 2731)),
]
# (M, d_in, d_out, plan, widths, offset): d_in below the cluster's 8
# blocks, d_out off the 32-column grid and off 4 (4-byte loads), a
# matrix 4 bytes off 16-byte alignment, and recurrentgemma_2b's width
QS_EDGE = [
    (3, 37, 100, "legacy", (1, 15, 17, 67), 0),
    (2, 5, 33, "cxl3", (0, 0, 33), 0),
    (2, 64, 1001, "cxl", (17, 0, 15, 969), 0),
    (2, 64, 96, "legacy", (30, 2, 0, 64), 1),
    (2, 2560, 7680, "legacy", (2000, 1999, 1, 3680), 0),
]


def _qs_weights(M, d_in, d_out, dev, seed, offset=0):
    """M random (d_in, d_out) fp32 matrices, ``offset`` floats into their
    allocations, each with an all-zero column (the 1e-8 scale floor) and
    two columns of exact .5 quotients: maxima 127 and 63.5 give scales 1
    and 0.5, so w / scale ties between two integers."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ws = []
    for _ in range(M):
        buf = torch.randn(d_in * d_out + offset, generator=g, device=dev)
        ws.append(buf[offset:].view(d_in, d_out))
    ties = torch.arange(d_in, dtype=torch.float32, device=dev) % 9 - 4.5
    for w in ws:
        w[:, d_out // 3] = 0.0
        w[:, d_out - 1] = ties
        w[0, d_out - 1] = 127.0
        if d_out > 2:
            w[:, 1] = ties * 0.5
            w[0, 1] = 63.5
    return ws


def _qs_check(ws, plan, widths):
    """quant_split of ``ws`` against split_weight of each matrix on the
    card: the same tiers in order, fields, shapes, dtypes and bits."""
    from repro_torch.kernels.quant_split import ops as qops
    from repro_torch.models.hetero_linear import split_weight
    counts = dict(zip((n for n, _ in QS_PLANS[plan]), widths))
    formats = dict(QS_PLANS[plan])
    n0 = qops.quant_split.launches
    got = qops.quant_split(qops.matrix_table(ws), counts, formats)
    torch.cuda.synchronize()
    assert qops.quant_split.launches == n0 + 1
    assert list(got) == list(counts)
    for i, w in enumerate(ws):
        want = split_weight(w, dict(counts), formats=formats)
        for name, seg in want.items():
            if seg.get("empty"):
                assert got[name] == {"empty": True}
                continue
            assert list(got[name]) == list(seg)
            for f, v in seg.items():
                mine = got[name][f][i]
                assert mine.shape == v.shape and mine.dtype == v.dtype
                assert torch.equal(mine, v), (i, name, f)


@pytest.mark.gpu
@pytest.mark.parametrize("plan,widths", QS_FULL)
def test_cuda_quant_split_bitwise_at_the_fleet_shape(plan, widths):
    """48 x (2048, 8192), one launch, every tier bitwise to split_weight."""
    dev = _card()
    ws = _qs_weights(48, 2048, 8192, dev, seed=sum(widths) + len(plan))
    _qs_check(ws, plan, widths)


@pytest.mark.gpu
@pytest.mark.parametrize("M,d_in,d_out,plan,widths,offset", QS_EDGE)
def test_cuda_quant_split_edges_bitwise(M, d_in, d_out, plan, widths,
                                        offset):
    from repro_torch.kernels.quant_split import ops as qops
    dev = _card()
    ws = _qs_weights(M, d_in, d_out, dev, seed=d_in + d_out, offset=offset)
    assert qops.matrix_table(ws).vec == (d_out % 4 == 0 and offset == 0)
    _qs_check(ws, plan, widths)


@pytest.mark.gpu
def test_cuda_quant_split_raises_instead_of_falling_back():
    from repro_torch.kernels.quant_split import ops as qops
    dev = _card()
    rows = qops.CLUSTER * qops.MAX_ROWS + 1
    tab = qops.matrix_table([torch.zeros((rows, 8), device=dev)])
    with pytest.raises(ValueError, match="rows a block"):
        qops.quant_split(tab, {"a": 8}, {"a": "int8"})
    tab = qops.matrix_table([torch.zeros((4, 8), device=dev)])
    with pytest.raises(ValueError, match="do not sum"):
        qops.quant_split(tab, {"a": 7}, {"a": "int8"})


@pytest.mark.gpu
@pytest.mark.parametrize("widen", [False, True])
def test_cuda_migration_is_one_quant_split_per_shape(widen):
    """A migration of the serve engine on the card launches quant_split
    once per shape of FFN matrix (one for internlm2; two with its last
    layer made wider), its pointer tables built once, and its tiers
    equal the CPU engine's bit for bit."""
    from repro_torch import api
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.quant_split import ops as qops
    from repro_torch.models import lm
    dev = _card()
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(5), cfg)
    if widen:
        last = list(params["stack"])[-1]
        g = torch.Generator().manual_seed(6)
        for wname in ("w_up", "w_gate"):
            params["stack"][last]["ffn"][wname] = torch.randn(
                (cfg.d_model, 2 * cfg.d_ff + 3), generator=g)
    ours = api.engine("gpu-pool", cfg, _to(params, dev), max_batch=4,
                      device=dev)
    ref = api.engine("gpu-pool", cfg, params, max_batch=4, device="cpu")
    spaces = [s for s, _, _ in ours._tier_plan]
    K = ours.model_spec.n_params
    tables = None
    for placement in ({spaces[0]: K // 3, spaces[1]: K // 3,
                       spaces[3]: K - 2 * (K // 3)}, {spaces[1]: K}):
        n0 = qops.quant_split.launches
        assert ours.apply_placement(placement)
        torch.cuda.synchronize()
        assert qops.quant_split.launches == n0 + (2 if widen else 1)
        tables = tables or dict(ours._tables)
        assert len(tables) == (2 if widen else 1)
        assert all(ours._tables[k] is v for k, v in tables.items())
        assert ref.apply_placement(placement)
        assert list(ours._tiered) == list(ref._tiered)
        for key, segs in ref._tiered.items():
            assert list(ours._tiered[key]) == list(segs)
            for tier, seg in segs.items():
                for f, v in seg.items():
                    mine = ours._tiered[key][tier][f]
                    if f == "empty":
                        assert mine is True
                    else:
                        assert torch.equal(mine.cpu(), v), (key, tier, f)


# -- decode_attn: the dense decode's attention in one launch a layer ---------

# arch, B, ring, positions of three consecutive steps' first (a list: one
# position a row): the dense cells' shape, the other variants, and the
# serving paths' rings (HeteroServeEngine: B=16, ring 128; DecodeEngine:
# per-row positions, B=4, ring 64)
DECODE_ATTN_CASES = {
    "internlm2_before_wrap": ("internlm2_1_8b", 16, 128, 60),
    "internlm2_after_wrap": ("internlm2_1_8b", 16, 128, 300),
    "internlm2_per_row": ("internlm2_1_8b", 16, 128,
                          [0, 1, 5, 126, 127, 128, 129, 255, 256, 300,
                           1000, 3, 64, 77, 90, 500]),
    "chatglm3_2d": ("chatglm3_6b", 16, 128, 200),
    "qwen25_bias": ("qwen25_32b", 8, 128, 90),
    "seamless_hd64": ("seamless_m4t_medium", 8, 128, 40),
    "recurrentgemma_below_window": ("recurrentgemma_2b", 4, 2048, 700),
    "recurrentgemma_past_window": ("recurrentgemma_2b", 4, 2048,
                                   [5000, 2046, 2047, 9000]),
    "recurrentgemma_serving": ("recurrentgemma_2b", 16, 128, 300),
    "recurrentgemma_engine_per_row": ("recurrentgemma_2b", 4, 64,
                                      [2, 63, 64, 100]),
    "internlm2_engine_per_row": ("internlm2_1_8b", 4, 64, [2, 63, 64, 100]),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(DECODE_ATTN_CASES))
def test_cuda_decode_attn_matches_the_plain_path(case):
    """Three consecutive decode steps of one attention layer at full
    width (bf16; q, k, v from the layer's products, with qwen2.5's
    bias), the kernel against ``decode_attn_plain`` on copies of one
    random ring: both caches bitwise after every step (k rotated as
    apply_rope rounds it), the output within ``decode_attn_atol`` (one
    bf16 step of each element and a quarter of the largest |output|),
    which both of ``bf16_sums``' controls (the scores or the value
    product summed in bf16) fail, and one launch a step (two where the
    ring is chunked)."""
    import dataclasses

    from torch_decode_attn_controls import bf16_sums, over_limit

    from repro_torch.configs import get_config
    from repro_torch.models.common import apply_rope
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.models import attention as attn
    dev = _card()
    arch, B, C, first = DECODE_ATTN_CASES[case]
    cfg = dataclasses.replace(get_config(arch), dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(len(case))
    p = {k: w.bfloat16() for k, w in attn.init_attention(gen, cfg).items()}
    if cfg.qkv_bias:
        for key in ("bq", "bk", "bv"):
            p[key] = torch.randn(p[key].shape, generator=gen, device=dev)
    shape = (B, C, cfg.n_kv_heads, cfg.hd)
    ring = {n: torch.randn(shape, generator=gen, device=dev).bfloat16()
            for n in ("k", "v")}
    ours = {n: t.clone() for n, t in ring.items()}
    plan = dops.decode_plan(B, cfg.n_heads, cfg.n_kv_heads, cfg.hd, C)
    for step in range(3):
        pos = torch.as_tensor(first, device=dev) + step
        x = torch.randn((B, 1, cfg.d_model), generator=gen,
                        device=dev).bfloat16()
        q, k, v = attn._qkv(p, x, cfg)
        assert dops.plain_reason(q, ours["k"], ours["v"]) is None
        n0 = dops.decode_attn.launches
        got = dops.decode_attn(q, k, v, ours["k"], ours["v"], pos,
                               attn.rope_table(cfg.rope_kind, cfg.hd, dev))
        torch.cuda.synchronize()
        assert dops.decode_attn.launches - n0 == (1 if plan.n_chunks == 1
                                                  else 2)
        want = attn.decode_attn_plain(q, k, v, cfg, ring, pos)
        assert torch.equal(ours["v"], ring["v"]), (case, step)
        assert torch.equal(ours["k"], ring["k"]), (case, step, float(
            (ours["k"].float() - ring["k"].float()).abs().max()))
        assert over_limit(got, want) <= 1.0, (case, step,
                                              over_limit(got, want))
        qr = apply_rope(q, pos.expand(B)[:, None], cfg.rope_kind)
        for which in ("scores", "values"):
            ctl = over_limit(bf16_sums(qr, ring["k"], ring["v"], pos, which),
                             want)
            assert ctl > 1.0, (case, step, which, ctl)


@pytest.mark.gpu
def test_cuda_decode_step_launches_decode_attn_once_a_layer():
    """Full-width internlm2_1_8b cut to 2 layers, a bf16 decode state
    of 16 rows and a ring of 128: three decode steps launch the kernel
    once a layer a step, every call counted as fused when traced."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.models import lm
    dev = _card()
    cfg = dataclasses.replace(get_config("internlm2_1_8b"), n_layers=2)
    params = lm.compute_copy(lm.init_lm(
        torch.Generator(device=dev).manual_seed(0), cfg), cfg)
    st = lm.init_decode_state(cfg, 16, 128, device=dev)
    toks = torch.arange(16, device=dev)
    n0 = dops.decode_attn.launches
    obs.reset()
    obs.enable()
    try:
        for pos in range(3):
            logits, st = lm.decode_step(params, cfg, st, toks, pos)
            toks = logits.argmax(dim=-1)
        torch.cuda.synchronize()
        m = obs.metrics()
        fused = m.value("decode_attn.fused")
        plain = sum(m.value("decode_attn.plain", reason=r) for r in (
            "dtensor", "device", "dtype", "head_dim"))
    finally:
        obs.disable()
        obs.reset()
    assert dops.decode_attn.launches - n0 == 3 * cfg.n_layers
    assert (fused, plain) == (3 * cfg.n_layers, 0)


@pytest.mark.gpu
def test_cuda_decode_attn_raises_instead_of_falling_back():
    from repro_torch.kernels.decode_attn import ops as dops
    dev = _card()
    q = torch.zeros((2, 1, 4, 128), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((2, 1, 2, 128), dtype=torch.bfloat16, device=dev)
    cache = torch.zeros((2, 8, 2, 128), dtype=torch.bfloat16, device=dev)
    pos = torch.tensor(3, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        dops.decode_attn(q.float(), kv, kv, cache, cache.clone(), pos)
    with pytest.raises(ValueError, match="head widths"):
        dops.decode_attn(q[..., :96].contiguous(), kv[..., :96].contiguous(),
                         kv[..., :96].contiguous(),
                         cache[..., :96].contiguous(),
                         cache[..., :96].contiguous(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        dops.decode_attn(q, kv, kv, cache.transpose(1, 2).contiguous()
                         .transpose(1, 2), cache.clone(), pos)
    with pytest.raises(ValueError, match="int64"):
        dops.decode_attn(q, kv, kv, cache, cache.clone(), pos.int())
    off = torch.zeros(cache.numel() + 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        dops.decode_attn(q, kv, kv, off[1:1 + cache.numel()].view(
            cache.shape), cache.clone(), pos)
    with pytest.raises(ValueError, match="fp32 frequencies"):
        dops.decode_attn(q, kv, kv, cache, cache.clone(), pos,
                         torch.zeros(80, device=dev))
    wide = torch.zeros((2, 1, 64, 128), dtype=torch.bfloat16, device=dev)
    assert dops.plain_reason(wide, cache, cache) is None
    with pytest.raises(ValueError, match="at most 16"):
        dops.decode_attn(wide, kv, kv, cache, cache.clone(), pos)
