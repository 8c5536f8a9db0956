"""The port's serving path against the JAX package, on the CPU.

Both packages get the same inputs, made with numpy from a seed (and the
same weights: JAX's init carried over by ``lm.params_from_numpy``):

* int8 quantization (weights per column, activations per row): bitwise;
* the plain ``pim_matmul`` (the CUDA kernel's stand-in on the CPU)
  against ``pim_matmul_ref`` and the Pallas kernel in interpret mode:
  bitwise;
* ``split_weight`` / ``tiered_matmul`` on the legacy 4-tier plan and the
  cxl-tier-3 3-way int8 plan: segments and int8 tiers bitwise, bf16
  tiers within BF16_ATOL;
* ``HeteroServeEngine`` through ``api.engine`` on gpu-pool, tpu-pool and
  cxl-tier-3 and ``DecodeEngine``: equal slice reports and re-tiering,
  ``tiered_forward`` within tolerance, decoded tokens equal at every
  step (seeds with no top-2 logit margin within LOGIT_ATOL, where a
  random-init near-tie could flip);
* the decode's compute copy (``lm.compute_copy``) in bf16: every
  family's decode from it bitwise the decode from the fp32 masters, the
  engine's logits and tokens across migrations bitwise ``decode_step``
  on the masters, and one copy shared by a fleet's engines.

tests/test_torch_gpu.py holds the CUDA kernel against the plain version
on the card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import workloads  # noqa: E402
from repro.kernels.pim_mac.ops import pim_matmul as jax_pim_matmul  # noqa
from repro.kernels.pim_mac.ref import pim_matmul_ref as jax_pim_ref  # noqa
from repro.models import hetero_linear as jax_hl  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.quant import int8 as jax_q  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.kernels.pim_mac import ops as pops  # noqa: E402
from repro_torch.models import hetero_linear as hl  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.quant import int8 as q8  # noqa: E402
from repro_torch.serve import engine as eng_mod  # noqa: E402
from repro_torch.serve import hetero as hetero_mod  # noqa: E402

# logits of the fp32 smoke models: the reference engine tests' tolerance
LOGIT_ATOL = 1e-4
# a bf16 tier: one bf16 rounding of a product summed in another order
BF16_ATOL = 3e-2

# tests/test_kernels.py's sweep
PIM_SHAPES = [
    (8, 8, 8), (16, 32, 8), (128, 128, 128), (100, 70, 50),
    (1, 256, 64), (37, 129, 255), (256, 64, 512),
]
OUT_DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _np(a):
    """numpy view of a torch tensor or a jax array, bf16 widened."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_params(cfg, seed=0):
    p = jax_lm.init_lm(jax.random.PRNGKey(seed), cfg)
    return p, lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                   "cpu")


# -- quantization -------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((64, 128), 0), ((64, 128), 1),
                                        ((2048, 14), 0), ((5, 3), 0)])
def test_quantize_per_channel_is_bitwise(shape, axis):
    rng = np.random.default_rng(sum(shape) + axis)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0)).astype(
        np.float32)
    w[0] = 0.0                                       # an all-zero row
    qj, sj = jax_q.quantize_per_channel(jnp.asarray(w), axis=axis)
    qt, st = q8.quantize_per_channel(_t(w), axis=axis)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    deq_j = jax_q.dequantize(qj, sj, axis=axis)
    assert np.array_equal(q8.dequantize(qt, st, axis=axis).numpy(),
                          np.asarray(deq_j))


@pytest.mark.parametrize("shape", [(16, 64), (1, 2048), (3, 5, 64)])
def test_quantize_activations_is_bitwise(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = (rng.standard_normal(shape) * 4).astype(np.float32)
    qj, sj = jax_q.quantize_activations(jnp.asarray(x))
    qt, st = q8.quantize_activations(_t(x))
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


# -- pim_mac ------------------------------------------------------------------

def _pim_case(M, K, N):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    x = rng.integers(-128, 128, (M, K), dtype=np.int8)
    w = rng.integers(-128, 128, (K, N), dtype=np.int8)
    sx = rng.uniform(0.001, 0.2, M).astype(np.float32)
    sw = rng.uniform(0.001, 0.2, N).astype(np.float32)
    return x, w, sx, sw


@pytest.mark.parametrize("dtypes", OUT_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("M,K,N", PIM_SHAPES)
def test_plain_pim_matmul_matches_jax_ref(M, K, N, dtypes):
    x, w, sx, sw = _pim_case(M, K, N)
    ref = jax_pim_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx),
                      jnp.asarray(sw), out_dtype=dtypes[1])
    n0 = pops.pim_matmul.launches
    out = pops.pim_matmul(_t(x), _t(w), _t(sx), _t(sw), out_dtype=dtypes[0])
    assert pops.pim_matmul.launches == n0         # the CPU runs no kernel
    assert out.dtype == dtypes[0]
    assert np.array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("dtypes", OUT_DTYPES, ids=["fp32", "bf16"])
def test_plain_pim_matmul_scalar_scales(dtypes):
    x, w, _, _ = _pim_case(37, 129, 255)
    ref = jax_pim_matmul(jnp.asarray(x), jnp.asarray(w), 0.0125,
                         jnp.float32(0.5), out_dtype=dtypes[1],
                         backend="ref")
    out = pops.pim_matmul(_t(x), _t(w), 0.0125, torch.tensor(0.5),
                          out_dtype=dtypes[0])
    assert np.array_equal(_np(out), _np(ref))


def test_plain_pim_matmul_matches_pallas_interpret():
    x, w, sx, sw = _pim_case(37, 129, 255)
    ref = jax_pim_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sx),
                         jnp.asarray(sw), bm=32, bn=32, bk=32,
                         backend="pallas_interpret")
    out = pops.pim_matmul(_t(x), _t(w), _t(sx), _t(sw))
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_plain_pim_matmul_int32_accumulation_exact():
    """Worst-case magnitudes: every product is +-127^2 over K=2048, so
    the accumulator reaches 33 million - beyond fp32's exact integers."""
    K = 2048
    x = np.full((16, K), 127, np.int8)
    w = np.full((K, 40), -127, np.int8)
    w[:, ::2] = 127
    ones = np.ones(16, np.float32), np.ones(40, np.float32)
    out = pops.pim_matmul(_t(x), _t(w), _t(ones[0]), _t(ones[1]))
    expect = np.array([127 * 127 * K, -127 * 127 * K] * 20, np.float32)
    assert np.array_equal(out.numpy(), np.broadcast_to(expect, (16, 40)))
    ref = jax_pim_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(ones[0]),
                      jnp.asarray(ones[1]))
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_pim_matmul_rejects_bad_inputs():
    x, w, sx, sw = (_t(a) for a in _pim_case(4, 32, 8))
    with pytest.raises(TypeError, match="int8"):
        pops.pim_matmul(x.float(), w, sx, sw)
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        pops.pim_matmul(x, w[:-1], sx, sw)
    with pytest.raises(ValueError, match="contiguous"):
        pops.pim_matmul(x, w.t().contiguous().t(), sx, sw)
    with pytest.raises(ValueError, match="scale_w"):
        pops.pim_matmul(x, w, sx, sw[:3])
    with pytest.raises(TypeError, match="float32"):
        pops.pim_matmul(x, w, sx.double(), sw)
    with pytest.raises(TypeError, match="out_dtype"):
        pops.pim_matmul(x, w, sx, sw, out_dtype=torch.float16)


# -- tiered linear -------------------------------------------------------------

LEGACY_COUNTS = [
    {"hp_bf16": 30, "hp_int8": 14, "lp_bf16": 0, "lp_int8": 84},
    {"hp_bf16": 0, "hp_int8": 14, "lp_bf16": 0, "lp_int8": 114},
    {"hp_bf16": 128, "hp_int8": 0, "lp_bf16": 0, "lp_int8": 0},
]
CXL3_COUNTS = {"hbm_int8": 20, "ddr_int8": 50, "cxl_int8": 58}


def _tiered_case(counts, formats, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((64, 128)) / 8).astype(np.float32)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    segs_j = jax_hl.split_weight(jnp.asarray(w), counts, formats=formats)
    segs_t = hl.split_weight(_t(w), dict(counts), formats=formats)
    return x, segs_j, segs_t


def _assert_same_tiering(x, segs_j, segs_t):
    assert list(segs_t) == list(segs_j)
    for name in segs_j:
        a, b = segs_t[name], segs_j[name]
        assert sorted(a) == sorted(b)
        for f in a:
            if f != "empty":
                assert np.array_equal(_np(a[f]), _np(b[f])), (name, f)
    yj = np.asarray(jax_hl.tiered_matmul(jnp.asarray(x), segs_j))
    yt = hl.tiered_matmul(_t(x), segs_t).numpy()
    assert yt.shape == yj.shape
    off = 0
    for name, seg in segs_j.items():
        if seg.get("empty"):
            continue
        n = (seg["q"] if "q" in seg else seg["w"]).shape[1]
        a, b = yt[..., off:off + n], yj[..., off:off + n]
        if "q" in seg:
            assert np.array_equal(a, b), name
        else:
            np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=0)
        off += n


@pytest.mark.parametrize("counts", LEGACY_COUNTS)
def test_tiered_matmul_legacy_plan_matches_jax(counts):
    _assert_same_tiering(*_tiered_case(counts, None, sum(counts.values())
                                       + counts["hp_int8"]))


def test_tiered_matmul_cxl3_int8_plan_matches_jax():
    formats = {k: "int8" for k in CXL3_COUNTS}
    _assert_same_tiering(*_tiered_case(CXL3_COUNTS, formats, 3))


def test_fractions_to_counts_matches_jax():
    placement = {"hp_bf16": 18560, "hp_int8": 0, "lp_bf16": 3,
                 "lp_int8": 145277}
    for d_out in (14, 128, 8192, 13696):
        assert hl.fractions_to_counts(d_out, placement, 163840) == \
            jax_hl.fractions_to_counts(d_out, placement, 163840)


def test_split_weight_rejects_bad_counts():
    with pytest.raises(ValueError, match="do not sum"):
        hl.split_weight(torch.zeros((4, 8)), {"hp_int8": 3})


# -- engines -------------------------------------------------------------------

class _Recorder:
    """Wraps a package's ``lm.decode_step`` and keeps every logits
    array it returns."""

    def __init__(self, module, monkeypatch):
        self.logits = []
        inner = module.decode_step

        def step(*a, **k):
            out = inner(*a, **k)
            self.logits.append(_np(out[0]).copy())
            return out
        monkeypatch.setattr(module, "decode_step", step)


def _top2_margin(logits) -> float:
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


def _assert_tokens_match(ours, ref, ref_logits) -> None:
    """Every step's tokens equal. A random-init argmax near-tie may flip
    within LOGIT_ATOL, so the seed must give none: the reference's top-2
    logit margin exceeds LOGIT_ATOL on every decoded row."""
    assert len(ours) == len(ref) == len(ref_logits) > 0
    for step, (a, b) in enumerate(zip(ours, ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert _top2_margin(ref_logits[step][:b.shape[0]]) > LOGIT_ATOL, \
            f"step {step}: near-tie, pick another seed"
        np.testing.assert_array_equal(a, b, err_msg=f"step {step}")


@pytest.mark.parametrize("name", ["gpu-pool", "tpu-pool", "cxl-tier-3"])
def test_hetero_engine_matches_jax(name, monkeypatch):
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    pj, pt = _jax_params(cfg_j)
    rec_j = _Recorder(jax_lm, monkeypatch)
    rec_t = _Recorder(lm, monkeypatch)
    ej = jax_api.engine(name, cfg_j, pj, max_batch=4)
    et = api.engine(name, cfg_t, pt, max_batch=4, device="cpu")
    assert et.t_slice_ms == ej.t_slice_ms
    x = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    toks_j, toks_t = [], []
    for n in workloads.SCENARIOS["case6_random"][:6]:
        rj = ej.run_slice(min(n, 4))
        rt = et.run_slice(min(n, 4))
        assert dataclasses.asdict(rt.report) == dataclasses.asdict(rj.report)
        assert rt.retiered == rj.retiered
        assert rt.tokens.dtype == np.int32
        if rj.tokens.size:                    # a slice that decoded
            toks_j.append(rj.tokens)
            toks_t.append(rt.tokens)
        assert list(et._tiered) == list(ej._tiered)
        for key in ej._tiered:
            for tier, seg in ej._tiered[key].items():
                ours = et._tiered[key][tier]
                assert sorted(ours) == sorted(seg)
                for f in seg:
                    if f != "empty":
                        assert tuple(ours[f].shape) == seg[f].shape
        np.testing.assert_allclose(et.tiered_forward(_t(x)).numpy(),
                                   np.asarray(ej.tiered_forward(
                                       jnp.asarray(x))),
                                   atol=BF16_ATOL, rtol=0)
    assert len(et._tiered) == 2 * cfg_t.n_layers
    assert et.energy_uj() == ej.energy_uj()
    assert et.deadline_misses() == ej.deadline_misses()
    assert len(rec_t.logits) == len(rec_j.logits) == len(toks_j)
    _assert_tokens_match(toks_t, toks_j, rec_j.logits)


def _tiers_by_split_weight(eng, placement):
    """The engine's tiers as ``_retier`` made them one matrix at a time:
    ``split_weight`` of each FFN matrix, in the stack's order."""
    plan = eng._tier_plan
    space_to_tier = {s: t for s, t, _ in plan}
    formats = {t: f for _, t, f in plan}
    order = tuple(t for _, t, _ in plan)
    share = {space_to_tier[k]: v for k, v in placement.items()}
    tiers = {}
    for lname, layer in eng.params["stack"].items():
        for wname in ("w_up", "w_gate"):
            w = layer["ffn"][wname]
            counts = hl.fractions_to_counts(
                w.shape[-1], share, eng.model_spec.n_params, order=order)
            tiers[(lname, wname)] = hl.split_weight(
                w.float(), {t: counts.get(t, 0) for t in order},
                formats=formats)
    return tiers


@pytest.mark.parametrize("name", ["gpu-pool", "cxl-tier", "cxl-tier-3"])
def test_retier_groups_by_shape_and_equals_split_weight(name, monkeypatch):
    """The FFN matrices grouped by shape (the last layer made wider, so
    two groups), the column counts worked out once a group, and segment
    dicts equal to ``split_weight``'s of each matrix in keys, order,
    shapes, dtypes and values, for the legacy bf16/int8 plan, the cxl
    int8/int8 pairs and cxl-tier-3's 3-way split. (On the card each
    group is one ``quant_split`` launch: tests/test_torch_gpu.py.)"""
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(3), cfg)
    last = list(params["stack"])[-1]
    g = torch.Generator().manual_seed(4)
    wide = (cfg.d_model, 2 * cfg.d_ff + 3)
    for wname in ("w_up", "w_gate"):
        params["stack"][last]["ffn"][wname] = torch.randn(wide, generator=g)
    eng = api.engine(name, cfg, params, max_batch=4, device="cpu")
    calls = []
    real = hetero_mod.fractions_to_counts

    def spy(d_out, *args, **kw):
        calls.append(d_out)
        return real(d_out, *args, **kw)
    monkeypatch.setattr(hetero_mod, "fractions_to_counts", spy)
    spaces = [s for s, _, _ in eng._tier_plan]
    K = eng.model_spec.n_params
    placements = [eng.sched.step(n).placement for n in (1, 4, 9)] + [
        {spaces[1]: K},                                  # one tier, all
        {spaces[0]: K // 3, spaces[-1]: K - K // 3}]     # empty middles
    moved = 0
    for placement in placements:
        calls.clear()
        if not eng.apply_placement(placement):
            continue
        moved += 1
        assert calls == [cfg.d_ff, wide[1]]
        want = _tiers_by_split_weight(eng, placement)
        assert list(eng._tiered) == list(want)
        for key, segs in want.items():
            got = eng._tiered[key]
            assert list(got) == list(segs), key
            for tier, seg in segs.items():
                assert list(got[tier]) == list(seg), (key, tier)
                for f, v in seg.items():
                    if f == "empty":
                        assert got[tier][f] is True
                        continue
                    assert got[tier][f].dtype == v.dtype
                    assert torch.equal(got[tier][f], v), (key, tier, f)
    assert moved >= 4


# the reference's defaults, then each keyword moved off its default
CHIP_KEYWORDS = [
    {},
    dict(n_hp_chips=2, n_lp_chips=6),
    dict(tokens_per_task=4, rho=16.0),
    dict(peak_tasks=20),
]


@pytest.mark.parametrize("kw", CHIP_KEYWORDS,
                         ids=["defaults", "chips", "task-rho", "peak"])
def test_hetero_engine_chip_keywords_match_jax(kw):
    """A direct ``HeteroServeEngine`` without a substrate folds
    ``n_hp_chips``, ``n_lp_chips``, ``tokens_per_task``, ``rho`` and
    ``peak_tasks`` into its ``tpu-pool`` substrate as the reference's
    does: the same slice length and ``SliceReport`` sequence."""
    from repro.serve.hetero import HeteroServeEngine as JaxEngine
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    pj, pt = _jax_params(cfg_j)
    ej = JaxEngine(cfg_j, pj, max_batch=4, **kw)
    et = hetero_mod.HeteroServeEngine(cfg_t, pt, max_batch=4, device="cpu",
                                      **kw)
    assert et.substrate.name == ej.substrate.name == "tpu-pool"
    assert et.t_slice_ms == ej.t_slice_ms
    for n in workloads.SCENARIOS["case6_random"][:4]:
        assert dataclasses.asdict(et.run_slice(min(n, 4)).report) == \
            dataclasses.asdict(ej.run_slice(min(n, 4)).report)


def test_hetero_engine_keywords_match_jax():
    """``t_slice_ms``, ``lut_points`` and a shared ``compiler``: the same
    reports as the reference's, and a second engine of the same shape
    builds no LUT of its own."""
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    pj, pt = _jax_params(cfg_j)
    cj, ct = jax_api.compiler(), api.compiler(device="cpu")
    kw = dict(t_slice_ms=0.05, lut_points=16, max_batch=4)
    engines = [(jax_api.engine("gpu-pool", cfg_j, pj, compiler=cj, **kw),
                api.engine("gpu-pool", cfg_t, pt, compiler=ct,
                           device="cpu", **kw)) for _ in range(2)]
    for ej, et in engines:
        assert et.t_slice_ms == ej.t_slice_ms == 0.05
        for n in workloads.SCENARIOS["case2_high_constant"][:3]:
            assert dataclasses.asdict(et.run_slice(n).report) == \
                dataclasses.asdict(ej.run_slice(n).report)
    assert ct.stats()["builds"] == cj.stats()["builds"] == 1
    assert ct.stats()["hits"] == cj.stats()["hits"] >= 1


def test_hetero_engine_mirrors_the_scanned_stack_fault():
    """ROADMAP reference note (c): under scan_layers=True the stack holds
    one "scan" group, ``_retier`` finds no FFN there and tiers nothing in
    both packages, while ``retiered`` still reads True."""
    cfg_j = dataclasses.replace(jax_smoke("internlm2_1_8b"), n_layers=4,
                                scan_layers=True)
    cfg_t = dataclasses.replace(get_smoke_config("internlm2_1_8b"),
                                n_layers=4, scan_layers=True)
    pj, pt = _jax_params(cfg_j)
    assert list(pt["stack"]) == list(pj["stack"]) == ["scan"]
    ej = jax_api.engine("gpu-pool", cfg_j, pj, max_batch=2)
    et = api.engine("gpu-pool", cfg_t, pt, max_batch=2, device="cpu")
    rj, rt = ej.run_slice(3), et.run_slice(3)
    assert rt.retiered and rj.retiered
    assert et._tiered == {} and ej._tiered == {}
    with pytest.raises(AssertionError, match="run_slice first"):
        et.tiered_forward(torch.zeros((1, 64)))
    with pytest.raises(AssertionError):
        ej.tiered_forward(jnp.zeros((1, 64)))


def test_hetero_engine_rejects_params_on_another_device():
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    meta = {k: v for k, v in params.items()}
    meta["final_ln"] = params["final_ln"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        api.engine("gpu-pool", cfg, meta, device="cpu")
    with pytest.raises(ValueError, match="no functional serve engine"):
        api.engine("edge-hhpim", cfg, params, device="cpu")


def _jax_decode_engine(cfg, params, **kw):
    """The reference's ``DecodeEngine``, its jitted step made to finish
    before it returns. ``step()`` passes ``jnp.asarray(self._slot_pos)``
    to the asynchronously dispatched step and then increments
    ``_slot_pos`` in place; on a loaded CPU the step can read the
    incremented positions (ROADMAP reference note (d))."""
    eng = jax_engine.DecodeEngine(cfg, params, **kw)
    step = eng._step_fn
    eng._step_fn = lambda *a: jax.block_until_ready(step(*a))
    return eng


def _requests(mod, prompts, new):
    return [mod.Request(rid=i, prompt=list(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]


def test_decode_engine_matches_jax(monkeypatch):
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    pj, pt = _jax_params(cfg_j, seed=3)
    prompts = [[5], [6, 7], [8, 9, 10, 11], [12, 13, 14], [1, 2, 3],
               [4, 2, 3]]
    rec = _Recorder(lm, monkeypatch)
    ours = eng_mod.DecodeEngine(cfg_t, pt, max_batch=4, max_len=64,
                                device="cpu")
    ref = _jax_decode_engine(cfg_j, pj, max_batch=4, max_len=64)
    for e, mod in ((ours, eng_mod), (ref, jax_engine)):
        for r in _requests(mod, prompts, 5):
            e.submit(r)
    steps_t, steps_j = [], []
    while ours.queue or not all(s is None or s.done for s in ours.slots):
        n_calls = len(rec.logits)
        steps_t.append(ours.step())
        steps_j.append(ref.step())
        step_logits = rec.logits[-1]          # this step's batched call
        assert len(rec.logits) > n_calls
        a, b = steps_t[-1], steps_j[-1]
        # the reference's step is jitted, so the near-tie check of
        # _assert_tokens_match reads the port's logits (within LOGIT_ATOL
        # of the reference's)
        slot = {s.rid: i for i, s in enumerate(ours.slots) if s}
        assert _top2_margin(step_logits[[slot[r] for r in a]]) > LOGIT_ATOL
        assert a == b, len(steps_t)
    assert len(steps_t) >= 5
    done_t = {r.rid: r.out for r in ours.completed}
    done_j = {r.rid: r.out for r in ref.completed}
    assert done_t == done_j and sorted(done_t) == list(range(6))
    assert all(len(v) == 5 for v in done_t.values())


def test_refilled_slot_state_matches_jax():
    """A request seated by slot refill into a used slot: its KV rows and
    next-step logits equal the reference engine's."""
    cfg_j, cfg_t = jax_smoke("internlm2_1_8b"), get_smoke_config(
        "internlm2_1_8b")
    pj, pt = _jax_params(cfg_j)
    ours = eng_mod.DecodeEngine(cfg_t, pt, max_batch=2, max_len=64,
                                device="cpu")
    ref = _jax_decode_engine(cfg_j, pj, max_batch=2, max_len=64)
    for e, mod in ((ours, eng_mod), (ref, jax_engine)):
        for r in _requests(mod, [[1, 2], [2, 2]], 5):
            e.submit(r)
        e.submit(mod.Request(rid=2, prompt=[9, 4, 7], max_new_tokens=4))
        while not any(s is not None and s.done for s in e.slots):
            e.step()
        e._fill_slots()
    slot = next(i for i, s in enumerate(ours.slots) if s.rid == 2)
    assert ref.slots[slot].rid == 2
    assert ours._slot_pos[slot] == ref._slot_pos[slot] == 2
    for layer in ("tail_0", "tail_1"):
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                ours._state["layers"][layer][kv][slot].numpy(),
                np.asarray(ref._state["layers"][layer][kv][slot]),
                atol=1e-5)
    lt, _ = lm.decode_step(pt, cfg_t, ours._state, ours._toks,
                           torch.tensor(ours._slot_pos))
    lj, _ = jax_lm.decode_step(pj, cfg_j, ref._state, ref._toks,
                               jnp.asarray(ref._slot_pos))
    np.testing.assert_allclose(lt.numpy()[slot], np.asarray(lj)[slot],
                               atol=LOGIT_ATOL)


def test_hetero_engine_decode_entry_point():
    cfg = get_smoke_config("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    eng = hetero_mod.HeteroServeEngine(cfg, params, max_batch=3,
                                       device="cpu")
    assert eng.decode(0).shape == (0,)
    toks = eng.decode(7)
    assert toks.shape == (3,) and toks.dtype == np.int32
    assert eng.apply_placement({"hp_mram": 10, "lp_mram": 0,
                                "hp_sram": 0, "lp_sram": 0}) is True
    assert eng.apply_placement({"hp_mram": 10, "lp_mram": 0,
                                "hp_sram": 0, "lp_sram": 0}) is False


# -- the decode's compute copy ------------------------------------------------


def _bf16(arch, **over):
    return dataclasses.replace(get_smoke_config(arch), dtype=torch.bfloat16,
                               **over)


def _paths(tree, path=()):
    """(path, leaf) of every leaf of a tree, in its key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, path + (k,))
        else:
            yield path + (k,), v


def _is_cast(path, cfg) -> bool:
    """A leaf that ``compute_copy`` casts: the stack's leaves the decode
    casts before a product, and the head."""
    return ((path[0] == "stack" and path[-1] in lm._DECODE_CAST)
            or path == ("lm_head",)
            or (path == ("embed",) and cfg.tie_embeddings))


def assert_compute_copy_of(copy, params, cfg):
    """``copy`` is ``lm.compute_copy(params, cfg)``: the same keys, each
    cast leaf in ``cfg.dtype`` with the bits of ``.to(cfg.dtype)``, every
    other leaf the very tensor of ``params``; ``params`` still fp32.
    Returns the cast leaves' bytes."""
    ours, masters = list(_paths(copy)), list(_paths(params))
    assert [p for p, _ in ours] == [p for p, _ in masters]
    n_bytes = 0
    for (path, c), (_, m) in zip(ours, masters):
        assert m.dtype == torch.float32, path
        if _is_cast(path, cfg) and cfg.dtype != m.dtype:
            assert c is not m and c.dtype == cfg.dtype, path
            assert torch.equal(c, m.to(cfg.dtype)), path
            n_bytes += c.nbytes
        else:
            assert c is m, path
        if path[-1] in ("router", "kv_norm") or path[-1].startswith(
                ("ln", "final_ln")):
            assert c is m, path
    assert copy["embed"] is params["embed"] or cfg.tie_embeddings
    return n_bytes


def _perturbed(params, seed=7):
    """``params`` with every leaf moved by noise, so that a norm scale or
    bias that ``init_lm`` sets to a round number (which bf16 holds
    exactly) would read another value if cast."""
    g = torch.Generator().manual_seed(seed)
    for _, v in _paths(params):
        v.add_(0.05 * torch.randn(v.shape, generator=g))
    return params


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _family_extra(cfg, g, B):
    extra = {}
    if cfg.n_prefix_embeds:
        extra["prefix_embeds"] = torch.randn(
            (B, cfg.n_prefix_embeds, cfg.d_model), generator=g)
    if cfg.is_encdec:
        extra["enc_frames"] = torch.randn((B, 5, cfg.d_model), generator=g)
    return extra


@pytest.mark.parametrize("arch,over", [(a, ()) for a in ARCH_IDS] + [
    ("internlm2_1_8b", (("tie_embeddings", True),)),
    ("recurrentgemma_2b", (("n_layers", 6), ("scan_layers", True)))],
    ids=ARCH_IDS + ["internlm2_1_8b-tied", "recurrentgemma_2b-scan"])
def test_compute_copy_decodes_every_family_bitwise(arch, over):
    """Every family's bf16 smoke model (a tied head, a scanned stack):
    after a prefill on the masters, four decode steps from the compute
    copy give the logits of the same steps on the fp32 masters, bit for
    bit, and the copy casts only what the decode casts. In the fp32
    smoke config the copy is the masters' own tensors."""
    cfg = _bf16(arch, **dict(over))
    params = _perturbed(lm.init_lm(torch.Generator().manual_seed(0), cfg))
    copy = lm.compute_copy(params, cfg)
    assert assert_compute_copy_of(copy, params, cfg) > 0
    g = torch.Generator().manual_seed(1)
    B = 3
    toks = torch.randint(0, cfg.vocab_size, (B, 4), generator=g)
    _, st = lm.prefill(params, cfg, toks, max_len=16,
                       **_family_extra(cfg, g, B))
    st_copy = _clone(st)
    n = toks.shape[1] + cfg.n_prefix_embeds
    t_m = t_c = toks[:, -1]
    for i, pos in enumerate((n, n + 1, n + 2, torch.tensor([n + 3, 2, 5]))):
        lm_m, st = lm.decode_step(params, cfg, st, t_m, pos)
        lm_c, st_copy = lm.decode_step(copy, cfg, st_copy, t_c, pos)
        assert torch.equal(lm_c, lm_m), (arch, i)
        t_m, t_c = lm_m.argmax(-1), lm_c.argmax(-1)
    fp32 = get_smoke_config(arch)
    same = lm.compute_copy(params, dataclasses.replace(fp32, **dict(over)))
    assert all(c is m for (_, c), (_, m) in zip(_paths(same),
                                                 _paths(params)))


def engine_against_masters(cfg, params, monkeypatch, loads, starts):
    """A gpu-pool engine served ``loads`` slices from first tokens
    ``starts``, each decode's logits kept, against ``lm.decode_step`` on
    the fp32 masters from the same start. Returns the engine, its slice
    results and, step by step, (engine logits, masters' logits, masters'
    tokens)."""
    kept = []
    step0 = lm.decode_step

    def step(*a, **k):
        logits, st = step0(*a, **k)
        kept.append(logits)
        return logits, st
    eng = api.engine("gpu-pool", cfg, params, max_batch=len(starts),
                     device="cpu")
    eng.start_tokens(starts)
    monkeypatch.setattr(lm, "decode_step", step)
    res = [eng.run_slice(n) for n in loads]
    monkeypatch.undo()
    st = lm.init_decode_state(cfg, len(starts), 128, device="cpu")
    toks = torch.tensor(starts)
    steps = []
    for pos, ours in enumerate(kept):
        logits, st = lm.decode_step(params, cfg, st, toks, pos)
        toks = logits.argmax(-1)
        steps.append((ours, logits, toks))
    return eng, res, steps


def assert_engine_decodes_as_masters(cfg, params, monkeypatch):
    """Six slices with migrations between the decodes: every step's
    logits and tokens bitwise the masters'; the engine's ``params`` the
    fp32 masters, its ``compute_params`` their compute copy."""
    starts = [5, 17, 3, 42]
    eng, res, steps = engine_against_masters(cfg, params, monkeypatch,
                                             (2, 4, 1, 4, 3, 4), starts)
    assert len(steps) == len(res) == 6
    assert sum(r.retiered for r in res[1:]) >= 3
    for r, (ours, want, toks) in zip(res, steps):
        assert ours.dtype == cfg.dtype
        assert torch.equal(ours, want)
        n = len(r.tokens)
        assert r.tokens.tolist() == toks[:n].tolist()
    assert eng.params is params
    assert assert_compute_copy_of(eng.compute_params, params, cfg) > 0
    return eng


def test_engine_decodes_from_its_compute_copy_bitwise(monkeypatch):
    """The dense bf16 smoke model through ``HeteroServeEngine``: its
    logits and tokens across migrations bitwise ``lm.decode_step`` on
    the fp32 masters, which the migrations keep reading."""
    cfg = _bf16("internlm2_1_8b")
    params = _perturbed(lm.init_lm(torch.Generator().manual_seed(0), cfg))
    eng = assert_engine_decodes_as_masters(cfg, params, monkeypatch)
    placement = eng._tiered_placement
    want = _tiers_by_split_weight(eng, placement)
    for key, segs in want.items():
        for tier, seg in segs.items():
            for f, v in seg.items():
                if f != "empty":
                    assert torch.equal(eng._tiered[key][tier][f], v)


def test_fleet_engines_share_one_compute_copy():
    """``api.fleet(decode=True)`` makes one compute copy for its four
    engines, in one ``engine.compute_copy`` span with the cast leaves'
    count and bytes; an engine built alone makes its own."""
    cfg = _bf16("internlm2_1_8b")
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg)
    obs.reset()
    obs.enable()
    try:
        fl = api.fleet("gpu-pool-mixed", cfg, params=params, decode=True,
                       n_engines=4, solver="dp", dvfs=True, max_batch=4,
                       device="cpu")
        fleet_spans = [e for e in obs.tracer().events()
                       if e["name"] == "engine.compute_copy"]
        obs.reset()
        obs.enable()
        alone = api.engine("gpu-pool", cfg, params, max_batch=4,
                           device="cpu")
        alone_spans = [e for e in obs.tracer().events()
                       if e["name"] == "engine.compute_copy"]
    finally:
        obs.reset()
    engines = [w.hetero for w in fl.workers]
    assert len(engines) == 4
    copy = engines[0].compute_params
    n_bytes = assert_compute_copy_of(copy, params, cfg)
    n_cast = sum(c is not m for (_, c), (_, m) in zip(_paths(copy),
                                                       _paths(params)))
    assert n_cast == 1 + 7 * cfg.n_layers
    for path, c in _paths(copy):
        ptrs = {_leaf(e.compute_params, path).data_ptr() for e in engines}
        assert ptrs == {c.data_ptr()}, path
    assert [e["args"] for e in fleet_spans] == [
        {"n_leaves": n_cast, "bytes": n_bytes, "shared_by": 4}]
    assert [e["args"] for e in alone_spans] == [
        {"n_leaves": n_cast, "bytes": n_bytes, "shared_by": 1}]
    assert alone.compute_params["lm_head"] is not copy["lm_head"]
    assert all(e.params is params for e in engines + [alone])


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree
