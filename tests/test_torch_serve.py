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
  random-init near-tie could flip).

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
from repro_torch import api  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
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
