"""The serve engines and the serve CLI on the other model families,
against the JAX package, on the CPU (smoke configs, fp32, JAX's init
carried over by ``lm.params_from_numpy``):

* ``DecodeEngine`` on recurrentgemma_2b (RG-LRU state and the
  local-attention ring buffer scattered into refilled slots), xlstm_1_3b
  (mLSTM matrices with -inf stabiliser rows), llama4_scout_17b_a16e (MoE
  at decode batch) and pixtral_12b: tokens equal at every step, on seeds
  whose top-2 logit margin exceeds the family's logit tolerance on every
  decoded row (a near-tie could flip);
* ``HeteroServeEngine`` through ``api.engine("gpu-pool")`` on
  recurrentgemma_2b, xlstm_1_3b and pixtral_12b: equal ``SliceReport``s,
  the same tiered matrices and tier columns, ``tiered_forward`` within
  BF16_ATOL, equal tokens;
* the reference's faults, mirrored with the same exception types
  (ROADMAP notes (f), (g)), and one the port departs from (note (e)):
  the JAX engine hands MoE expert weights to ``split_weight`` in
  ``_retier`` (AssertionError), the port tiers each expert's matrix;
  the encoder-decoder engines decode without
  ``enc_out`` (AttributeError); xlstm's published ``d_ff=0`` tiers no
  matrix and ``tiered_forward`` then fails its assert (AssertionError);
* ``launch/serve.py --arch`` for every registered architecture.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as jax_api  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serve import engine as jax_engine  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.core import workloads  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import engine as eng_mod  # noqa: E402
from test_torch_families import (LOGIT_ATOL, XLSTM_STACK_ATOL,  # noqa: E402
                                 _configs, _params, _t)

# a bf16 tier: one bf16 rounding of a product summed in another order
BF16_ATOL = 3e-2


def _logit_atol(arch):
    return XLSTM_STACK_ATOL if arch == "xlstm_1_3b" else LOGIT_ATOL


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _top2_margin(logits) -> float:
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return float(np.min(top2[..., 1] - top2[..., 0]))


class _Recorder:
    """Wraps a package's ``lm.decode_step`` and keeps every logits array
    it returns."""

    def __init__(self, module, monkeypatch):
        self.logits = []
        inner = module.decode_step

        def step(*a, **k):
            out = inner(*a, **k)
            self.logits.append(_np(out[0]).copy())
            return out
        monkeypatch.setattr(module, "decode_step", step)


def _jax_decode_engine(cfg, params, **kw):
    """The reference's ``DecodeEngine``, its jitted step made to finish
    before it returns (ROADMAP reference note (d))."""
    eng = jax_engine.DecodeEngine(cfg, params, **kw)
    step = eng._step_fn
    eng._step_fn = lambda *a: jax.block_until_ready(step(*a))
    return eng


def _requests(mod, prompts, new):
    return [mod.Request(rid=i, prompt=list(p), max_new_tokens=new)
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("arch,seed", [
    ("recurrentgemma_2b", 3), ("xlstm_1_3b", 3),
    ("llama4_scout_17b_a16e", 3), ("pixtral_12b", 3)])
def test_decode_engine_matches_jax(arch, seed, monkeypatch):
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(arch, (), seed)
    atol = _logit_atol(arch)
    # two prompt lengths (the reference compiles a prefill per length);
    # max_len 8 < recurrentgemma's window 16: its ring buffer wraps
    prompts = [[5], [6, 7], [8, 9], [12], [1, 2], [4]]
    rec = _Recorder(lm, monkeypatch)
    ours = eng_mod.DecodeEngine(cfg_t, pt, max_batch=4, max_len=8,
                                device="cpu")
    ref = _jax_decode_engine(cfg_j, pj, max_batch=4, max_len=8)
    for e, mod in ((ours, eng_mod), (ref, jax_engine)):
        for r in _requests(mod, prompts, 7):
            e.submit(r)
    n_steps = 0
    while ours.queue or not all(s is None or s.done for s in ours.slots):
        a, b = ours.step(), ref.step()
        slot = {s.rid: i for i, s in enumerate(ours.slots) if s}
        assert _top2_margin(rec.logits[-1][[slot[r] for r in a]]) > atol, \
            f"step {n_steps}: near-tie, pick another seed"
        assert a == b, n_steps
        n_steps += 1
    assert n_steps >= 7
    done_t = {r.rid: r.out for r in ours.completed}
    done_j = {r.rid: r.out for r in ref.completed}
    assert done_t == done_j and sorted(done_t) == list(range(6))
    assert all(len(v) == 7 for v in done_t.values())


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "xlstm_1_3b",
                                  "pixtral_12b"])
def test_hetero_engine_matches_jax(arch, monkeypatch):
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(arch)
    rec_j = _Recorder(jax_lm, monkeypatch)
    ej = jax_api.engine("gpu-pool", cfg_j, pj, max_batch=4)
    et = api.engine("gpu-pool", cfg_t, pt, max_batch=4, device="cpu")
    assert et.t_slice_ms == ej.t_slice_ms
    x = np.random.default_rng(1).standard_normal(
        (5, cfg_t.d_model)).astype(np.float32)
    atol = _logit_atol(arch)
    for n in workloads.SCENARIOS["case6_random"][:6]:
        rj = ej.run_slice(min(n, 4))
        rt = et.run_slice(min(n, 4))
        assert dataclasses.asdict(rt.report) == dataclasses.asdict(rj.report)
        assert rt.retiered == rj.retiered
        if rj.tokens.size:                    # a slice that decoded
            assert _top2_margin(rec_j.logits[-1][:rj.tokens.size]) > atol
        np.testing.assert_array_equal(rt.tokens, rj.tokens)
        assert list(et._tiered) == list(ej._tiered)
        for key, segs in ej._tiered.items():
            assert list(et._tiered[key]) == list(segs)
            for tier, seg in segs.items():
                ours = et._tiered[key][tier]
                assert sorted(ours) == sorted(seg)
                for f in seg:
                    if f != "empty":
                        assert tuple(ours[f].shape) == seg[f].shape
        np.testing.assert_allclose(
            et.tiered_forward(_t(x)).numpy(),
            np.asarray(ej.tiered_forward(jnp.asarray(x))), atol=BF16_ATOL,
            rtol=0)
    # every block of these families has an FFN at smoke width
    assert len(et._tiered) == 2 * cfg_t.n_layers
    assert et.energy_uj() == ej.energy_uj()
    assert et.deadline_misses() == ej.deadline_misses()
    assert sum(r.tokens.size > 0 for r in et.history) == len(rec_j.logits)


@pytest.mark.parametrize("arch", ["arctic_480b", "llama4_scout_17b_a16e"])
def test_moe_retier_fault_mirrors_jax(arch):
    """Reference note (e), a deliberate departure of the port: the JAX
    engine's ``_retier`` hands the (E, d, f) expert weights to
    ``split_weight``, whose column-count assert fails; the port splits
    each expert's matrix (the ``[i]`` view of the stacked leaf) and a
    residual dense MLP's as it splits a dense FFN's, and decodes."""
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(arch)
    ej = jax_api.engine("gpu-pool", cfg_j, pj, max_batch=2)
    et = api.engine("gpu-pool", cfg_t, pt, max_batch=2, device="cpu")
    with pytest.raises(AssertionError):
        ej.run_slice(3)
    res = et.run_slice(3)
    assert res.retiered and res.tokens.size == 2
    E = cfg_t.n_experts
    per_layer = 2 * E + (2 if cfg_t.moe_dense_ff else 0)
    assert len(et._tiered) == cfg_t.n_layers * per_layer
    from repro_torch.models.hetero_linear import split_weight
    formats = {t: f for _, t, f in et._tier_plan}
    for (lname, *path), segs in et._tiered.items():
        w = pt["stack"][lname]["ffn"]
        for k in path:
            w = w[k]
        assert w.ndim == 2
        counts = {t: (0 if s.get("empty") else
                      next(iter(s.values())).shape[-1])
                  for t, s in segs.items()}
        want = split_weight(w, counts, formats=formats)
        for tier, seg in want.items():
            for f, v in seg.items():
                if f != "empty":
                    assert torch.equal(segs[tier][f], v), (lname, path)


def test_encdec_engines_fault_mirrors_jax():
    """Reference note (f): both engines build their decode state without
    ``enc_out``, so cross attention reads ``None.shape``."""
    cfg_j, cfg_t = _configs("seamless_m4t_medium")
    pj, pt = _params("seamless_m4t_medium")
    ej = jax_api.engine("gpu-pool", cfg_j, pj, max_batch=2)
    et = api.engine("gpu-pool", cfg_t, pt, max_batch=2, device="cpu")
    assert et._state["enc_out"] is None and ej._state["enc_out"] is None
    with pytest.raises(AttributeError, match="shape"):
        ej.run_slice(3)
    with pytest.raises(AttributeError, match="shape"):
        et.run_slice(3)
    for mod, e in ((jax_engine, _jax_decode_engine(cfg_j, pj, max_batch=2,
                                                   max_len=8)),
                   (eng_mod, eng_mod.DecodeEngine(cfg_t, pt, max_batch=2,
                                                  max_len=8,
                                                  device="cpu"))):
        e.submit(mod.Request(rid=0, prompt=[1, 2], max_new_tokens=2))
        with pytest.raises(AttributeError, match="shape"):
            e.run_until_done()


def test_xlstm_without_ffn_fault_mirrors_jax():
    """Reference note (g): with xlstm's published ``d_ff=0`` no block has
    an FFN, the engines tier 0 matrices while ``retiered`` reads True,
    and ``tiered_forward`` fails its assert."""
    over = (("d_ff", 0),)
    cfg_j, cfg_t = _configs("xlstm_1_3b", over)
    pj, pt = _params("xlstm_1_3b", over)
    assert not any("ffn" in blk for blk in pt["stack"].values())
    ej = jax_api.engine("gpu-pool", cfg_j, pj, max_batch=2)
    et = api.engine("gpu-pool", cfg_t, pt, max_batch=2, device="cpu")
    rj, rt = ej.run_slice(3), et.run_slice(3)
    assert rt.retiered and rj.retiered
    assert dataclasses.asdict(rt.report) == dataclasses.asdict(rj.report)
    np.testing.assert_array_equal(rt.tokens, rj.tokens)
    assert et._tiered == {} and ej._tiered == {}
    x = np.zeros((1, cfg_t.d_model), np.float32)
    with pytest.raises(AssertionError):
        ej.tiered_forward(jnp.asarray(x))
    with pytest.raises(AssertionError, match="run_slice first"):
        et.tiered_forward(_t(x))


# the reference's failures on these engines (note (f)); every other pair
# runs to its end, the MoE models' hetero engines too (note (e): the
# port tiers each expert)
CLI_FAULTS = {("seamless_m4t_medium", "hetero"): AttributeError,
              ("seamless_m4t_medium", "batch"): AttributeError}


@pytest.mark.parametrize("engine", ["batch", "hetero"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_runs_every_arch(arch, engine, capsys):
    argv = ["--arch", arch, "--engine", engine, "--device", "cpu",
            "--requests", "2", "--max-new-tokens", "2"]
    fault = CLI_FAULTS.get((arch, engine))
    if fault is not None:
        with pytest.raises(fault):
            serve.main(argv)
        return
    serve.main(argv)
    out = capsys.readouterr().out
    assert f"arch={arch} " in out
    assert ("request 1: 2 tokens" in out if engine == "batch"
            else "deadline misses" in out)
