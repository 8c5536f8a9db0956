"""DeepSeek-V2-Lite in the port, on the CPU at smoke size (float32,
seeded random weights), against the benchmark's plain reference
(``portbench/reference/mla_moe.py``, which imports nothing of the port):

* MLA: prefill, then decode through the latent ring past its window,
  equal to the reference's full forward; the tolerance fails a bf16
  run and a renormalised top-k gate;
* YaRN's frequencies and softmax scale against the closed form;
* DeepSeekMoE: softmax-then-top-k routing in fp32, no token dropped at
  a skewed batch, and the four shares of a layer (the shared experts
  counted once) summing to the uncut layer;
* the serve engines: ``HeteroServeEngine`` re-tiers every held expert's
  matrix (bitwise ``split_weight`` of its view) and decodes in bf16 from
  its compute copy bitwise as from the fp32 masters, ``DecodeEngine``'s
  tokens follow the reference; the placement model spec of an MoE model
  and, bit for bit, of every dense one;
* the program's spans and device-side counts (``attn.mla``,
  ``moe.experts``, ``moe.expert_tokens``), recorded only when traced.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import mla_moe as ref  # noqa: E402
from repro_torch import api, obs  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import lm, moe  # noqa: E402
from repro_torch.models.common import rope_freqs  # noqa: E402
from repro_torch.models.hetero_linear import split_weight  # noqa: E402
from repro_torch.models.mla import softmax_scale  # noqa: E402
from repro_torch.serve import engine as eng_mod  # noqa: E402
from repro_torch.serve.hetero import tpu_model_spec  # noqa: E402

ARCH = "deepseek_v2_lite"
# float32 program against the float32 reference: the same sums in
# another order (decode attends in the latent, the reference expands
# keys and values), through 3 blocks; logits are O(1). A bf16 program
# or a renormalised gate lands far above it (asserted below)
LOGIT_ATOL = 1e-4


def _cfg(**over):
    return dataclasses.replace(get_smoke_config(ARCH), **over)


def _ref_config(cfg) -> dict:
    """The reference's configuration (the catalog's keys) of ``cfg``."""
    first, n = cfg.held_experts
    return {
        "hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
        "kv_lora_rank": cfg.kv_lora_rank,
        "qk_nope_head_dim": cfg.qk_nope_dim,
        "qk_rope_head_dim": cfg.qk_rope_dim, "v_head_dim": cfg.v_head_dim,
        "intermediate_size": cfg.d_ff,
        "moe_intermediate_size": cfg.moe_d_ff,
        "n_shared_experts": cfg.moe_shared_ff // cfg.moe_d_ff,
        "n_routed_experts": cfg.n_experts, "n_experts": n,
        "deployment": {"held_first": first},
        "num_experts_per_tok": cfg.experts_per_token,
        "norm_topk_prob": False, "routed_scaling_factor": 1,
        "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.first_dense_layers,
        "rms_norm_eps": cfg.norm_eps, "rope_theta": 10000,
        "rope_scaling": {
            "factor": cfg.yarn_factor, "beta_fast": cfg.yarn_beta_fast,
            "beta_slow": cfg.yarn_beta_slow, "mscale": cfg.yarn_mscale,
            "mscale_all_dim": cfg.yarn_mscale_all_dim,
            "original_max_position_embeddings": cfg.yarn_original_len},
    }


def _params(cfg, seed=0):
    return lm.init_lm(torch.Generator().manual_seed(seed), cfg)


def _tokens(cfg, B, L, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, L), generator=g)


def _ring_decode(cfg, params, toks, window):
    """Prefill of the first four tokens into a ring of ``window`` slots,
    then one decode step per further token; the logits of every step
    from the last prompt token on, float32."""
    B, L = toks.shape
    logits, st = lm.prefill(params, cfg, toks[:, :4], max_len=window)
    out = [logits.float()]
    for t in range(4, L):
        logits, st = lm.decode_step(params, cfg, st, toks[:, t], t)
        out.append(logits.float())
    return torch.stack(out, dim=1)


def _ref_logits(cfg, params, toks, window):
    with torch.no_grad():
        return ref.logits(params, _ref_config(cfg), toks, window)


def test_mla_decode_through_the_ring_matches_the_reference():
    """Prefill, then decode 14 steps past a ring of 8 latent slots: each
    step's logits equal the reference's full forward with an 8-position
    window, within LOGIT_ATOL. A bf16 program and a gate renormalised
    over the top-k both lie far outside it."""
    cfg = _cfg()
    params = _params(cfg)
    toks = _tokens(cfg, 2, 22)
    want = _ref_logits(cfg, params, toks, 8)[:, 3:]
    got = _ring_decode(cfg, params, toks, 8)
    err = float((got - want).abs().max())
    assert err <= LOGIT_ATOL, err
    # the full-sequence forward (no ring: a window as long as the input)
    full = lm.forward(params, cfg, toks)[0]
    err_full = float((full - _ref_logits(cfg, params, toks, 22)).abs().max())
    assert err_full <= LOGIT_ATOL, err_full

    bf16 = _ring_decode(dataclasses.replace(cfg, dtype=torch.bfloat16),
                        params, toks, 8)
    assert float((bf16 - want).abs().max()) > 20 * LOGIT_ATOL

    route = moe.route

    def renorm(router, x, c):
        w, e = route(router, x, c)
        return w / w.sum(-1, keepdim=True), e
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(moe, "route", renorm)
        wrong = _ring_decode(cfg, params, toks, 8)
    assert float((wrong - want).abs().max()) > 20 * LOGIT_ATOL


def test_yarn_frequencies_and_scale_against_the_closed_form():
    """DeepSeek-V2-Lite's published YaRN (factor 40, beta 32/1, original
    4096, mscale 0.707 twice) at its rope width 64."""
    cfg = get_config(ARCH)
    dim, theta, f = cfg.qk_rope_dim, 10000.0, 40.0

    def corr(turns):
        return dim * math.log(4096 / (turns * 2 * math.pi)) / \
            (2 * math.log(theta))
    lo, hi = max(math.floor(corr(32)), 0), min(math.ceil(corr(1)), dim - 1)
    assert (lo, hi) == (10, 23)
    want = []
    for j in range(dim // 2):
        base = theta ** (2 * j / dim)
        ramp = min(max((j - lo) / (hi - lo), 0.0), 1.0)
        want.append((1 / (f * base)) * ramp + (1 / base) * (1 - ramp))
    got = rope_freqs(dim, cfg).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        ref.yarn_freqs(dim, theta, _ref_config(cfg)["rope_scaling"])
        .double().numpy(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m * m - 1.5896) < 1e-3
    assert softmax_scale(cfg) == pytest.approx(m * m / math.sqrt(192),
                                               rel=1e-12)
    assert softmax_scale(cfg) == ref.softmax_scale(_ref_config(cfg))
    # no YaRN factor: the plain frequencies, as every other model has
    plain = dataclasses.replace(cfg, yarn_factor=0.0)
    np.testing.assert_allclose(
        rope_freqs(dim, plain).double().numpy(),
        [theta ** (-2 * j / dim) for j in range(dim // 2)], rtol=1e-6)


def _moe_layer(cfg, seed=3):
    p = lm.init_lm(torch.Generator().manual_seed(seed), cfg)
    return p["stack"]["tail_1"]["ffn"]


def test_routing_is_softmax_then_top_k_and_drops_no_token():
    """A skewed batch, every token routed to the same six experts (a
    capacity-limited dispatch would drop most of them): every token's
    output is the gate-weighted sum of its held experts plus the shared
    experts, by a per-token loop and by the reference."""
    cfg = _cfg(moe_held=None)                  # all 16 experts held
    p = _moe_layer(cfg)
    # a router column per chosen expert far above the rest
    p["router"] = p["router"].clone()
    x = torch.randn((1, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4)).abs()
    p["router"][:, [1, 3, 5, 7, 9, 11]] += 0.1
    w, e = moe.route(p["router"], x[0], cfg)
    assert sorted(set(e.flatten().tolist())) == [1, 3, 5, 7, 9, 11]
    probs = torch.softmax(x[0] @ p["router"], -1)
    assert torch.allclose(w, torch.topk(probs, 6, -1).values)
    assert float(w.sum(-1).max()) < 1.0        # not renormalised
    y = moe.moe(p, x, cfg)[0]
    for t in range(x.shape[1]):
        want = moe.mlp(p["shared"], x[0, t], cfg.mlp_act)
        for wt, ex in zip(w[t], e[t]):
            h = torch.nn.functional.silu(x[0, t] @ p["w_gate"][ex]) * \
                (x[0, t] @ p["w_up"][ex])
            want = want + wt * (h @ p["w_down"][ex])
        assert torch.allclose(y[t], want, atol=1e-5), t
    with torch.no_grad():
        r = ref.moe(p, x, _ref_config(cfg), ref.Matmul())[0]
    assert float((y - r).abs().max()) <= 1e-5


def test_four_shares_sum_to_the_uncut_layer():
    """The layer cut four ways (experts 0-3, 4-7, 8-11, 12-15 held), the
    shared experts counted once: the shares' outputs add up to the
    uncut layer, the program's and the reference's."""
    whole = _cfg(moe_held=None)
    p = _moe_layer(whole)
    x = torch.randn((2, 5, whole.d_model),
                    generator=torch.Generator().manual_seed(6))
    uncut = moe.moe(p, x, whole)
    shared = moe.mlp(p["shared"], x, whole.mlp_act)
    total = torch.zeros_like(uncut)
    for s in range(4):
        cfg = _cfg(moe_held=(4 * s, 4))
        part = dict(p, **{k: p[k][4 * s:4 * s + 4]
                          for k in ("w_gate", "w_up", "w_down")})
        out = moe.moe(part, x, cfg)
        with torch.no_grad():
            r = ref.moe(part, x, _ref_config(cfg), ref.Matmul())
        assert float((out - r).abs().max()) <= 1e-5
        total = total + out - shared
    assert float((total + shared - uncut).abs().max()) <= 1e-5
    with torch.no_grad():
        r = ref.moe(p, x, _ref_config(whole), ref.Matmul())
    assert float((uncut - r).abs().max()) <= 1e-5


def test_hetero_engine_tiers_every_held_expert():
    """Each held expert's w_up/w_gate, the shared experts' and the dense
    layer's are split as a dense matrix is: every segment bitwise equal
    to ``split_weight`` of that matrix (an expert's a view of its
    stacked leaf). The engine decodes from the caller's first tokens."""
    cfg = _cfg()
    params = _params(cfg)
    eng = api.engine("gpu-pool", cfg, params, max_batch=4, device="cpu")
    eng.start_tokens([5, 6, 7, 8])
    obs.reset()
    obs.enable()
    try:
        res = eng.run_slice(3)
    finally:
        events = list(obs.tracer().events())
        obs.reset()
    assert res.retiered and res.tokens.size == 3
    n_held = cfg.held_experts[1]
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert len(eng._tiered) == 2 + n_moe * (2 * n_held + 2)
    mig = [e for e in events if e["name"] == "engine.migration"]
    assert mig[0]["args"]["n_expert_weights"] == 2 * n_held * n_moe
    K = eng.model_spec.n_params
    formats = {t: f for _, t, f in eng._tier_plan}
    order = tuple(t for _, t, _ in eng._tier_plan)
    from repro_torch.models.hetero_linear import fractions_to_counts
    share = {dict((s, t) for s, t, _ in eng._tier_plan)[k]: v
             for k, v in eng._tiered_placement.items()}
    for key, segs in eng._tiered.items():
        node = params["stack"][key[0]]["ffn"]
        for k in key[1:]:
            node = node[k]
        counts = fractions_to_counts(node.shape[1], share, K, order=order)
        want = split_weight(node, {t: counts.get(t, 0) for t in order},
                            formats=formats)
        assert list(segs) == list(want)
        for tier, seg in want.items():
            for f, v in seg.items():
                if f != "empty":
                    assert torch.equal(segs[tier][f], v), (key, tier, f)
    with pytest.raises(RuntimeError, match="before the first decode"):
        eng.start_tokens([1, 2, 3, 4])


def test_hetero_engine_decodes_from_its_compute_copy_bitwise(monkeypatch):
    """The bf16 smoke model through ``HeteroServeEngine``: logits and
    tokens across migrations (every held expert re-tiered from the fp32
    masters) bitwise ``lm.decode_step`` on the masters. The copy casts
    the held experts, the shared and dense MLPs and MLA's products; the
    router (read in fp32 by ``route``), MLA's latent norm and the untied
    embedding stay the masters' own tensors."""
    from test_torch_serve import _perturbed, assert_engine_decodes_as_masters
    cfg = _cfg(dtype=torch.bfloat16)
    params = _perturbed(_params(cfg))
    eng = assert_engine_decodes_as_masters(cfg, params, monkeypatch)
    copy = eng.compute_params
    assert copy["embed"] is params["embed"]
    for lname, layer in params["stack"].items():
        ours = copy["stack"][lname]
        assert ours["mix"]["kv_norm"] is layer["mix"]["kv_norm"]
        assert ours["mix"]["w_kv_b"].dtype == torch.bfloat16
        ffn = layer["ffn"]
        if "router" in ffn:
            assert ours["ffn"]["router"] is ffn["router"]
            for sub in ("w_gate", "w_up", "w_down"):
                assert ours["ffn"][sub].dtype == torch.bfloat16
                assert ours["ffn"]["shared"][sub].dtype == torch.bfloat16


def test_decode_engine_serves_by_the_reference():
    """``DecodeEngine``'s batched prefill and slot decode (per-row
    positions) of two prompts: every greedy token is the reference's
    argmax over the request's own sequence."""
    cfg = _cfg()
    params = _params(cfg)
    e = eng_mod.DecodeEngine(cfg, params, max_batch=2, max_len=32,
                             device="cpu")
    prompts = [[11, 22, 33, 44], [5, 6, 7]]
    for i, pr in enumerate(prompts):
        e.submit(eng_mod.Request(rid=i, prompt=pr, max_new_tokens=5))
    done = {r.rid: r for r in e.run_until_done()}
    for i, pr in enumerate(prompts):
        seq = pr + done[i].out
        logits = _ref_logits(cfg, params, torch.tensor([seq[:-1]]), 32)
        want = logits[0, len(pr) - 1:].argmax(-1).tolist()
        assert done[i].out == want


def test_model_spec_of_an_moe_model_and_every_dense_one():
    """An MoE model's resident weights hold every held expert, a task's
    MACs only the routed share of them (the reference's count); a dense
    model's two counts are one, bit for bit the JAX package's."""
    from repro.configs import ARCH_IDS as JAX_ARCHS
    from repro.configs import get_config as jax_config
    from repro.serve.hetero import tpu_model_spec as jax_spec
    for arch in JAX_ARCHS:
        cfg = get_config(arch)
        if cfg.n_experts:
            continue
        for tokens in (1, 2, 8):
            a, b = tpu_model_spec(cfg, tokens), jax_spec(jax_config(arch),
                                                         tokens)
            assert (a.name, a.n_params, a.n_macs, a.pim_ratio) == \
                (b.name, b.n_params, b.n_macs, b.pim_ratio)
    cfg = dataclasses.replace(get_config(ARCH), moe_held=(0, 16))
    spec = tpu_model_spec(cfg, 2)
    c = _ref_config(cfg)
    assert (spec.n_params, spec.n_macs) == ref.model_spec(c, 2)
    d, f = 2048, 1408
    always = 27 * 4 * d * d + 3 * d * 10944 + 26 * 2 * 3 * d * f
    assert spec.n_params == always + 26 * 16 * 3 * d * f
    assert spec.n_macs == 2 * (always + 26 * 6 * 16 * 3 * d * f // 64)
    assert spec.n_params == 4_568_776_704


def test_spans_and_counts_only_when_traced():
    """Traced, each MLA block's attention and each MoE FFN of a decode
    step is a span, and each held expert's token-choices are counted on
    the device and read once (``read_device_counts``, also on
    ``disable``); untraced, nothing is recorded."""
    cfg = _cfg()
    params = _params(cfg)
    toks = _tokens(cfg, 4, 1)[:, 0]
    st = lm.init_decode_state(cfg, 4, 8, device="cpu")
    obs.reset()
    lm.decode_step(params, cfg, st, toks, 0)
    assert obs.tracer().events() == [] and obs.read_device_counts() == {}
    obs.enable()
    try:
        lm.decode_step(params, cfg, st, toks, 1)
        names = [e["name"] for e in obs.tracer().events()]
        counts = obs.read_device_counts()
        assert obs.read_device_counts() == {}
        lm.decode_step(params, cfg, st, toks, 2)
        obs.disable()
        again = obs.metrics().value("moe.expert_tokens", index=0)
    finally:
        obs.reset()
    assert names.count("attn.mla") == cfg.n_layers
    assert names.count("moe.experts") == cfg.n_layers - 1
    n_held = cfg.held_experts[1]
    got = counts["moe.expert_tokens"]
    assert len(got) == n_held
    # of the 4 rows' top-6 choices in the 2 MoE layers, those held here
    assert 0 < sum(got) <= 4 * cfg.experts_per_token * 2
    assert again >= got[0]


def test_scanned_stack_with_a_leading_dense_layer_raises():
    """A scanned group holds blocks of one kind, so the leading dense
    layer cannot be laid out there: raise rather than tier nothing."""
    cfg = dataclasses.replace(_cfg(), scan_layers=True, n_layers=5)
    with pytest.raises(ValueError, match="unscanned stack"):
        _params(cfg)


@pytest.mark.parametrize("over", [dict(moe_held=(0, 4)),
                                  dict(moe_shared_ff=64),
                                  dict(moe_router="softmax")])
def test_deepseek_fields_need_its_router(over):
    """Held experts and shared experts are DeepSeekMoE's layer, which
    only ``moe_router="softmax_topk"`` selects: with the capacity-limited
    default router (or an unknown one) the config does not build."""
    base = dataclasses.replace(_cfg(), moe_held=None, moe_shared_ff=0)
    with pytest.raises(ValueError, match="moe_router"):
        dataclasses.replace(base, **{"moe_router": "topk_softmax", **over})
