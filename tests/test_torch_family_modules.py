"""The port's new model modules against the JAX package, on the CPU, one
module at a time (the whole models are in tests/test_torch_families.py,
whose helpers and tolerances this file shares):

* MoE dispatch with tokens over capacity (top-1 and top-2), independent
  dispatch blocks, arctic's dense residual MLP;
* local windowed attention and non-causal (encoder) chunked attention at
  S=1024, cross attention (dense and chunked), the local-attention ring
  buffer decoded past its length;
* mLSTM and sLSTM at S=256 (the JAX package's two-level
  ``chunked_scan``), RG-LRU decode against its block, ``softplus``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jax_attn  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import recurrent as jax_rec  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm, moe, recurrent  # noqa: E402
from repro_torch.models.mlp import mlp  # noqa: E402
from test_torch_families import (ACT_ATOL, AUX_ATOL, _assert_same_state,  # noqa: E402,E501
                                 _close, _configs, _params, _t)


def test_ring_buffer_decode_past_the_cache_matches_jax():
    """recurrentgemma's local-attention cache holds min(max_len,
    local_window) = 8 slots; decoding to position 13 wraps the ring, with
    scalar and then per-row positions (one row wrapped, one not)."""
    cfg_j, cfg_t = _configs("recurrentgemma_2b")
    pj, pt = _params("recurrentgemma_2b")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 14)).astype(np.int32)
    st = lm.init_decode_state(cfg_t, 2, 8, device="cpu")
    sj = jax_lm.init_decode_state(cfg_j, 2, 8)
    assert st["layers"]["tail_2"]["k"].shape[1] == 8
    for t in range(12):
        lt, st = lm.decode_step(pt, cfg_t, st, _t(toks[:, t]).long(), t)
        lj, sj = jax_lm.decode_step(pj, cfg_j, sj, jnp.asarray(toks[:, t]),
                                    jnp.int32(t))
        _close(lt, lj)
    pos = np.array([12, 5], np.int32)
    lt, st = lm.decode_step(pt, cfg_t, st, _t(toks[:, 12]).long(), _t(pos))
    lj, sj = jax_lm.decode_step(pj, cfg_j, sj, jnp.asarray(toks[:, 12]),
                                jnp.asarray(pos))
    _close(lt, lj)
    _assert_same_state(st, sj)


# -- modules -------------------------------------------------------------------


def _moe_case(arch, seed, B, S):
    cfg_j, cfg_t = _configs(arch)
    pj, pt = _params(arch)
    layer = "tail_0"
    ffn_j, ffn_t = pj["stack"][layer]["ffn"], pt["stack"][layer]["ffn"]
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg_j.d_model)).astype(np.float32)
    return cfg_j, cfg_t, ffn_j, ffn_t, x


def _clustered(x, spread=0.05):
    """Tokens close to one another (one shared vector plus a little of
    each token's own): they all pick the same experts, past capacity."""
    return (x[:1, :1] + spread * x).astype(np.float32)


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "arctic_480b"])
def test_moe_drops_tokens_over_capacity_as_jax(arch):
    """More tokens pick one expert than a block holds: the reference's
    drops (slot C-1 of expert 0, zero update) and the port's agree, top-1
    and top-2."""
    cfg_j, cfg_t, ffn_j, ffn_t, x = _moe_case(arch, 3, 4, 8)
    x = _clustered(x)
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1) @ np.asarray(ffn_j["router"])
    top = np.argsort(-logits, axis=-1)[:, :cfg_j.experts_per_token]
    cap = jax_moe._block_capacity(T, cfg_j)
    assert moe._block_capacity(T, cfg_t) == cap
    assert np.bincount(top.ravel()).max() > cap      # tokens are dropped
    _close(moe.moe(ffn_t, _t(x), cfg_t),
           jax_moe.moe(ffn_j, jnp.asarray(x), cfg_j), atol=ACT_ATOL)
    np.testing.assert_allclose(
        float(moe.aux_load_balance_loss(ffn_t, _t(x), cfg_t)),
        float(jax_moe.aux_load_balance_loss(ffn_j, jnp.asarray(x), cfg_j)),
        atol=AUX_ATOL, rtol=0)


def test_moe_dispatch_blocks_are_independent():
    """With two dispatch blocks each half of the tokens is routed with its
    own capacity, as two one-block calls (the reference's blocked path
    needs a device mesh for its sharding hints)."""
    _, cfg_t, _, ffn_t, x = _moe_case("llama4_scout_17b_a16e", 7, 4, 8)
    xt = _t(_clustered(x))
    two = dataclasses.replace(cfg_t, moe_dispatch_blocks=2)
    halves = [moe.moe(ffn_t, xt[i:i + 2], cfg_t) for i in (0, 2)]
    torch.testing.assert_close(moe.moe(ffn_t, xt, two), torch.cat(halves),
                               atol=0, rtol=0)
    assert not torch.equal(moe.moe(ffn_t, xt, cfg_t), torch.cat(halves))


def test_moe_slot_positions_are_stable_running_indices():
    flat_e = torch.tensor([[2, 0, 2, 1, 2, 0], [1, 1, 1, 1, 0, 3]])
    pos = moe._slot_positions(flat_e, 4)
    assert pos.tolist() == [[0, 0, 1, 0, 2, 1], [0, 1, 2, 3, 0, 0]]


def test_arctic_dense_residual_matches_jax():
    """arctic's MoE adds a dense MLP of every token beside the experts:
    the port's layer equals the same layer without it plus the MLP, and
    the reference's layer."""
    cfg_j, cfg_t, ffn_j, ffn_t, x = _moe_case("arctic_480b", 5, 2, 5)
    assert "dense_mlp" in ffn_t and cfg_t.moe_dense_ff
    xt = _t(x)
    full = moe.moe(ffn_t, xt, cfg_t)
    experts_only = moe.moe({k: v for k, v in ffn_t.items()
                            if k != "dense_mlp"}, xt, cfg_t)
    dense = mlp(ffn_t["dense_mlp"], xt.reshape(1, 10, -1),
                cfg_t.mlp_act).reshape(xt.shape)
    torch.testing.assert_close(full, experts_only + dense, atol=1e-6,
                               rtol=0)
    _close(full, jax_moe.moe(ffn_j, jnp.asarray(x), cfg_j), atol=ACT_ATOL)


def _attn_layer(arch, key="mix", layer=None):
    pj, pt = _params(arch)
    layer = layer or next(k for k, v in pt["stack"].items()
                          if "wq" in v[key])
    return pj["stack"][layer][key], pt["stack"][layer][key]


def test_local_windowed_attention_matches_jax():
    """S = 1024 with window 16 takes the windowed chunk path in both
    packages; it equals the port's dense windowed-mask attention too."""
    cfg_j, cfg_t = _configs("recurrentgemma_2b")
    assert cfg_t.attn_kind == "local" and cfg_t.local_window == 16
    lj, lt = _attn_layer("recurrentgemma_2b")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 1024, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1024, dtype=np.int32), (1, 1024))
    ours = attn.attention(lt, _t(x), cfg_t, _t(pos).long())
    _close(ours, jax_attn.attention(lj, jnp.asarray(x), cfg_j,
                                    jnp.asarray(pos)), atol=ACT_ATOL)
    q, k, v = attn._project_qkv(lt, _t(x), cfg_t, _t(pos).long())
    dense = attn._sdpa(q, k, v, attn._causal_mask(1024, 1024, 16), cfg_t)
    torch.testing.assert_close(
        attn._local_windowed_sdpa(q, k, v, cfg_t, attn.Q_CHUNK), dense,
        atol=ACT_ATOL, rtol=0)


def test_encoder_attention_matches_jax():
    """S = 1024 takes the non-causal chunked path in both packages; it
    equals the port's unmasked dense attention too."""
    cfg_j, cfg_t = _configs("seamless_m4t_medium")
    pj, pt = _params("seamless_m4t_medium")
    lj, lt = pj["encoder"]["tail_0"]["mix"], pt["encoder"]["tail_0"]["mix"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 1024, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1024, dtype=np.int32), (1, 1024))
    _close(attn.encoder_attention(lt, _t(x), cfg_t, _t(pos).long()),
           jax_attn.encoder_attention(lj, jnp.asarray(x), cfg_j,
                                      jnp.asarray(pos)), atol=ACT_ATOL)
    q, k, v = attn._project_qkv(lt, _t(x), cfg_t, _t(pos).long())
    torch.testing.assert_close(
        attn._chunked_causal_sdpa(q, k, v, cfg_t, 512, 512, causal=False),
        attn._sdpa(q, k, v, None, cfg_t), atol=ACT_ATOL, rtol=0)


@pytest.mark.parametrize("Sq,Sk", [(3, 5), (512, 1024)])
def test_cross_attention_matches_jax(Sq, Sk):
    """Short sequences take the dense path; (512, 1024) the non-causal
    chunked path with Sq != Sk."""
    cfg_j, cfg_t = _configs("seamless_m4t_medium")
    lj, lt = _attn_layer("seamless_m4t_medium", key="cross")
    rng = np.random.default_rng(Sq + Sk)
    x = rng.standard_normal((2, Sq, cfg_j.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, Sk, cfg_j.d_model)).astype(np.float32)
    ours = attn.cross_attention(lt, _t(x), _t(enc), cfg_t)
    _close(ours, jax_attn.cross_attention(lj, jnp.asarray(x),
                                          jnp.asarray(enc), cfg_j),
           atol=ACT_ATOL)
    torch.testing.assert_close(
        attn.cross_attention_decode(lt, _t(x), _t(enc), cfg_t), ours)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_cells_at_two_level_scan_length_match_jax(kind):
    """S = 256 takes ``chunked_scan``'s two-level (chunked, checkpointed)
    path in JAX; the port's plain loop computes the same recurrence."""
    cfg_j, cfg_t = _configs("xlstm_1_3b")
    pj, pt = _params("xlstm_1_3b")
    layer = next(k for k, v in pt["stack"].items()
                 if ("wq" in v["mix"]) == (kind == "mlstm"))
    S = 256
    assert S % jax_rec._SCAN_CHUNK == 0 and S > jax_rec._SCAN_CHUNK
    x = np.random.default_rng(8).standard_normal(
        (2, S, cfg_j.d_model)).astype(np.float32)
    fj = getattr(jax_rec, f"{kind}_block")
    ft = getattr(recurrent, f"{kind}_block")
    _close(ft(pt["stack"][layer]["mix"], _t(x), cfg_t),
           fj(pj["stack"][layer]["mix"], jnp.asarray(x), cfg_j),
           atol=ACT_ATOL)


def test_rglru_decode_matches_its_block_and_jax():
    """Stepping ``rglru_decode`` over a sequence gives the block's
    outputs (the conv state carries the last K-1 inputs, the recurrence
    ``h``), and the block matches the reference's associative scan."""
    cfg_j, cfg_t = _configs("recurrentgemma_2b")
    pj, pt = _params("recurrentgemma_2b")
    pm_j, pm_t = pj["stack"]["tail_0"]["mix"], pt["stack"]["tail_0"]["mix"]
    assert "lam" in pm_t
    x = np.random.default_rng(9).standard_normal(
        (2, 40, cfg_j.d_model)).astype(np.float32)
    block = recurrent.rglru_block(pm_t, _t(x), cfg_t)
    _close(block, jax_rec.rglru_block(pm_j, jnp.asarray(x), cfg_j),
           atol=ACT_ATOL)
    st = recurrent.init_rglru_state(cfg_t, 2, torch.float32)
    sj = jax_rec.init_rglru_state(cfg_j, 2, jnp.float32)
    steps = []
    for t in range(x.shape[1]):
        y, st = recurrent.rglru_decode(pm_t, _t(x[:, t:t + 1]), cfg_t, st)
        yj, sj = jax_rec.rglru_decode(pm_j, jnp.asarray(x[:, t:t + 1]),
                                      cfg_j, sj)
        steps.append(y)
    torch.testing.assert_close(torch.cat(steps, dim=1), block,
                               atol=ACT_ATOL, rtol=0)
    _assert_same_state(st, sj)


def test_softplus_is_jax_logaddexp():
    x = np.linspace(-40.0, 40.0, 161).astype(np.float32)
    _close(recurrent._softplus(_t(x)), jax.nn.softplus(jnp.asarray(x)),
           atol=1e-6)
