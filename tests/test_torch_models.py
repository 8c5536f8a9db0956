"""The port's dense decoder models against the JAX package, on the CPU,
and the param and decode-state layout of every family.

Both packages run the same weights (JAX's init carried over by
``lm.params_from_numpy``) on the same token ids, made with numpy from a
seed, in fp32. ``forward``, ``prefill`` and ``decode_step`` logits agree
within LOGIT_ATOL - the tolerance the reference's own engine tests use -
on the smoke configs of internlm2_1_8b, chatglm3_6b (2-D RoPE) and
qwen25_32b (QKV bias), with and without the scanned stack layout. The
other families' numerics are held in tests/test_torch_families.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.models import mlp as jax_mlp  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm, mlp  # noqa: E402
from repro_torch.models.common import apply_rope, rms_norm  # noqa: E402

# logits of the fp32 smoke models: tests/test_train_serve.py's tolerance
LOGIT_ATOL = 1e-4
# one layer's activations in fp32
ACT_ATOL = 1e-5

DENSE = ["internlm2_1_8b", "chatglm3_6b", "qwen25_32b"]


def _configs(arch, **over):
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


def _params(cfg_j, seed=0):
    pj = jax_lm.init_lm(jax.random.PRNGKey(seed), cfg_j)
    return pj, lm.params_from_numpy(jax.tree_util.tree_map(np.asarray, pj),
                                    "cpu")


def _close(ours, ref, atol=LOGIT_ATOL):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


CASES = [(a, {}) for a in DENSE] + [
    ("internlm2_1_8b", dict(n_layers=4, scan_layers=True))]


@pytest.mark.parametrize("arch,over", CASES,
                         ids=DENSE + ["internlm2_1_8b-scan"])
def test_logits_match_jax(arch, over):
    cfg_j, cfg_t = _configs(arch, **over)
    pj, pt = _params(cfg_j)
    assert list(pt["stack"]) == list(pj["stack"])
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg_j.vocab_size, (2, 6)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    lt, aux = lm.forward(pt, cfg_t, tt)
    _close(lt, jax_lm.forward(pj, cfg_j, jnp.asarray(toks))[0])
    assert float(aux) == 0.0
    ht, _ = lm.forward_hidden(pt, cfg_t, tt)
    _close(ht, jax_lm.forward_hidden(pj, cfg_j, jnp.asarray(toks))[0],
           atol=ACT_ATOL)

    lt, st = lm.prefill(pt, cfg_t, tt, max_len=16)
    lj, sj = jax_lm.prefill(pj, cfg_j, jnp.asarray(toks), max_len=16)
    _close(lt, lj)
    # a scalar-position step, then per-row positions (slot batching)
    lt, st = lm.decode_step(pt, cfg_t, st, tt[:, 1], 6)
    lj, sj = jax_lm.decode_step(pj, cfg_j, sj, jnp.asarray(toks[:, 1]),
                                jnp.int32(6))
    _close(lt, lj)
    pos = np.array([7, 3], np.int32)
    lt, st = lm.decode_step(pt, cfg_t, st, tt[:, 2], torch.from_numpy(pos))
    lj, sj = jax_lm.decode_step(pj, cfg_j, sj, jnp.asarray(toks[:, 2]),
                                jnp.asarray(pos))
    _close(lt, lj)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, sj))
    for path, ref in flat_t:
        node = st
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), ref, atol=ACT_ATOL, rtol=0)


def test_chunked_causal_attention_matches_jax():
    """S = 1024 takes the flash-style chunked path in both packages."""
    cfg_j, cfg_t = _configs("internlm2_1_8b")
    pj, pt = _params(cfg_j)
    layer_j = pj["stack"]["tail_0"]["mix"]
    layer_t = pt["stack"]["tail_0"]["mix"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 1024, cfg_j.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1024, dtype=np.int32), (1, 1024))
    ref = jax_attn.attention(layer_j, jnp.asarray(x), cfg_j,
                             jnp.asarray(pos))
    ours = attn.attention(layer_t, torch.from_numpy(x), cfg_t,
                          torch.from_numpy(pos.copy()).long())
    _close(ours, ref, atol=ACT_ATOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_activations_match_jax(act):
    rng = np.random.default_rng(len(act))
    pj = jax_mlp.init_mlp(jax.random.PRNGKey(1), 32, 48, act)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    _close(mlp.mlp(pt, torch.from_numpy(x), act),
           jax_mlp.mlp(pj, jnp.asarray(x), act), atol=ACT_ATOL)


@pytest.mark.parametrize("kind", ["full", "2d", "none"])
def test_rope_and_rms_norm_match_jax(kind):
    from repro.models import common as jax_common
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5)).astype(np.int32)
    _close(apply_rope(torch.from_numpy(x), torch.from_numpy(pos), kind),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), kind),
           atol=ACT_ATOL)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           atol=ACT_ATOL)


# every family's tree (cross attention, an encoder, MoE experts, recurrent
# mixers, FFN-less blocks) and the scanned layouts, heterogeneous periods
# included
LAYOUTS = [("internlm2_1_8b", {})] + [(a, {}) for a in (
    "arctic_480b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
    "xlstm_1_3b", "seamless_m4t_medium", "pixtral_12b")] + [
    ("qwen25_32b", dict(n_layers=4, scan_layers=True)),
    ("recurrentgemma_2b", dict(n_layers=8, scan_layers=True)),
    ("xlstm_1_3b", dict(scan_layers=True, d_ff=0)),
    ("seamless_m4t_medium", dict(n_layers=4, n_encoder_layers=4,
                                 scan_layers=True))]


@pytest.mark.parametrize("arch,over", LAYOUTS, ids=[
    a + ("-scan" if o.get("scan_layers") else "") for a, o in LAYOUTS])
def test_init_lm_matches_the_reference_layout(arch, over):
    cfg_j, cfg_t = _configs(arch, **over)
    pt = lm.init_lm(torch.Generator().manual_seed(0), cfg_t)
    pj = jax.eval_shape(lambda: jax_lm.init_lm(jax.random.PRNGKey(0),
                                               cfg_j))
    ours = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(pt)}
    ref = {jax.tree_util.keystr(p): v.shape for p, v in
           jax.tree_util.tree_leaves_with_path(pj)}
    assert ours == ref
    assert all(v.dtype == torch.float32 for v in jax.tree_util.tree_leaves(
        pt))
    again = lm.init_lm(torch.Generator().manual_seed(0), cfg_t)
    assert torch.equal(again["embed"], pt["embed"])
    # the decode state's layout too (KV caches clamped to a local window,
    # recurrent rows, mLSTM matrices), with enc_out for enc-dec models
    st = lm.init_decode_state(cfg_t, 2, 32, device="cpu")
    sj = jax.eval_shape(lambda: jax_lm.init_decode_state(cfg_j, 2, 32))
    ours = {jax.tree_util.keystr(p): tuple(v.shape) for p, v in
            jax.tree_util.tree_leaves_with_path(st)}
    ref = {jax.tree_util.keystr(p): v.shape for p, v in
           jax.tree_util.tree_leaves_with_path(sj)}
    assert ours == ref
    assert ("enc_out" in st) == ("enc_out" in sj) == cfg_t.is_encdec
