"""The port's other model families against the JAX package, on the CPU.

MoE (arctic_480b with its dense residual MLP, llama4_scout_17b_a16e),
hybrid (recurrentgemma_2b: RG-LRU + local attention with a ring-buffer
cache), ssm (xlstm_1_3b: mLSTM/sLSTM), encoder-decoder
(seamless_m4t_medium) and VLM (pixtral_12b, prefix embeddings), at their
smoke sizes in fp32. Both packages run the same weights (JAX's init
carried over by ``lm.params_from_numpy``) on the same inputs, made with
numpy from a seed:

* ``forward`` logits within LOGIT_ATOL, the MoE ``aux`` within AUX_ATOL,
  ``forward_hidden`` within ACT_ATOL; ``prefill`` and ``decode_step``
  (scalar and per-row positions) logits within LOGIT_ATOL and every
  decode-state leaf within ACT_ATOL, also in the scanned layouts
  (heterogeneous periods: recurrentgemma's (rglru, rglru, attn),
  xlstm's seven mLSTM blocks and one sLSTM block);
* every block of xlstm's stack on its own, within ACT_ATOL.

tests/test_torch_family_modules.py holds the modules one at a time and
tests/test_torch_family_engines.py the serve engines on these families.

The RG-LRU prefill runs its recurrence sequentially in fp32 where JAX
uses ``lax.associative_scan``: the two differ by fp32 rounding only, far
inside LOGIT_ATOL at these sizes.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402

# logits of the fp32 smoke models: tests/test_train_serve.py's tolerance
LOGIT_ATOL = 1e-4
# one layer's activations, the final hidden state and decode-state leaves
ACT_ATOL = 1e-5
# the summed MoE load-balance loss (O(1), fp32 means over tokens)
AUX_ATOL = 1e-6
# xlstm's 16-block smoke stack, whole: each block agrees with the
# reference within ACT_ATOL given the same input (test_xlstm_blocks_one_
# by_one_match_jax, ~1.5e-6), but random-init mLSTM/sLSTM blocks pass an
# input difference on ~1.3x larger, so the stack multiplies that
# rounding by up to sum(1.3^i, i < 16) ~ 170: 2.6e-4, bounded by 5e-4
XLSTM_STACK_ATOL = 5e-4

FAMILIES = ["arctic_480b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
            "xlstm_1_3b", "seamless_m4t_medium", "pixtral_12b"]
SCANNED = [("recurrentgemma_2b", (("n_layers", 6), ("scan_layers", True))),
           ("xlstm_1_3b", (("scan_layers", True),))]
CASES = [(a, ()) for a in FAMILIES] + SCANNED
IDS = FAMILIES + ["recurrentgemma_2b-scan", "xlstm_1_3b-scan"]


def _configs(arch, over=()):
    over = dict(over)
    return (dataclasses.replace(jax_smoke(arch), **over),
            dataclasses.replace(get_smoke_config(arch), **over))


@functools.lru_cache(maxsize=None)
def _params(arch, over=(), seed=0):
    """JAX's init and the same tree carried over to the port."""
    cfg_j, _ = _configs(arch, over)
    pj = jax_lm.init_lm(jax.random.PRNGKey(seed), cfg_j)
    return pj, lm.params_from_numpy(_numpy_tree(pj), "cpu")


def _numpy_tree(tree):
    """numpy leaves in the tree's own key order (``tree_map`` would sort
    the keys: "tail_10" before "tail_2")."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, atol=LOGIT_ATOL):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=0)


def _inputs(cfg, rng, B=2, S=6, frames=5):
    """Token ids and the family's extra inputs (prefix embeddings, encoder
    frames), as (numpy kwargs, torch kwargs)."""
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = {}
    if cfg.n_prefix_embeds:
        extra["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        extra["enc_frames"] = rng.standard_normal(
            (B, frames, cfg.d_model)).astype(np.float32)
    return (toks, {k: jnp.asarray(v) for k, v in extra.items()},
            {k: _t(v) for k, v in extra.items()})


def _assert_same_state(st, sj, atol=ACT_ATOL):
    """Every leaf of the JAX decode state (enc_out included) within
    ``atol`` of the port's leaf at the same path, or within ACT_ATOL of
    its magnitude where that is larger (mLSTM's C and n grow past O(10),
    where 1e-5 is about one fp32 ulp)."""
    leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, sj))
    assert leaves
    for path, ref in leaves:
        node = st
        for k in path:
            node = node[k.key]
        np.testing.assert_allclose(node.numpy(), ref, atol=atol,
                                   rtol=ACT_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@functools.lru_cache(maxsize=None)
def _jax_forward(arch, over=()):
    """The reference's ``forward`` and ``forward_hidden`` in one jitted
    call (one compile; eager JAX compiles every op of a new shape)."""
    cfg_j, _ = _configs(arch, over)

    def both(p, toks, kw):
        return (jax_lm.forward(p, cfg_j, toks, **kw),
                jax_lm.forward_hidden(p, cfg_j, toks, **kw)[0])
    return jax.jit(both)


@pytest.mark.parametrize("arch,over", CASES, ids=IDS)
def test_family_matches_jax(arch, over):
    cfg_j, cfg_t = _configs(arch, over)
    pj, pt = _params(arch, over)
    assert list(pt["stack"]) == list(pj["stack"])
    stack_atol = XLSTM_STACK_ATOL if arch == "xlstm_1_3b" else None
    logit_atol = stack_atol or LOGIT_ATOL
    toks, kw_j, kw_t = _inputs(cfg_j, np.random.default_rng(len(arch)))
    tt = _t(toks).long()

    (lj, aux_j), hj = _jax_forward(arch, over)(pj, jnp.asarray(toks), kw_j)
    lt, aux_t = lm.forward(pt, cfg_t, tt, **kw_t)
    _close(lt, lj, logit_atol)
    assert aux_t.dtype == torch.float32 and aux_t.shape == ()
    np.testing.assert_allclose(float(aux_t), float(aux_j), atol=AUX_ATOL,
                               rtol=0)
    assert (float(aux_j) > 0) == bool(cfg_j.n_experts)
    ht, _ = lm.forward_hidden(pt, cfg_t, tt, **kw_t)
    _close(ht, hj, stack_atol or ACT_ATOL)

    lt, st = lm.prefill(pt, cfg_t, tt, max_len=16, **kw_t)
    lj, sj = jax_lm.prefill(pj, cfg_j, jnp.asarray(toks), max_len=16,
                            **kw_j)
    _close(lt, lj, logit_atol)
    _assert_same_state(st, sj, stack_atol or ACT_ATOL)
    # a scalar-position step, then per-row positions (slot batching)
    n = toks.shape[1] + cfg_j.n_prefix_embeds
    lt, st = lm.decode_step(pt, cfg_t, st, tt[:, 1], n)
    lj, sj = jax_lm.decode_step(pj, cfg_j, sj, jnp.asarray(toks[:, 1]),
                                jnp.int32(n))
    _close(lt, lj, logit_atol)
    pos = np.array([n + 1, 3], np.int32)
    lt, st = lm.decode_step(pt, cfg_t, st, tt[:, 2], _t(pos))
    lj, sj = jax_lm.decode_step(pj, cfg_j, sj, jnp.asarray(toks[:, 2]),
                                jnp.asarray(pos))
    _close(lt, lj, logit_atol)
    _assert_same_state(st, sj, stack_atol or ACT_ATOL)


def test_xlstm_blocks_one_by_one_match_jax():
    """Every block of xlstm's smoke stack on the reference's own input to
    it (the previous block's JAX output): within ACT_ATOL, the rounding
    that XLSTM_STACK_ATOL lets the whole stack amplify."""
    cfg_j, cfg_t = _configs("xlstm_1_3b")
    pj, pt = _params("xlstm_1_3b")
    toks, _, _ = _inputs(cfg_j, np.random.default_rng(10))
    x, pos = jax_lm._embed_inputs(pj, cfg_j, jnp.asarray(toks), None)
    pos_t = _t(pos).long()
    for i, kind in enumerate(cfg_j.pattern_for_depth()):
        name = f"tail_{i}"
        yt, _ = lm.apply_block(pt["stack"][name], _t(x), cfg_t, kind,
                               positions=pos_t)
        x, _ = jax_lm.apply_block(pj["stack"][name], x, cfg_j, kind,
                                  positions=pos)
        _close(yt, x, ACT_ATOL)
