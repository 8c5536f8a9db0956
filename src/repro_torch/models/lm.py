"""Decoder language models of the dense family, assembled from the block
zoo: GQA attention (full causal, RoPE "full"/"2d", optional QKV bias) and
a SwiGLU / GeGLU / GELU MLP.

The param and decode-state trees keep the JAX package's layout exactly:
``{"embed", "final_ln", "stack", ["lm_head"]}`` with ``stack`` holding a
``"scan"`` group (every leaf with a leading group axis, looped over in
Python here) and/or unscanned ``"tail_i"`` blocks, as
``_stack_layout`` decides. ``cfg.scan_layers`` therefore picks the tree
layout only; ``cfg.remat`` has no effect (both are XLA compile switches).
Code that walks the trees (the serve engine's re-tiering, the decode
engine's state scatter) sees the same keys as in the JAX package.

:func:`params_from_numpy` carries a JAX param tree (numpy leaves) over,
so both packages can run the same weights. The MoE, hybrid, ssm,
encoder-decoder and VLM families raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import ModelConfig, dense_init, rms_norm
from repro_torch.models.mlp import init_mlp_cfg, mlp_cfg

PyTree = Any

_ATTN_KEYS = {"wq", "wk", "wv", "wo", "bq", "bk", "bv"}


def _require_dense(cfg: ModelConfig) -> None:
    if (cfg.family != "dense" or cfg.n_experts or cfg.is_encdec
            or cfg.n_prefix_embeds or set(cfg.block_pattern) != {"attn"}):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; the "
            f"port runs the dense family (attention + MLP blocks)")
    attn_lib._require_full_attention(cfg)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    dev = gen.device
    return {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "mix": attn_lib.init_attention(gen, cfg),
        "ln2": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "ffn": init_mlp_cfg(gen, cfg),
    }


def apply_block(p: PyTree, x: torch.Tensor, cfg: ModelConfig, *,
                positions) -> torch.Tensor:
    """Full-sequence block application."""
    x = x + attn_lib.attention(p["mix"], rms_norm(x, p["ln1"], cfg.norm_eps),
                               cfg, positions)
    return x + mlp_cfg(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)


def apply_block_decode(p: PyTree, x: torch.Tensor, cfg: ModelConfig,
                       state: PyTree, *, pos) -> Tuple[torch.Tensor, PyTree]:
    """One-token block application with its KV cache (written in place)."""
    h, new_state = attn_lib.attention_decode(
        p["mix"], rms_norm(x, p["ln1"], cfg.norm_eps), cfg, state, pos)
    x = x + h
    x = x + mlp_cfg(p["ffn"], rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, new_state


# ---------------------------------------------------------------------------
# stack layout: scanned groups + tail
# ---------------------------------------------------------------------------


def _stack_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...],
                                             Tuple[str, ...]]:
    """Returns (n_groups, period_kinds, tail_kinds)."""
    pattern = cfg.pattern_for_depth()
    period = cfg.block_pattern
    if not cfg.scan_layers:
        return 0, (), pattern
    n_groups = cfg.n_layers // len(period)
    tail = pattern[n_groups * len(period):]
    if n_groups < 2:        # scanning 0/1 group is pointless
        return 0, (), pattern
    return n_groups, period, tail


def _stack_trees(trees: List[PyTree]) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index_tree(tree: PyTree, i: int) -> PyTree:
    """Group ``i`` of a stacked tree, as views (in-place writes reach the
    stacked leaves)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _init_stack(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    n_groups, period, tail = _stack_layout(cfg)
    out: Dict[str, PyTree] = {}
    if n_groups:
        out["scan"] = _stack_trees([
            {f"p{i}": init_block(gen, cfg) for i in range(len(period))}
            for _ in range(n_groups)])
    for i in range(len(tail)):
        out[f"tail_{i}"] = init_block(gen, cfg)
    return out


def _apply_stack(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *,
                 positions) -> torch.Tensor:
    n_groups, period, tail = _stack_layout(cfg)
    for gi in range(n_groups):
        gparams = _index_tree(params["scan"], gi)
        for i in range(len(period)):
            x = apply_block(gparams[f"p{i}"], x, cfg, positions=positions)
    for i in range(len(tail)):
        x = apply_block(params[f"tail_{i}"], x, cfg, positions=positions)
    return x


def _init_stack_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> PyTree:
    n_groups, period, tail = _stack_layout(cfg)
    out: Dict[str, PyTree] = {}
    if n_groups:
        out["scan"] = _stack_trees([
            {f"p{i}": attn_lib.init_kv_cache(cfg, batch, max_len, dtype,
                                             device)
             for i in range(len(period))}
            for _ in range(n_groups)])
    for i in range(len(tail)):
        out[f"tail_{i}"] = attn_lib.init_kv_cache(cfg, batch, max_len,
                                                  dtype, device)
    return out


def _apply_stack_decode(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                        state: PyTree, *, pos
                        ) -> Tuple[torch.Tensor, PyTree]:
    n_groups, period, tail = _stack_layout(cfg)
    new_state: Dict[str, PyTree] = {}
    if n_groups:
        # every group's cache is a view of the stacked leaves, which the
        # in-place cache writes update: the stacked tree is the new state
        for gi in range(n_groups):
            gparams = _index_tree(params["scan"], gi)
            gstate = _index_tree(state["scan"], gi)
            for i in range(len(period)):
                x, _ = apply_block_decode(gparams[f"p{i}"], x, cfg,
                                          gstate[f"p{i}"], pos=pos)
        new_state["scan"] = state["scan"]
    for i in range(len(tail)):
        x, new_state[f"tail_{i}"] = apply_block_decode(
            params[f"tail_{i}"], x, cfg, state[f"tail_{i}"], pos=pos)
    return x, new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random fp32 params on ``gen``'s device, drawn from ``gen``."""
    _require_dense(cfg)
    params: Dict[str, PyTree] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1),
        "final_ln": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=gen.device),
        "stack": _init_stack(gen, cfg),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return params


def _check_dense_tree(tree: PyTree) -> None:
    if "encoder" in tree:
        raise NotImplementedError("encoder-decoder params: the family is "
                                  "not ported yet")
    for entry in tree["stack"].values():
        blocks = entry.values() if "ln1" not in entry else [entry]
        for blk in blocks:
            if "cross" in blk:
                raise NotImplementedError("cross-attention params: the "
                                          "encoder-decoder family is not "
                                          "ported yet")
            if not set(blk["mix"]) <= _ATTN_KEYS:
                raise NotImplementedError("recurrent mixer params: the "
                                          "hybrid/ssm families are not "
                                          "ported yet")
            if "router" in blk.get("ffn", {}):
                raise NotImplementedError("MoE params: the moe family is "
                                          "not ported yet")


def params_from_numpy(tree: PyTree, device=DEFAULT_DEVICE) -> PyTree:
    """The JAX package's param tree (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's: the
    same keys, torch tensors on ``device``."""
    dev = resolve_device(device)
    _check_dense_tree(tree)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t)).to(dev)
    return conv(tree)


def _embed_inputs(params, cfg: ModelConfig, tokens):
    # gather, then cast: the same values as casting the whole table first
    x = params["embed"][tokens].to(cfg.dtype)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def _lm_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    return x @ head


def forward(params, cfg: ModelConfig, tokens
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward. Returns (logits, aux_loss); the dense
    family's aux loss is 0."""
    _require_dense(cfg)
    x, positions = _embed_inputs(params, cfg, tokens)
    x = _apply_stack(params["stack"], x, cfg, positions=positions)
    return _lm_logits(params, cfg, x), torch.zeros((), device=x.device)


def forward_hidden(params, cfg: ModelConfig, tokens
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like forward() but stops at the final norm (no vocab projection)."""
    _require_dense(cfg)
    x, positions = _embed_inputs(params, cfg, tokens)
    x = _apply_stack(params["stack"], x, cfg, positions=positions)
    return (rms_norm(x, params["final_ln"], cfg.norm_eps),
            torch.zeros((), device=x.device))


# -- decode -----------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      device=DEFAULT_DEVICE) -> PyTree:
    _require_dense(cfg)
    return {"layers": _init_stack_state(cfg, batch, max_len, cfg.dtype,
                                        resolve_device(device))}


def decode_step(params, cfg: ModelConfig, state, tokens, pos
                ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step. tokens: (B,) integer; pos: () integer, or (B,)
    for per-row positions (slot continuous batching).

    Returns (logits (B, vocab), new_state). The KV caches of ``state`` are
    updated in place and shared with ``new_state``.
    """
    x = params["embed"][tokens].to(cfg.dtype)
    return _decode_step_embed(params, cfg, state, x, pos)


def prefill(params, cfg: ModelConfig, tokens, *, max_len: int
            ) -> Tuple[torch.Tensor, PyTree]:
    """Process a prompt and build a decode state by stepping (reference
    implementation used by tests; production serving uses forward() for
    logits and batch-writes the cache)."""
    B, S = tokens.shape
    state = init_decode_state(cfg, B, max_len, device=tokens.device)
    logits = None
    x, _ = _embed_inputs(params, cfg, tokens)
    for t in range(S):
        logits, state = _decode_step_embed(params, cfg, state, x[:, t], t)
    return logits, state


def _decode_step_embed(params, cfg, state, x_embed, pos):
    x = x_embed[:, None, :]
    # one host-to-device copy of a host position per step, not per layer
    pos = torch.as_tensor(pos, device=x.device).long()
    x, new_layers = _apply_stack_decode(params["stack"], x, cfg,
                                        state["layers"], pos=pos)
    logits = _lm_logits(params, cfg, x)[:, 0, :]
    new_state = dict(state)
    new_state["layers"] = new_layers
    return logits, new_state
