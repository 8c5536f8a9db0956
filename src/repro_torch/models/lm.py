"""Full language models assembled from the block zoo, for every
architecture family of the registry:
  dense / moe decoder LMs (GQA attention + [Swi/Ge]GLU or MoE FFN),
  hybrid stacks (RG-LRU + local attention, RecurrentGemma-style),
  ssm stacks (mLSTM/sLSTM, xLSTM-style),
  encoder-decoder (Seamless-style; frame-embedding frontend stub),
  vlm (Pixtral-style; patch-embedding frontend stub prepended to text).

The param and decode-state trees keep the JAX package's layout exactly:
``{"embed", "final_ln", "stack", ["encoder", "enc_final_ln"],
["lm_head"]}`` with each stack holding a ``"scan"`` group (one
``p{i}`` block per kind of the period, every leaf with a leading group
axis, looped over in Python here) and/or unscanned ``"tail_i"`` blocks,
as ``_stack_layout`` decides. ``cfg.scan_layers`` therefore picks the
tree layout only. ``cfg.remat`` checkpoints each block of a
full-sequence stack (``torch.utils.checkpoint``, as ``jax.checkpoint``
does) while autograd records, so a training step keeps only the blocks'
inputs and recomputes the rest in the backward pass; serving and decode
run without it. Code that walks the trees (the serve engine's
re-tiering, the decode engine's state scatter) sees the same keys as in
the JAX package.

:func:`params_from_numpy` carries a JAX param tree (numpy leaves) over,
so both packages can run the same weights. :func:`loss_fn` is the
training loss (next-token cross-entropy, chunked over the sequence as
in the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.common import (ModelConfig, batch_only,
                                      dense_init, replicate_for_gather,
                                      rms_norm, shard_activations)
from repro_torch.models.mlp import init_mlp_cfg, mlp_cfg

PyTree = Any


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    if kind in ("mlstm", "slstm"):
        return cfg.d_ff > 0
    return True


def _is_moe(cfg: ModelConfig, kind: str) -> bool:
    return bool(cfg.n_experts) and kind == "attn"


def _moe_ffn(p) -> bool:
    """The block's FFN is an MoE layer (it has a router); a leading
    dense block of an MoE model has a plain MLP."""
    return "router" in p["ffn"]


def _init_attention(gen: torch.Generator, cfg: ModelConfig):
    return (mla_lib.init_mla(gen, cfg) if cfg.kv_lora_rank
            else attn_lib.init_attention(gen, cfg))


_INIT_MIX = {"attn": _init_attention, "rglru": rec_lib.init_rglru,
             "mlstm": rec_lib.init_mlstm, "slstm": rec_lib.init_slstm}
_APPLY_MIX = {"rglru": rec_lib.rglru_block, "mlstm": rec_lib.mlstm_block,
              "slstm": rec_lib.slstm_block}
_DECODE_MIX = {"rglru": rec_lib.rglru_decode,
               "mlstm": rec_lib.mlstm_decode,
               "slstm": rec_lib.slstm_decode}


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               cross: bool = False, dense: bool = False) -> PyTree:
    """One block's params; ``dense`` gives an MoE model's block a plain
    d_ff MLP (its leading dense layers)."""
    if kind not in _INIT_MIX:
        raise ValueError(kind)
    dev = gen.device
    p: Dict[str, PyTree] = {
        "ln1": torch.zeros((cfg.d_model,), dtype=torch.float32, device=dev),
        "mix": _INIT_MIX[kind](gen, cfg)}
    if cross:
        p["ln_cross"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                                    device=dev)
        p["cross"] = attn_lib.init_cross_attention(gen, cfg)
    if _has_ffn(cfg, kind):
        p["ln2"] = torch.zeros((cfg.d_model,), dtype=torch.float32,
                               device=dev)
        p["ffn"] = (moe_lib.init_moe(gen, cfg)
                    if _is_moe(cfg, kind) and not dense
                    else init_mlp_cfg(gen, cfg))
    return p


def apply_block(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions, enc_out=None, causal: bool = True
                ) -> Tuple[torch.Tensor, Any]:
    """Full-sequence block application. Returns (x, aux_loss); aux_loss is
    0.0 for a block without an MoE FFN."""
    aux = 0.0
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn" and cfg.kv_lora_rank:
        h = mla_lib.mla_attention(p["mix"], h, cfg, positions)
    elif kind == "attn":
        h = (attn_lib.attention(p["mix"], h, cfg, positions) if causal
             else attn_lib.encoder_attention(p["mix"], h, cfg, positions))
    else:
        h = _APPLY_MIX[kind](p["mix"], h, cfg)
    # on a mesh, reduce the mixer's partial sums here: DTensor would carry
    # them unreduced into the next norm and reshard on its own (JAX's
    # partitioner reduces at the residual add)
    x = shard_activations(x + h, cfg)
    if "cross" in p:
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = shard_activations(
            x + attn_lib.cross_attention(p["cross"], h, enc_out, cfg), cfg)
    if "ffn" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if _moe_ffn(p):
            aux = moe_lib.aux_load_balance_loss(p["ffn"], h, cfg)
            h = moe_lib.moe(p["ffn"], h, cfg)
        else:
            h = mlp_cfg(p["ffn"], h, cfg)
        x = x + h
    return x, aux


def apply_block_decode(p: PyTree, x: torch.Tensor, cfg: ModelConfig,
                       kind: str, state: PyTree, *, pos, enc_out=None
                       ) -> Tuple[torch.Tensor, PyTree]:
    """One-token block application with recurrent/KV state (a KV cache is
    written in place, a recurrent state returned anew). On a mesh the
    residual stream is sharded by batch only (``batch_only``), its
    partial sums reduced at each add.

    Traced, an MLA block's attention and an MoE FFN are the spans
    ``attn.mla`` and ``moe.experts`` (the host's enqueue of their
    work)."""
    x = batch_only(x)
    _obs = obs.enabled()
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn" and cfg.kv_lora_rank:
        _t0 = obs.now_ns() if _obs else 0
        h, new_state = mla_lib.mla_decode(p["mix"], h, cfg, state, pos)
        if _obs:
            obs.complete("attn.mla", _t0, cat="model")
    elif kind == "attn":
        h, new_state = attn_lib.attention_decode(p["mix"], h, cfg, state,
                                                 pos)
    else:
        h, new_state = _DECODE_MIX[kind](p["mix"], h, cfg, state)
    x = batch_only(x + h)
    if "cross" in p:
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        x = batch_only(
            x + attn_lib.cross_attention_decode(p["cross"], h, enc_out, cfg))
    if "ffn" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if _moe_ffn(p):
            _t0 = obs.now_ns() if _obs else 0
            h = moe_lib.moe(p["ffn"], h, cfg)
            if _obs:
                obs.complete("moe.experts", _t0, cat="model")
        else:
            h = mlp_cfg(p["ffn"], h, cfg)
        x = batch_only(x + h)
    return x, new_state


def init_block_state(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device) -> PyTree:
    if kind == "attn" and cfg.kv_lora_rank:
        return mla_lib.init_mla_cache(cfg, batch, max_len, dtype, device)
    if kind == "attn":
        return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device)
    if kind == "rglru":
        return rec_lib.init_rglru_state(cfg, batch, dtype, device)
    if kind == "mlstm":
        return rec_lib.init_mlstm_state(cfg, batch, device)
    if kind == "slstm":
        return rec_lib.init_slstm_state(cfg, batch, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# stack layout: scanned groups + tail
# ---------------------------------------------------------------------------


def _stack_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...],
                                             Tuple[str, ...]]:
    """Returns (n_groups, period_kinds, tail_kinds)."""
    pattern = cfg.pattern_for_depth()
    period = cfg.block_pattern
    if cfg.first_dense_layers and cfg.scan_layers:
        # a scanned group holds blocks of one kind: leading dense blocks
        # would be MoE there, and the serve engine would tier nothing
        raise ValueError(f"{cfg.name}: leading dense layers need an "
                         f"unscanned stack (scan_layers=False)")
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


def _unbind_tree(tree: PyTree, n: int) -> List[PyTree]:
    """The ``n`` groups of a stacked tree, as views. One ``unbind`` per
    leaf: its backward stacks the groups' gradients once, where indexing
    each group would add a zero-padded full-size gradient per group."""
    if isinstance(tree, dict):
        per_key = {k: _unbind_tree(v, n) for k, v in tree.items()}
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _write_back(views: PyTree, new: PyTree) -> None:
    """Copy a group's new state into its views of the stacked leaves,
    where the block returned new tensors (recurrent state) rather than
    writing the views in place (KV caches)."""
    if isinstance(views, dict):
        for k in views:
            _write_back(views[k], new[k])
    elif new is not views:
        views.copy_(new)


def _init_stack(gen: torch.Generator, cfg: ModelConfig,
                cross: bool) -> PyTree:
    n_groups, period, tail = _stack_layout(cfg)
    out: Dict[str, PyTree] = {}
    if n_groups:
        out["scan"] = _stack_trees([
            {f"p{i}": init_block(gen, cfg, kind, cross)
             for i, kind in enumerate(period)}
            for _ in range(n_groups)])
    for i, kind in enumerate(tail):
        out[f"tail_{i}"] = init_block(gen, cfg, kind, cross,
                                      dense=i < cfg.first_dense_layers)
    return out


def _apply_stack(params: PyTree, x: torch.Tensor, cfg: ModelConfig, *,
                 positions, enc_out=None, causal=True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x, the blocks' summed aux loss as an fp32 scalar)."""
    n_groups, period, tail = _stack_layout(cfg)
    groups = _unbind_tree(params["scan"], n_groups) if n_groups else []
    blocks = [(g[f"p{i}"], kind) for g in groups
              for i, kind in enumerate(period)]
    blocks += [(params[f"tail_{i}"], kind) for i, kind in enumerate(tail)]
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    x = shard_activations(x, cfg)
    for blk, kind in blocks:
        kw = dict(cfg=cfg, kind=kind, positions=positions, enc_out=enc_out,
                  causal=causal)
        if remat:
            x, a = checkpoint(apply_block, blk, x, use_reentrant=False, **kw)
        else:
            x, a = apply_block(blk, x, **kw)
        # constrain outside the checkpoint boundary, as the reference
        x = shard_activations(x, cfg)
        aux_total = aux_total + a
    return x, aux_total


def _init_stack_state(cfg: ModelConfig, batch: int, max_len: int, dtype,
                      device) -> PyTree:
    n_groups, period, tail = _stack_layout(cfg)
    out: Dict[str, PyTree] = {}
    if n_groups:
        out["scan"] = _stack_trees([
            {f"p{i}": init_block_state(cfg, kind, batch, max_len, dtype,
                                       device)
             for i, kind in enumerate(period)}
            for _ in range(n_groups)])
    for i, kind in enumerate(tail):
        out[f"tail_{i}"] = init_block_state(cfg, kind, batch, max_len,
                                            dtype, device)
    return out


def _apply_stack_decode(params: PyTree, x: torch.Tensor, cfg: ModelConfig,
                        state: PyTree, *, pos, enc_out=None
                        ) -> Tuple[torch.Tensor, PyTree]:
    n_groups, period, tail = _stack_layout(cfg)
    new_state: Dict[str, PyTree] = {}
    if n_groups:
        # every group's state is a view of the stacked leaves: KV caches
        # are written in place, recurrent states copied back, so the
        # stacked tree is the new state
        for gi in range(n_groups):
            gparams = _index_tree(params["scan"], gi)
            gstate = _index_tree(state["scan"], gi)
            for i, kind in enumerate(period):
                x, s = apply_block_decode(gparams[f"p{i}"], x, cfg, kind,
                                          gstate[f"p{i}"], pos=pos,
                                          enc_out=enc_out)
                _write_back(gstate[f"p{i}"], s)
        new_state["scan"] = state["scan"]
    for i, kind in enumerate(tail):
        x, new_state[f"tail_{i}"] = apply_block_decode(
            params[f"tail_{i}"], x, cfg, kind, state[f"tail_{i}"], pos=pos,
            enc_out=enc_out)
    return x, new_state


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> PyTree:
    """Random fp32 params on ``gen``'s device, drawn from ``gen``."""
    dev = gen.device
    params: Dict[str, PyTree] = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), in_axis=1),
        "final_ln": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                device=dev),
        "stack": _init_stack(gen, cfg, cross=cfg.is_encdec),
    }
    if cfg.is_encdec:
        params["encoder"] = _init_stack(gen, _enc_cfg(cfg), cross=False)
        params["enc_final_ln"] = torch.zeros((cfg.d_model,),
                                             dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size))
    return params


def _enc_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers,
                               n_experts=0, block_pattern=("attn",))


def params_from_numpy(tree: PyTree, device=DEFAULT_DEVICE) -> PyTree:
    """The JAX package's param tree (nested dicts of numpy arrays, e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) as the port's: the
    same keys, torch tensors on ``device``."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t)).to(dev)
    return conv(tree)


def _embed_inputs(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    """Token embedding (+ optional prepended modality embeddings); the
    positions count the prefix.

    On a mesh, a large token count gathers from a replicated table, cast
    to the compute dtype first (halving the all-gather's bytes); small
    token counts gather straight from the sharded table."""
    table = params["embed"]
    if tokens.numel() > 4096 and cfg.act_dp_axes is not None:
        table = replicate_for_gather(table.to(cfg.dtype), cfg)
    # gather, then cast: the same values as casting the whole table first;
    # a DTensor table through F.embedding, whose sharding rules cover its
    # backward (DTensor's index_put rule fails in torch 2.11)
    x = (F.embedding(tokens, table) if isinstance(table, DTensor)
         else table[tokens]).to(cfg.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def _lm_logits(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    return x @ head


def encode(params, cfg: ModelConfig, enc_frames) -> torch.Tensor:
    """Encoder for enc-dec models; enc_frames: (B, Se, d) frontend stub."""
    ec = _enc_cfg(cfg)
    B, Se, _ = enc_frames.shape
    positions = torch.arange(Se, device=enc_frames.device).expand(B, Se)
    x, _ = _apply_stack(params["encoder"], enc_frames.to(cfg.dtype), ec,
                        positions=positions, causal=False)
    return rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


def _forward_stack(params, cfg: ModelConfig, tokens, prefix_embeds,
                   enc_frames) -> Tuple[torch.Tensor, torch.Tensor]:
    enc_out = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             f"enc_frames")
        enc_out = encode(params, cfg, enc_frames)
    x, positions = _embed_inputs(params, cfg, tokens, prefix_embeds)
    return _apply_stack(params["stack"], x, cfg, positions=positions,
                        enc_out=enc_out, causal=True)


def forward(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
            enc_frames=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward. Returns (logits, aux_loss)."""
    x, aux = _forward_stack(params, cfg, tokens, prefix_embeds, enc_frames)
    return _lm_logits(params, cfg, x), aux


def forward_hidden(params, cfg: ModelConfig, tokens, *, prefix_embeds=None,
                   enc_frames=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like forward() but stops at the final norm (no vocab projection)."""
    x, aux = _forward_stack(params, cfg, tokens, prefix_embeds, enc_frames)
    return rms_norm(x, params["final_ln"], cfg.norm_eps), aux


_CE_CHUNK = 512


def _ce_sum(hx, head, tx, mx) -> torch.Tensor:
    """Masked sum of the next-token negative log-likelihoods of one
    stretch of hidden states."""
    logits = (hx @ head).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, tx.long()[..., None])[..., 0]
    return torch.sum(nll * mx)


def _chunked_ce(h, head, targets, mask, n_chunks: int) -> torch.Tensor:
    """Cross-entropy over sequence chunks: the (B, S, vocab) logits tensor
    is never materialized whole (multi-GiB at 256k vocabs); each chunk's
    logits are recomputed in the backward pass (checkpoint). The chunks'
    sums are added to a carry in order, as the reference's scan does."""
    B, S, d = h.shape
    c = S // n_chunks
    hc = h.reshape(B, n_chunks, c, d).transpose(0, 1)
    tc = targets.reshape(B, n_chunks, c).transpose(0, 1)
    mc = mask.reshape(B, n_chunks, c).transpose(0, 1)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        total = total + checkpoint(_ce_sum, hc[i], head, tc[i], mc[i],
                                   use_reentrant=False)
    return total


def loss_fn(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy (text positions only for vlm prefixes).
    Returns (loss + 0.01 * the MoE load-balance loss, {"loss", "aux",
    "tokens"})."""
    h, aux = forward_hidden(params, cfg, batch["tokens"],
                            prefix_embeds=batch.get("prefix_embeds"),
                            enc_frames=batch.get("enc_frames"))
    P = 0 if batch.get("prefix_embeds") is None else \
        batch["prefix_embeds"].shape[1]
    h = h[:, P:, :]
    head = (params["embed"].T if cfg.tie_embeddings
            else params["lm_head"]).to(cfg.dtype)
    targets = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=h.device)
    S = h.shape[1]
    n_chunks = S // _CE_CHUNK if S % _CE_CHUNK == 0 and S > _CE_CHUNK else 1
    if n_chunks > 1:
        total_nll = _chunked_ce(h, head, targets, mask, n_chunks)
    else:
        total_nll = _ce_sum(h, head, targets, mask)
    loss = total_nll / torch.clamp(torch.sum(mask), min=1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux, "tokens": torch.sum(mask)}


# -- decode -----------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                      enc_out=None, device=DEFAULT_DEVICE) -> PyTree:
    state = {"layers": _init_stack_state(cfg, batch, max_len, cfg.dtype,
                                         resolve_device(device))}
    if cfg.is_encdec:
        state["enc_out"] = enc_out
    return state


def decode_step(params, cfg: ModelConfig, state, tokens, pos
                ) -> Tuple[torch.Tensor, PyTree]:
    """One decode step. tokens: (B,) integer; pos: () integer, or (B,)
    for per-row positions (slot continuous batching).

    Returns (logits (B, vocab), new_state). The KV caches of ``state``
    (and, in a scanned stack, every state leaf) are updated in place and
    shared with ``new_state``.
    """
    x = params["embed"][tokens].to(cfg.dtype)
    return _decode_step_embed(params, cfg, state, x, pos)


# the stack's leaves that a decode step reads only through a cast to the
# compute dtype (``w.to(x.dtype)``) before a product or a bias add, in
# every block kind: attention and cross attention, MLA, the MLPs and the
# held experts with their shared and dense MLPs, the RG-LRU, mLSTM and
# sLSTM. Norm scales, gate biases, the RG-LRU's decay and the MoE router
# are read otherwise (in fp32, or cast after a gather) and are not here
_DECODE_CAST = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_kv_a", "w_kv_b",
    "w_gate", "w_up", "w_down", "w_in_x", "w_in_g", "conv_w", "w_a", "w_x",
    "w_out", "wi", "wf", "wz", "wo_gate"})


def compute_copy(params, cfg: ModelConfig) -> PyTree:
    """The tree :func:`decode_step` reads in place of ``params``, with
    the same results bit for bit: each leaf that the step casts to
    ``cfg.dtype`` before using it cast once here (the stack's
    ``_DECODE_CAST`` leaves, ``lm_head``, and the embedding table when it
    is the head too), so no step casts a weight again. Every other leaf
    is the very tensor of ``params``: the norm scales, the biases read in
    fp32, the router, an untied embedding table (a step gathers its rows,
    then casts them), the encoder (read by :func:`encode` only). A leaf
    already in ``cfg.dtype`` is returned as it is."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict)
                    else v.to(cfg.dtype) if k in _DECODE_CAST else v)
                for k, v in tree.items()}
    out = dict(params)
    out["stack"] = walk(params["stack"])
    if cfg.tie_embeddings:
        out["embed"] = params["embed"].to(cfg.dtype)
    else:
        out["lm_head"] = params["lm_head"].to(cfg.dtype)
    return out


def prefill(params, cfg: ModelConfig, tokens, *, max_len: int,
            prefix_embeds=None, enc_frames=None
            ) -> Tuple[torch.Tensor, PyTree]:
    """Process a prompt and build a decode state by stepping (reference
    implementation used by tests; production serving uses forward() for
    logits and batch-writes the cache)."""
    B, S = tokens.shape
    enc_out = encode(params, cfg, enc_frames) if cfg.is_encdec else None
    state = init_decode_state(cfg, B, max_len, enc_out=enc_out,
                              device=tokens.device)
    logits = None
    x, _ = _embed_inputs(params, cfg, tokens, prefix_embeds)
    for t in range(x.shape[1]):
        logits, state = _decode_step_embed(params, cfg, state, x[:, t], t)
    return logits, state


def _decode_step_embed(params, cfg, state, x_embed, pos):
    x = x_embed[:, None, :]
    # one host-to-device copy of a host position per step, not per layer
    pos = torch.as_tensor(pos, device=x.device).long()
    x, new_layers = _apply_stack_decode(params["stack"], x, cfg,
                                        state["layers"], pos=pos,
                                        enc_out=state.get("enc_out"))
    logits = _lm_logits(params, cfg, x)[:, 0, :]
    new_state = dict(state)
    new_state["layers"] = new_layers
    return logits, new_state
