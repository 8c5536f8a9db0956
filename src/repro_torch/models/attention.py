"""Grouped-query attention with RoPE variants, local windows, KV caches and
encoder-decoder cross attention. Pure functions over explicit param dicts,
in the JAX package's (B, S, H, hd) layout.

The attention product is plain tensor code (no fused attention call), as
the JAX package has no attention kernel, but for one-token decode on the
card: there the hand-written ``decode_attn`` kernel
(``kernels/decode_attn``) takes RoPE, the cache write and the attention
in one launch a layer. Local attention keeps a ring
buffer of ``local_window`` slots in decode; long sequences take the
chunked paths (flash-style online softmax for full and encoder/cross
attention, exact window slicing for local attention).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.kernels.decode_attn import ops as decode_attn_ops
from repro_torch.models.common import (ModelConfig, _rope_freqs,
                                      apply_rope, batch_only, dense_init)

KVCache = Dict[str, torch.Tensor]   # {"k": (B,S,KV,hd), "v": ...}

NEG = -1e30


def init_attention(gen: torch.Generator, cfg: ModelConfig
                   ) -> Dict[str, torch.Tensor]:
    hd, d = cfg.hd, cfg.d_model
    p = {
        "wq": dense_init(gen, (d, cfg.n_heads * hd)),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd)),
        "wo": dense_init(gen, (cfg.n_heads * hd, d)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=torch.float32,
                                  device=gen.device)
    return p


def _qkv(p, x, cfg: ModelConfig):
    """q, k, v in the (B, S, heads, hd) layout, before RoPE. On a mesh
    they are sharded by batch only (``batch_only``): the attention
    products fold batch and heads into one matmul batch dim, which
    DTensor cannot flatten while the head dim is sharded as well (a KV
    cache keeps its own sequence sharding)."""
    B, S, _ = x.shape
    hd = cfg.hd
    q = batch_only(x @ p["wq"].to(x.dtype))
    k = batch_only(x @ p["wk"].to(x.dtype))
    v = batch_only(x @ p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _project_qkv(p, x, cfg: ModelConfig, positions):
    """q, k, v of :func:`_qkv`, q and k rotated."""
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_kind)
    k = apply_rope(k, positions, cfg.rope_kind)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,hd); k,v: (B,Sk,KV,hd); GQA via head grouping. Logits
    and softmax in fp32, the value product in v's dtype."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    q = q.reshape(B, Sq, KV, g, hd)
    logits = torch.einsum("bqkgh,bskh->bkgqs", q.float(), k.float())
    logits = logits / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, H * hd)


def _causal_mask(Sq: int, Sk: int, window: Optional[int] = None,
                 device=None) -> torch.Tensor:
    """(1,1,1,Sq,Sk) boolean mask; window => local (sliding) attention."""
    qpos = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None]


# sequences at or above this length take the O(S)-memory chunked path
CHUNKED_ATTN_THRESHOLD = 1024
Q_CHUNK = 512
K_CHUNK = 512   # == Q_CHUNK so the causal diagonal is a single chunk pair


def _chunked_causal_sdpa(q, k, v, cfg: ModelConfig, q_chunk: int,
                         k_chunk: int, causal: bool = True):
    """Flash-style online-softmax attention, O(S) memory.

    Loops over query chunks and, inside, key chunks with running (max,
    denom, acc) carries in fp32. Handles causal (Sq == Sk) and
    bidirectional attention, and GQA. The JAX package scans every key
    chunk and masks the causal pairs above the diagonal with -1e30; those
    pairs leave the carries unchanged bit for bit (their probabilities
    are exp(-1e30 - m) = 0 and their correction exp(0) = 1), so they are
    skipped here.
    """
    if q_chunk != k_chunk:
        raise ValueError("the causal diagonal needs q_chunk == k_chunk")
    c = q_chunk
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if causal and Sk != Sq:
        raise ValueError("causal chunked attention needs Sq == Sk")
    KV = k.shape[2]
    g = H // KV
    nq, n = Sq // c, Sk // c
    dev = q.device
    qc = q.reshape(B, nq, c, KV, g, hd).permute(1, 0, 3, 4, 2, 5).float()
    kc = k.reshape(B, n, c, KV, hd).permute(1, 0, 3, 2, 4).float()
    vc = v.reshape(B, n, c, KV, hd).permute(1, 0, 3, 2, 4).float()
    scale = 1.0 / math.sqrt(hd)
    # the diagonal pair's additive triangular mask
    ar = torch.arange(c, device=dev)
    tri = torch.where(ar[None, :] <= ar[:, None], 0.0, NEG).float()
    outs = []
    for iq in range(nq):
        qi = qc[iq]                                   # (B,KV,g,c,hd)
        m = torch.full((B, KV, g, c), NEG, dtype=torch.float32, device=dev)
        denom = torch.zeros((B, KV, g, c), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, g, c, hd), dtype=torch.float32,
                          device=dev)
        for jk in range(iq + 1 if causal else n):
            s = torch.einsum("bkgqh,bksh->bkgqs", qi, kc[jk]) * scale
            if causal and jk == iq:
                s = s + tri
            m_new = torch.maximum(m, s.amax(dim=-1))
            p_ = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            denom = denom * corr + p_.sum(dim=-1)
            acc = (acc * corr[..., None]
                   + torch.einsum("bkgqs,bksh->bkgqh", p_, vc[jk]))
            m = m_new
        outs.append(acc / denom.clamp_min(1e-30)[..., None])
    # (nq, B, KV, g, c, hd) -> (B, Sq, H*hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, H * hd)
    return out.to(q.dtype)


def _left_pad_time(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (B, S, ...) after ``n`` zero positions, the values of
    ``F.pad(x, (0, 0, 0, 0, n, 0))``. A ``cat``: on a batch-sharded
    DTensor, torch 2.11's rule for ``pad`` fails (IndexError while
    redistributing), its rule for ``cat`` does not."""
    zeros = x.new_zeros((x.shape[0], n) + tuple(x.shape[2:]))
    return torch.cat([zeros, x], dim=1)


def _local_windowed_sdpa(q, k, v, cfg: ModelConfig, q_chunk: int):
    """Sliding-window attention: per q-chunk, attend to the preceding
    ``window`` keys only - O(S * window) compute, exact."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    g = H // KV
    W = cfg.local_window
    nq = S // q_chunk
    span = W + q_chunk
    dev = q.device
    # left-pad keys so every chunk slices a fixed [span] window
    kp = _left_pad_time(k, W).float()
    vp = _left_pad_time(v, W).float()
    scale = 1.0 / math.sqrt(hd)
    qc = q.reshape(B, nq, q_chunk, KV, g, hd).permute(1, 0, 3, 4, 2, 5)
    # chunk-invariant window mask: the offset k - q = (kk - W) - qq is the
    # same for every chunk; only the left boundary (k_pos >= 0) varies
    qq = torch.arange(q_chunk, device=dev)[:, None]
    kk = torch.arange(span, device=dev)[None, :]
    rel = (kk - W) - qq
    win_mask = torch.where((rel <= 0) & (rel > -W), 0.0, NEG).float()
    outs = []
    for iq in range(nq):
        start = iq * q_chunk
        kj = kp[:, start:start + span].transpose(1, 2)   # (B,KV,span,hd)
        vj = vp[:, start:start + span].transpose(1, 2)
        s = torch.einsum("bkgqh,bksh->bkgqs", qc[iq].float(), kj) * scale
        valid = torch.where(start - W + torch.arange(span, device=dev) >= 0,
                            0.0, NEG).float()
        s = s + win_mask + valid[None, :]
        p_ = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bksh->bkgqh", p_, vj))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H * hd)
    return out.to(q.dtype)


def attention(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Full-sequence (training / prefill) self attention.

    Long sequences use the O(S)-memory chunked path (flash-style online
    softmax for causal-full, exact windowed slicing for local attention).
    """
    q, k, v = _project_qkv(p, x, cfg, positions)
    S = x.shape[1]
    local = cfg.attn_kind == "local"
    window = cfg.local_window if local else None
    if S >= CHUNKED_ATTN_THRESHOLD and S % Q_CHUNK == 0 \
            and S % K_CHUNK == 0 and (not local or cfg.local_window < S):
        if local:
            out = _local_windowed_sdpa(q, k, v, cfg, Q_CHUNK)
        else:
            out = _chunked_causal_sdpa(q, k, v, cfg, Q_CHUNK, K_CHUNK)
    else:
        out = _sdpa(q, k, v, _causal_mask(S, S, window, device=x.device),
                    cfg)
    return out @ p["wo"].to(x.dtype)


def _unmasked_sdpa(q, k, v, cfg: ModelConfig):
    """Bidirectional attention (encoder self attention, cross attention):
    the non-causal chunked path once either sequence is long."""
    Sq, Sk = q.shape[1], k.shape[1]
    if (max(Sq, Sk) >= CHUNKED_ATTN_THRESHOLD and Sq % Q_CHUNK == 0
            and Sk % K_CHUNK == 0):
        return _chunked_causal_sdpa(q, k, v, cfg, Q_CHUNK, K_CHUNK,
                                    causal=False)
    return _sdpa(q, k, v, None, cfg)


def encoder_attention(p, x, cfg: ModelConfig, positions) -> torch.Tensor:
    """Bidirectional self-attention (encoder side)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    return _unmasked_sdpa(q, k, v, cfg) @ p["wo"].to(x.dtype)


def init_cross_attention(gen: torch.Generator, cfg: ModelConfig
                         ) -> Dict[str, torch.Tensor]:
    return init_attention(gen, cfg)


def cross_attention(p, x, enc_out, cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross attention over encoder outputs (no RoPE, no mask)."""
    B, Sq, _ = x.shape
    Sk = enc_out.shape[1]
    hd = cfg.hd
    q = batch_only(x @ p["wq"].to(x.dtype)).reshape(B, Sq, cfg.n_heads, hd)
    k = batch_only(enc_out @ p["wk"].to(x.dtype)).reshape(
        B, Sk, cfg.n_kv_heads, hd)
    v = batch_only(enc_out @ p["wv"].to(x.dtype)).reshape(
        B, Sk, cfg.n_kv_heads, hd)
    return _unmasked_sdpa(q, k, v, cfg) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# decode path (KV cache)
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device=None) -> KVCache:
    if cfg.attn_kind == "local":
        max_len = min(max_len, cfg.local_window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cfg: ModelConfig, cache: KVCache,
                     pos) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B,1,d); pos: () or (B,) integer absolute
    position(s) - a vector gives every batch row its own position (slot
    continuous batching, where requests start at different times).

    Local attention uses a ring buffer of size ``local_window``; full
    attention appends at ``pos``. Both write slot ``pos % C``. The cache
    is written IN PLACE where the JAX package selects a new cache with
    ``where``: the values are the same, and the returned cache holds the
    same tensors as ``cache``.

    Between the q/k/v products and ``wo``, a plain CUDA bf16 cache of a
    head width the ``decode_attn`` kernel is built for takes the kernel
    (RoPE, the cache write, scores, softmax and the value product in one
    launch, with the RoPE frequencies of :func:`rope_table`); every other
    cache (the CPU, DTensor, not bf16, other widths) takes
    :func:`decode_attn_plain` (``decode_attn_ops.plain_reason`` says
    why). Traced, each call counts ``decode_attn.fused`` or
    ``decode_attn.plain`` (labelled with the reason).
    """
    pos = torch.as_tensor(pos, device=x.device).long()
    q, k, v = _qkv(p, x, cfg)
    reason = decode_attn_ops.plain_reason(q, cache["k"], cache["v"])
    if obs.enabled():
        if reason is None:
            obs.counter("decode_attn.fused")
        else:
            obs.counter("decode_attn.plain", reason=reason)
    if reason is None:
        out = decode_attn_ops.decode_attn(
            q, k, v, cache["k"], cache["v"], pos,
            rope_table(cfg.rope_kind, cfg.hd, q.device))
    else:
        out = decode_attn_plain(q, k, v, cfg, cache, pos)
    out = out @ p["wo"].to(x.dtype)
    return out, {"k": cache["k"], "v": cache["v"]}


@functools.lru_cache(maxsize=None)
def rope_table(kind: str, hd: int, device: torch.device
               ) -> Optional[torch.Tensor]:
    """The fp32 frequencies :func:`apply_rope` of ``kind`` builds on
    every call for heads of width ``hd`` (the same expressions, the same
    bits), made once on ``device`` and kept for the ``decode_attn``
    kernel; None for ``"none"``."""
    if kind == "none":
        return None
    return _rope_freqs(hd if kind == "full" else hd // 2, device=device)


def decode_attn_plain(q, k, v, cfg: ModelConfig, cache: KVCache,
                      pos: torch.Tensor) -> torch.Tensor:
    """The plain version of the ``decode_attn`` kernel: RoPE of q (B,1,H,hd)
    and k (B,1,KV,hd), k and v written to slot ``pos % C`` of the cache
    (``index_copy_`` / ``index_put_``; a DTensor cache by a ``where``
    select copied over it), then :func:`_sdpa` over the valid slots.
    pos: () or (B,) int64 on the cache's device. Returns (B, 1, H hd)."""
    B = q.shape[0]
    per_row = pos.ndim == 1
    positions = pos[:, None] if per_row else pos.expand(B, 1)
    q = apply_rope(q, positions, cfg.rope_kind)
    k = apply_rope(k, positions, cfg.rope_kind)
    C = cache["k"].shape[1]
    slot = pos % C
    idx = torch.arange(C, device=q.device)
    if isinstance(cache["k"], DTensor):
        # a sharded cache: no sharding rule writes a slot of a sharded
        # dim in place, so select the new cache (as the JAX package does)
        # and copy it over the old one, shard by shard
        hit = (idx[None, :] == slot[:, None] if per_row
               else (idx == slot)[None, :])[:, :, None, None]
        for name, new in (("k", k), ("v", v)):
            cache[name].copy_(torch.where(
                hit, new.to(cache[name].dtype), cache[name]))
    elif per_row:
        rows = torch.arange(B, device=q.device)
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    else:
        cache["k"].index_copy_(1, slot.view(1), k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot.view(1), v.to(cache["v"].dtype))
    # valid = entries written so far and (for local) within the window;
    # a full ring buffer is all valid
    if cfg.attn_kind == "local":
        if per_row:
            valid = (idx[None, :] <= slot[:, None]) | (pos[:, None] >= C)
        else:
            valid = (idx <= slot) | (pos >= C)
    else:
        valid = idx[None, :] <= pos[:, None] if per_row else idx <= pos
    mask = (valid[:, None, None, None, :] if per_row
            else valid[None, None, None, None, :])
    return _sdpa(q, cache["k"], cache["v"], mask, cfg)


def cross_attention_decode(p, x, enc_out, cfg: ModelConfig) -> torch.Tensor:
    return cross_attention(p, x, enc_out, cfg)
