"""Multi-head latent attention (MLA, DeepSeek-V2, arXiv:2405.04434), with
YaRN RoPE and a decode cache of the latent.

Each head's query is ``qk_nope_dim`` numbers without position and
``qk_rope_dim`` roped ones (no query LoRA). Keys and values come from one
``kv_lora_rank`` latent per position, RMS-normalised, through ``w_kv_b``;
one roped key of ``qk_rope_dim`` numbers per position is shared by every
head. Scores are scaled by 1/sqrt(qk_nope_dim + qk_rope_dim) times
YaRN's mscale(factor, mscale_all_dim)^2.

The decode cache holds, per position, the normalised latent (``"c"``)
and the roped shared key (``"kr"``): kv_lora_rank + qk_rope_dim numbers
where GQA holds keys and values of every KV head. Decode writes slot
``pos % C`` of a ring of C slots, as ``attention_decode`` does, and
attends in the latent: each head's query is taken through its part of
``w_kv_b`` onto the latent, and its output back out of it (the absorbed
form, the same products in another order as the full-sequence path).

RoPE rotates interleaved pairs (x[2j], x[2j+1]), as every attention of
this package; DeepSeek's code rotates halves after a fixed permutation
of the same dimensions, which leaves every score unchanged.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                      rms_norm, rope_freqs, yarn_mscale)

NEG = -1e30

MLACache = Dict[str, torch.Tensor]   # {"c": (B,C,rank), "kr": (B,C,rope)}


def init_mla(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    d, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    return {
        "wq": dense_init(gen, (d, H * (dn + dr))),
        "w_kv_a": dense_init(gen, (d, r + dr)),
        "kv_norm": torch.zeros((r,), dtype=torch.float32, device=gen.device),
        "w_kv_b": dense_init(gen, (r, H * (dn + dv))),
        "wo": dense_init(gen, (H * dv, d)),
    }


def softmax_scale(cfg: ModelConfig) -> float:
    s = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if cfg.yarn_factor:
        m = yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        s = s * m * m
    return s


@functools.lru_cache(maxsize=64)
def _freqs(dim: int, cfg: ModelConfig, device: torch.device) -> torch.Tensor:
    """The rotary frequencies, made once per config and device (a decode
    step would otherwise launch their arithmetic in every layer)."""
    return rope_freqs(dim, cfg, device=device)


def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """x (B, S, heads, qk_rope_dim) roped at ``positions`` (B, S), times
    YaRN's cos/sin factor mscale(f, mscale) / mscale(f, mscale_all_dim)
    where it is not 1."""
    y = apply_rope(x, positions, freqs=_freqs(x.shape[-1], cfg, x.device))
    if cfg.yarn_factor:
        m = (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
             / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))
        if m != 1.0:
            y = y * m
    return y


def _project(p, x: torch.Tensor, cfg: ModelConfig, positions
             ) -> Tuple[torch.Tensor, ...]:
    """q_nope (B,S,H,dn), roped q_pe (B,S,H,dr), the normalised latent c
    (B,S,rank) and the roped shared key kr (B,S,dr)."""
    B, S, _ = x.shape
    H, r, dn = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim
    q = (x @ p["wq"].to(x.dtype)).view(B, S, H, -1)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv = x @ p["w_kv_a"].to(x.dtype)
    c = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    q_pe = _rope(q_pe, positions, cfg)
    kr = _rope(kv[..., None, r:], positions, cfg)[:, :, 0]
    return q_nope, q_pe, c, kr


def mla_attention(p, x: torch.Tensor, cfg: ModelConfig, positions
                  ) -> torch.Tensor:
    """Full-sequence causal MLA (training / prefill): keys and values
    expanded from the latent. Logits and softmax in fp32, the value
    product in the compute dtype."""
    B, S, _ = x.shape
    H, dn = cfg.n_heads, cfg.qk_nope_dim
    q_nope, q_pe, c, kr = _project(p, x, cfg, positions)
    kv = (c @ p["w_kv_b"].to(x.dtype)).view(B, S, H, -1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    logits = (torch.einsum("bqhn,bshn->bhqs", q_nope.float(), k_nope.float())
              + torch.einsum("bqhr,bsr->bhqs", q_pe.float(), kr.float()))
    logits = logits * softmax_scale(cfg)
    qpos = torch.arange(S, device=x.device)
    mask = qpos[None, :] <= qpos[:, None]
    logits = torch.where(mask, logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqs,bshv->bqhv", probs, v).reshape(B, S, -1)
    return out @ p["wo"].to(x.dtype)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device=None) -> MLACache:
    return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                             dtype=dtype, device=device),
            "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                              dtype=dtype, device=device)}


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: MLACache,
               pos) -> Tuple[torch.Tensor, MLACache]:
    """One-token decode. x: (B,1,d); pos: () or (B,) absolute positions.
    Writes the latent and the roped key of ``pos`` to slot ``pos % C``
    of the cache IN PLACE, then attends over the written slots (a full
    ring: all of them) in the latent."""
    B = x.shape[0]
    H, r, dn = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim
    pos = torch.as_tensor(pos, device=x.device).long()
    per_row = pos.ndim == 1
    positions = pos[:, None] if per_row else pos.expand(B, 1)
    q_nope, q_pe, c, kr = _project(p, x, cfg, positions)
    C = cache["c"].shape[1]
    slot = pos % C
    if per_row:
        rows = torch.arange(B, device=x.device)
        cache["c"][rows, slot] = c[:, 0].to(cache["c"].dtype)
        cache["kr"][rows, slot] = kr[:, 0].to(cache["kr"].dtype)
    else:
        cache["c"].index_copy_(1, slot.view(1), c.to(cache["c"].dtype))
        cache["kr"].index_copy_(1, slot.view(1), kr.to(cache["kr"].dtype))
    idx = torch.arange(C, device=x.device)
    valid = idx[None, :] <= pos[:, None] if per_row else (idx <= pos)[None]
    w = p["w_kv_b"].to(x.dtype).view(r, H, -1)
    w_uk, w_uv = w[..., :dn], w[..., dn:]
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    logits = (torch.einsum("bhr,bsr->bhs", q_lat.float(),
                           cache["c"].float())
              + torch.einsum("bhe,bse->bhs", q_pe[:, 0].float(),
                             cache["kr"].float()))
    logits = logits * softmax_scale(cfg)
    logits = torch.where(valid[:, None, :], logits, NEG)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhs,bsr->bhr", probs, cache["c"].to(x.dtype))
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv).reshape(B, 1, -1)
    return out @ p["wo"].to(x.dtype), cache
