"""Mixture-of-Experts layer with block-parallel scatter dispatch.

Dispatch is index-based (per-block slot positions + a batched scatter
into per-expert slots), not a one-hot einsum, as in the JAX package:
tokens are grouped into ``moe_dispatch_blocks`` blocks, each (token,
choice) gets the running index of its expert within its block, and
over-capacity tokens are dropped (GShard-style) with the residual stream
keeping them alive. The grouped expert products are plain batched
matmuls (E x C x d x f), as the JAX package leaves them to XLA.

The JAX package's sharding hints (``_wsc``) have no counterpart on one
card.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init
from repro_torch.models.mlp import init_mlp, mlp


def init_moe(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(gen, (d, E)),
        "w_gate": dense_init(gen, (E, d, f), in_axis=1),
        "w_up": dense_init(gen, (E, d, f), in_axis=1),
        "w_down": dense_init(gen, (E, f, d), in_axis=1),
    }
    if cfg.moe_dense_ff:
        p["dense_mlp"] = init_mlp(gen, d, cfg.moe_dense_ff, cfg.mlp_act)
    return p


def _block_capacity(t_block: int, cfg: ModelConfig) -> int:
    c = math.ceil(t_block * cfg.experts_per_token / cfg.n_experts
                  * cfg.moe_capacity_factor)
    return max(4, min(t_block, c))


def _slot_positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """(nb, n) expert ids -> each entry's running index within its
    expert, per block: an exclusive prefix sum of the expert counts and a
    stable argsort, as the reference's ``positions_one``."""
    nb, n = flat_e.shape
    counts = torch.zeros((nb, E), dtype=torch.long, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, dim=1) - counts
    order = torch.argsort(flat_e, dim=1, stable=True)
    pos_sorted = (torch.arange(n, device=flat_e.device)[None, :]
                  - torch.gather(start, 1, torch.gather(flat_e, 1, order)))
    return torch.zeros_like(flat_e).scatter_(1, order, pos_sorted)


def moe(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    nb = cfg.moe_dispatch_blocks
    if T % nb != 0:
        nb = 1
    tb = T // nb                      # tokens per dispatch block
    C = _block_capacity(tb, cfg)
    dt = x.dtype
    dev = x.device
    xb = x.reshape(nb, tb, d)

    logits = (xb @ p["router"].to(dt)).float()               # (nb,tb,E)
    # descending, as lax.top_k; seeded fp32 logits make exact ties, which
    # the two may break differently, improbable
    weights, experts = torch.topk(logits, k, dim=-1)         # (nb,tb,k)
    weights = torch.softmax(weights, dim=-1)

    flat_e = experts.reshape(nb, tb * k)
    pos = _slot_positions(flat_e, E)
    keep = pos < C
    safe_e = torch.where(keep, flat_e, 0)
    safe_p = torch.where(keep, pos, C - 1)

    src = (torch.repeat_interleave(xb, k, dim=1)
           * keep[..., None].to(dt))
    # scatter into (nb, E, C, d) slots; dropped entries add a zero update
    # at slot C-1 of expert 0, as in the reference
    blk = torch.arange(nb, device=dev)[:, None].expand(nb, tb * k)
    slots = torch.zeros((nb, E, C, d), dtype=dt, device=dev)
    slots.index_put_((blk, safe_e, safe_p), src, accumulate=True)

    # grouped expert GEMMs (the real FLOPs)
    g = torch.einsum("becd,edf->becf", slots, p["w_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", slots, p["w_up"].to(dt))
    h = F.silu(g) * u
    out_slots = torch.einsum("becf,efd->becd", h, p["w_down"].to(dt))

    # gather back + router-weighted combine
    gathered = out_slots[blk, safe_e, safe_p]                # (nb,tbk,d)
    gathered = gathered * keep[..., None].to(dt)
    gathered = gathered * weights.reshape(nb, tb * k)[..., None].to(dt)
    y = gathered.reshape(nb, tb, k, d).sum(dim=2)

    if "dense_mlp" in p:
        y = y + mlp(p["dense_mlp"], xb, cfg.mlp_act)
    return y.reshape(B, S, d)


def aux_load_balance_loss(p, x: torch.Tensor, cfg: ModelConfig
                          ) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (mean over tokens)."""
    T = x.shape[0] * x.shape[1]
    logits = (x.reshape(T, -1) @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top1 = torch.argmax(logits, dim=-1)
    frac_tokens = F.one_hot(top1, cfg.n_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)
