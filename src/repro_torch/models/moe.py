"""Mixture-of-Experts layer with block-parallel scatter dispatch.

Dispatch is index-based (per-block slot positions + a batched scatter
into per-expert slots), not a one-hot einsum, as in the JAX package:
tokens are grouped into ``moe_dispatch_blocks`` blocks, each (token,
choice) gets the running index of its expert within its block, and
over-capacity tokens are dropped (GShard-style) with the residual stream
keeping them alive. The grouped expert products are plain batched
matmuls (E x C x d x f), as the JAX package leaves them to XLA.

A DeepSeekMoE layer (``moe_router="softmax_topk"``, with shared
experts and a share of the experts held here where set) takes
:func:`moe_held` instead: every held expert on every token, each token's
part weighted by its gate, 0 off its top-k, so no token is dropped.

On a mesh (DTensor activations) the dispatch and the gather back run
on each rank's own blocks (``_blockwise``), and with
moe_dispatch_blocks > 1 the slot buffers are laid out block dim over
"data" and expert dim over "model" (expert parallelism) around the
expert products, by ``_wsc``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import obs
from repro_torch.models.common import ModelConfig, batch_only, dense_init
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.parallel.sharding import to_placements


def _wsc(x: torch.Tensor, *spec) -> torch.Tensor:
    """Sharding hint: a DTensor moved to ``spec``'s layout; a plain
    tensor (one card) is returned as is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def _blockwise(fn, *xs):
    """``fn`` over tensors whose dim 0 is the dispatch block: the JAX
    package's ``vmap`` over blocks. On DTensors (no sharding rule covers
    the scatter, sort and index ops of the dispatch) every input is laid
    out with the block dim as the first input shards it and all else
    whole, and ``fn`` runs on each rank's own blocks."""
    if not isinstance(xs[0], DTensor):
        return fn(*xs)
    mesh = xs[0].device_mesh
    pl = batch_only(xs[0]).placements
    local = [x.redistribute(mesh, pl).to_local() for x in xs]
    out = fn(*local)

    def wrap(t):
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def init_moe(gen: torch.Generator, cfg: ModelConfig
             ) -> Dict[str, torch.Tensor]:
    """The router over all ``n_experts``, the held experts' stacked
    weights, and the shared experts and residual dense MLP where set."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
    n = cfg.held_experts[1]
    p = {
        "router": dense_init(gen, (d, E)),
        "w_gate": dense_init(gen, (n, d, f), in_axis=1),
        "w_up": dense_init(gen, (n, d, f), in_axis=1),
        "w_down": dense_init(gen, (n, f, d), in_axis=1),
    }
    if cfg.moe_dense_ff:
        p["dense_mlp"] = init_mlp(gen, d, cfg.moe_dense_ff, cfg.mlp_act)
    if cfg.moe_shared_ff:
        p["shared"] = init_mlp(gen, d, cfg.moe_shared_ff, cfg.mlp_act)
    return p


def route(router: torch.Tensor, x: torch.Tensor, cfg: ModelConfig):
    """Gate weights and expert ids (T, k) of tokens x (T, d): the
    router's product and softmax over all experts in fp32, then greedy
    top-k of those weights, not renormalised (DeepSeek's ``MoEGate``)."""
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    return torch.topk(probs, cfg.experts_per_token, dim=-1)


def moe_held(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """DeepSeekMoE, x: (B, S, d) -> (B, S, d): the held experts' part of
    the routed result plus the shared experts. Every held expert runs on
    every token; a token's output is its gate-weighted sum (in fp32) of
    the held experts among its top-k, so no token is dropped and the
    experts held elsewhere add nothing here.

    Traced, the token-choices that reach each held expert are added up
    on the device (``moe.expert_tokens``; no host sync)."""
    B, S, d = x.shape
    dt = x.dtype
    x2 = x.reshape(B * S, d)
    first, n = cfg.held_experts
    weights, experts = route(p["router"], x2, cfg)
    local = experts - first
    held = (local >= 0) & (local < n)
    slot = local.clamp(0, n - 1)
    gates = torch.zeros((x2.shape[0], n), dtype=torch.float32,
                        device=x.device)
    gates.scatter_add_(1, slot, torch.where(held, weights, 0.0))
    if obs.enabled():
        obs.count_on_device("moe.expert_tokens", torch.zeros(
            n, dtype=torch.long, device=x.device).scatter_add_(
                0, slot.reshape(-1), held.reshape(-1).long()))
    xe = x2.expand(n, *x2.shape)
    h = (F.silu(torch.bmm(xe, p["w_gate"].to(dt)))
         * torch.bmm(xe, p["w_up"].to(dt)))
    o = torch.bmm(h, p["w_down"].to(dt))                       # (n, T, d)
    y = (o.float() * gates.T[..., None]).sum(dim=0).to(dt)
    if "shared" in p:
        y = y + mlp(p["shared"], x2, cfg.mlp_act)
    if "dense_mlp" in p:
        y = y + mlp(p["dense_mlp"], x2, cfg.mlp_act)
    return y.reshape(B, S, d)


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
    if cfg.moe_router == "softmax_topk":
        return moe_held(p, x, cfg)
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

    def dispatch(xb, flat_e):
        n = xb.shape[0]
        pos = _slot_positions(flat_e, E)
        keep = pos < C
        safe_e = torch.where(keep, flat_e, 0)
        safe_p = torch.where(keep, pos, C - 1)
        src = (torch.repeat_interleave(xb, k, dim=1)
               * keep[..., None].to(dt))
        # scatter into (nb, E, C, d) slots; dropped entries add a zero
        # update at slot C-1 of expert 0, as in the reference
        blk = torch.arange(n, device=dev)[:, None].expand(n, tb * k)
        slots = torch.zeros((n, E, C, d), dtype=dt, device=dev)
        slots.index_put_((blk, safe_e, safe_p), src, accumulate=True)
        return keep, safe_e, safe_p, slots

    keep, safe_e, safe_p, slots = _blockwise(dispatch, xb, flat_e)

    # grouped expert GEMMs (the real FLOPs); expert dim -> "model" axis
    if nb > 1:
        slots = _wsc(slots, "data", "model", None, None)
    g = torch.einsum("becd,edf->becf", slots, p["w_gate"].to(dt))
    u = torch.einsum("becd,edf->becf", slots, p["w_up"].to(dt))
    h = F.silu(g) * u
    out_slots = torch.einsum("becf,efd->becd", h, p["w_down"].to(dt))
    if nb > 1:
        out_slots = _wsc(out_slots, "data", "model", None, None)

    # gather back + router-weighted combine
    def gather(o, e, pos):
        blk = torch.arange(o.shape[0], device=dev)[:, None].expand(e.shape)
        return o[blk, e, pos]

    gathered = _blockwise(gather, out_slots, safe_e, safe_p)  # (nb,tbk,d)
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
