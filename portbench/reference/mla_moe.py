"""DeepSeek-V2's layer (MLA with YaRN RoPE, DeepSeekMoE with shared
experts) on one card's share of the routed experts: the logits of every
position of whole token sequences, and the placement model spec of such
a model.

Plain float32 PyTorch after the published description (arXiv:2405.04434
and the model's ``modeling_deepseek.py``), written apart from the
program. ``c`` is the configuration file (``portbench/configs``): its
published keys, ``n_experts`` the experts held here and
``deployment.held_first`` the first of them.

- Attention sees the last ``window`` positions, the current one
  included, as the serve engines' ring of ``window`` latent slots does.
  Keys and values are expanded from the latent (the program attends in
  the latent when it decodes: the same products in another order).
- MoE layers: the router's product and softmax over all
  ``n_routed_experts`` in float32, greedy top-k of those weights, not
  renormalised, times ``routed_scaling_factor``; each held expert's
  SwiGLU output weighted by its gate and summed in float32; the experts
  held elsewhere add nothing; the shared experts, one SwiGLU of
  ``n_shared_experts`` x ``moe_intermediate_size``, are added whole.

Departures from DeepSeek's code: RoPE rotates interleaved pairs
(x[2j], x[2j+1]), as the program does, where DeepSeek's code permutes
the roped dimensions and rotates halves (every score is the same); the
router runs in float32 in the control too (DeepSeek computes it in
float32 whatever the model's dtype). Norm scales are stored as
``1 + scale`` (``common.rms_norm``), as the program stores them.
"""
from __future__ import annotations

import contextlib
import math

import torch

from portbench.reference import placement
from portbench.reference.common import Matmul, rms_norm


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(dim: int, theta: float, rs: dict, device=None
               ) -> torch.Tensor:
    """YaRN's (dim/2,) frequencies: theta^(-2j/dim) where pair j turns
    more than ``beta_fast`` times over ``original_max_position_embeddings``,
    that over ``factor`` where it turns fewer than ``beta_slow`` times, a
    linear ramp over the pairs between."""
    L0, f = rs["original_max_position_embeddings"], rs["factor"]

    def pair(turns: float) -> float:
        # the pair index at which the wavelength fits ``turns`` times
        return (dim * math.log(L0 / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    lo = max(math.floor(pair(rs["beta_fast"])), 0)
    hi = min(math.ceil(pair(rs["beta_slow"])), dim - 1)
    if lo == hi:
        hi += 0.001
    base = theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device) / dim)
    j = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ramp = ((j - lo) / (hi - lo)).clamp(0, 1)
    return (1.0 / (f * base)) * ramp + (1.0 / base) * (1 - ramp)


def rope(x: torch.Tensor, pos: torch.Tensor, freqs: torch.Tensor
         ) -> torch.Tensor:
    """Interleaved-pair rotation of x (B, L, heads, dim) at ``pos`` (L,)."""
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def softmax_scale(c: dict) -> float:
    s = 1.0 / math.sqrt(c["qk_nope_head_dim"] + c["qk_rope_head_dim"])
    rs = c.get("rope_scaling")
    if rs:
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        s = s * m * m
    return s


def held(c: dict):
    """(first, count) of the routed experts held here."""
    return c["deployment"]["held_first"], c["n_experts"]


def mla(p: dict, h: torch.Tensor, c: dict, pos: torch.Tensor,
        mask: torch.Tensor, mm: Matmul) -> torch.Tensor:
    B, L, _ = h.shape
    H = c["num_attention_heads"]
    r, dn, dr = c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    rs = c.get("rope_scaling")
    freqs = (yarn_freqs(dr, c["rope_theta"], rs, h.device) if rs else
             1.0 / c["rope_theta"] ** (torch.arange(
                 0, dr, 2, dtype=torch.float32, device=h.device) / dr))
    attn_factor = (yarn_mscale(rs["factor"], rs["mscale"])
                   / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
                   if rs else 1.0)
    q = mm(h, p["wq"]).view(B, L, H, dn + dr)
    q_nope, q_pe = q[..., :dn], rope(q[..., dn:], pos, freqs) * attn_factor
    kv_a = mm(h, p["w_kv_a"])
    lat = rms_norm(kv_a[..., :r], p["kv_norm"], c["rms_norm_eps"])
    k_pe = rope(kv_a[..., None, r:], pos, freqs) * attn_factor  # (B,L,1,dr)
    kv = mm(lat, p["w_kv_b"]).view(B, L, H, -1)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_pe.expand(B, L, H, dr)], dim=-1)
    qq = torch.cat([q_nope, q_pe], dim=-1)
    s = mm(qq.transpose(1, 2), k.permute(0, 2, 3, 1)) * softmax_scale(c)
    s = torch.where(mask, s, -torch.inf)
    o = mm(torch.softmax(s, dim=-1), v.transpose(1, 2))
    return mm(o.transpose(1, 2).reshape(B, L, -1), p["wo"])


def swiglu(p: dict, h: torch.Tensor, mm: Matmul) -> torch.Tensor:
    g = torch.nn.functional.silu(mm(h, p["w_gate"])) * mm(h, p["w_up"])
    return mm(g, p["w_down"])


def route(router: torch.Tensor, h: torch.Tensor, c: dict):
    """Gate weights and expert ids (T, k): softmax over every routed
    expert in float32, greedy top-k, not renormalised (unless the
    configuration says ``norm_topk_prob``)."""
    probs = torch.softmax(h.float() @ router.float(), dim=-1)
    w, e = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    if c["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    return w * c["routed_scaling_factor"], e


def moe(p: dict, h: torch.Tensor, c: dict, mm: Matmul) -> torch.Tensor:
    """The held experts' part of the routed result plus the shared
    experts, h (B, L, d)."""
    B, L, d = h.shape
    x = h.reshape(B * L, d)
    first, n = held(c)
    w, e = route(p["router"], x, c)
    gates = torch.zeros((x.shape[0], n), dtype=torch.float32,
                        device=x.device)
    for j in range(e.shape[1]):
        local = e[:, j] - first
        hit = (local >= 0) & (local < n)
        gates[hit, local[hit]] += w[hit, j]
    y = torch.zeros_like(x)
    for i in range(n):
        rows = gates[:, i] != 0
        if rows.any():
            ex = {k: p[k][i] for k in ("w_gate", "w_up", "w_down")}
            y[rows] += gates[rows, i, None] * swiglu(ex, x[rows], mm)
    y = y + swiglu(p["shared"], x, mm)
    return y.reshape(B, L, d)


def logits(params: dict, c: dict, tokens: torch.Tensor, window: int,
           mm: Matmul = Matmul()) -> torch.Tensor:
    """(B, L, vocab) float32 logits of ``tokens`` (B, L)."""
    B, L = tokens.shape
    eps = c["rms_norm_eps"]
    pos = torch.arange(L, device=tokens.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    x = mm.act(params["embed"][tokens].float())
    for i in range(c["num_hidden_layers"]):
        p = params["stack"][f"tail_{i}"]
        x = mm.act(x + mla(p["mix"], rms_norm(x, p["ln1"], eps), c, pos,
                           mask, mm))
        h = rms_norm(x, p["ln2"], eps)
        f = p["ffn"]
        x = mm.act(x + (moe(f, h, c, mm) if "router" in f
                        else swiglu(f, h, mm)))
    x = rms_norm(x, params["final_ln"], eps)
    return mm(x, params["lm_head"])


# -- the placement's model ----------------------------------------------------

def model_spec(c: dict, tokens_per_task: int):
    """(resident weights, MACs of a task) the placement divides: four
    d x d attention matrices a layer, the leading dense layers' SwiGLU,
    and per MoE layer every held expert and the shared experts resident,
    of the held experts only the routed share (experts per token x held
    / routed experts) in a task's MACs."""
    d, L = c["hidden_size"], c["num_hidden_layers"]
    n_dense = c["first_k_dense_replace"]
    n_moe = L - n_dense
    expert = 3 * d * c["moe_intermediate_size"]
    shared = c["n_shared_experts"] * expert
    n = held(c)[1]
    always = L * 4 * d * d + n_dense * 3 * d * c["intermediate_size"] \
        + n_moe * shared
    routed = n_moe * c["num_experts_per_tok"] * n * expert \
        // c["n_routed_experts"]
    return always + n_moe * n * expert, (always + routed) * tokens_per_task


class Model:
    """``placement.Model`` of an MoE configuration: its weights and a
    task's MACs are two numbers."""

    def __init__(self, c: dict, tokens_per_task: int):
        self.n_params, n_macs = model_spec(c, tokens_per_task)
        self.ops_per_weight = int(round(n_macs * 1.0)) / self.n_params


@contextlib.contextmanager
def placement_model():
    """The placement reference (``reference/placement.py``) with its
    model spec taken from :class:`Model`: its arithmetic is the same for
    any model once the two counts are known."""
    dense = placement.Model
    placement.Model = Model
    try:
        yield
    finally:
        placement.Model = dense
