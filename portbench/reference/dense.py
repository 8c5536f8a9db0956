"""A dense decoder LM (InternLM2's layer: GQA with RoPE, SwiGLU FFN, RMS
norms), the logits of every position of whole token sequences.

Attention sees the last ``window`` positions, the current one included:
the serve engines keep ``window`` positions of keys and values and write
position ``p`` to slot ``p % window``, so past that many tokens each
step attends over a ring of the latest ones, at their absolute RoPE
positions.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.common import Matmul, rms_norm, rope


def logits(params: dict, c: dict, tokens: torch.Tensor, window: int,
           mm: Matmul = Matmul()) -> torch.Tensor:
    """(B, L, vocab) float32 logits of ``tokens`` (B, L)."""
    B, L = tokens.shape
    H, KV, hd = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    eps = c["norm_eps"]
    pos = torch.arange(L, device=tokens.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = (kp <= qp) & (kp > qp - window)
    x = mm.act(params["embed"][tokens].float())
    for i in range(c["n_layers"]):
        p = params["stack"][f"tail_{i}"]
        h = rms_norm(x, p["ln1"], eps)
        a = p["mix"]
        q = rope(mm(h, a["wq"]).view(B, L, H, hd), pos, c["rope_theta"])
        k = rope(mm(h, a["wk"]).view(B, L, KV, hd), pos, c["rope_theta"])
        v = mm(h, a["wv"]).view(B, L, KV, hd)
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
        s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
        s = torch.where(mask, s, -torch.inf)
        o = mm(torch.softmax(s, dim=-1), v.transpose(1, 2))
        x = mm.act(x + mm(o.transpose(1, 2).reshape(B, L, H * hd), a["wo"]))
        h = rms_norm(x, p["ln2"], eps)
        f = p["ffn"]
        g = torch.nn.functional.silu(mm(h, f["w_gate"])) * mm(h, f["w_up"])
        x = mm.act(x + mm(g, f["w_down"]))
    x = rms_norm(x, params["final_ln"], eps)
    return mm(x, params["lm_head"])
