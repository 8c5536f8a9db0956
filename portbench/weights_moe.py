"""Parameter layout and seeded weights of an MLA + DeepSeekMoE
configuration (``portbench/configs/deepseek_v2_lite.json``), made by the
benchmark as ``portbench.weights`` makes a dense one: the port's tree
(an unscanned stack of ``tail_{i}`` blocks), every normally drawn leaf
out of one ``torch.randn`` call on a generator on the device, scaled by
``1/sqrt(fan_in)``, norms 0. Only the experts held here are drawn, in
their stacked ``(n_experts, d_in, d_out)`` leaves."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.weights import Leaf, _mat, _norm


def _stack(path, n: int, d_in: int, d_out: int) -> Leaf:
    return (path, (n, d_in, d_out), "normal", float(d_in))


def _swiglu(p, d: int, f: int) -> List[Leaf]:
    return [_mat(p + ("w_gate",), d, f), _mat(p + ("w_up",), d, f),
            _mat(p + ("w_down",), f, d)]


def _block(p, c: dict, moe: bool) -> List[Leaf]:
    d, H = c["hidden_size"], c["num_attention_heads"]
    r, dn, dr, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"],
                     c["qk_rope_head_dim"], c["v_head_dim"])
    a, m = p + ("mix",), p + ("ffn",)
    out = [_norm(p + ("ln1",), d),
           _mat(a + ("wq",), d, H * (dn + dr)),
           _mat(a + ("w_kv_a",), d, r + dr),
           _norm(a + ("kv_norm",), r),
           _mat(a + ("w_kv_b",), r, H * (dn + dv)),
           _mat(a + ("wo",), H * dv, d),
           _norm(p + ("ln2",), d)]
    if not moe:
        return out + _swiglu(m, d, c["intermediate_size"])
    n, f = c["n_experts"], c["moe_intermediate_size"]
    return out + [_mat(m + ("router",), d, c["n_routed_experts"]),
                  _stack(m + ("w_gate",), n, d, f),
                  _stack(m + ("w_up",), n, d, f),
                  _stack(m + ("w_down",), n, f, d)] + \
        _swiglu(m + ("shared",), d, c["n_shared_experts"] * f)


def layout(c: dict) -> List[Leaf]:
    if c["arch"] != "mla_moe" or c["scan_layers"]:
        raise ValueError("a layout written for unscanned MLA + MoE stacks")
    d, V = c["hidden_size"], c["vocab_size"]
    out = [(("embed",), (V, d), "normal", float(d)),
           _norm(("final_ln",), d)]
    for i in range(c["num_hidden_layers"]):
        out += _block(("stack", f"tail_{i}"), c,
                      moe=i >= c["first_k_dense_replace"])
    out.append(_mat(("lm_head",), d, V))
    return out


def n_params(c: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout(c))


def expert_params(c: dict) -> int:
    """One routed expert's weights (its SwiGLU's three matrices)."""
    return 3 * c["hidden_size"] * c["moe_intermediate_size"]


def row_params(c: dict) -> int:
    """The weights every token's step multiplies by: all but the
    embedding table (a gather) and the held routed experts."""
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return (n_params(c) - c["vocab_size"] * c["hidden_size"]
            - n_moe * c["n_experts"] * expert_params(c))


def matmul_params(c: dict) -> int:
    """The weights a token's step multiplies by on this card, on
    average: ``row_params`` and, per MoE layer, its routed share of the
    held experts (experts per token x held / routed experts)."""
    n_moe = c["num_hidden_layers"] - c["first_k_dense_replace"]
    return row_params(c) + (n_moe * c["num_experts_per_tok"] * c["n_experts"]
                            * expert_params(c) // c["n_routed_experts"])


def make(c: dict, seed: int, device) -> Dict:
    """The parameter tree of ``c`` in fp32 on ``device``, from ``seed``."""
    leaves = layout(c)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    total = sum(math.prod(s) for _, s, kind, _ in leaves if kind == "normal")
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    tree: Dict = {}
    off = 0
    for path, shape, kind, arg in leaves:
        if kind == "normal":
            n = math.prod(shape)
            t = flat[off:off + n].view(shape)
            t.mul_(1.0 / math.sqrt(arg))
            off += n
        else:
            t = torch.full(shape, arg, dtype=torch.float32, device=device)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree
