"""Parameter layouts and seeded weights, made by the benchmark.

A configuration file under ``portbench/configs`` gives the sizes; this
module turns them into the nested parameter tree that ``repro_torch``
takes (its keys and shapes), and fills it on the device from the seed:
every normally drawn leaf comes out of one ``torch.randn`` call on a
generator on the card, scaled by ``1/sqrt(fan_in)`` leaf by leaf, and
every constant leaf is a ``torch.full``. The same seed on the same
device gives the same values, so the reference regenerates the weights
it was handed instead of taking them from the program.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str, float]
# (path, shape, "normal" | "const", fan_in | value)


def _norm(path, d: int) -> Leaf:
    return (path, (d,), "const", 0.0)


def _mat(path, d_in: int, d_out: int) -> Leaf:
    return (path, (d_in, d_out), "normal", float(d_in))


def _block(p, c: dict) -> List[Leaf]:
    """A dense decoder block: attention (GQA) and a SwiGLU FFN, each
    after its norm."""
    d, hd, f = c["d_model"], c["head_dim"], c["d_ff"]
    a, m = p + ("mix",), p + ("ffn",)
    return [_norm(p + ("ln1",), d),
            _mat(a + ("wq",), d, c["n_heads"] * hd),
            _mat(a + ("wk",), d, c["n_kv_heads"] * hd),
            _mat(a + ("wv",), d, c["n_kv_heads"] * hd),
            _mat(a + ("wo",), c["n_heads"] * hd, d),
            _norm(p + ("ln2",), d),
            _mat(m + ("w_gate",), d, f), _mat(m + ("w_up",), d, f),
            _mat(m + ("w_down",), f, d)]


def layout(c: dict) -> List[Leaf]:
    """Every leaf of the configuration's parameter tree: an unscanned
    stack of ``tail_{i}`` blocks between the embedding and the head."""
    if c["scan_layers"] or c["arch"] != "dense":
        raise ValueError("a layout is written for unscanned dense stacks")
    d, V = c["d_model"], c["vocab_size"]
    out = [(("embed",), (V, d), "normal", float(d)),
           _norm(("final_ln",), d)]
    for i in range(c["n_layers"]):
        out += _block(("stack", f"tail_{i}"), c)
    out.append(_mat(("lm_head",), d, V))
    return out


def n_params(c: dict) -> int:
    return sum(math.prod(shape) for _, shape, _, _ in layout(c))


def n_matmul_params(c: dict) -> int:
    """Parameters less the embedding table (a gather, no product)."""
    return n_params(c) - c["vocab_size"] * c["d_model"]


def make(c: dict, seed: int, device) -> Dict:
    """The parameter tree of ``c`` in fp32 on ``device``, drawn from
    ``seed``: N(0, 1/fan_in) matrices out of one ``randn`` call, norms
    constant."""
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
