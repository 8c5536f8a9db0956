"""Recurrent sequence mixers: RG-LRU (Griffin/RecurrentGemma) and
xLSTM's mLSTM / sLSTM cells.

Training/prefill runs each recurrence over the whole sequence in fp32
through one op per block (``repro_torch.kernels``): ``rglru_scan``
(differentiable; its backward is the ``rglru_scan_bwd`` op),
``mlstm_scan`` and ``slstm_scan``. Each launches a CUDA kernel on CUDA
tensors and runs the sequential loop over time (the kernel's plain
version) on CPU tensors. The JAX package's ``lax.associative_scan``
(RG-LRU) and two-level checkpointed ``lax.scan`` (``chunked_scan``)
compute the same recurrences (the associative scan in another
association order, so RG-LRU outputs differ from it by fp32 rounding
only: within 1e-5 of the reference per block in fp32,
tests/test_torch_family_modules.py).

The mLSTM and sLSTM ops have no backward yet. While autograd records
(grad mode on and an input of the scan requiring grad), ``mlstm_block``
and ``slstm_block`` therefore run the loop of ``chunked_scan`` instead,
whose 128-step chunks are checkpointed as the reference's are: a
dispatch on grad mode, not a fallback. Decode is a single state update
- this is what makes the state O(1) in context for these archs - and
equals the sequential loop's step. Every update keeps the reference's
fp32 / compute-dtype casts.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.kernels.mlstm_scan.ref import mlstm_step as _mlstm_step
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.slstm_scan.ops import slstm_scan
from repro_torch.kernels.slstm_scan.ref import slstm_step as _slstm_step
from repro_torch.models.common import ModelConfig, batch_only, dense_init
from repro_torch.models.mlp import _gelu


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0); F.softplus turns linear above
    # its threshold
    return torch.logaddexp(x, torch.zeros_like(x))


_SCAN_CHUNK = 128


def _scan(f, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = f(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(f, init, xs, chunk: int = _SCAN_CHUNK):
    """``lax.scan`` over the leading axis of every tensor of ``xs``:
    returns (final carry, stacked per-step outputs).

    A flat loop over S steps saves the carry at every step for the
    backward pass - O(S x state) residuals, catastrophic for
    matrix-memory cells (mLSTM state is (B,H,hd,hd)). While autograd
    records, a sequence of several whole chunks is run chunk by chunk
    under ``torch.utils.checkpoint``, as the reference's two-level scan
    does: carries are saved only at the S/chunk boundaries and a chunk
    is recomputed in the backward pass. The values are the same either
    way.
    """
    T = xs[0].shape[0]
    if T % chunk or T <= chunk or not torch.is_grad_enabled():
        return _scan(f, init, xs)
    carry, ys = init, []
    for c in range(T // chunk):
        xc = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        carry, y = checkpoint(_scan, f, carry, xc, use_reentrant=False)
        ys.append(y)
    return carry, torch.cat(ys)


def _records(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma recurrent block: conv1d + gated linear recurrence)
# ---------------------------------------------------------------------------

_CONV_K = 4
_C_GATE = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    dev = gen.device
    return {
        # block input projections (recurrent branch + gelu gate branch)
        "w_in_x": dense_init(gen, (d, d)),
        "w_in_g": dense_init(gen, (d, d)),
        "conv_w": dense_init(gen, (_CONV_K, d)) * 0.1,
        # RG-LRU gates
        "w_a": dense_init(gen, (d, d)),
        "w_x": dense_init(gen, (d, d)),
        "b_a": torch.zeros((d,), dtype=torch.float32, device=dev),
        "b_x": torch.zeros((d,), dtype=torch.float32, device=dev),
        # recurrence decay parameter Lambda (softplus-parameterized)
        "lam": torch.full((d,), 2.0, dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, (d, d)),
    }


def _rglru_gates(p, x):
    """a_t (decay) and gated input for the linear recurrence, fp32."""
    dt = x.dtype
    r = torch.sigmoid((x @ p["w_a"].to(dt)).float() + p["b_a"])
    i = torch.sigmoid((x @ p["w_x"].to(dt)).float() + p["b_x"])
    log_a = -_C_GATE * _softplus(p["lam"]) * r             # (B,S,d) fp32
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * i * x.float()
    return a, b


def _conv1d_causal(w, x, state=None):
    """Depthwise causal conv, kernel K, as the reference's K-term sum of
    shifted products (``F.conv1d`` sums in another order). x: (B,S,d);
    state: (B,K-1,d)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i].to(x.dtype) for i in range(K))
    return out, xp[:, -(K - 1):]


def rglru_block(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence recurrent block (train/prefill). x: (B,S,d)."""
    dt = x.dtype
    g = _gelu(x @ p["w_in_g"].to(dt))
    h = x @ p["w_in_x"].to(dt)
    h, _ = _conv1d_causal(p["conv_w"], h)
    a, b = _rglru_gates(p, h)
    # h_t = a_t * h_{t-1} + b_t from h_{-1} = 0, in fp32
    y = rglru_scan(a.contiguous(), b.contiguous()).to(dt)
    return (y * g) @ p["w_out"].to(dt)


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device=None):
    d = cfg.d_model
    return {"h": torch.zeros((batch, d), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, _CONV_K - 1, d), dtype=dtype,
                                device=device)}


def rglru_decode(p, x, cfg: ModelConfig, state
                 ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (B,1,d)."""
    dt = x.dtype
    g = _gelu(x @ p["w_in_g"].to(dt))
    h = x @ p["w_in_x"].to(dt)
    h, conv_state = _conv1d_causal(p["conv_w"], h, state["conv"])
    a, b = _rglru_gates(p, h)
    h_new = a[:, 0] * state["h"] + b[:, 0]
    y = h_new[:, None, :].to(dt)
    out = (y * g) @ p["w_out"].to(dt)
    return out, {"h": h_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell)
# ---------------------------------------------------------------------------


def init_mlstm(gen: torch.Generator, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    dev = gen.device
    return {
        "wq": dense_init(gen, (d, H * hd)),
        "wk": dense_init(gen, (d, H * hd)),
        "wv": dense_init(gen, (d, H * hd)),
        "wi": dense_init(gen, (d, H)),
        "wf": dense_init(gen, (d, H)),
        "wo_gate": dense_init(gen, (d, H * hd)),
        "w_out": dense_init(gen, (H * hd, d)),
        "bf": torch.full((H,), 3.0, dtype=torch.float32, device=dev),
        "bi": torch.zeros((H,), dtype=torch.float32, device=dev),
    }


def _mlstm_qkv(p, x, cfg):
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    # sqrt(hd) in fp32, then cast to the compute dtype, as the reference
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                   device=x.device)).to(dt)
    # on a mesh, batch-only layouts (as attention's q, k, v): the heads
    # split out of a sharded feature dim only where the mesh divides them
    q = batch_only(x @ p["wq"].to(dt)).reshape(B, S, H, hd)
    k = batch_only(x @ p["wk"].to(dt)).reshape(B, S, H, hd) / root
    v = batch_only(x @ p["wv"].to(dt)).reshape(B, S, H, hd)
    i_gate = (x @ p["wi"].to(dt)).float() + p["bi"]
    f_gate = (x @ p["wf"].to(dt)).float() + p["bf"]
    o_gate = torch.sigmoid(x @ p["wo_gate"].to(dt))
    return q, k, v, i_gate, f_gate, o_gate


def mlstm_block(p, x, cfg: ModelConfig) -> torch.Tensor:
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    dt = x.dtype
    dev = x.device
    q, k, v, i, f, o = _mlstm_qkv(p, x, cfg)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32 = F.logsigmoid(f)
    if _records(q32, k32, v32, i, f32):
        init = (torch.zeros((B, H, hd, hd), dtype=torch.float32,
                            device=dev),
                torch.zeros((B, H, hd), dtype=torch.float32, device=dev),
                torch.full((B, H), -torch.inf, dtype=torch.float32,
                           device=dev))
        _, hs = chunked_scan(_mlstm_step, init, tuple(
            t.transpose(0, 1) for t in (q32, k32, v32, i, f32)))
        hs = hs.transpose(0, 1)
    else:
        hs = mlstm_scan(*(t.contiguous() for t in (q32, k32, v32, i, f32)))
    h = hs.to(dt).reshape(B, S, H * hd)
    return (h * o) @ p["w_out"].to(dt)


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None):
    H, hd = cfg.n_heads, cfg.hd
    return {"C": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, hd), dtype=torch.float32,
                             device=device),
            "m": torch.full((batch, H), -torch.inf, dtype=torch.float32,
                            device=device)}


def mlstm_decode(p, x, cfg: ModelConfig, state
                 ) -> Tuple[torch.Tensor, Dict]:
    B = x.shape[0]
    dt = x.dtype
    q, k, v, i, f, o = _mlstm_qkv(p, x, cfg)
    carry = (state["C"], state["n"], state["m"])
    inp = (q[:, 0].float(), k[:, 0].float(), v[:, 0].float(), i[:, 0],
           F.logsigmoid(f[:, 0]))
    (C, n, m), h = _mlstm_step(carry, inp)
    h = h.to(dt).reshape(B, 1, -1)
    out = (h * o) @ p["w_out"].to(dt)
    return out, {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory cell with exponential gating)
# ---------------------------------------------------------------------------


def init_slstm(gen: torch.Generator, cfg: ModelConfig
               ) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    return {
        "wz": dense_init(gen, (d, d)),
        "wi": dense_init(gen, (d, d)),
        "wf": dense_init(gen, (d, d)),
        "wo_gate": dense_init(gen, (d, d)),
        "w_out": dense_init(gen, (d, d)),
        "bf": torch.full((d,), 3.0, dtype=torch.float32, device=gen.device),
    }


def _slstm_pre(p, x):
    dt = x.dtype
    z = (x @ p["wz"].to(dt)).float()
    i = (x @ p["wi"].to(dt)).float()
    f = (x @ p["wf"].to(dt)).float() + p["bf"]
    o = (x @ p["wo_gate"].to(dt)).float()
    return z, i, f, o


def slstm_block(p, x, cfg: ModelConfig) -> torch.Tensor:
    B, S, d = x.shape
    dt = x.dtype
    dev = x.device
    z, i, f, o = _slstm_pre(p, x)
    if _records(z, i, f, o):
        init = (torch.zeros((B, d), dtype=torch.float32, device=dev),
                torch.zeros((B, d), dtype=torch.float32, device=dev),
                torch.full((B, d), -torch.inf, dtype=torch.float32,
                           device=dev))
        _, hs = chunked_scan(_slstm_step, init,
                             tuple(t.transpose(0, 1) for t in (z, i, f, o)))
        hs = hs.transpose(0, 1)
    else:
        hs = slstm_scan(*(t.contiguous() for t in (z, i, f, o)))
    h = hs.to(dt)
    return h @ p["w_out"].to(dt)


def init_slstm_state(cfg: ModelConfig, batch: int, device=None):
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "n": torch.zeros((batch, d), dtype=torch.float32, device=device),
            "m": torch.full((batch, d), -torch.inf, dtype=torch.float32,
                            device=device)}


def slstm_decode(p, x, cfg: ModelConfig, state
                 ) -> Tuple[torch.Tensor, Dict]:
    dt = x.dtype
    z, i, f, o = _slstm_pre(p, x)
    carry = (state["c"], state["n"], state["m"])
    (c, n, m), h = _slstm_step(carry, (z[:, 0], i[:, 0], f[:, 0], o[:, 0]))
    out = h[:, None, :].to(dt) @ p["w_out"].to(dt)
    return out, {"c": c, "n": n, "m": m}
