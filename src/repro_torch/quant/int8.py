"""Symmetric per-channel INT8 quantization - the "MRAM tier" weight format
(DESIGN.md SS.3). Used by the HH-PIM serving runtime and the pim_mac kernel.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
values and fp32 scales equal the JAX package's bit for bit, and
the QAT helper ``fake_quant`` takes the same values.

Every division has a tensor divisor: CUDA turns a division by a Python
scalar into a multiply by its rounded reciprocal, which can differ in
the last bit, so the card's scales would not match the CPU's.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize_per_channel(w: torch.Tensor, axis: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (float) -> (int8 values, float32 scales along `axis`-complement).

    Symmetric: w ~= q * scale. Scales are per output column for a (d_in,
    d_out) matrix with axis=0 (reduce over d_in).
    """
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(w / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale.squeeze(axis)


def dequantize(q: torch.Tensor, scale: torch.Tensor, axis: int = 0,
               dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (token) symmetric int8 activation quantization."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(x / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale[..., 0]


def fake_quant(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Straight-through QAT helper: value of quant-dequant, gradient of
    identity."""
    q, s = quantize_per_channel(w.detach(), axis)
    deq = dequantize(q, s, axis, w.dtype)
    return w + (deq - w).detach()
