"""Plain PyTorch version of the ``slstm_scan`` kernel: xLSTM's
scalar-memory cell with exponential gating over a whole sequence.

This repo's sLSTM has no recurrent weight matrix (the JAX package's
``repro/models/recurrent.py::_slstm_step``): each unit is its own
recurrence. :func:`slstm_step` is one time step; :func:`slstm_scan_ref`
runs it over the sequence from the zero state (``m = -inf``), exactly as
the port's ``slstm_block`` did before the kernel existed. The CPU tests
use it as the kernel's stand-in and ``chip_smoke.py`` holds the kernel
against it on the card, within a stated tolerance (``exp``, ``tanh``,
``sigmoid`` and ``logsigmoid`` need not round as torch's do).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def slstm_step(carry, inp):
    """carry: c,n,m (B,d); inp: z,i,f,o (B,d) fp32 (pre-activation)."""
    c, n, m = carry
    z, i, f, o = inp
    logf = F.logsigmoid(f)
    m_new = torch.maximum(logf + m, i)
    fg = torch.exp(logf + m - m_new)
    ig = torch.exp(i - m_new)
    c = fg * c + ig * torch.tanh(z)
    n = fg * n + ig
    h = torch.sigmoid(o) * c / torch.clamp_min(n, 1.0)
    return (c, n, m_new), h


def slstm_scan_ref(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                   o: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) fp32 of the recurrence over axis 1 of the gate
    pre-activations ``z``, ``i``, ``f`` (forget bias included), ``o``,
    each (B, S, d) fp32."""
    B, S, d = z.shape
    carry = (z.new_zeros((B, d)), z.new_zeros((B, d)),
             torch.full((B, d), -torch.inf, dtype=z.dtype, device=z.device))
    xs = tuple(t.transpose(0, 1) for t in (z, i, f, o))
    hs = []
    for t in range(S):
        carry, h = slstm_step(carry, tuple(x[t] for x in xs))
        hs.append(h)
    return torch.stack(hs, dim=1)
