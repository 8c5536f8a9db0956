"""Plain PyTorch model of the ``slstm_scan`` kernel's chunked scan over
time.

The sLSTM of this repo has no recurrent weight matrix: every unit is its
own recurrence, and given the stabilizer m it is linear in (c, n), while
m is a max-plus scan. So the kernel (``repro_torch/csrc/slstm_scan.cu``)
cuts time into chunks of ``chunk`` steps and runs, per (row, unit):

1. local: each chunk from the zero state (c = n = 0, m = -inf) with the
   loop's own step, recording its end state (c, n, m) and G, the sum of
   logsigmoid(f) over the chunk;
2. combine: a serial pass over the chunks giving each its true incoming
   state, with the step's own update: m = max(G + m_prev, m_loc),
   c = exp((G + m_prev) - m) c_prev + exp(m_loc - m) c_loc, n likewise;
3. rerun: each chunk again, from its incoming state, writing h.

This module runs the same three passes step for step, so that the CPU
tests can hold them to the loop of :mod:`.ref` (which stays the op's
definition). No path of the port calls it. Phase 3 is the loop's own
step (:func:`.ref.slstm_step`); only the incoming states differ from the
loop's, by rounding. From a chunk's first step on n >= 1, so the clamp
max(n, 1) does not bind, and a boundary m off by rounding rescales c
and n alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan.ref import slstm_step


def _zero_state(z: torch.Tensor):
    B, _, d = z.shape
    return (z.new_zeros((B, d)), z.new_zeros((B, d)),
            torch.full((B, d), -torch.inf, dtype=z.dtype, device=z.device))


def slstm_chunked(z, i, f, o, chunk: int) -> torch.Tensor:
    """``h`` (B, S, d) as ``ref.slstm_scan_ref`` computes it, through
    the local pass, the combine and the rerun, in chunks of ``chunk``
    steps."""
    S = z.shape[1]
    xs = (z, i, f, o)
    bounds = [(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    local = []
    for c0, c1 in bounds:                        # 1. local
        carry = _zero_state(z)
        G = z.new_zeros(carry[0].shape)
        for t in range(c0, c1):
            carry, _ = slstm_step(carry, tuple(x[:, t] for x in xs))
            G = G + F.logsigmoid(f[:, t])
        local.append((*carry, G))
    incoming, (c, n, m) = [], _zero_state(z)
    for c_loc, n_loc, m_loc, G in local:         # 2. combine
        incoming.append((c, n, m))
        gm = G + m
        m_new = torch.maximum(gm, m_loc)
        a, b = torch.exp(gm - m_new), torch.exp(m_loc - m_new)
        c, n, m = a * c + b * c_loc, a * n + b * n_loc, m_new
    hs = []
    for (c0, c1), carry in zip(bounds, incoming):   # 3. rerun
        for t in range(c0, c1):
            carry, h = slstm_step(carry, tuple(x[:, t] for x in xs))
            hs.append(h)
    return torch.stack(hs, dim=1)
