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

:func:`slstm_chunked_bwd` models the backward kernels. Given the states,
a step of the backward (:func:`.ref.slstm_bwd_step`) is linear in the
gradients it carries back, (dc, dn, dm), so time is cut into chunks
again, run backwards:

1. the forward's local pass and combine give each chunk's incoming
   state;
2. local: each chunk, its states rerun from its incoming state, walked
   backwards from a zero carry with the output's gradients (giving b)
   and from each unit carry without them (giving the columns of A): the
   chunk maps the carry at its end, x, to A x + b at its start;
3. combine: a serial pass over the chunks from the last, x_{c-1} = A_c
   x_c + b_c from x = 0 past the end;
4. apply: each chunk walked backwards again from its true carry,
   writing the gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan.ref import (slstm_bwd_step,
                                                slstm_step)


def _zero_state(z: torch.Tensor):
    B, _, d = z.shape
    return (z.new_zeros((B, d)), z.new_zeros((B, d)),
            torch.full((B, d), -torch.inf, dtype=z.dtype, device=z.device))


def _incoming(z, i, f, o, chunk: int):
    """The chunks' step ranges and incoming states (c, n, m), by the
    local pass and the combine."""
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
    return bounds, incoming


def slstm_chunked(z, i, f, o, chunk: int) -> torch.Tensor:
    """``h`` (B, S, d) as ``ref.slstm_scan_ref`` computes it, through
    the local pass, the combine and the rerun, in chunks of ``chunk``
    steps."""
    xs = (z, i, f, o)
    hs = []
    for (c0, c1), carry in zip(*_incoming(z, i, f, o, chunk)):   # 3. rerun
        for t in range(c0, c1):
            carry, h = slstm_step(carry, tuple(x[:, t] for x in xs))
            hs.append(h)
    return torch.stack(hs, dim=1)


def _chunk_back(xs, dh, c0, c1, states, carry, grads=None):
    """Steps c1 - 1 down to c0 of the backward from ``carry``; the
    gradients into ``grads`` when given. Returns the carry at c0."""
    for t in range(c1 - 1, c0 - 1, -1):
        carry, g = slstm_bwd_step(states[t - c0], states[t - c0 + 1],
                                  tuple(x[:, t] for x in xs), dh[:, t],
                                  carry)
        if grads is not None:
            for dst, x in zip(grads, g):
                dst[:, t] = x
    return carry


def slstm_chunked_bwd(z, i, f, o, dh, chunk: int) -> tuple:
    """``(dz, di, df, do)`` as ``ref.slstm_scan_bwd_ref`` computes them,
    through the chunked scan backwards in time."""
    xs = (z, i, f, o)
    bounds, incoming = _incoming(z, i, f, o, chunk)

    def states(c0, c1, carry):
        out = [carry]
        for t in range(c0, c1):
            carry, _ = slstm_step(carry, tuple(x[:, t] for x in xs))
            out.append(carry)
        return out
    zero = torch.zeros_like(z[:, 0])
    maps = []
    for (c0, c1), start in zip(bounds, incoming):          # 2. local
        st = states(c0, c1, start)
        b = _chunk_back(xs, dh, c0, c1, st, (zero, zero, zero))
        cols = [_chunk_back(xs, torch.zeros_like(dh), c0, c1, st,
                            tuple(torch.ones_like(zero) if e == j else zero
                                  for e in range(3))) for j in range(3)]
        maps.append((cols, b))
    ends, x = [], (zero, zero, zero)
    for cols, b in reversed(maps):                         # 3. combine
        ends.append(x)
        x = tuple(b[r] + sum(cols[j][r] * x[j] for j in range(3))
                  for r in range(3))
    grads = [torch.empty_like(t) for t in xs]
    for (c0, c1), start, end in zip(bounds, incoming, reversed(ends)):
        _chunk_back(xs, dh, c0, c1, states(c0, c1, start), end, grads)
    return tuple(grads)                                    # 4. apply
