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
tests can hold them to the loop of
:mod:`repro_torch.kernels.slstm_scan.ref` (which stays the op's
definition). No path of the port calls it, so it lives with the tests
(``test_torch_chunked_scans.py``). Phase 3 is the loop's own step
(:func:`~repro_torch.kernels.slstm_scan.ref.slstm_step`); only the
incoming states differ from the loop's, by rounding. From a chunk's
first step on n >= 1, so the clamp max(n, 1) does not bind, and a
boundary m off by rounding rescales c and n alike.

:func:`slstm_chunked_bwd` models the backward kernels. Given the states,
a step of the backward (:func:`slstm_bwd_step`) is linear in the
gradients it carries back, x = (dc, dn, dm): it sends the carry of its
new state to its incoming state's by [[fg, 0, 0], [0, fg, 0], [P, Q,
sel]] plus a term in dh (:func:`step_matrix`). Products of such
matrices keep that form, so a span of steps maps the carry at its end
to A x + b at its start with A = [[a, 0, 0], [0, a, 0], [p, q, s]]: 7
numbers, found by one walk back (:func:`span_map`). Time is cut into
chunks of ``chunk`` steps, each into spans of ``span`` steps:

1. states: each chunk from the zero state, its local (c, n, m, G) after
   every span; the forward's combine over the chunks' ends gives each
   chunk's incoming state, and a span's incoming state is the chunk's
   carried through the local state at the span's start by the same
   update;
2. maps: each span rerun from its incoming state and walked back once,
   from a zero carry with the output's gradients, giving (a, p, q, s)
   and b;
3. chain: from the last chunk (x = 0 past the end), each chunk takes its
   successor's carry at its start as its end carry and applies its
   spans' maps from the last, giving each span's end carry and its own
   start carry;
4. apply: each span walked back from its end carry, writing the
   gradients.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_scan.ref import half_at_ties
from repro_torch.kernels.slstm_scan.ref import (slstm_bwd_step,
                                                slstm_step)


def _zero_state(z: torch.Tensor):
    B, _, d = z.shape
    return (z.new_zeros((B, d)), z.new_zeros((B, d)),
            torch.full((B, d), -torch.inf, dtype=z.dtype, device=z.device))


def _combine(start, local):
    """``start`` (c, n, m) carried through a span run from the zero state
    to ``local`` (c, n, m, G): the combine's update."""
    c, n, m = start
    c_loc, n_loc, m_loc, G = local
    gm = G + m
    m_new = torch.maximum(gm, m_loc)
    a, b = torch.exp(gm - m_new), torch.exp(m_loc - m_new)
    return a * c + b * c_loc, a * n + b * n_loc, m_new


def _local(z, i, f, o, c0: int, c1: int, span: int) -> list:
    """Steps [c0, c1) from the zero state: (c, n, m, G) after every
    ``span`` steps and at c1."""
    xs = (z, i, f, o)
    carry = _zero_state(z)
    G = z.new_zeros(carry[0].shape)
    out = []
    for t in range(c0, c1):
        carry, _ = slstm_step(carry, tuple(x[:, t] for x in xs))
        G = G + F.logsigmoid(f[:, t])
        if (t + 1 - c0) % span == 0 or t + 1 == c1:
            out.append((*carry, G))
    return out


def _incoming(z, i, f, o, chunk: int, span: int):
    """The chunks' step ranges, incoming states (c, n, m) and local
    states after every ``span`` steps, by the local pass and the
    combine."""
    S = z.shape[1]
    bounds = [(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    local = [_local(z, i, f, o, c0, c1, span)
             for c0, c1 in bounds]                 # 1. local
    incoming, x = [], _zero_state(z)
    for loc in local:                              # 2. combine
        incoming.append(x)
        x = _combine(x, loc[-1])
    return bounds, incoming, local


def slstm_chunked(z, i, f, o, chunk: int) -> torch.Tensor:
    """``h`` (B, S, d) as ``ref.slstm_scan_ref`` computes it, through
    the local pass, the combine and the rerun, in chunks of ``chunk``
    steps."""
    xs = (z, i, f, o)
    hs = []
    bounds, incoming, _ = _incoming(z, i, f, o, chunk, chunk)
    for (c0, c1), carry in zip(bounds, incoming):          # 3. rerun
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


def step_matrix(prev, state, inp):
    """(fg, P, Q, sel) of one step: the matrix [[fg, 0, 0], [0, fg, 0],
    [P, Q, sel]] by which :func:`slstm_bwd_step` sends the carried
    gradients (dc, dn, dm) of ``state`` to those of ``prev`` (its dh
    term aside): P = (1 - sel) fg c_{t-1} - sel ig tanh z, Q = (1 - sel)
    fg n_{t-1} - sel ig."""
    (c0, n0, m0), (_, _, m1) = prev, state
    z, i, f, _ = inp
    a = F.logsigmoid(f) + m0
    fg, ig = torch.exp(a - m1), torch.exp(i - m1)
    sel = half_at_ties(a, i)
    return (fg, (1 - sel) * fg * c0 - sel * ig * torch.tanh(z),
            (1 - sel) * fg * n0 - sel * ig, sel)


def span_map(xs, dh, c0: int, c1: int, states):
    """The map of steps [c0, c1) from the carry at c1 to the carry at c0,
    by one walk back: ((a, p, q, s), b), A = [[a, 0, 0], [0, a, 0], [p, q,
    s]]; ``states`` the states before each step and after the last."""
    zero = torch.zeros_like(dh[:, 0])
    a, p, q, s = torch.ones_like(zero), zero, zero, torch.ones_like(zero)
    b = (zero, zero, zero)
    for t in range(c1 - 1, c0 - 1, -1):
        prev, state = states[t - c0], states[t - c0 + 1]
        inp = tuple(x[:, t] for x in xs)
        b, _ = slstm_bwd_step(prev, state, inp, dh[:, t], b)
        fg, P, Q, sel = step_matrix(prev, state, inp)
        a, p, q, s = fg * a, P * a + sel * p, Q * a + sel * q, sel * s
    return (a, p, q, s), b


def apply_map(m, b, x):
    """A x + b for a span's map (``span_map``) and a carry x."""
    a, p, q, s = m
    return (a * x[0] + b[0], a * x[1] + b[1],
            p * x[0] + q * x[1] + s * x[2] + b[2])


def slstm_chunked_bwd(z, i, f, o, dh, chunk: int, span: int) -> tuple:
    """``(dz, di, df, do)`` as ``ref.slstm_scan_bwd_ref`` computes them,
    through the chunked scan backwards in time: chunks of ``chunk``
    steps, spans of ``span``."""
    xs = (z, i, f, o)
    bounds, incoming, local = _incoming(z, i, f, o, chunk, span)

    def states(c0, c1, carry):
        out = [carry]
        for t in range(c0, c1):
            carry, _ = slstm_step(carry, tuple(x[:, t] for x in xs))
            out.append(carry)
        return out
    spans = []                                     # 1. each span's start
    for k, ((c0, c1), x, loc) in enumerate(zip(bounds, incoming, local)):
        for w, s0 in enumerate(range(c0, c1, span)):
            start = x if w == 0 else (loc[w - 1][:3] if k == 0
                                      else _combine(x, loc[w - 1]))
            s1 = min(s0 + span, c1)
            st = states(s0, s1, start)
            spans.append((k, s0, s1, st, *span_map(xs, dh, s0, s1, st)))
    zero = torch.zeros_like(z[:, 0])
    ends, x = [None] * len(spans), (zero, zero, zero)
    for e in range(len(spans) - 1, -1, -1):        # 3. the chain
        ends[e] = x
        x = apply_map(spans[e][4], spans[e][5], x)
    grads = [torch.empty_like(t) for t in xs]
    for (_, s0, s1, st, _, _), end in zip(spans, ends):   # 4. apply
        _chunk_back(xs, dh, s0, s1, st, end, grads)
    return tuple(grads)
