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

:func:`slstm_scan_bwd_ref` is the recurrence's backward, an explicit
loop backwards in time (no autograd).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm_scan.ref import half_at_ties


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


def slstm_bwd_step(prev, state, inp, dh, carry):
    """One step of the backward, from step t's incoming state ``prev``
    and its new state ``state`` (each (c, n, m)), its inputs ``inp`` (z,
    i, f, o), the output's gradient ``dh`` and the carried gradients
    ``carry`` (dc, dn, dm) of ``state``: returns (the carried gradients
    of ``prev``, (dz, di, df, do)). Linear in (``dh``, ``carry``)."""
    (c0, n0, m0), (c1, n1, m1) = prev, state
    z, i, f, o = inp
    dc, dn, dm = carry
    a = F.logsigmoid(f) + m0
    fg, ig = torch.exp(a - m1), torch.exp(i - m1)
    tz, so = torch.tanh(z), torch.sigmoid(o)
    nd = torch.clamp_min(n1, 1.0)
    do = dh * c1 / nd * so * (1 - so)
    dc = dc + dh * so / nd
    dn = dn - dh * so * c1 / (nd * nd) * half_at_ties(
        n1, torch.ones_like(n1))
    dz = dc * ig * (1 - tz * tz)
    ga = fg * (dc * c0 + dn * n0)
    gi = ig * (dc * tz + dn)
    share = half_at_ties(a, i)
    dm_tot = dm - ga - gi
    da = ga + share * dm_tot
    di = gi + (1 - share) * dm_tot
    return (fg * dc, fg * dn, da), (dz, di, da * torch.sigmoid(-f), do)


def slstm_scan_bwd_ref(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                       o: torch.Tensor, dh: torch.Tensor) -> tuple:
    """``(dz, di, df, do)`` of :func:`slstm_scan_ref` given its inputs and
    the output's gradient ``dh`` (all (B, S, d) fp32): the states by the
    loop, then :func:`slstm_bwd_step` backwards in time.

    Step t, with a = logsigmoid(f) + m_{t-1}, fg = exp(a - m_t), ig =
    exp(i - m_t), nd = max(n_t, 1): d sigmoid(o) = dh c_t / nd; dc += dh
    sigmoid(o) / nd; dn += -dh sigmoid(o) c_t / nd^2 times d nd / dn;
    dz = ig dc (1 - tanh(z)^2); d(a - m_t) = fg (dc c_{t-1} + dn
    n_{t-1}), d(i - m_t) = ig (dc tanh(z) + dn), dc and dn carried back
    times fg; the max m_t = max(a, i) hands dm_t on to a or to i; df =
    da sigmoid(-f), the gradient of the op's own logsigmoid. n_t = 1
    exactly at every first step and wherever i_t dominates: there the
    clamp's tie gives n half of the gradient, as ``jnp.maximum`` does
    (``torch.clamp_min`` would give it all).
    """
    B, S, d = z.shape
    xs = tuple(t.transpose(0, 1) for t in (z, i, f, o, dh))
    carry = (z.new_zeros((B, d)), z.new_zeros((B, d)),
             torch.full((B, d), -torch.inf, dtype=z.dtype, device=z.device))
    states = [carry]
    for t in range(S):
        carry, _ = slstm_step(carry, tuple(x[t] for x in xs[:4]))
        states.append(carry)
    grads = [torch.empty_like(x) for x in xs[:4]]
    carry = tuple(z.new_zeros((B, d)) for _ in range(3))
    for t in range(S - 1, -1, -1):
        carry, g = slstm_bwd_step(states[t], states[t + 1],
                                  tuple(x[t] for x in xs[:4]), xs[4][t],
                                  carry)
        for dst, x in zip(grads, g):
            dst[t] = x
    return tuple(g.transpose(0, 1) for g in grads)
