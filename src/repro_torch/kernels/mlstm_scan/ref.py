"""Plain PyTorch version of the ``mlstm_scan`` kernel: xLSTM's stabilized
matrix-memory recurrence over a whole sequence.

:func:`mlstm_step` is one time step of the JAX package's
``repro/models/recurrent.py::_mlstm_step``; :func:`mlstm_scan_ref` runs it
over the sequence from the zero state (``m = -inf``), exactly as the
port's ``mlstm_block`` did before the kernel existed. The CPU tests use
it as the kernel's stand-in and ``chip_smoke.py`` holds the kernel
against it on the card, within a stated tolerance (the kernel sums
``C q`` and ``n q`` in another order).

:func:`mlstm_scan_exact` is the same recurrence in float64 given the
stabilizer m of the fp32 loop (which is part of the op: where the clamp
binds, h scales with e^{-m}). Where the forget gate is near 1 the fp32
loop's own rounding, carried through thousands of steps of state, is of
the order of that tolerance (its f + m - m' rounds to 0), so kernels are
held to this one there.
"""
from __future__ import annotations

import torch


def mlstm_step(carry, inp):
    """Stabilized mLSTM recurrence (one time step, batched).

    carry: C (B,H,hd,hd), n (B,H,hd), m (B,H)
    inp:   q,k,v (B,H,hd); i,f (B,H)
    """
    C, n, m = carry
    q, k, v, i, f = inp
    m_new = torch.maximum(f + m, i)
    fg = torch.exp(f + m - m_new)[..., None]
    ig = torch.exp(i - m_new)[..., None]
    C = fg[..., None] * C + ig[..., None] * (k[..., :, None]
                                             * v[..., None, :])
    n = fg * n + ig * k
    h_num = torch.einsum("bhij,bhi->bhj", C, q.to(C.dtype))
    h_den = torch.clamp_min(torch.abs(torch.einsum(
        "bhi,bhi->bh", n, q.to(n.dtype))), 1.0)
    h = h_num / h_den[..., None]
    return (C, n, m_new), h


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, H, hd) fp32 of the recurrence over axis 1.

    q, k, v: (B, S, H, hd) fp32 (k already scaled by 1/sqrt(hd));
    i: (B, S, H) fp32 input-gate pre-activation; f: (B, S, H) fp32
    log forget gate (``logsigmoid`` of its pre-activation).
    """
    B, S, H, hd = q.shape
    carry = (q.new_zeros((B, H, hd, hd)), q.new_zeros((B, H, hd)),
             torch.full((B, H), -torch.inf, dtype=q.dtype, device=q.device))
    xs = tuple(t.transpose(0, 1) for t in (q, k, v, i, f))
    hs = []
    for t in range(S):
        carry, h = mlstm_step(carry, tuple(x[t] for x in xs))
        hs.append(h)
    return torch.stack(hs, dim=1)


def mlstm_scan_exact(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, H, hd) float64 of :func:`mlstm_scan_ref`'s recurrence
    from fp32 inputs: m by the loop's own fp32 recurrence, everything
    else in float64."""
    B, S, H, hd = q.shape
    m = torch.full((B, H), -torch.inf, dtype=i.dtype, device=i.device)
    ms = []
    for t in range(S):
        m = torch.maximum(f[:, t] + m, i[:, t])
        ms.append(m.double())
    q, k, v, i, f = (x.double() for x in (q, k, v, i, f))
    C = q.new_zeros((B, H, hd, hd))
    n = q.new_zeros((B, H, hd))
    m_prev = torch.full((B, H), -torch.inf, dtype=q.dtype, device=q.device)
    hs = []
    for t in range(S):
        fg = torch.exp(f[:, t] + m_prev - ms[t])
        ig = torch.exp(i[:, t] - ms[t])
        C = fg[..., None, None] * C + ig[..., None, None] * (
            k[:, t, :, :, None] * v[:, t, :, None, :])
        n = fg[..., None] * n + ig[..., None] * k[:, t]
        h_num = torch.einsum("bhij,bhi->bhj", C, q[:, t])
        h_den = torch.clamp_min(torch.abs(torch.einsum(
            "bhi,bhi->bh", n, q[:, t])), 1.0)
        hs.append(h_num / h_den[..., None])
        m_prev = ms[t]
    return torch.stack(hs, dim=1)
