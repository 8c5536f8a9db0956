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

:func:`mlstm_scan_bwd_ref` is the recurrence's backward, an explicit
loop backwards in time (no autograd), and :func:`mlstm_scan_bwd_exact`
the same in float64 given the fp32 loop's m.
"""
from __future__ import annotations

import torch

# the backward recomputes the states forward a segment at a time from a
# state saved at every SEGMENT-th step
SEGMENT = 64


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


def _stabilizers(i: torch.Tensor, f: torch.Tensor) -> list:
    """m_t (B, H) of every step, by the loop's own fp32 recurrence."""
    m = torch.full(i[:, 0].shape, -torch.inf, dtype=i.dtype, device=i.device)
    ms = []
    for t in range(i.shape[1]):
        m = torch.maximum(f[:, t] + m, i[:, t])
        ms.append(m)
    return ms


def half_at_ties(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The share of max(x, y)'s gradient that x takes, as ``jnp.maximum``
    gives it: 1 where x > y, 1/2 at a tie, else 0."""
    return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _mlstm_bwd(q, k, v, i, f, h, dh, ms):
    """The backward loop in the inputs' dtype, with m_t given (``ms``)."""
    B, S, H, hd = q.shape
    xs = [t.transpose(0, 1) for t in (q, k, v, i, f, h, dh)]
    q, k, v, i, f, h, dh = xs
    neg = torch.full((B, H), -torch.inf, dtype=q.dtype, device=q.device)
    ms = [m.to(q.dtype) for m in ms]

    def step(C, n, t):
        m_prev = ms[t - 1] if t else neg
        fg = torch.exp(f[t] + m_prev - ms[t])
        ig = torch.exp(i[t] - ms[t])
        C = fg[..., None, None] * C + ig[..., None, None] * (
            k[t][..., :, None] * v[t][..., None, :])
        return C, fg[..., None] * n + ig[..., None] * k[t], fg, ig

    saved = {}                           # (C, n) before every segment
    C, n = q.new_zeros((B, H, hd, hd)), q.new_zeros((B, H, hd))
    for t in range(S):
        if t % SEGMENT == 0:
            saved[t] = (C, n)
        C, n, _, _ = step(C, n, t)
    grads = [torch.empty_like(x) for x in (q, k, v, i, f)]
    dq, dk, dv, di, df = grads
    dC, dn = torch.zeros_like(C), torch.zeros_like(n)
    dm = q.new_zeros((B, H))
    for s0 in sorted(saved, reverse=True):
        C, n = saved[s0]
        states = [(C, n)]                # before each step of the segment
        for t in range(s0, min(s0 + SEGMENT, S)):
            C, n, _, _ = step(C, n, t)
            states.append((C, n))
        for t in range(min(s0 + SEGMENT, S) - 1, s0 - 1, -1):
            (C0, n0), (C1, n1) = states[t - s0], states[t - s0 + 1]
            _, _, fg, ig = step(C0, n0, t)
            d = torch.einsum("bhi,bhi->bh", n1, q[t])
            den = torch.clamp_min(d.abs(), 1.0)
            u = (dh[t] * h[t]).sum(-1)
            dd = -u / den * half_at_ties(d.abs(), torch.ones_like(d)) \
                * torch.sign(d)
            dnum = dh[t] / den[..., None]
            dC = dC + q[t][..., :, None] * dnum[..., None, :]
            dn = dn + dd[..., None] * q[t]
            dq[t] = torch.einsum("bhij,bhj->bhi", C1, dnum) \
                + dd[..., None] * n1
            dCv = torch.einsum("bhij,bhj->bhi", dC, v[t])
            dk[t] = ig[..., None] * (dCv + dn)
            dv[t] = ig[..., None] * torch.einsum("bhij,bhi->bhj", dC, k[t])
            ga = fg * ((dC * C0).sum((-2, -1)) + (dn * n0).sum(-1))
            gi = ig * ((dCv * k[t]).sum(-1) + (dn * k[t]).sum(-1))
            dC, dn = fg[..., None, None] * dC, fg[..., None] * dn
            # m' = max(f + m, i): the gradient of m' to f + m or to i
            a = f[t] + (ms[t - 1] if t else neg)
            share = half_at_ties(a, i[t])
            dm_tot = dm - ga - gi
            da = ga + share * dm_tot
            di[t] = gi + (1 - share) * dm_tot
            df[t] = da
            dm = da
    return tuple(g.transpose(0, 1) for g in grads)


def mlstm_scan_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i: torch.Tensor, f: torch.Tensor, h: torch.Tensor,
                       dh: torch.Tensor) -> tuple:
    """``(dq, dk, dv, di, df)`` of :func:`mlstm_scan_ref` given its inputs,
    its output ``h`` and the output's gradient ``dh``: a loop backwards
    in time, the states recomputed a segment at a time.

    Step t, with fg = exp(f + m_{t-1} - m_t), ig = exp(i - m_t), d = n_t .
    q_t and den = max(|d|, 1): dnum = dh / den, dd = -(dh . h) / den
    times d den / dd; dC += q dnum^T and dn += dd q (carried back as
    fg dC, fg dn); dq = C_t dnum + dd n_t, dk = ig (dC v + dn), dv = ig
    dC^T k; then d(f + m_{t-1} - m_t) = fg <dC, C_{t-1}> + fg <dn,
    n_{t-1}>, d(i - m_t) = ig (k^T dC v + dn . k), and the max m_t =
    max(f + m_{t-1}, i) hands dm_t on to f + m_{t-1} or to i. m has a
    gradient only where the clamp binds. Ties split the gradient in
    halves, as ``jnp.maximum``'s does (``torch.clamp_min`` would pass all
    of it); |d| has gradient 0 at 0.
    """
    return _mlstm_bwd(q, k, v, i, f, h, dh, _stabilizers(i, f))


def mlstm_scan_bwd_exact(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         i: torch.Tensor, f: torch.Tensor,
                         dh: torch.Tensor) -> tuple:
    """:func:`mlstm_scan_bwd_ref`'s gradients in float64 from fp32
    inputs, given m by the fp32 loop's own recurrence and h by
    :func:`mlstm_scan_exact`."""
    ms = _stabilizers(i, f)
    h = mlstm_scan_exact(q, k, v, i, f)
    return _mlstm_bwd(*(x.double() for x in (q, k, v, i, f)), h,
                      dh.double(), ms)
