"""Plain PyTorch model of the ``mlstm_scan`` kernel's chunkwise algorithm.

The kernel (``repro_torch/csrc/mlstm_scan.cu``) does not walk the
sequence one step at a time: it splits it into chunks of ``chunk``
steps and, per chunk, does a few small matrix products. This module
runs the same decomposition step for step in PyTorch, so that the CPU
tests can hold it to the loop of :mod:`.ref` (which stays the op's
definition). No path of the port calls it.

Per (batch row, head), with m_{-1} = -inf, C = 0, n = 0:

* :func:`mlstm_chunk_gates` (the kernel's ``gates`` pass): the
  stabilizer by the loop's own recurrence, m_t = max(f_t + m_{t-1}, i_t)
  in fp32 and in the loop's order, so m equals the loop's bit for bit;
  b_t, the sum of f over the chunk up to t (at most ``chunk`` terms,
  never a sum over the whole sequence); s_t = exp(b_t + (m_prev - m_t)),
  the decay of the incoming state to step t (m_prev: m before the
  chunk); w_s = exp((i_s - m_e) + (b_e - b_s)), the weight of input s
  in the state at the chunk's end e. Both are formed and exponentiated
  in float64 and rounded once to fp32, as the kernel does: s at the
  chunk's end decays the whole state once a chunk, so its rounding
  compounds over the chunks.
* intra (the ``intra`` pass): P[t, s] = (q_t . k_s) exp((i_s - m_t) +
  (b_t - b_s)) for s <= t, 0 above the diagonal.
* inter (the ``inter`` pass), chunk after chunk:
  num_t = s_t (q_t C) + sum_s P[t, s] v_s,
  den_t = s_t (q_t . n) + sum_s P[t, s],
  h_t = num_t / max(|den_t|, 1);
  then C <- s_e C + sum_s w_s k_s v_s^T and n <- s_e n + sum_s w_s k_s,
  each chunk's sum formed apart and added to the decayed state once (so
  the state rounds once a chunk, not once a term).

The clamp binds where |den_t| < 1, and there h_t scales with e^{-m_t}:
that is why m is the loop's and not the published chunkwise kernels'
stabilizer. Only the sums are taken in another order than the loop's,
so h agrees with it to a tolerance.
"""
from __future__ import annotations

import torch


def mlstm_chunk_gates(i: torch.Tensor, f: torch.Tensor, chunk: int):
    """(m, b, s, w), each (B, S, H) fp32, of input gates ``i`` and log
    forget gates ``f`` (B, S, H) in chunks of ``chunk`` steps."""
    B, S, H = i.shape
    m, b, s, w = (torch.empty_like(i) for _ in range(4))
    m_run = torch.full((B, H), -torch.inf, dtype=i.dtype, device=i.device)
    for c0 in range(0, S, chunk):
        c1 = min(c0 + chunk, S)
        m_prev = m_run
        for t in range(c0, c1):
            m_run = torch.maximum(f[:, t] + m_run, i[:, t])
            m[:, t] = m_run
            b[:, t] = f[:, t] if t == c0 else b[:, t - 1] + f[:, t]
        sl = slice(c0, c1)
        bd, md = b[:, sl].double(), m[:, sl].double()
        s[:, sl] = torch.exp(bd + (m_prev[:, None].double() - md)).to(i.dtype)
        w[:, sl] = torch.exp((i[:, sl].double() - md[:, -1:])
                             + (bd[:, -1:] - bd)).to(i.dtype)
    return m, b, s, w


def mlstm_intra(q, k, i, b, m) -> torch.Tensor:
    """P (B, H, L, L) of one chunk: q, k (B, L, H, hd); i, b, m (B, L,
    H). Zero above the diagonal (never computed there)."""
    L = q.shape[1]
    qk = torch.einsum("bthx,bshx->bhts", q, k)
    it, bt, mt = (x.transpose(1, 2) for x in (i, b, m))     # (B, H, L)
    g = torch.exp((it[:, :, None, :] - mt[:, :, :, None])
                  + (bt[:, :, :, None] - bt[:, :, None, :]))
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    return torch.where(causal, qk * g, torch.zeros_like(qk))


def mlstm_chunked(q, k, v, i, f, chunk: int):
    """(h, den): ``h`` (B, S, H, hd) as ``ref.mlstm_scan_ref`` computes
    it, through the chunkwise decomposition, and the denominators
    n_t . q_t before the clamp (B, S, H)."""
    B, S, H, hd = q.shape
    m, b, s, w = mlstm_chunk_gates(i, f, chunk)
    C = q.new_zeros((B, H, hd, hd))
    n = q.new_zeros((B, H, hd))
    hs, dens = [], []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        qc, kc, vc = q[:, sl], k[:, sl], v[:, sl]
        P = mlstm_intra(qc, kc, i[:, sl], b[:, sl], m[:, sl])
        sc = s[:, sl].transpose(1, 2)                         # (B, H, L)
        num = sc[..., None] * torch.einsum("bthx,bhxj->bhtj", qc, C) \
            + torch.einsum("bhts,bshj->bhtj", P, vc)
        den = sc * torch.einsum("bthx,bhx->bht", qc, n) + P.sum(-1)
        h = num / torch.clamp_min(den.abs(), 1.0)[..., None]
        hs.append(h.transpose(1, 2))
        dens.append(den.transpose(1, 2))
        a = sc[..., -1]                                        # s_e
        wc = w[:, sl].transpose(1, 2)
        C = a[..., None, None] * C + torch.einsum(
            "bshx,bhs,bshj->bhxj", kc, wc, vc)
        n = a[..., None] * n + torch.einsum("bshx,bhs->bhx", kc, wc)
    return torch.cat(hs, dim=1), torch.cat(dens, dim=1)
