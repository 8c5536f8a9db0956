"""Plain PyTorch model of the ``mlstm_scan`` kernel's chunkwise algorithm.

The kernel (``repro_torch/csrc/mlstm_scan.cu``) does not walk the
sequence one step at a time: it splits it into chunks of ``chunk``
steps and, per chunk, does a few small matrix products. This module
runs the same decomposition step for step in PyTorch, so that the CPU
tests can hold it to the loop of
:mod:`repro_torch.kernels.mlstm_scan.ref` (which stays the op's
definition). No path of the port calls it, so it lives with the tests
(``test_torch_chunked_scans.py``, ``test_torch_scan_grads.py``).

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

:func:`mlstm_chunked_bwd` models the backward kernels the same way. In
a chunk the state is a sum of decayed inputs, C_t = sum_s D_ts k_s
v_s^T with log D_ts = F_t - F_s + i_s - m_t (F the sum of f from the
start), so the gradient is that of P_ts = D_ts (q_t . k_s) and of the
gates through log D. Given m:

* n before every chunk (the ``nsum`` and ``ncombine`` passes): every
  chunk's K^T w at once, then n_c = s_e n_{c-1} + (K^T w)_{c-1} serially
  over the chunks, one add a chunk, as the forward rounds n;
* intra: dnum_t = dh_t / den_t, dd_t = -(dh_t . h_t) / den_t d den/d d
  (d_t = s_t (q_t . n_prev) + rowsum(P), recomputed); dS = (dH V^T /
  den + dd) ⊙ D, 0 above the diagonal, and dq += dS K, dk += dS^T Q,
  dv += (P / den)^T dH;
* inter, a forward walk: dq_t += (s_t / den_t) C_prev dh_t + s_t dd_t
  n_prev, C rebuilt chunk after chunk as the forward builds it;
* inter, a reverse walk over dC = sum_t (decay) q_t dnum_t^T and dn:
  dk_s += w_s (dC v_s) + w_s dn, dv_s += w_s dC^T k_s, then dC <- s_e dC
  + Q^T diag(s / den) dH and dn <- s_e dn + Q^T (s dd) (the kernel runs
  it twice, once tiled by dC's rows for dk, once by its columns for dv).
  The walks' two products run on the tensor cores in 8-deep steps, each
  step's partial product formed apart and added to a running sum
  (:func:`walk_product`, :func:`chunk_update`): M y_t over each warp's
  ``xw`` columns of M (``mlstm_scan.ops.mlstm_plan``), the warps' sums
  added in order; the chunk's update over its four steps, added once to the
  decayed state, M <- s_e M + U;
* the gates, per step, without any hd^2 product: with G = dP ⊙ P the
  gradient of log D, its row sum R_t = dh_t . h_t + dd_t d_t = (dh_t .
  h_t)(1 - d den/d|d|) (0 where the clamp does not bind: h is then
  invariant to D's scale) and its column sum Cs_s = k_s . dk_s; so dF_t
  = R_t - Cs_t, di_t = Cs_t, and m_t takes -R_t, handed back through
  m_t = max(f_t + m_{t-1}, i_t) serially, as the gates pass runs it
  forward. df_t is A_t, the reverse cumulative sum of dF from t (in
  float64: the G of pairs s < t <= t'), plus what the max hands to f;
  A_0 is 0 (no pair crosses step 0: f_0 meets only m_{-1} = -inf), and
  di_0 is written with it as R_0 - (A_0 - A_1), so that at S = 1 both
  gradients are 0 exactly, as the loop's are.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm_scan.ops import mlstm_plan
from repro_torch.kernels.mlstm_scan.ref import half_at_ties

STEP = 8                                 # depth of one mma.sync m16n8k8


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


def walk_product(M, y, xw: int):
    """(M y_t) (B, L, H, hd) of a walk's chunk, M (B, H, hd, hd) and y
    (B, L, H, hd): each warp's ``xw`` columns of M in 8-deep steps, every
    step's product added to the warp's running sum, then the warps' sums
    added in order."""
    hd = M.shape[-1]
    total = None
    for w0 in range(0, hd, xw):
        part = None
        for x0 in range(w0, min(w0 + xw, hd), STEP):
            sl = slice(x0, min(x0 + STEP, hd))
            p = torch.einsum("bhrx,bthx->bthr", M[..., sl], y[..., sl])
            part = p if part is None else part + p
        total = part if total is None else total + part
    return total


def chunk_update(x, gamma, z):
    """U = X^T diag(gamma) Z (B, H, hd, hd) of a chunk, x and z (B, L, H,
    hd), gamma (B, L, H): diag(gamma) X formed first, then the chunk's
    8-deep steps, each apart, added in order."""
    gx = gamma[..., None] * x
    U = None
    for t0 in range(0, x.shape[1], STEP):
        sl = slice(t0, t0 + STEP)
        p = torch.einsum("bshx,bshj->bhxj", gx[:, sl], z[:, sl])
        U = p if U is None else U + p
    return U


def mlstm_chunked_bwd(q, k, v, i, f, h, dh, chunk: int):
    """``(dq, dk, dv, di, df)`` as ``ref.mlstm_scan_bwd_ref`` computes
    them, through the chunkwise decomposition of the backward kernels."""
    B, S, H, hd = q.shape
    xw = mlstm_plan(hd).xw
    m, b, s, w = mlstm_chunk_gates(i, f, chunk)
    bounds = [slice(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    decay = [s[:, sl][:, -1] for sl in bounds]               # s_e (B, H)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    sd, sdd, R = (torch.empty_like(i) for _ in range(3))
    sums = [torch.einsum("bshx,bhs->bhx", k[:, sl], w[:, sl].transpose(1, 2))
            for sl in bounds]                # each chunk's K^T w, at once
    n_prev, n = [], q.new_zeros((B, H, hd))
    for a, u in zip(decay, sums):            # then n before every chunk
        n_prev.append(n)
        n = a[..., None] * n + u
    for sl, n in zip(bounds, n_prev):        # intra
        qc, kc, vc, hc, dhc = (x[:, sl] for x in (q, k, v, h, dh))
        P = mlstm_intra(qc, kc, i[:, sl], b[:, sl], m[:, sl])  # (B,H,L,L)
        D = mlstm_intra(torch.ones_like(qc[..., :1]),
                        torch.ones_like(kc[..., :1]), i[:, sl], b[:, sl],
                        m[:, sl])
        sc = s[:, sl].transpose(1, 2)                           # (B,H,L)
        d = sc * torch.einsum("bthx,bhx->bht", qc, n) + P.sum(-1)
        den = torch.clamp_min(d.abs(), 1.0)
        u = (dhc * hc).sum(-1).transpose(1, 2)
        mu = half_at_ties(d.abs(), torch.ones_like(d))     # d den / d|d|
        dd = -u / den * mu * torch.sign(d)
        R[:, sl] = (u * (1 - mu)).transpose(1, 2)
        sd[:, sl] = (sc / den).transpose(1, 2)
        sdd[:, sl] = (sc * dd).transpose(1, 2)
        L = qc.shape[1]
        causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
        dS = torch.where(causal, (torch.einsum("bthx,bshx->bhts", dhc, vc)
                                  / den[..., None] + dd[..., None]) * D,
                         torch.zeros_like(D))
        dq[:, sl] = torch.einsum("bhts,bshx->bthx", dS, kc)
        dk[:, sl] = torch.einsum("bhts,bthx->bshx", dS, qc)
        dv[:, sl] = torch.einsum("bhts,bthx->bshx", P / den[..., None], dhc)
    C = q.new_zeros((B, H, hd, hd))
    for sl, a, n in zip(bounds, decay, n_prev):   # forward walk: dq's inter
        dq[:, sl] += sd[:, sl, :, None] * walk_product(C, dh[:, sl], xw) \
            + sdd[:, sl, :, None] * n[:, None]
        C = a[..., None, None] * C + chunk_update(k[:, sl], w[:, sl],
                                                   v[:, sl])
    dC, dn = q.new_zeros((B, H, hd, hd)), q.new_zeros((B, H, hd))
    for sl, a in zip(reversed(bounds), reversed(decay)):   # reverse walks
        wc = w[:, sl, :, None]
        dk[:, sl] += wc * walk_product(dC, v[:, sl], xw) + wc * dn[:, None]
        dv[:, sl] += wc * walk_product(dC.transpose(-1, -2), k[:, sl], xw)
        dC = a[..., None, None] * dC + chunk_update(q[:, sl], sd[:, sl],
                                                     dh[:, sl])
        dn = a[..., None] * dn + torch.einsum(
            "bthx,bht->bhx", q[:, sl], sdd[:, sl].transpose(1, 2))
    Cs = (k * dk).sum(-1)
    di, df = torch.empty_like(i), torch.empty_like(f)
    acc = torch.zeros((B, H), dtype=torch.float64, device=q.device)
    dm = torch.zeros_like(acc)
    for t in range(S - 1, -1, -1):           # the gates, serially
        r = R[:, t].double()
        dA = r - Cs[:, t].double() if t else -acc
        acc = acc + dA
        g = dm - r
        m_prev = m[:, t - 1] if t else torch.full_like(m[:, 0], -torch.inf)
        da = half_at_ties(f[:, t] + m_prev, i[:, t]).double() * g
        df[:, t] = (acc + da).to(f.dtype)
        di[:, t] = ((r - dA) + (g - da)).to(i.dtype)
        dm = da
    return dq, dk, dv, di, df
