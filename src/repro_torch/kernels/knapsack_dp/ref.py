"""Plain PyTorch version of the ``dp_stages`` kernel (Algorithm 1).

dp[t, k] = min energy placing exactly k weight-groups in the spaces seen so
far within time t (integer ticks). The recurrence over one space i is

    dp_i[t, k] = min(dp_{i-1}[t, k], dp_i[t - t_i, k - 1] + e_i)

which is sequential in t and vectorized over k. This version is batched
over the (variant, cluster) dims and runs on any device; the CPU tests
use it as the kernel's stand-in and ``chip_smoke.py`` holds the kernel
against it on the card.
"""
from __future__ import annotations

import torch

INF = float("inf")


def base_stage(T: int, K: int, *, device=None) -> torch.Tensor:
    """The k=0 base table: 0 energy for no items, +inf otherwise."""
    base = torch.full((T + 1, K + 1), INF, dtype=torch.float32,
                      device=device)
    base[:, 0] = 0.0
    return base


def dp_stages_ref(t_items: torch.Tensor, e_items: torch.Tensor,
                  T: int, K: int) -> torch.Tensor:
    """Every per-space DP table of every (variant, cluster).

    Args:
      t_items: (V, C, n) int32 per-space tick costs, all >= 1.
      e_items: (V, C, n) float32 per-space energies (+inf = inert pad).
      T, K: tick horizon / group count; tables are (T+1, K+1).

    Returns:
      (V, C, n+1, T+1, K+1) float32 stage tables, stage 0 the k=0 base.

    Rows ``[t0, t0 + step)`` with ``step`` the smallest ``t_i`` of the
    batch read only rows below ``t0`` of the stage being written, so they
    are updated together; every element still gets exactly the one add
    and the one min of the recurrence, so the bits equal a row-by-row
    loop's.
    """
    V, C, n = t_items.shape
    dev = e_items.device
    stages = torch.empty((V, C, n + 1, T + 1, K + 1), dtype=torch.float32,
                         device=dev)
    stages[:, :, 0] = base_stage(T, K, device=dev)
    vi = torch.arange(V, device=dev).view(V, 1, 1)
    ci = torch.arange(C, device=dev).view(1, C, 1)
    for i in range(n):
        out = stages[:, :, i + 1]
        out.copy_(stages[:, :, i])
        t_i = t_items[:, :, i].long()                          # (V, C)
        e_i = e_items[:, :, i].view(V, C, 1, 1)
        step = int(t_i.min())
        for t0 in range(0, T + 1, step):
            t = torch.arange(t0, min(t0 + step, T + 1), device=dev)
            src = t.view(1, 1, -1) - t_i.unsqueeze(-1)         # (V, C, S)
            prev = out[vi, ci, src.clamp(min=0)][..., :-1]     # (V, C, S, K)
            take = torch.where((src >= 0).unsqueeze(-1), prev + e_i, INF)
            t1 = t0 + t.numel()
            out[:, :, t0:t1, 1:] = torch.minimum(out[:, :, t0:t1, 1:], take)
    return stages


def gather_rows(final: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``final[v, c, rows[v]]`` for (V, C, T+1, K+1) tables and (V, R)
    rows: the consulted rows of each cluster's final stage,
    (V, C, R, K+1)."""
    V, C = final.shape[:2]
    vi = torch.arange(V, device=final.device).view(V, 1, 1)
    ci = torch.arange(C, device=final.device).view(1, C, 1)
    return final[vi, ci, rows.long().unsqueeze(1)]
