"""Plain PyTorch version of the fused LUT pipeline.

One call evaluates, for every variant ``v`` of a batched build:

  1. the per-cluster Algorithm-1 DP stage tables
     (:func:`repro_torch.kernels.knapsack_dp.ref.dp_stages_ref`, the
     plain version of the ``dp_stages`` kernel),
  2. the row gather of each cluster's final table at the consulted
     t-grid tick rows,
  3. the Algorithm-2 min-plus combine with argmin backtrace
     (:func:`repro_torch.core.multipool.combine_rows_torch`, the plain
     version of the ``minplus_combine`` kernel).

Ragged clusters are inert-padded by the caller (``t=1, e=+inf``): an
infinite-cost space folds to a bitwise copy of the previous stage, so
padding changes no byte of any table or combine result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.multipool import combine_rows_torch
from repro_torch.kernels.knapsack_dp.ref import dp_stages_ref, gather_rows


def lut_pipeline_ref(t_items: torch.Tensor, e_items: torch.Tensor,
                     rows: torch.Tensor, *, T: int, K: int):
    """Fused DP + combine, batched over variants, on any device.

    Args:
      t_items: (V, C, n) int32 per-space tick costs (inert-padded).
      e_items: (V, C, n) float32 per-space energies (pad ``+inf``).
      rows:    (V, R) int32 consulted t-tick rows, ``0 <= row <= T``.

    Returns:
      stages: (V, C, n+1, T+1, K+1) float32, stage 0 the k=0 base.
      min_e:  (V, R) float32 minimum total energy per consulted row.
      splits: (V, R, C) int32 per-cluster group counts (-1 infeasible).
    """
    stages = dp_stages_ref(t_items, e_items, T, K)
    min_e, splits = combine_rows_torch(gather_rows(stages[:, :, -1], rows))
    return stages, min_e, splits


def tie_heavy_rows(V: int, C: int, R: int, K: int, seed: int = 0,
                   device="cpu") -> torch.Tensor:
    """(V, C, R, K+1) float32 gathered rows on which a combine's
    tie-breaking shows: row r takes the kind ``r % 6`` -

      0. +inf in every cluster (an infeasible row);
      1. a +inf prefix of random length in each cluster, integers 0..2
         after it;
      2. zeros (every split ties);
      3. the final candidates equal 1 at i = s, s+1, s+32, s+64 and
         s+1024 (s = K // 3: tied across lanes, across warps and within
         one thread of a 1024-wide block) and 3 elsewhere; the middle
         clusters are 0 at k=0 and 3 elsewhere, which leaves the fold
         unchanged;
      4. integers 0..2 with a fifth +inf;
      5. zeros, but the last cluster +inf past k=0: the final combine
         takes i = K, and the backtrace walks the middle folds' traces
         at k = K, where every split ties.

    The inputs of the combine kernel's tie tests (CPU emulation, card
    tests, ``chip_smoke.py``)."""
    rng = np.random.default_rng(seed)
    K1 = K + 1
    g = rng.integers(0, 3, size=(V, C, R, K1)).astype(np.float32)
    kind = np.arange(R) % 6
    g[:, :, kind == 0] = np.inf
    for r in np.flatnonzero(kind == 1):
        for v in range(V):
            for c in range(C):
                g[v, c, r, :rng.integers(0, K1 + 1)] = np.inf
    g[:, :, kind == 2] = 0.0
    s = K // 3
    ties = [i for i in (s, s + 1, s + 32, s + 64, s + 1024) if i <= K]
    for r in np.flatnonzero(kind == 3):
        g[:, :, r] = 3.0
        g[:, 0, r, ties] = 1.0
        g[:, 1:C - 1, r, 0] = 0.0
        if C > 1:
            g[:, C - 1, r] = 0.0
    for r in np.flatnonzero(kind == 4):
        g[:, :, r][rng.random((V, C, K1)) < 0.2] = np.inf
    g[:, :, kind == 5] = 0.0
    if C > 1:
        g[:, C - 1, kind == 5, 1:] = np.inf
    return torch.from_numpy(g).to(device)
