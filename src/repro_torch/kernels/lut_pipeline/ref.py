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
