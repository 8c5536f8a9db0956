"""Public op: Algorithm-1 DP stage tables, CUDA kernel or plain version.

:func:`dp_stages` wraps the ``dp_stages`` CUDA kernel
(``repro_torch/csrc/dp_stages.cu``): CUDA tensors launch the kernel,
CPU tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Its launch count is ``dp_stages.launches`` (one per call,
though the kernel runs as a base fill, one launch per stage and a row
gather). :func:`chain_plan` lays out the kernel's diagonal chains here,
where the CPU tests can check the geometry, and the kernel follows it.

:func:`knapsack_dp` keeps the contract of the JAX package's op
(``repro/kernels/knapsack_dp/ops.py``): one cluster's table, or with
``return_stages=True`` every per-space table stacked to
``(n+1, T+1, K+1)`` (stage 0 is the k=0 base) for
``repro_torch.core.placement.backtrace_tables``. It is the
``batched=False`` anchor of ``build_lut``; the fused
:mod:`repro_torch.kernels.lut_pipeline` op launches the same kernel for
every variant and cluster of a build.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.knapsack_dp.ref import dp_stages_ref, gather_rows

CHAINS_PER_WARP = 128                    # Q = 4 chains per lane x 32 lanes
GRID_X_MAX = 2 ** 31 - 1
PLANE_MAX = 2 ** 31 - 2 ** 20             # 32-bit index math of one table
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


class ChainPlan(NamedTuple):
    """Warp layout of the ``dp_stages`` chain kernel, per stage i and
    table b = v C + c (all int64 arrays):

    * ``residues[i, b] = min(t_i, T + 1)``: the row classes t mod t_i;
    * ``warps_per_residue[i, b] = ceil((T // t_i + K + 1) /
      CHAINS_PER_WARP)``: the diagonal chains m = u - k in [-K, T // t_i],
      ``CHAINS_PER_WARP`` of them per warp;
    * ``warp_off[i]``: prefix sums of ``residues * warps_per_residue``
      over the tables, so warp ``w`` of stage i belongs to the table b
      with ``warp_off[i, b] <= w < warp_off[i, b + 1]``."""
    residues: np.ndarray
    warps_per_residue: np.ndarray
    warp_off: np.ndarray

    @property
    def stage_warps(self) -> np.ndarray:
        return self.warp_off[:, -1]


def chain_plan(t_items: np.ndarray, T: int, K: int) -> ChainPlan:
    """The chain kernel's geometry for (V, C, n) tick costs ``t_items``
    (all >= 1) and (T+1, K+1) tables; raises where a stage's grid would
    exceed CUDA's limits or a table its 32-bit indexing."""
    t = np.asarray(t_items, dtype=np.int64)
    # (n, V C), C-ordered: the kernel reads the plans' rows by pointer
    t = np.ascontiguousarray(t.reshape(-1, t.shape[-1]).T)
    residues = np.minimum(t, T + 1)
    wpr = (T // t + K + CHAINS_PER_WARP) // CHAINS_PER_WARP
    warps = residues * wpr
    warp_off = np.zeros((t.shape[0], t.shape[1] + 1), dtype=np.int64)
    np.cumsum(warps, axis=1, out=warp_off[:, 1:])
    plan = ChainPlan(residues, wpr, warp_off)
    if (T + 1) * (K + 1) > PLANE_MAX or t.shape[1] > 65535:
        raise ValueError(f"dp_stages takes (T+1)(K+1) <= {PLANE_MAX} and "
                         f"at most 65535 tables, got T={T}, K={K}, "
                         f"{t.shape[1]} tables")
    if plan.stage_warps.size and int(plan.stage_warps.max()) * 32 \
            > GRID_X_MAX:
        raise ValueError(f"dp_stages: {int(plan.stage_warps.max())} "
                         f"chain warps in one stage exceed the grid limit "
                         f"(T={T}, K={K})")
    return plan


def _check_inputs(t_items: torch.Tensor, e_items: torch.Tensor, T: int,
                  K: int, rows: Optional[torch.Tensor]) -> None:
    if t_items.dtype != torch.int32 or e_items.dtype != torch.float32:
        raise TypeError(f"t_items must be int32 and e_items float32, got "
                        f"{t_items.dtype} and {e_items.dtype}")
    if t_items.ndim != 3 or e_items.shape != t_items.shape:
        raise ValueError(f"t_items/e_items must both be (V, C, n), got "
                         f"{tuple(t_items.shape)} and "
                         f"{tuple(e_items.shape)}")
    if T < 0 or K < 0:
        raise ValueError(f"T and K must be >= 0, got T={T}, K={K}")
    tensors = [t_items, e_items] + ([] if rows is None else [rows])
    if any(x.device != t_items.device for x in tensors):
        raise ValueError("t_items, e_items and rows must share a device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("t_items, e_items and rows must be contiguous")
    # the recurrence reads row t - t_i of the stage being written, so a
    # space of zero ticks would read its own row (placement pads t=1)
    if t_items.numel() and int(t_items.min()) < 1:
        raise ValueError("every t_item must be >= 1 tick")
    if rows is not None:
        if rows.dtype != torch.int32 or rows.ndim != 2 \
                or rows.shape[0] != t_items.shape[0]:
            raise ValueError(f"rows must be int32 (V, R), got {rows.dtype} "
                             f"{tuple(rows.shape)}")
        if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) > T):
            raise ValueError(f"rows must lie in [0, T={T}]")


def dp_stages(t_items: torch.Tensor, e_items: torch.Tensor, T: int, K: int,
              rows: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stage tables of every (variant, cluster) and the gathered rows.

    Args:
      t_items: (V, C, n) int32 per-space tick costs, all >= 1 (ragged
        clusters inert-padded with ``t=1, e=+inf``).
      e_items: (V, C, n) float32 per-space energies.
      T, K: tick horizon / group count; tables are (T+1, K+1).
      rows: optional (V, R) int32 consulted tick rows, ``0 <= row <= T``.

    Returns:
      stages: (V, C, n+1, T+1, K+1) float32, stage 0 the k=0 base.
      gathered: (V, C, R, K+1) float32 rows ``rows[v]`` of each cluster's
        final stage, or None without ``rows``.
    """
    _check_inputs(t_items, e_items, T, K, rows)
    dev = t_items.device
    if dev.type == "cpu":
        stages = dp_stages_ref(t_items, e_items, T, K)
        return stages, (None if rows is None
                        else gather_rows(stages[:, :, -1], rows))
    if dev.type != "cuda":
        raise ValueError(f"dp_stages runs on cuda or cpu, not {dev}")
    V, C, n = t_items.shape
    R = 0 if rows is None else rows.shape[1]
    stages = torch.empty((V, C, n + 1, T + 1, K + 1), dtype=torch.float32,
                         device=dev)
    gathered = (None if rows is None else
                torch.empty((V, C, R, K + 1), dtype=torch.float32,
                            device=dev))
    plan = chain_plan(t_items.cpu().numpy(), T, K)
    warp_off = torch.as_tensor(plan.warp_off, dtype=torch.int32).to(dev)
    wpr = torch.as_tensor(plan.warps_per_residue, dtype=torch.int32).to(dev)
    stage_warps = np.ascontiguousarray(plan.stage_warps, dtype=np.int32)
    fn = build.entry("dp_stages", "dp_stages_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(t_items.data_ptr(), e_items.data_ptr(),
                    None if rows is None else rows.data_ptr(),
                    warp_off.data_ptr(), wpr.data_ptr(),
                    stage_warps.ctypes.data, stages.data_ptr(),
                    None if gathered is None else gathered.data_ptr(),
                    V, C, n, T, K, R,
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "dp_stages")
    dp_stages.launches += 1
    return stages, gathered


dp_stages.launches = 0


def knapsack_dp(t_items: Sequence[int], e_items: Sequence[float],
                T: int, K: int, *, device=DEFAULT_DEVICE,
                return_stages: bool = False) -> torch.Tensor:
    """Build the (T+1, K+1) min-energy table for one cluster's spaces.

    device: ``"cuda"`` (the kernel; raises without a card) or ``"cpu"``
      (the plain version).
    return_stages: also return every intermediate per-space table,
      stacked to (n+1, T+1, K+1), for backtracing placements.
    """
    dev = resolve_device(device)
    n = len(t_items)
    t = torch.tensor(list(t_items), dtype=torch.int32,
                     device=dev).view(1, 1, n)
    e = torch.tensor(list(e_items), dtype=torch.float32,
                     device=dev).view(1, 1, n)
    stages, _ = dp_stages(t, e, T, K)
    if obs.enabled():
        # dispatch accounting keyed by the device that ran, so a trace
        # shows whether the kernel or the plain version ran
        obs.counter("kernels.knapsack_dp.dispatch", backend=dev.type)
    stages = stages[0, 0]
    return stages if return_stages else stages[-1]
