"""Public op: Algorithm-1 DP stage tables, CUDA kernel or plain version.

:func:`dp_stages` wraps the ``dp_stages`` CUDA kernel
(``repro_torch/csrc/dp_stages.cu``): CUDA tensors launch the kernel,
CPU tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Its launch count is ``dp_stages.launches``.

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
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.knapsack_dp.ref import dp_stages_ref, gather_rows


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
    fn = build.load("dp_stages").dp_stages_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(t_items.data_ptr(), e_items.data_ptr(),
                    None if rows is None else rows.data_ptr(),
                    stages.data_ptr(),
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
    _obs = obs.enabled()
    _t0 = obs.now_ns() if _obs else 0
    stages, _ = dp_stages(t, e, T, K)
    if _obs:
        # dispatch accounting keyed by the device that ran, so a trace
        # shows whether the kernel or the plain version ran
        obs.counter("kernels.knapsack_dp.dispatch", backend=dev.type)
        obs.observe("kernels.knapsack_dp.us",
                    (obs.now_ns() - _t0) / 1e3, backend=dev.type)
    stages = stages[0, 0]
    return stages if return_stages else stages[-1]
