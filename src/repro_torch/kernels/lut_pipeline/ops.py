"""Public op: the fused LUT pipeline on CUDA kernels or their plain
versions.

This is the build engine behind ``build_lut(method="dp",
batched=True)`` (repro_torch.core.placement) and the clock-grid
``build_lut_grid``: per-cluster Algorithm-1 stage tables, the consulted
t-grid row gather, and the Algorithm-2 min-plus combine with argmin
backtrace, in one device pass per build. On the card that pass is two
kernels on one stream:

  * ``dp_stages`` (:func:`repro_torch.kernels.knapsack_dp.ops.dp_stages`)
    - the stage tables as independent diagonal chains, and the row
    gather;
  * ``minplus_combine`` (:func:`minplus_combine`, this module's wrapper of
    ``repro_torch/csrc/minplus_combine.cu``) - one block per variant:
    the fold, the final k=K combine and the split backtrace.

Together they replace the JAX package's one fused Pallas kernel
(``repro/kernels/lut_pipeline/kernel.py::_fused_kernel``). CPU tensors
run the plain versions; both give byte-identical tables and identical
integer splits (tests/test_torch_kernels.py, ``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.core.multipool import combine_rows_torch
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.knapsack_dp.ops import dp_stages

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def minplus_combine(gathered: torch.Tensor):
    """Min-plus combine of every variant's gathered cluster rows.

    Args:
      gathered: (V, C, R, K+1) float32 rows of each cluster's final
        stage table.

    Returns:
      min_e:  (V, R) float32 min total energy per row.
      splits: (V, R, C) int32 per-cluster group counts (-1 infeasible),
        bit-matching the numpy ``combine_many`` fold of the same rows.
    """
    if gathered.dtype != torch.float32 or gathered.ndim != 4:
        raise ValueError(f"gathered must be float32 (V, C, R, K+1), got "
                         f"{gathered.dtype} {tuple(gathered.shape)}")
    if not gathered.is_contiguous():
        raise ValueError("gathered must be contiguous")
    dev = gathered.device
    if dev.type == "cpu":
        return combine_rows_torch(gathered)
    if dev.type != "cuda":
        raise ValueError(f"minplus_combine runs on cuda or cpu, not {dev}")
    V, C, R, K1 = gathered.shape
    min_e = torch.empty((V, R), dtype=torch.float32, device=dev)
    splits = torch.empty((V, R, C), dtype=torch.int32, device=dev)
    # double-buffered fold accumulator and the middle folds' argmin traces
    fbuf = torch.empty((V, 2, R, K1), dtype=torch.float32, device=dev)
    args = torch.empty((V, max(C - 2, 1), R, K1), dtype=torch.int32,
                       device=dev)
    fn = build.entry("minplus_combine", "minplus_combine_launch",
                     _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(gathered.data_ptr(), fbuf.data_ptr(), args.data_ptr(),
                    min_e.data_ptr(), splits.data_ptr(), V, C, R, K1 - 1,
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "minplus_combine")
    minplus_combine.launches += 1
    return min_e, splits


minplus_combine.launches = 0


def lut_build(t_items, e_items, T: int, K: int, rows, *,
              device=DEFAULT_DEVICE):
    """Fused Algorithm-1 + Algorithm-2 evaluation, batched over variants.

    Args:
      t_items: (V, C, n) per-variant/cluster/space integer tick costs.
        Ragged clusters must be inert-padded with ``(t=1, e=+inf)``; an
        infinite-cost space folds to a bitwise copy of the previous
        stage, so padding changes no byte of any result (and the
        placement backtrace walks through padded stages via its
        carry branch).
      e_items: (V, C, n) per-space energies (pad ``+inf``).
      T, K: tick horizon / weight-group count; tables are (T+1, K+1).
      rows: (R,) or (V, R) consulted t-grid tick rows, ``0 <= row <= T``.
      device: ``"cuda"`` (the kernels; raises without a card) or
        ``"cpu"`` (their plain versions).

    Returns:
      stages: (V, C, n+1, T+1, K+1) float32 per-space DP stage tables,
        stage 0 being the k=0 base - the same layout
        ``knapsack_dp(..., return_stages=True)`` yields per cluster,
        ready for ``placement.backtrace_tables``.
      min_e:  (V, R) float32 min total energy per consulted row.
      splits: (V, R, C) int32 optimal per-cluster group counts
        (-1 on infeasible rows), bit-matching the numpy
        ``combine_many`` fold of the same tables.
    """
    dev = resolve_device(device)
    t = torch.as_tensor(t_items, dtype=torch.int32, device=dev)
    e = torch.as_tensor(e_items, dtype=torch.float32, device=dev)
    if t.ndim != 3 or e.shape != t.shape:
        raise ValueError(f"t_items/e_items must both be (V, C, n), got "
                         f"{tuple(t.shape)} and {tuple(e.shape)}")
    r = torch.as_tensor(rows, dtype=torch.int32, device=dev)
    if r.ndim == 1:
        r = r.unsqueeze(0).expand(t.shape[0], -1)
    _obs = obs.enabled()
    _t0 = obs.now_ns() if _obs else 0
    stages, gathered = dp_stages(t.contiguous(), e.contiguous(), T, K,
                                 r.contiguous())
    min_e, splits = minplus_combine(gathered)
    if _obs:
        # dispatch accounting keyed by the device that ran, so a trace
        # shows whether the kernels or the plain versions ran
        obs.counter("kernels.lut_pipeline.dispatch", backend=dev.type)
        obs.observe("kernels.lut_pipeline.us",
                    (obs.now_ns() - _t0) / 1e3, backend=dev.type)
    return stages, min_e, splits
