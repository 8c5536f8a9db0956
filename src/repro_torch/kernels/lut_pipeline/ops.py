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
    ``repro_torch/csrc/minplus_combine.cu``) - one block per consulted
    row (v, r), its rows in shared memory: the fold, the final k=K
    combine and the split backtrace. :func:`combine_plan` gives its
    launch geometry here, where the CPU tests can check it.

Together they replace the JAX package's one fused Pallas kernel
(``repro/kernels/lut_pipeline/kernel.py::_fused_kernel``). CPU tensors
run the plain versions; both give byte-identical tables and identical
integer splits (tests/test_torch_kernels.py, ``chip_smoke.py``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.multipool import combine_rows_torch
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.knapsack_dp.ops import dp_stages

# bytes of shared memory a block may use on an H100 (after the opt-in);
# the kernel's static part is one (value, index) pair per warp
SHARED_MAX = 232448
STATIC_SHARED = 32 * 8
MAX_THREADS = 1024
GRID_X_MAX = 2 ** 31 - 1
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


class CombinePlan(NamedTuple):
    """Launch geometry of one ``minplus_combine`` call: ``blocks`` = V R,
    one per consulted row (v, r); ``threads`` per block, K+1 rounded up
    to a multiple of 32 and at most ``MAX_THREADS`` (a fold's outputs
    are serial chains of k+1 steps, one per thread); ``shared_bytes`` of
    dynamic shared memory: the C staged rows, two fold accumulators and
    the C-2 argmin traces, (K+1) words each."""
    blocks: int
    threads: int
    shared_bytes: int


@functools.lru_cache(maxsize=256)
def combine_plan(V: int, C: int, R: int, K: int) -> CombinePlan:
    """The combine kernel's geometry for gathered rows (V, C, R, K+1);
    raises ``ValueError`` for a shape whose rows do not fit in one
    block's shared memory or whose blocks exceed the grid."""
    if C < 1 or K < 0:
        raise ValueError(f"minplus_combine needs C >= 1 clusters and K >= "
                         f"0, got C={C}, K={K}")
    K1 = K + 1
    threads = min(MAX_THREADS, 32 * -(-K1 // 32))
    shared = (C + 2 + max(C - 2, 0)) * K1 * 4
    if shared + STATIC_SHARED > SHARED_MAX:
        raise ValueError(
            f"minplus_combine: gathered (V, C, R, K+1) = ({V}, {C}, {R}, "
            f"{K1}) needs {shared} bytes of shared memory per block, over "
            f"the {SHARED_MAX - STATIC_SHARED} a block can have")
    if V * R > GRID_X_MAX:
        raise ValueError(f"minplus_combine: V R = {V * R} blocks exceed "
                         f"the grid limit ({V}, {C}, {R}, {K1})")
    return CombinePlan(V * R, threads, shared)


@functools.lru_cache(maxsize=1)
def _launcher():
    return build.entry("minplus_combine", "minplus_combine_launch",
                       _ARGTYPES)


def minplus_combine(gathered: torch.Tensor):
    """Min-plus combine of every variant's gathered cluster rows.

    Args:
      gathered: (V, C, R, K+1) float32 rows of each cluster's final
        stage table.

    Returns:
      min_e:  (V, R) float32 min total energy per row.
      splits: (V, R, C) int32 per-cluster group counts (-1 infeasible),
        bit-matching the numpy ``combine_many`` fold of the same rows.

    A CUDA tensor whose rows exceed one block's shared memory
    (:func:`combine_plan`) raises ``ValueError``.
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
    plan = combine_plan(V, C, R, K1 - 1)
    min_e = torch.empty((V, R), dtype=torch.float32, device=dev)
    splits = torch.empty((V, R, C), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        status = _launcher()(gathered.data_ptr(), min_e.data_ptr(),
                             splits.data_ptr(), V, C, R, K1 - 1,
                             plan.threads, plan.shared_bytes,
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
    stages, gathered = dp_stages(t.contiguous(), e.contiguous(), T, K,
                                 r.contiguous())
    min_e, splits = minplus_combine(gathered)
    if obs.enabled():
        # dispatch accounting keyed by the device that ran, so a trace
        # shows whether the kernels or the plain versions ran
        obs.counter("kernels.lut_pipeline.dispatch", backend=dev.type)
    return stages, min_e, splits
