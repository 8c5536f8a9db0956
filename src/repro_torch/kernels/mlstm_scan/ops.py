"""Public op: xLSTM's mLSTM recurrence over a sequence, CUDA kernel or
plain version.

:func:`mlstm_scan` wraps the kernel of ``repro_torch/csrc/mlstm_scan.cu``,
which stands in for the JAX package's ``lax.scan`` of ``_mlstm_step``
(``repro/models/recurrent.py``). CUDA tensors launch the kernel, CPU
tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Its launch count is ``mlstm_scan.launches`` (one per call).
:func:`mlstm_plan` chooses the launch geometry here, where the CPU tests
can check it.

It is a ``torch.library`` custom op (``repro_torch::mlstm_scan``) with a
fake (meta) version, a DTensor rule (every operand sharded alike on the
batch dim or the head dim (2), or all replicated; never on time) and a
FLOP count for ``FlopCounterMode`` (``5 B S H hd^2``, the per-block term
of ``launch/roofline.py``'s recurrent FLOPs). It has no backward yet:
``models.recurrent.mlstm_block`` calls it only while autograd does not
record.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_scan.ref import mlstm_scan_ref

TILE = 32                                # columns of C per block
MAX_WARPS = 8                            # the kernel's launch bounds
MAX_RPT = 64                             # rows of C a thread keeps
MAX_HD = MAX_WARPS * MAX_RPT
GRID_YZ_MAX = 65535

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


class MlstmPlan(NamedTuple):
    """Launch geometry of one ``mlstm_scan`` call: grid ``(tiles, H, B)``
    of ``warps`` warps, each thread keeping ``rpt`` rows of its column
    of C."""
    rpt: int
    warps: int
    tiles: int


def mlstm_plan(hd: int) -> MlstmPlan:
    """The fewest rows per thread (a power of two) that cover ``hd``
    rows with at most ``MAX_WARPS`` warps; one block per 32 columns."""
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"mlstm_scan takes 1 <= hd <= {MAX_HD}, got {hd}")
    rpt = 1
    while rpt * MAX_WARPS < hd:
        rpt *= 2
    return MlstmPlan(rpt, -(-hd // rpt), -(-hd // TILE))


def _check(q, k, v, i, f) -> None:
    ts = (q, k, v, i, f)
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"mlstm_scan takes float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"mlstm_scan: operands on {q.device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("mlstm_scan takes contiguous operands")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape \
            or i.shape != q.shape[:3] or f.shape != q.shape[:3]:
        raise ValueError(f"mlstm_scan takes q, k, v (B, S, H, hd) and i, f "
                         f"(B, S, H), got {[tuple(t.shape) for t in ts]}")


@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=())
def _mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    _check(q, k, v, i, f)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, i, f)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    plan = mlstm_plan(hd)
    if H > GRID_YZ_MAX or B > GRID_YZ_MAX:
        raise ValueError(f"mlstm_scan grid (tiles, H={H}, B={B}) exceeds "
                         f"CUDA's limits")
    h = torch.empty_like(q)
    fn = build.entry("mlstm_scan", "mlstm_scan_launch", _ARGS)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), i.data_ptr(),
                    f.data_ptr(), h.data_ptr(), B, S, H, hd, plan.rpt,
                    plan.warps, plan.tiles,
                    torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "mlstm_scan")
    mlstm_scan.launches += 1
    return h


@_mlstm_scan.register_fake
def _(q, k, v, i, f):
    _check(q, k, v, i, f)
    return torch.empty_like(q)


@register_sharding(torch.ops.repro_torch.mlstm_scan.default)
def _(q, k, v, i, f):
    return [([p], [p] * 5) for p in (Replicate(), Shard(0), Shard(2))]


@register_flop_formula(torch.ops.repro_torch.mlstm_scan)
def _(q_shape, k_shape, v_shape, i_shape, f_shape, out_shape=None,
      **kwargs) -> int:
    B, S, H, hd = q_shape
    return 5 * B * S * H * hd * hd


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, H, hd) fp32 of the stabilized mLSTM recurrence from
    the zero state; q, k, v (B, S, H, hd) fp32 (k scaled by 1/sqrt(hd)),
    i (B, S, H) the input-gate pre-activation and f (B, S, H) the log
    forget gate, fp32, all contiguous; hd <= 512. Not differentiable."""
    return torch.ops.repro_torch.mlstm_scan(q, k, v, i, f)


mlstm_scan.launches = 0
