"""Public ops: the RG-LRU's linear recurrence over a sequence and its
backward, CUDA kernels or plain versions.

:func:`rglru_scan` (``h_t = a_t * h_{t-1} + b_t`` from ``h_{-1} = 0``)
and :func:`rglru_scan_bwd` wrap the two kernels of
``repro_torch/csrc/rglru_scan.cu``, which stand in for the JAX package's
``lax.associative_scan`` in ``repro/models/recurrent.py::rglru_block``.
CUDA tensors launch a kernel, CPU tensors run the plain version
(:mod:`.ref`), and a CUDA tensor never falls back; either way the outputs
are the plain loop's bit for bit. The launch counts are
``rglru_scan.launches`` and ``rglru_scan_bwd.launches`` (one per call).

Each is a ``torch.library`` custom op (``repro_torch::rglru_scan``,
``repro_torch::rglru_scan_bwd``), so that the dry run's fake tensors and
DTensors see one op per block, not one per time step:

* a fake (meta) version, for ``FakeTensorMode`` and meta tensors;
* autograd: ``rglru_scan``'s backward is ``rglru_scan_bwd``, on the
  saved ``a`` and output ``h``;
* a DTensor rule: every input and output sharded alike on the batch dim
  (0) or the channel dim (2), or all replicated; the time dim is never
  split;
* a FLOP count for ``FlopCounterMode``: ``12 B S d`` forward, the
  per-block term of ``launch/roofline.py``'s recurrent FLOPs, and twice
  that backward (the roofline counts a backward as two forwards).

:func:`rglru_plan` chooses the kernels' launch plan here, where the CPU
tests can check it: one block of one warp per (batch row, 32 channels),
each lane walking one channel through every step, fed through a ring of
tiles in shared memory (``FWD_RING``, ``BWD_RING``: steps a tile, tiles;
a tile no longer than S rounded up to 4 steps); 16-byte copies where
``d % 4 == 0`` and every pointer is 16-byte aligned, else 4-byte copies.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)

LANES = 32                               # channels a block, one a lane
# (steps a tile, tiles in the ring) forward and backward: within 2 % of
# the fastest rings of a sweep on an H100 (PERF.md §6); their blocks fit
# two to an SM (dynamic shared memory <= 113 KB)
FWD_RING = (128, 3)
BWD_RING = (112, 2)
GRID_Y_MAX = 65535

_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


class RglruPlan(NamedTuple):
    """Launch plan of one ``rglru_scan`` or ``rglru_scan_bwd`` call: the
    grid ``(rows, groups)`` of one-warp blocks, block ``(x, y)`` walking
    channels ``[32 y, 32 y + 32)`` of batch row ``x``; tiles of ``tile``
    steps of each input, ``stages`` of them in the ring;
    ``smem`` the dynamic shared bytes (``(stages x ins + outs) x tile x
    32`` floats: forward the ring of a and b and h's tile, backward the
    ring of dh, a and h and the tiles of da and db); ``vec`` 16-byte
    copies, else 4-byte. The kernel checks it against its own layout."""
    groups: int
    rows: int
    tile: int
    stages: int
    smem: int
    vec: bool


def rglru_plan(B: int, S: int, d: int, backward: bool = False,
               aligned: bool = True) -> RglruPlan:
    """The plan of a (B, S, d) scan: ``backward`` for ``rglru_scan_bwd``,
    ``aligned`` when every operand's pointer is 16-byte aligned. Raises
    on what the kernels cannot hold."""
    if min(B, S, d) < 1:
        raise ValueError(f"rglru_plan takes B, S, d >= 1, got {(B, S, d)}")
    groups = -(-d // LANES)
    if groups > GRID_Y_MAX:
        raise ValueError(f"rglru_scan grid (B, groups={groups}) exceeds "
                         f"CUDA's limit of {GRID_Y_MAX} groups of 32 "
                         f"channels")
    tile, stages = BWD_RING if backward else FWD_RING
    tile = min(tile, -(-S // 4) * 4)
    ins, outs = (3, 2) if backward else (2, 1)
    return RglruPlan(groups, B, tile, stages,
                     (stages * ins + outs) * tile * LANES * 4,
                     d % 4 == 0 and aligned)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _check(op: str, *ts: torch.Tensor) -> None:
    """Every operand (B, S, d) fp32 of one shape, on one device,
    contiguous: what the kernels take."""
    ref = ts[0]
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{op} takes float32, got {t.dtype}")
        if t.ndim != 3 or t.shape != ref.shape:
            raise ValueError(f"{op} takes (B, S, d) operands of one shape, "
                             f"got {[tuple(x.shape) for x in ts]}")
        if t.device != ref.device:
            raise ValueError(f"{op}: operands on {ref.device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op} takes contiguous operands")


def _device(op: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op} runs on cuda or cpu, not {t.device}")
    return t.device.type


def _launch(op: str, ts: Tuple[torch.Tensor, ...], plan: RglruPlan) -> None:
    """Launch the kernel of ``op`` on CUDA operands ``ts`` by ``plan``:
    ``"rglru_scan"`` (a, b, h) or ``"rglru_scan_bwd"`` (a, h, dh, da,
    db), outputs last; adds one to the op's launch count."""
    B, S, d = ts[0].shape
    symbol, args = {"rglru_scan": ("rglru_scan_fwd_launch", _FWD_ARGS),
                    "rglru_scan_bwd": ("rglru_scan_bwd_launch",
                                       _BWD_ARGS)}[op]
    fn = build.entry("rglru_scan", symbol, args)
    dev = ts[0].device
    with torch.cuda.device(dev):
        status = fn(*(t.data_ptr() for t in ts), B, S, d, plan.groups,
                    plan.tile, plan.stages, plan.smem, int(plan.vec),
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, op)
    (rglru_scan if op == "rglru_scan" else rglru_scan_bwd).launches += 1


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check("rglru_scan", a, b)
    if _device("rglru_scan", a) == "cpu":
        return rglru_scan_ref(a, b)
    h = torch.empty_like(b)
    if h.numel():
        _launch("rglru_scan", (a, b, h),
                rglru_plan(*b.shape, aligned=_aligned(a, b, h)))
    return h


@_rglru_scan.register_fake
def _(a, b):
    _check("rglru_scan", a, b)
    return torch.empty_like(b)


@torch.library.custom_op("repro_torch::rglru_scan_bwd", mutates_args=())
def _rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check("rglru_scan_bwd", a, h, dh)
    if _device("rglru_scan_bwd", a) == "cpu":
        return rglru_scan_bwd_ref(a, h, dh)
    da, db = torch.empty_like(a), torch.empty_like(a)
    ts = (a, h, dh, da, db)
    if da.numel():
        _launch("rglru_scan_bwd", ts,
                rglru_plan(*a.shape, backward=True, aligned=_aligned(*ts)))
    return da, db


@_rglru_scan_bwd.register_fake
def _(a, h, dh):
    _check("rglru_scan_bwd", a, h, dh)
    return torch.empty_like(a), torch.empty_like(a)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0], output)


def _backward(ctx, dh):
    a, h = ctx.saved_tensors
    return tuple(torch.ops.repro_torch.rglru_scan_bwd(a, h, dh.contiguous()))


_rglru_scan.register_autograd(_backward, setup_context=_setup_context)


def _placements(n_out: int, n_in: int):
    """Every output and input alike: replicated, or sharded on the batch
    dim or the channel dim (never on time, dim 1)."""
    return [([p] * n_out, [p] * n_in)
            for p in (Replicate(), Shard(0), Shard(2))]


@register_sharding(torch.ops.repro_torch.rglru_scan.default)
def _(a, b):
    return _placements(1, 2)


@register_sharding(torch.ops.repro_torch.rglru_scan_bwd.default)
def _(a, h, dh):
    return _placements(2, 3)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _(a_shape, b_shape, out_shape=None, **kwargs) -> int:
    B, S, d = b_shape
    return 12 * B * S * d


@register_flop_formula(torch.ops.repro_torch.rglru_scan_bwd)
def _(a_shape, h_shape, dh_shape, out_shape=None, **kwargs) -> int:
    B, S, d = a_shape
    return 24 * B * S * d


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) fp32 with ``h_t = a_t * h_{t-1} + b_t`` over axis
    1, from ``h_{-1} = 0``; ``a``, ``b`` (B, S, d) fp32, contiguous.
    Differentiable in ``a`` and ``b`` (through :func:`rglru_scan_bwd`)."""
    return torch.ops.repro_torch.rglru_scan(a, b)


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(da, db)`` of :func:`rglru_scan` given ``a``, its output ``h`` and
    the gradient ``dh`` of ``h`` (all (B, S, d) fp32, contiguous)."""
    da, db = torch.ops.repro_torch.rglru_scan_bwd(a, h, dh)
    return da, db


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
