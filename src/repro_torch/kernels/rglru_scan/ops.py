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
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                rglru_scan_ref)

_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _check("rglru_scan", a, b)
    if _device("rglru_scan", a) == "cpu":
        return rglru_scan_ref(a, b)
    h = torch.empty_like(b)
    B, S, d = b.shape
    fn = build.entry("rglru_scan", "rglru_scan_fwd_launch", _FWD_ARGS)
    with torch.cuda.device(a.device):
        status = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, d,
                    torch.cuda.current_stream(a.device).cuda_stream)
    build.check(status, "rglru_scan")
    rglru_scan.launches += 1
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
    B, S, d = a.shape
    fn = build.entry("rglru_scan", "rglru_scan_bwd_launch", _BWD_ARGS)
    with torch.cuda.device(a.device):
        status = fn(a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                    da.data_ptr(), db.data_ptr(), B, S, d,
                    torch.cuda.current_stream(a.device).cuda_stream)
    build.check(status, "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
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
