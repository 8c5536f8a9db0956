"""Public op: xLSTM's sLSTM recurrence over a sequence, CUDA kernel or
plain version.

:func:`slstm_scan` wraps the kernel of ``repro_torch/csrc/slstm_scan.cu``,
which stands in for the JAX package's ``lax.scan`` of ``_slstm_step``
(``repro/models/recurrent.py``). CUDA tensors launch the kernel, CPU
tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Its launch count is ``slstm_scan.launches`` (one per call).

It is a ``torch.library`` custom op (``repro_torch::slstm_scan``) with a
fake (meta) version, a DTensor rule (every operand sharded alike on the
batch dim or the unit dim (2), or all replicated; never on time) and a
FLOP count for ``FlopCounterMode`` (``12 B S d``, the per-block term of
``launch/roofline.py``'s recurrent FLOPs). It has no backward yet:
``models.recurrent.slstm_block`` calls it only while autograd does not
record.
"""
from __future__ import annotations

import ctypes

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.slstm_scan.ref import slstm_scan_ref

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(z, i, f, o) -> None:
    ts = (z, i, f, o)
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"slstm_scan takes float32, got {t.dtype}")
        if t.ndim != 3 or t.shape != z.shape:
            raise ValueError(f"slstm_scan takes (B, S, d) operands of one "
                             f"shape, got {[tuple(x.shape) for x in ts]}")
        if t.device != z.device:
            raise ValueError(f"slstm_scan: operands on {z.device} and "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("slstm_scan takes contiguous operands")


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                o: torch.Tensor) -> torch.Tensor:
    _check(z, i, f, o)
    if z.device.type == "cpu":
        return slstm_scan_ref(z, i, f, o)
    if z.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cuda or cpu, not {z.device}")
    h = torch.empty_like(z)
    B, S, d = z.shape
    fn = build.entry("slstm_scan", "slstm_scan_launch", _ARGS)
    with torch.cuda.device(z.device):
        status = fn(z.data_ptr(), i.data_ptr(), f.data_ptr(), o.data_ptr(),
                    h.data_ptr(), B, S, d,
                    torch.cuda.current_stream(z.device).cuda_stream)
    build.check(status, "slstm_scan")
    slstm_scan.launches += 1
    return h


@_slstm_scan.register_fake
def _(z, i, f, o):
    _check(z, i, f, o)
    return torch.empty_like(z)


@register_sharding(torch.ops.repro_torch.slstm_scan.default)
def _(z, i, f, o):
    return [([p], [p] * 4) for p in (Replicate(), Shard(0), Shard(2))]


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _(z_shape, i_shape, f_shape, o_shape, out_shape=None, **kwargs) -> int:
    B, S, d = z_shape
    return 12 * B * S * d


def slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) fp32 of the sLSTM recurrence from the zero state;
    ``z``, ``i``, ``f`` (forget bias included), ``o`` the (B, S, d) fp32
    gate pre-activations, contiguous. Not differentiable."""
    return torch.ops.repro_torch.slstm_scan(z, i, f, o)


slstm_scan.launches = 0
