"""Public op: xLSTM's sLSTM recurrence over a sequence, CUDA kernel or
plain version.

:func:`slstm_scan` wraps the kernel of ``repro_torch/csrc/slstm_scan.cu``,
which stands in for the JAX package's ``lax.scan`` of ``_slstm_step``
(``repro/models/recurrent.py``). CUDA tensors launch the kernel, CPU
tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Its launch count is ``slstm_scan.launches`` (one per call).
The kernel is a chunked scan over time in chunks of ``CHUNK`` steps (a
local pass per chunk, a serial combine over the chunks, a rerun of each
chunk from its incoming state); ``tests/torch_slstm_chunked.py``
models it in PyTorch for the CPU tests.

:func:`slstm_scan_bwd` wraps the backward kernels of the same file:
a states pass and the forward's combine give the incoming state of
each chunk of ``BWD_CHUNK`` steps, then one kernel walks the chunks
backwards in time, a block per (row, 32 units, chunk) taken by ticket
from the end of time, each warp a span of ``BWD_SPAN`` steps whose map
of the carried gradients it finds in one walk (7 numbers), the chunks
chained through their published carries. :func:`slstm_bwd_plan` gives
its launch plan, checked on the CPU. Its launch count is
``slstm_scan_bwd.launches``.

Each is a ``torch.library`` custom op (``repro_torch::slstm_scan``,
``repro_torch::slstm_scan_bwd``) with a fake (meta) version, a DTensor
rule (every operand sharded alike on the batch dim or the unit dim (2),
or all replicated; never on time) and a FLOP count for
``FlopCounterMode``: ``12 B S d`` forward, the per-block term of
``launch/roofline.py``'s recurrent FLOPs, and twice that backward. The
backward op is the forward's autograd, on the saved inputs.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.slstm_scan.ref import (slstm_scan_bwd_ref,
                                                slstm_scan_ref)

CHUNK = 64                               # steps per chunk of the kernel
BWD_SPAN = 8                             # steps a warp of the backward walks
BWD_WARPS = 8                            # spans (warps) a backward chunk
BWD_CHUNK = BWD_SPAN * BWD_WARPS         # steps per chunk of the backward
BWD_UNITS = 32                           # units a block, one a lane
GRID_X_MAX = 2 ** 31 - 1

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _check(op: str, *ts: torch.Tensor) -> None:
    """Every operand (B, S, d) fp32 of one shape, on one device,
    contiguous: what the kernels take."""
    z = ts[0]
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{op} takes float32, got {t.dtype}")
        if t.ndim != 3 or t.shape != z.shape:
            raise ValueError(f"{op} takes (B, S, d) operands of one "
                             f"shape, got {[tuple(x.shape) for x in ts]}")
        if t.device != z.device:
            raise ValueError(f"{op}: operands on {z.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op} takes contiguous operands")


class SlstmBwdPlan(NamedTuple):
    """Launch plan of one ``slstm_scan_bwd`` call. Time is cut into
    ``chunks`` chunks of ``chunk`` = ``BWD_SPAN`` x ``warps`` steps, and
    the chain kernel's grid into ``tickets`` = B x ``groups`` x ``chunks``
    blocks of ``warps`` warps: the block that takes ticket t from the
    counter walks chunk ``chunks - 1 - t // (B groups)`` of row ``(t %
    (B groups)) // groups``, units ``[32 g, 32 g + 32)``, ``g = t %
    groups``, its warp w steps ``[w BWD_SPAN, (w + 1) BWD_SPAN)``.
    ``smem``: the dynamic shared bytes (``(5 chunk + 10 warps) x 32``
    floats: z, i, f, o and dh staged, the spans' maps and end carries);
    ``vec`` 16-byte copies, else 4-byte; ``scratch`` the floats of the
    scratch tensor (the states pass's 4 ``warps`` planes of B ``chunks``
    d, 96 floats of carry and one flag a ticket, the ticket counter). The
    kernel takes ``warps`` and ``vec`` and derives the rest as here."""
    chunk: int
    warps: int
    groups: int
    chunks: int
    tickets: int
    smem: int
    vec: bool
    scratch: int


def slstm_bwd_plan(B: int, S: int, d: int,
                   aligned: bool = True) -> SlstmBwdPlan:
    """The plan of a (B, S, d) ``slstm_scan_bwd``; ``aligned`` when every
    operand's pointer is 16-byte aligned. A chunk no longer than S
    rounded up to a whole span. Raises on what the kernels cannot
    hold."""
    if min(B, S, d) < 1:
        raise ValueError(f"slstm_bwd_plan takes B, S, d >= 1, got "
                         f"{(B, S, d)}")
    warps = min(BWD_WARPS, -(-S // BWD_SPAN))
    chunk = BWD_SPAN * warps
    groups, chunks = -(-d // BWD_UNITS), -(-S // chunk)
    tickets = B * groups * chunks
    if tickets > GRID_X_MAX:
        raise ValueError(f"slstm_scan_bwd: {tickets} blocks exceed CUDA's "
                         f"grid limit of {GRID_X_MAX}")
    smem = (5 * chunk + 10 * warps) * BWD_UNITS * 4
    scratch = 4 * warps * B * chunks * d + 3 * BWD_UNITS * tickets \
        + tickets + 1
    return SlstmBwdPlan(chunk, warps, groups, chunks, tickets, smem,
                        d % 4 == 0 and aligned, scratch)


def bwd_scratch_floats(B: int, S: int, d: int) -> int:
    """Floats of the backward's scratch (``slstm_bwd_plan``'s)."""
    return slstm_bwd_plan(B, S, d).scratch


@torch.library.custom_op("repro_torch::slstm_scan", mutates_args=())
def _slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                o: torch.Tensor) -> torch.Tensor:
    _check("slstm_scan", z, i, f, o)
    if z.device.type == "cpu":
        return slstm_scan_ref(z, i, f, o)
    if z.device.type != "cuda":
        raise ValueError(f"slstm_scan runs on cuda or cpu, not {z.device}")
    h = torch.empty_like(z)
    B, S, d = z.shape
    n_chunks = -(-S // CHUNK)            # one: only the rerun runs
    scratch = torch.empty(4 * B * n_chunks * d if n_chunks > 1 else 0,
                          dtype=torch.float32, device=z.device)
    fn = build.entry("slstm_scan", "slstm_scan_launch", _ARGS)
    with torch.cuda.device(z.device):
        status = fn(z.data_ptr(), i.data_ptr(), f.data_ptr(), o.data_ptr(),
                    h.data_ptr(), scratch.data_ptr(), B, S, d, CHUNK,
                    torch.cuda.current_stream(z.device).cuda_stream)
    build.check(status, "slstm_scan")
    slstm_scan.launches += 1
    return h


@_slstm_scan.register_fake
def _(z, i, f, o):
    _check("slstm_scan", z, i, f, o)
    return torch.empty_like(z)


@torch.library.custom_op("repro_torch::slstm_scan_bwd", mutates_args=())
def _slstm_scan_bwd(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                    o: torch.Tensor, dh: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    _check("slstm_scan_bwd", z, i, f, o, dh)
    if z.device.type == "cpu":
        return slstm_scan_bwd_ref(z, i, f, o, dh)
    if z.device.type != "cuda":
        raise ValueError(f"slstm_scan_bwd runs on cuda or cpu, not "
                         f"{z.device}")
    grads = tuple(torch.empty_like(z) for _ in range(4))
    if not z.numel():
        return grads
    B, S, d = z.shape
    ts = (z, i, f, o, dh) + grads
    plan = slstm_bwd_plan(B, S, d,
                          aligned=all(t.data_ptr() % 16 == 0 for t in ts))
    scratch = torch.empty(plan.scratch, dtype=torch.float32,
                          device=z.device)
    fn = build.entry("slstm_scan", "slstm_scan_bwd_launch", _BWD_ARGS)
    with torch.cuda.device(z.device):
        status = fn(*(t.data_ptr() for t in ts), scratch.data_ptr(), B, S,
                    d, plan.warps, int(plan.vec),
                    torch.cuda.current_stream(z.device).cuda_stream)
    build.check(status, "slstm_scan_bwd")
    slstm_scan_bwd.launches += 1
    return grads


@_slstm_scan_bwd.register_fake
def _(z, i, f, o, dh):
    _check("slstm_scan_bwd", z, i, f, o, dh)
    return tuple(torch.empty_like(z) for _ in range(4))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dh):
    return tuple(torch.ops.repro_torch.slstm_scan_bwd(*ctx.saved_tensors,
                                                      dh.contiguous()))


_slstm_scan.register_autograd(_backward, setup_context=_setup_context)


def _placements(n_out: int, n_in: int):
    """Every output and input alike: replicated, or sharded on the batch
    dim or the unit dim (never on time, dim 1)."""
    return [([p] * n_out, [p] * n_in)
            for p in (Replicate(), Shard(0), Shard(2))]


@register_sharding(torch.ops.repro_torch.slstm_scan.default)
def _(z, i, f, o):
    return _placements(1, 4)


@register_sharding(torch.ops.repro_torch.slstm_scan_bwd.default)
def _(z, i, f, o, dh):
    return _placements(4, 5)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _(z_shape, i_shape, f_shape, o_shape, out_shape=None, **kwargs) -> int:
    B, S, d = z_shape
    return 12 * B * S * d


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _(z_shape, *shapes, out_shape=None, **kwargs) -> int:
    B, S, d = z_shape
    return 24 * B * S * d


def slstm_scan(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
               o: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, d) fp32 of the sLSTM recurrence from the zero state;
    ``z``, ``i``, ``f`` (forget bias included), ``o`` the (B, S, d) fp32
    gate pre-activations, contiguous. Differentiable in every input
    (through :func:`slstm_scan_bwd`)."""
    return torch.ops.repro_torch.slstm_scan(z, i, f, o)


def slstm_scan_bwd(z: torch.Tensor, i: torch.Tensor, f: torch.Tensor,
                   o: torch.Tensor, dh: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """``(dz, di, df, do)`` of :func:`slstm_scan` given its inputs and the
    gradient ``dh`` of its output (all (B, S, d) fp32, contiguous)."""
    return tuple(torch.ops.repro_torch.slstm_scan_bwd(z, i, f, o, dh))


slstm_scan.launches = 0
slstm_scan_bwd.launches = 0
