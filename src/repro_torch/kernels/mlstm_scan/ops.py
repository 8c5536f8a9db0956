"""Public op: xLSTM's mLSTM recurrence over a sequence, CUDA kernel or
plain version.

:func:`mlstm_scan` wraps the kernel of ``repro_torch/csrc/mlstm_scan.cu``,
which stands in for the JAX package's ``lax.scan`` of ``_mlstm_step``
(``repro/models/recurrent.py``). CUDA tensors launch the kernel, CPU
tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Its launch count is ``mlstm_scan.launches`` (one per call).
:func:`mlstm_plan` chooses the launch plan here, where the CPU tests
can check it: chunks of 32 steps, one inter block per 32 columns of C
(8 warps, each owning a slice of C's rows), and the inter kernel's
dynamic shared memory (228,864 bytes at hd = 512). The kernel is
chunkwise (three passes: the stabilizer, each chunk's gated Q K^T, then
the state chunk after chunk); ``tests/torch_mlstm_chunked.py`` models
it in PyTorch for the CPU tests.

:func:`mlstm_scan_bwd` wraps the backward kernels of the same file (a
chunkwise backward: the forward's gates pass; n before every chunk, from
every chunk's K^T w formed at once and a serial combine; each chunk's
intra terms, Q K^T and dH V^T on the tensor cores; three walks over the
chunks for the inter terms of dq, dk and dv, their products on the
tensor cores; and the gates' gradients from per-step sums, serially);
its launch count is ``mlstm_scan_bwd.launches``. The walks take the
inter kernel's ``xw`` (columns of their state a warp) from
:func:`mlstm_plan`. ``tests/torch_mlstm_chunked.py`` models it too.

Each is a ``torch.library`` custom op (``repro_torch::mlstm_scan``,
``repro_torch::mlstm_scan_bwd``) with a fake (meta) version, a DTensor
rule (every operand sharded alike on the batch dim or the head dim (2),
or all replicated; never on time) and a FLOP count for
``FlopCounterMode``: ``5 B S H hd^2`` forward, the per-block term of
``launch/roofline.py``'s recurrent FLOPs, and twice that backward (the
roofline counts a backward as two forwards, whatever the kernel
recomputes). The backward op is the forward's autograd, on the saved
inputs and output ``h``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_scan.ref import (mlstm_scan_bwd_ref,
                                                mlstm_scan_ref)

CHUNK = 32                               # steps per chunk: one warp
TILE = 32                                # columns of C per inter block
WARPS = 8                                # warps per inter block
MAX_HD = 512
MAX_SMEM = 232448                        # bytes a block can have (H100)
P_STRIDE = CHUNK + 4                     # row stride of P and V^T
RED_STRIDE = TILE + 8                    # row stride of the partial sums
GRID_YZ_MAX = 65535

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


class MlstmPlan(NamedTuple):
    """Launch plan of one ``mlstm_scan`` call: chunks of ``chunk``
    steps; the inter kernel's grid ``(tiles, H, B)`` of ``warps`` warps,
    warp w owning rows ``[w xw, (w + 1) xw)`` of C; ``stride`` the row
    stride (floats) of C^T and of a chunk of q in shared memory,
    ``kstride`` that of a chunk of k; ``kbuf`` the floats of the k
    buffer (which also holds the warps' partial sums); ``smem`` the
    inter kernel's dynamic shared bytes. ``chunk`` and ``warps`` are
    the kernel's constants and are not passed to it; the kernel checks
    the rest against its own layout."""
    chunk: int
    tiles: int
    warps: int
    xw: int
    stride: int
    kstride: int
    kbuf: int
    smem: int


def mlstm_plan(hd: int) -> MlstmPlan:
    """The inter kernel's layout for head width ``hd``: ``WARPS`` warps
    of ``xw`` = 16, 32 or 64 rows of C each (a power of two: whole
    16-row tensor-core tiles, loads of whole rows of 16-byte vectors,
    loops the compiler unrolls), hd padded with zeros to
    ``hp = WARPS * xw``. Strides are chosen so that shared memory is
    read without bank conflicts: ``stride`` (q and C^T rows, read 8 at
    one column and written 4 at 8) is 4 mod 32 floats, ``kstride`` (k
    rows, read 4 at 8 columns) is 8 mod 32."""
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"mlstm_scan takes 1 <= hd <= {MAX_HD}, got {hd}")
    xw = 16
    while xw * WARPS < hd:
        xw *= 2
    hp = xw * WARPS                      # hd padded to the warps' rows
    stride = 4 * ((hp // 4) | 1)
    kstride = hp + 8
    kbuf = max(CHUNK * kstride, WARPS * CHUNK * (RED_STRIDE + 1))
    smalls = (CHUNK + 2 * TILE) * P_STRIDE + 2 * CHUNK
    floats = (TILE + CHUNK) * stride + kbuf + hp + 2 * smalls
    return MlstmPlan(CHUNK, -(-hd // TILE), WARPS, xw, stride, kstride,
                     kbuf, 4 * floats)


def scratch_floats(B: int, S: int, H: int) -> int:
    """Floats of the kernel's scratch: m, b, s, w per step (padded to
    whole chunks) and each chunk's P."""
    n = B * H * -(-S // CHUNK) * CHUNK
    return 4 * n + n * CHUNK


def bwd_scratch_floats(B: int, S: int, H: int, hd: int) -> int:
    """Floats of the backward's scratch: m, b, s, w, s / den, s dd, R and
    Cs per step (padded to whole chunks) and hd per chunk, which hold each
    chunk's K^T w and then, combined in place, n before every chunk."""
    chunks = -(-S // CHUNK)
    return 8 * B * H * chunks * CHUNK + B * H * chunks * hd


def _check(op: str, q, k, v, i, f, *wide) -> None:
    """q, k, v and ``wide`` (B, S, H, hd), i and f (B, S, H), fp32, on one
    device, contiguous: what the kernels take."""
    ts = (q, k, v, i, f) + wide
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{op} takes float32, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{op}: operands on {q.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{op} takes contiguous operands")
    if q.ndim != 4 or any(t.shape != q.shape for t in (k, v) + wide) \
            or i.shape != q.shape[:3] or f.shape != q.shape[:3]:
        raise ValueError(f"{op} takes q, k, v (B, S, H, hd) and i, f "
                         f"(B, S, H), got {[tuple(t.shape) for t in ts]}")


def _plan(op: str, q: torch.Tensor) -> MlstmPlan:
    """The launch plan of a CUDA call, after the device check."""
    if q.device.type != "cuda":
        raise ValueError(f"{op} runs on cuda or cpu, not {q.device}")
    B, S, H, hd = q.shape
    plan = mlstm_plan(hd)
    if H > GRID_YZ_MAX or B > GRID_YZ_MAX:
        raise ValueError(f"{op} grid (tiles, H={H}, B={B}) exceeds CUDA's "
                         f"limits")
    return plan


@torch.library.custom_op("repro_torch::mlstm_scan", mutates_args=())
def _mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    _check("mlstm_scan", q, k, v, i, f)
    if q.device.type == "cpu":
        return mlstm_scan_ref(q, k, v, i, f)
    plan = _plan("mlstm_scan", q)
    B, S, H, hd = q.shape
    h = torch.empty_like(q)
    scratch = torch.empty(scratch_floats(B, S, H), dtype=torch.float32,
                          device=q.device)
    ts = (q, k, v, i, f, h)
    vec = hd % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts)
    fn = build.entry("mlstm_scan", "mlstm_scan_launch", _ARGS)
    with torch.cuda.device(q.device):
        status = fn(*(t.data_ptr() for t in ts), scratch.data_ptr(), B, S,
                    H, hd, plan.tiles, *plan[3:], int(vec),
                    torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "mlstm_scan")
    mlstm_scan.launches += 1
    return h


@_mlstm_scan.register_fake
def _(q, k, v, i, f):
    _check("mlstm_scan", q, k, v, i, f)
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::mlstm_scan_bwd", mutates_args=())
def _mlstm_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i: torch.Tensor, f: torch.Tensor, h: torch.Tensor,
                    dh: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    _check("mlstm_scan_bwd", q, k, v, i, f, h, dh)
    if q.device.type == "cpu":
        return mlstm_scan_bwd_ref(q, k, v, i, f, h, dh)
    plan = _plan("mlstm_scan_bwd", q)
    B, S, H, hd = q.shape
    grads = tuple(torch.empty_like(t) for t in (q, k, v, i, f))
    scratch = torch.empty(bwd_scratch_floats(B, S, H, hd),
                          dtype=torch.float32, device=q.device)
    ts = (q, k, v, i, f, h, dh) + grads
    vec = hd % 4 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (q, k, v, h, dh) + grads[:3])
    fn = build.entry("mlstm_scan", "mlstm_scan_bwd_launch", _BWD_ARGS)
    with torch.cuda.device(q.device):
        status = fn(*(t.data_ptr() for t in ts), scratch.data_ptr(), B, S,
                    H, hd, plan.xw, int(vec),
                    torch.cuda.current_stream(q.device).cuda_stream)
    build.check(status, "mlstm_scan_bwd")
    mlstm_scan_bwd.launches += 1
    return grads


@_mlstm_scan_bwd.register_fake
def _(q, k, v, i, f, h, dh):
    _check("mlstm_scan_bwd", q, k, v, i, f, h, dh)
    return tuple(torch.empty_like(t) for t in (q, k, v, i, f))


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output)


def _backward(ctx, dh):
    return tuple(torch.ops.repro_torch.mlstm_scan_bwd(
        *ctx.saved_tensors, dh.contiguous()))


_mlstm_scan.register_autograd(_backward, setup_context=_setup_context)


def _placements(n_out: int, n_in: int):
    """Every output and input alike: replicated, or sharded on the batch
    dim or the head dim (never on time, dim 1)."""
    return [([p] * n_out, [p] * n_in)
            for p in (Replicate(), Shard(0), Shard(2))]


@register_sharding(torch.ops.repro_torch.mlstm_scan.default)
def _(q, k, v, i, f):
    return _placements(1, 5)


@register_sharding(torch.ops.repro_torch.mlstm_scan_bwd.default)
def _(q, k, v, i, f, h, dh):
    return _placements(5, 7)


@register_flop_formula(torch.ops.repro_torch.mlstm_scan)
def _(q_shape, k_shape, v_shape, i_shape, f_shape, out_shape=None,
      **kwargs) -> int:
    B, S, H, hd = q_shape
    return 5 * B * S * H * hd * hd


@register_flop_formula(torch.ops.repro_torch.mlstm_scan_bwd)
def _(q_shape, *shapes, out_shape=None, **kwargs) -> int:
    B, S, H, hd = q_shape
    return 10 * B * S * H * hd * hd


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``h`` (B, S, H, hd) fp32 of the stabilized mLSTM recurrence from
    the zero state; q, k, v (B, S, H, hd) fp32 (k scaled by 1/sqrt(hd)),
    i (B, S, H) the input-gate pre-activation and f (B, S, H) the log
    forget gate, fp32, all contiguous; hd <= 512. Differentiable in
    every input (through :func:`mlstm_scan_bwd`)."""
    return torch.ops.repro_torch.mlstm_scan(q, k, v, i, f)


def mlstm_scan_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i: torch.Tensor, f: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``(dq, dk, dv, di, df)`` of :func:`mlstm_scan` given its inputs,
    its output ``h`` and the gradient ``dh`` of ``h`` ((B, S, H, hd)
    fp32, contiguous)."""
    return tuple(torch.ops.repro_torch.mlstm_scan_bwd(q, k, v, i, f, h, dh))


mlstm_scan.launches = 0
mlstm_scan_bwd.launches = 0
