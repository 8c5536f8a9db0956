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
the state chunk after chunk); :mod:`.chunked` models it in PyTorch for
the CPU tests.

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

CHUNK = 32                               # steps per chunk: one warp
TILE = 32                                # columns of C per inter block
WARPS = 8                                # warps per inter block
MAX_HD = 512
MAX_SMEM = 232448                        # bytes a block can have (H100)
P_STRIDE = CHUNK + 4                     # row stride of P and V^T
RED_STRIDE = TILE + 8                    # row stride of the partial sums
GRID_YZ_MAX = 65535

_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


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
