"""Public op: one decode token of grouped-query attention in one CUDA
launch a layer.

:func:`decode_attn` wraps the ``decode_attn`` CUDA kernel
(``repro_torch/csrc/decode_attn.cu``): from the step's q, k and v (after
the products and the optional qkv bias, before RoPE) it rotates q and k,
writes k and v to slot ``pos % C`` of the bf16 caches in place, and
returns the attention over the valid slots, (B, 1, H hd) in bf16, for
the output product. It takes CUDA tensors only and never falls back: the
plain version is ``models.attention.decode_attn_plain``, today's
PyTorch path, which ``attention_decode`` takes wherever
:func:`plain_reason` names a reason (the CPU, DTensor tensors, caches
that are not bf16, head widths the kernel has no build for); on any
other CUDA tensors the kernel runs or the wrapper raises. The RoPE
frequencies come from the caller (``attention.rope_table``, made once
and kept). The caches it writes equal the plain
version's bit for bit; the output differs only by the order of fp32
sums. Its launch count is ``decode_attn.launches`` (kernel launches: one
a call, two where the ring is cut into chunks).

:func:`decode_plan` chooses the launch geometry here, where the CPU tests
can check it: a ring of up to ``SHORT_RING`` slots whose K and V rows fit
in a block's shared memory takes one block of ``THREADS`` threads per
(row, KV head) and one launch; a longer ring is cut into chunks of a
power-of-two number of slots, enough for ``FILL`` blocks, and a second
launch combines them.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build

THREADS = 128
WARPS = THREADS // 32
HEAD_DIMS = (64, 128, 256)               # head widths the kernel is built for
MAX_GROUP = 16                           # query heads a KV head
SHORT_RING = 256                         # slots one block covers at most
MIN_CHUNK = 32                           # slots of a chunk, at least
SMS = 132                                # streaming multiprocessors (H100)
FILL = 2 * SMS                           # blocks a chunked ring aims for
MAX_SMEM = 232448                        # bytes a block can have (H100)
STATIC_SMEM = 256                        # the second kernel's own
MAX_GRID = 65535                         # grid.y (KV heads), grid.z (rows)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = ([_P] * 6 + [_I] + [_P] * 6 + [_I] * 6 + [ctypes.c_float]
             + [_I] * 2 + [_P])


class DecodePlan(NamedTuple):
    """Launch geometry of one call: grid ``(n_chunks, KV, B)`` of
    ``THREADS`` threads, each block ``chunk`` slots of one (row, KV head)
    ring with the ``group`` query heads on it, ``tile`` of them in
    registers at a time. One chunk: one launch with ``smem`` bytes of
    dynamic shared memory (K and V rows, rotated queries, the warps'
    value sums, scores); more: the scores pass with ``smem`` and the
    values pass with ``smem_values``."""
    group: int
    tile: int
    chunk: int
    n_chunks: int
    smem: int
    smem_values: int


def _smem(chunk: int, hd: int, group: int, tile: int,
          chunked: bool) -> Tuple[int, int]:
    """Dynamic shared memory of the two kernels (``smem_bytes`` in the
    CUDA source)."""
    rows = chunk * hd * 2
    scores = group * chunk * 4
    red = WARPS * tile * hd * 4
    if not chunked:
        return 2 * rows + group * hd * 4 + red + scores, 0
    return rows + group * hd * 4 + scores, rows + red + scores


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, H: int, KV: int, hd: int, C: int) -> DecodePlan:
    """The plan of a call on B rows, H query heads over KV heads of
    width ``hd`` and a ring of C slots. Raises on what the kernel does
    not take."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attn is built for head widths "
                         f"{HEAD_DIMS}, got {hd}")
    if min(B, H, KV, C) < 1 or H % KV:
        raise ValueError(f"decode_attn: B={B}, H={H}, KV={KV}, C={C}")
    group = H // KV
    if group > MAX_GROUP:
        raise ValueError(f"decode_attn takes at most {MAX_GROUP} query "
                         f"heads a KV head, got {group}")
    if B > MAX_GRID or KV > MAX_GRID:
        raise ValueError(f"decode_attn takes at most {MAX_GRID} rows and "
                         f"KV heads, got {B}, {KV}")
    tile = 2 if group <= 2 else 4 if group <= 4 else 8
    if C <= SHORT_RING:
        smem, _ = _smem(C, hd, group, tile, False)
        if smem <= MAX_SMEM:
            return DecodePlan(group, tile, C, 1, smem, 0)
    chunk = SHORT_RING
    while chunk >= C:                    # at least two chunks
        chunk //= 2
    while chunk > MIN_CHUNK and B * KV * -(-C // chunk) < FILL:
        chunk //= 2
    smem, smem_values = _smem(chunk, hd, group, tile, True)
    assert max(smem, smem_values + STATIC_SMEM) <= MAX_SMEM
    return DecodePlan(group, tile, chunk, -(-C // chunk), smem, smem_values)


def plain_reason(q: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor) -> Optional[str]:
    """None where :func:`decode_attn` takes this step, else why the plain
    version does: ``"dtensor"`` (a sharded cache or query), ``"device"``
    (not CUDA), ``"dtype"`` (not bf16: the kernel is the bf16 decode's,
    and an fp32 model keeps fp32 arithmetic), ``"head_dim"`` (no build
    for the width). Nothing else sends CUDA tensors to the plain version:
    a layout or head group the kernel does not take raises in
    :func:`decode_attn`. q: (B, 1, H, hd); caches: (B, C, KV, hd)."""
    if any(isinstance(t, DTensor) for t in (q, cache_k, cache_v)):
        return "dtensor"
    if any(t.device.type != "cuda" for t in (q, cache_k, cache_v)):
        return "device"
    if any(t.dtype != torch.bfloat16 for t in (q, cache_k, cache_v)):
        return "dtype"
    if q.shape[-1] not in HEAD_DIMS:
        return "head_dim"
    return None


@functools.lru_cache(maxsize=None)
def score_scale(hd: int) -> float:
    """The scores' factor: ``logits / math.sqrt(hd)`` on a CUDA tensor is
    a product with the fp32 reciprocal of the fp32 divisor."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


def _check(name: str, t: torch.Tensor, shape: tuple, dev) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"decode_attn takes bf16 {name}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"decode_attn: {name} of shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if t.device != dev:
        raise ValueError(f"decode_attn: {name} on {t.device}, not {dev}")
    if not t.is_contiguous():
        raise ValueError(f"decode_attn takes a contiguous {name}")


def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, freqs: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """One decode token's attention, the caches written in place.

    Args:
      q: (B, 1, H, hd) bf16 queries before RoPE.
      k, v: (B, 1, KV, hd) bf16 keys (before RoPE) and values.
      cache_k, cache_v: (B, C, KV, hd) bf16 rings; slot ``pos % C`` of
        each row takes its k and v.
      pos: int64 on the caches' device, () for every row or (B,) per row.
      freqs: (R,) fp32 RoPE frequencies on the same device: the pair
        (x[2i], x[2i + 1]) of each head, i < R, turns by the angle
        ``float(pos) * freqs[i]``, the rest passes through; None: no
        RoPE. ``attention.rope_table`` gives apply_rope's (R = hd / 2
        for "full", hd / 4 for "2d").

    Returns (B, 1, H hd) bf16, what ``decode_attn_plain`` returns.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda tensors, not {dev}; "
                         f"the plain version is "
                         f"models.attention.decode_attn_plain")
    B, _, H, hd = q.shape
    C, KV = cache_k.shape[1], cache_k.shape[2]
    plan = decode_plan(B, H, KV, hd, C)
    _check("q", q, (B, 1, H, hd), dev)
    for name, t in (("k", k), ("v", v)):
        _check(name, t, (B, 1, KV, hd), dev)
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        _check(name, t, (B, C, KV, hd), dev)
    if pos.dtype != torch.int64 or pos.device != dev or \
            tuple(pos.shape) not in ((), (B,)) or not pos.is_contiguous():
        raise ValueError(f"decode_attn takes an int64 position of shape () "
                         f"or ({B},) on {dev}, got {pos.dtype} "
                         f"{tuple(pos.shape)} on {pos.device}")
    rot = 0 if freqs is None else 2 * freqs.numel()
    if freqs is not None and (freqs.dtype != torch.float32
                              or freqs.device != dev or freqs.ndim != 1
                              or not freqs.is_contiguous() or rot > hd):
        raise ValueError(f"decode_attn takes contiguous fp32 frequencies "
                         f"(R,) on {dev}, 2 R <= {hd}, got {freqs.dtype} "
                         f"{tuple(freqs.shape)} on {freqs.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_k", cache_k),
                    ("cache_v", cache_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attn takes a 16-byte aligned {name}")
    out = torch.empty((B, 1, H * hd), dtype=torch.bfloat16, device=dev)
    scratch = [None] * 4
    if plan.n_chunks > 1:
        g, n = plan.group, plan.n_chunks
        scratch = [torch.empty((B, KV, g, C), dtype=torch.float32,
                               device=dev),
                   torch.empty((B, KV, n, g, 2), dtype=torch.float32,
                               device=dev),
                   torch.empty((B, KV, n, g, hd), dtype=torch.float32,
                               device=dev),
                   torch.empty((B, KV), dtype=torch.int32, device=dev)]
    fn = build.entry("decode_attn", "decode_attn_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_k.data_ptr(),
            cache_v.data_ptr(), pos.data_ptr(), int(pos.ndim == 1),
            None if freqs is None else freqs.data_ptr(), out.data_ptr(),
            *(None if t is None else t.data_ptr() for t in scratch),
            B, H, KV, hd, C, rot, score_scale(hd), plan.chunk, plan.n_chunks,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "decode_attn")
    decode_attn.launches += 1 if plan.n_chunks == 1 else 2
    return out


decode_attn.launches = 0
