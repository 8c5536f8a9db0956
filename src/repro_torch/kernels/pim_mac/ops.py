"""Public op: W8A8 matmul with fused dequantization, CUDA kernel or plain
version.

:func:`pim_matmul` wraps the ``pim_mac`` CUDA kernel
(``repro_torch/csrc/pim_mac.cu``), the port of the JAX package's Pallas
kernel (``repro/kernels/pim_mac``): CUDA tensors launch the kernel, CPU
tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Any ``(M, K) x (K, N)`` shapes; the kernel masks the ragged
edges itself, so nothing is padded here. Its launch count is
``pim_matmul.launches`` (one per call).

The kernel splits K across blocks; :func:`split_plan` chooses the launch
geometry here, where the CPU tests can check it, and the kernel follows
it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.pim_mac.ref import pim_matmul_ref

BN = 128                                 # output columns per block
BK = 64                                  # k rows per pipeline step
THREADS = 128
# blocks a launch aims for, per SM: two blocks with four 8 KB w stages
# each keep enough weight bytes in flight on every SM
BLOCKS_PER_SM = 2
# the last block of a tile adds the other splits' partials: more splits
# lengthen that serial tail more than they shorten the loads
MAX_SPLITS = 8
# |acc| <= 128^2 K must stay below 2^31 for the int32 accumulator
MAX_K = 2 ** 31 // 128 ** 2 - 1
MAX_M = 65535 * 32                       # grid.y limit x the 32-row tile
GRID_X_MAX = 2 ** 31 - 1

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


class SplitPlan(NamedTuple):
    """Launch geometry of one ``pim_mac`` call: blocks of ``16 * mt``
    rows x ``BN`` columns, grid ``(n_tiles, m_tiles, splits)``, each
    split ``k_chunk`` rows of K (a multiple of ``BK``)."""
    mt: int
    m_tiles: int
    n_tiles: int
    splits: int
    k_chunk: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    @property
    def partial_ints(self) -> int:
        """int32 partial sums of the split-K workspace (0 unsplit)."""
        if self.splits == 1:
            return 0
        return self.blocks * 16 * self.mt * THREADS


@functools.lru_cache(maxsize=1024)
def split_plan(M: int, K: int, N: int, sms: int = 132) -> SplitPlan:
    """The split-K geometry for an (M, K) x (K, N) product on a card of
    ``sms`` SMs: one or two m16 tiles per block (M <= 16 reads w once
    per 16 rows, larger M once per 32), and K split into equal chunks of
    whole ``BK`` steps until about ``BLOCKS_PER_SM * sms`` blocks run,
    at most ``MAX_SPLITS`` chunks."""
    if M < 1 or N < 1 or K < 0:
        raise ValueError(f"split_plan needs M, N >= 1 and K >= 0, got "
                         f"M={M}, K={K}, N={N}")
    mt = 1 if M <= 16 else 2
    m_tiles = math.ceil(M / (16 * mt))
    n_tiles = math.ceil(N / BN)
    steps = max(1, math.ceil(K / BK))
    want = min(MAX_SPLITS,
               math.ceil(BLOCKS_PER_SM * sms / (m_tiles * n_tiles)))
    per = math.ceil(steps / max(1, min(steps, want)))
    plan = SplitPlan(mt, m_tiles, n_tiles, math.ceil(steps / per), per * BK)
    if m_tiles > 65535 or n_tiles > GRID_X_MAX or plan.splits > 65535:
        raise ValueError(f"pim_matmul grid {plan} exceeds CUDA's limits")
    return plan


def _scales(s, n: int, what: str, dev: torch.device) -> torch.Tensor:
    """A scalar or (n,) fp32 scale broadcast to a contiguous (n,) vector
    on ``dev`` (the reference's ``broadcast_to`` of ``reshape(-1)``)."""
    if isinstance(s, torch.Tensor) and s.dtype == torch.float32 \
            and s.shape == (n,) and s.device == dev and s.is_contiguous():
        return s                          # the tiered matmul's every call
    if not isinstance(s, torch.Tensor):
        s = torch.tensor(s, dtype=torch.float32, device=dev)
    if s.dtype != torch.float32:
        raise TypeError(f"{what} must be float32, got {s.dtype}")
    if s.device != dev:
        raise ValueError(f"{what} is on {s.device}, the operands on {dev}")
    s = s.reshape(-1)
    if s.numel() not in (1, n):
        raise ValueError(f"{what} must be a scalar or ({n},), got "
                         f"{s.numel()} values")
    return s.expand(n).contiguous()


def pim_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor, scale_x, scale_w,
               *, out_dtype=torch.float32) -> torch.Tensor:
    """W8A8 matmul with per-row/col scales; any (M, K) x (K, N) shapes.

    Args:
      x_i8: (M, K) int8 activations, contiguous.
      w_i8: (K, N) int8 weights, contiguous.
      scale_x: scalar or (M,) float32 per-row scale.
      scale_w: scalar or (N,) float32 per-column scale.
      out_dtype: torch.float32 or torch.bfloat16.

    Returns (M, N) ``out_dtype``: ``(acc * scale_x[:, None]) *
    scale_w[None, :]`` with ``acc`` the exact int32 product.
    """
    if x_i8.dtype != torch.int8 or w_i8.dtype != torch.int8:
        raise TypeError(f"x_i8 and w_i8 must be int8, got {x_i8.dtype} and "
                        f"{w_i8.dtype}")
    if x_i8.ndim != 2 or w_i8.ndim != 2 or x_i8.shape[1] != w_i8.shape[0]:
        raise ValueError(f"need (M, K) x (K, N), got {tuple(x_i8.shape)} "
                         f"and {tuple(w_i8.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    dev = x_i8.device
    if w_i8.device != dev:
        raise ValueError(f"x_i8 is on {dev}, w_i8 on {w_i8.device}")
    if not (x_i8.is_contiguous() and w_i8.is_contiguous()):
        raise ValueError("x_i8 and w_i8 must be contiguous")
    (M, K), N = x_i8.shape, w_i8.shape[1]
    sx = _scales(scale_x, M, "scale_x", dev)
    sw = _scales(scale_w, N, "scale_w", dev)
    if obs.enabled():
        obs.counter("kernels.pim_mac.dispatch", backend=dev.type)
    if dev.type == "cpu":
        return pim_matmul_ref(x_i8, w_i8, sx, sw, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"pim_matmul runs on cuda or cpu, not {dev}")
    if K > MAX_K or M > MAX_M:
        raise ValueError(f"pim_matmul takes K <= {MAX_K} (exact int32 "
                         f"accumulation) and M <= {MAX_M}, got M={M}, K={K}")
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    plan = split_plan(M, K, N, _sm_count(dev))
    stream = torch.cuda.current_stream(dev)
    partial = arrivals = None
    if plan.splits > 1:
        partial, arrivals = _split_k_scratch(dev, stream, plan)
    fn = build.entry("pim_mac", "pim_mac_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        status = fn(x_i8.data_ptr(), w_i8.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(),
                    None if partial is None else partial.data_ptr(),
                    None if arrivals is None else arrivals.data_ptr(),
                    M, K, N, int(out_dtype == torch.bfloat16), plan.mt,
                    plan.m_tiles, plan.n_tiles, plan.splits, plan.k_chunk,
                    int(K % 16 == 0 and x_i8.data_ptr() % 16 == 0),
                    int(N % 16 == 0 and w_i8.data_ptr() % 16 == 0),
                    stream.cuda_stream)
    build.check(status, "pim_mac")
    pim_matmul.launches += 1
    return out


pim_matmul.launches = 0

_sms: Dict[int, int] = {}
_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _split_k_scratch(dev: torch.device, stream, plan: SplitPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K partial sums and per-tile arrival counters, kept per
    (device, stream) and grown as needed. Launches ordered on one stream
    may share them: a launch's partials are read within that launch, and
    the last block of a tile resets its counter, so the counters (zeroed
    once, when allocated) need no memset per call."""
    key = (stream.device_index, stream.stream_id)
    partial, arrivals = _scratch.get(key, (None, None))
    tiles = plan.m_tiles * plan.n_tiles
    if partial is None or partial.numel() < plan.partial_ints:
        partial = torch.empty(plan.partial_ints, dtype=torch.int32,
                              device=dev)
    if arrivals is None or arrivals.numel() < tiles:
        arrivals = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                               device=dev)
    _scratch[key] = (partial, arrivals)
    return partial, arrivals
