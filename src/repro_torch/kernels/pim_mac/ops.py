"""Public op: W8A8 matmul with fused dequantization, CUDA kernel or plain
version.

:func:`pim_matmul` wraps the ``pim_mac`` CUDA kernel
(``repro_torch/csrc/pim_mac.cu``), the port of the JAX package's Pallas
kernel (``repro/kernels/pim_mac``): CUDA tensors launch the kernel, CPU
tensors run the plain version (:mod:`.ref`), and a CUDA tensor never
falls back. Any ``(M, K) x (K, N)`` shapes; the kernel masks the ragged
edges itself, so nothing is padded here. Its launch count is
``pim_matmul.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import obs
from repro_torch.kernels import build
from repro_torch.kernels.pim_mac.ref import pim_matmul_ref

# |acc| <= 128^2 K must stay below 2^31 for the int32 accumulator
MAX_K = 2 ** 31 // 128 ** 2 - 1
MAX_M = 65535 * 16                       # grid.y limit x the 16-row tile


def _scales(s, n: int, what: str, dev: torch.device) -> torch.Tensor:
    """A scalar or (n,) fp32 scale broadcast to a contiguous (n,) vector
    on ``dev`` (the reference's ``broadcast_to`` of ``reshape(-1)``)."""
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
    fn = build.load("pim_mac").pim_mac_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        status = fn(x_i8.data_ptr(), w_i8.data_ptr(), sx.data_ptr(),
                    sw.data_ptr(), out.data_ptr(), M, K, N,
                    int(out_dtype == torch.bfloat16),
                    torch.cuda.current_stream(dev).cuda_stream)
    build.check(status, "pim_mac")
    pim_matmul.launches += 1
    return out


pim_matmul.launches = 0
