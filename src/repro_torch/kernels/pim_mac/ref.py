"""Plain PyTorch version of the ``pim_mac`` kernel (W8A8 -> int32 ->
scaled float).

The product is the exact int32 accumulator: an integer matmul on the
CPU, and float64 on CUDA (which has no general int32 matmul), exact while
128^2 * K < 2^53. The epilogue then runs in the reference's order,
``(acc * sx[:, None]) * sw[None, :]`` in fp32, cast to ``out_dtype``. The
CPU tests use it as the kernel's stand-in and ``chip_smoke.py`` holds the
kernel against it on the card.
"""
from __future__ import annotations

import torch


def pim_matmul_ref(x_i8: torch.Tensor, w_i8: torch.Tensor,
                   scale_x, scale_w,
                   out_dtype=torch.float32) -> torch.Tensor:
    """``(M,K)i8 @ (K,N)i8 -> (M,N)`` with per-row/per-col dequant scales.

    Args:
      x_i8:     (M, K) int8 activations.
      w_i8:     (K, N) int8 weights.
      scale_x:  scalar or (M,) per-row activation scale.
      scale_w:  scalar or (N,) per-column weight scale.
    """
    if x_i8.device.type == "cpu":
        acc = x_i8.to(torch.int32) @ w_i8.to(torch.int32)
    else:
        acc = (x_i8.double() @ w_i8.double()).to(torch.int32)
    sx = torch.as_tensor(scale_x, dtype=torch.float32, device=x_i8.device)
    sw = torch.as_tensor(scale_w, dtype=torch.float32, device=x_i8.device)
    if sx.ndim == 1:
        sx = sx[:, None]
    if sw.ndim == 1:
        sw = sw[None, :]
    return (acc.float() * sx * sw).to(out_dtype)
