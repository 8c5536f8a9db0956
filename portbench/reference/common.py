"""Numerics shared by the references: RMS norm, RoPE, and the matrix
product in float32 or, for the control, in fp8."""
from __future__ import annotations

import torch

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def exact() -> None:
    """float32 products stay float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn under one per-tensor scale (amax to
    the format's largest value), back in float32; the gradient passes
    through the rounding unchanged."""
    s = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


class Matmul:
    """The compute dtype of a reference: ``a @ b`` and the activations
    between blocks in float32, or, for the control, in fp8 where the
    program holds them in bf16: both operands and the product rounded to
    fp8 (sums in float32, as fp8 tensor cores take them), and the
    residual stream rounded to fp8 at every block (``act``)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            return to_fp8(to_fp8(a) @ to_fp8(b))
        return a @ b

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return to_fp8(x) if self.fp8 else x


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x / rms(x) * (1 + scale)."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + scale)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on interleaved pairs (x[2j], x[2j+1]); x (B, L,
    H, hd), pos (L,)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos.float()[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)
