"""The ``decode_attn`` kernel's output limit and the controls it must catch.

The kernel and its plain version (``models.attention.decode_attn_plain``)
take the same fp32 scores, softmax and value sums in another order, and
both round the probabilities and the output to bf16. Where both fp32
sums fall either side of a rounding boundary an output element moves by
one bf16 step of itself; the fp32 sums themselves differ by a few fp32
steps, and by a bf16 step of a probability times its value where a
probability's two fp32 values fall either side of a bf16 boundary
(about once a call at the dense cells' shape, mostly on small
probabilities). :func:`decode_attn_atol` allows each element one bf16
step of itself plus a quarter step of the largest |output|;
:func:`over_limit` is the largest |difference| over its limit (at most 1
passes).

:func:`bf16_sums` is the same attention with one of its fp32 sums taken in
bf16 instead (a kernel that accumulated the scores or the value product in
its storage type): its elements lie several bf16 steps of themselves off,
so the limit tells it from the kernel, which a limit on the largest
|output| alone would not at a few rows. The card tests
(tests/test_torch_gpu.py), ``chip_smoke.py`` and the CPU model of the
kernel's schedule (tests/test_torch_kernel_geometry.py) all hold the
kernel to the limit and check that both controls fail it. No path of the
port calls this module.
"""
import math

import torch


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step (ulp) of each |x|: 2^-7 of its binade's floor."""
    _, e = torch.frexp(x.float().abs().clamp(min=2.0 ** -100))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def decode_attn_atol(want: torch.Tensor) -> torch.Tensor:
    """Each element's limit: one bf16 step of |want| there, plus a
    quarter step of the largest |want|."""
    top = _bf16_step(want.float().abs().max())
    return _bf16_step(want) + top / 4


def over_limit(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over its :func:`decode_attn_atol`."""
    d = (got.float() - want.float()).abs()
    return float((d / decode_attn_atol(want)).max())


def bf16_sums(qr: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
              pos: torch.Tensor, which: str) -> torch.Tensor:
    """The attention of rotated queries qr (B, 1, H, hd) over written bf16
    rings (B, C, KV, hd) at positions pos (() or (B,)), the slots t <
    min(pos + 1, C), with the scores' dot products (``which="scores"``)
    or the value product (``"values"``) summed term by term in bf16, each
    partial sum rounded; the rest as the plain version (fp32 softmax,
    probabilities rounded to bf16). Returns (B, 1, H hd) bf16."""
    B, _, H, hd = qr.shape
    C, KV = ck.shape[1], ck.shape[2]
    g = H // KV
    q = qr[:, 0].reshape(B, KV, g, hd)
    k = ck.permute(0, 2, 1, 3)                         # (B, KV, C, hd)
    v = cv.permute(0, 2, 1, 3)
    if which == "scores":
        s = torch.zeros((B, KV, g, C), dtype=torch.bfloat16,
                        device=qr.device)
        for h in range(hd):
            s = s + q[..., h:h + 1] * k[:, :, None, :, h]
        s = s.float()
    else:
        s = torch.einsum("bkgh,bkch->bkgc", q.float(), k.float())
    s = s / math.sqrt(hd)
    n = torch.clamp(pos.expand(B) + 1, max=C)
    valid = torch.arange(C, device=qr.device)[None, :] < n[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(-1e30, device=qr.device))
    p = torch.softmax(s, dim=-1).bfloat16()
    if which == "values":
        out = torch.zeros((B, KV, g, hd), dtype=torch.bfloat16,
                          device=qr.device)
        for t in range(C):
            out = out + p[..., t:t + 1] * v[:, :, None, t]
    else:
        out = torch.einsum("bkgc,bkch->bkgh", p.float(),
                           v.float()).bfloat16()
    return out.reshape(B, 1, H * hd)
