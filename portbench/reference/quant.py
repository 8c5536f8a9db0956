"""The serve engine's weight tiers, worked out again: a placement's
share of the model's weights scaled to one matrix's columns, the columns
split in the tier plan's order, int8 tiers quantized symmetrically per
column (round half to even, scale = max |w| / 127, at least 1e-8 / 127),
bf16 tiers rounded to bfloat16."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def model_spec_params(c: dict) -> int:
    """The weights a placement divides: every layer's FFN (three
    matrices of SwiGLU) and four d x d attention matrices."""
    d, L = c["d_model"], c["n_layers"]
    return L * 3 * d * c["d_ff"] + L * 4 * d * d


def counts(d_out: int, placement: Dict[str, int], total: int,
           plan: Sequence[Tuple[str, str, str]]) -> Dict[str, int]:
    """Columns per tier; the last tier takes what rounding leaves."""
    share = {tier: placement.get(space, 0) for space, tier, _ in plan}
    order = [tier for _, tier, _ in plan]
    out, acc = {}, 0
    for name in order[:-1]:
        n = min(int(round(d_out * share[name] / max(total, 1))), d_out - acc)
        out[name] = n
        acc += n
    out[order[-1]] = d_out - acc
    return out


def quantize(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = amax.clamp_min(1e-8) / torch.full_like(amax, 127.0)
    q = torch.round(w / scale).clamp_(-127, 127)
    return q.to(torch.int8), scale.squeeze(0)


def mismatches(w: torch.Tensor, placement: Dict[str, int], total: int,
               plan: Sequence[Tuple[str, str, str]], segs: dict) -> int:
    """Elements of ``segs`` (tier -> {"q", "scale"} or {"w"}) that differ
    from the reference's split of ``w`` (d_in, d_out) float32."""
    n_cols = counts(w.shape[1], placement, total, plan)
    bad, off = 0, 0
    for _, tier, fmt in plan:
        n = n_cols[tier]
        seg = w[:, off:off + n].float()
        off += n
        got = segs.get(tier, {})
        if n == 0:
            bad += sum(t.numel() for t in got.values())
            continue
        if fmt == "int8":
            q, s = quantize(seg)
            for name, want in (("q", q), ("scale", s)):
                have = got.get(name)
                bad += (want.numel() if have is None or
                        have.shape != want.shape
                        else int((have != want).sum()))
        else:
            want = seg.to(torch.bfloat16)
            have = got.get("w")
            bad += (want.numel() if have is None or have.shape != want.shape
                    else int((have != want).sum()))
    return bad
