"""Tiered linear layers: the HH-PIM storage spaces realized on the card.

A weight matrix is split column-wise into per-tier segments according to
the placement LUT. The legacy (tpu/gpu pool) mapping is four segments
(hp_bf16 | hp_int8 | lp_bf16 | lp_int8): bf16 segments are the "SRAM"
tier (full-bandwidth reads); int8 segments are the "MRAM" tier (half
the HBM bytes, W8A8 through the pim_mac kernel). The hp/lp pools differ
in chips+clock in the energy model; functionally the math is identical,
so outputs are placement-invariant up to int8 quantization error.

A substrate can supply its own tier naming and formats via the
``formats`` mapping (see ``Substrate.tier_plan``): the CXL substrates
use int8/int8 tier pairs (e.g. hp_ddr_int8 | hp_cxl_int8 | ...), where
a placement change moves real weight columns between segments without
a format change, and the three-tier ``cxl-tier-3`` splits into one
int8 segment per pool (hbm_int8 | ddr_int8 | cxl_int8).

On CUDA tensors every int8 tier launches the ``pim_mac`` kernel
(:func:`repro_torch.kernels.pim_mac.ops.pim_matmul`); bf16 tiers stay a
plain ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import torch

from repro_torch.kernels.pim_mac.ops import pim_matmul
from repro_torch.quant.int8 import quantize_activations, quantize_per_channel

#: legacy tpu/gpu pool tier order; also the default split order
SPACES = ("hp_bf16", "hp_int8", "lp_bf16", "lp_int8")


def split_weight(w: torch.Tensor, counts: Dict[str, int],
                 formats: Optional[Mapping[str, str]] = None
                 ) -> Dict[str, dict]:
    """Split (d_in, d_out) columns into tier segments per ``counts``
    (columns per tier, summing to d_out). int8 tiers store (q, scale).

    Without ``formats`` the legacy 4-tier naming applies (``SPACES``
    order, ``*_int8`` names quantized). With ``formats`` (tier ->
    "bf16" | "int8") the split follows ``counts``' own (insertion)
    order - the substrate's ``tier_plan`` order.

    The serve engine splits every FFN matrix of one shape at once with
    the ``quant_split`` kernel (:mod:`repro_torch.kernels.quant_split`),
    whose plain version is this function of each matrix."""
    if sum(counts.values()) != w.shape[1]:
        raise ValueError(f"tier counts {counts} do not sum to the "
                         f"{w.shape[1]} columns of w")
    order = SPACES if formats is None else tuple(counts)
    segs: Dict[str, dict] = {}
    off = 0
    for name in order:
        n = counts.get(name, 0)
        seg = w[:, off:off + n]
        off += n
        fmt = (("int8" if name.endswith("int8") else "bf16")
               if formats is None else formats[name])
        if n == 0:
            segs[name] = {"empty": True}
        elif fmt == "int8":
            q, s = quantize_per_channel(seg, axis=0)
            segs[name] = {"q": q, "scale": s}
        else:
            segs[name] = {"w": seg.to(torch.bfloat16)}
    return segs


def tiered_matmul(x: torch.Tensor, segs: Dict[str, dict]) -> torch.Tensor:
    """x: (..., d_in) -> (..., d_out), concatenating tier outputs in
    the segments' split order (the dict's insertion order)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    outs = []
    xq = sx = None
    for seg in segs.values():
        if seg.get("empty"):
            continue
        if "q" in seg:                       # int8 tier (W8A8 kernel)
            if xq is None:
                xq, sx = quantize_activations(x2)
            y = pim_matmul(xq, seg["q"], sx, seg["scale"],
                           out_dtype=torch.float32)
        else:                                # bf16 tier
            y = (x2.to(torch.bfloat16) @ seg["w"]).float()
        outs.append(y)
    y = torch.cat(outs, dim=-1)
    return y.reshape(lead + (y.shape[-1],)).to(x.dtype)


def fractions_to_counts(d_out: int, placement: Dict[str, int],
                        total: int,
                        order: Sequence[str] = SPACES) -> Dict[str, int]:
    """Scale a global weight-count placement to one matrix's columns;
    ``order`` is the tier split order (last tier absorbs rounding)."""
    counts = {}
    acc = 0
    for name in order[:-1]:
        c = int(round(d_out * placement.get(name, 0) / max(total, 1)))
        c = min(c, d_out - acc)
        counts[name] = c
        acc += c
    counts[order[-1]] = d_out - acc
    return counts
