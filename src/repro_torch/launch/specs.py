"""Cells of the (architecture x shape) grid and the config used to
lower a full model.

Only what training needs is ported: ``SHAPES``, ``cell_is_applicable``
and ``dryrun_config``. The abstract params / decode state, the per-cell
input specs and the mesh they are laid out on (``abstract_*``,
``*_specs``, ``launch/mesh.py``) wait for the tooling slice, with the
dry-run that uses them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.models.common import ModelConfig

# shape id -> (seq_len, global_batch, step kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (assignment rule)."""
    if shape == "long_500k" and not cfg.is_subquadratic:
        return False, ("skipped: pure full-attention arch at 512k context "
                       "(assignment rule; noted in DESIGN.md)")
    return True, ""


def dryrun_config(cfg: ModelConfig, mesh=None) -> ModelConfig:
    """Full config tuned for lowering: bf16, scanned stacks, remat on;
    MoE dispatch blocked by the mesh's data-parallel extent and activation
    batch dims pinned to the DP axes. ``mesh.shape`` maps axis names to
    sizes; without a mesh (one card) nothing is blocked or pinned."""
    nb = 1
    dp_axes = []
    if mesh is not None:
        for ax in ("pod", "data"):
            if ax in mesh.shape:
                nb *= mesh.shape[ax]
                dp_axes.append(ax)
    return dataclasses.replace(cfg, dtype=torch.bfloat16, scan_layers=True,
                               remat=True, moe_dispatch_blocks=nb,
                               act_dp_axes=tuple(dp_axes) or None)
