"""Stand-in inputs for every (architecture x shape) cell, and the config
used to lower a full model.

``abstract_params``, ``abstract_decode_state``, ``train_batch_specs``
and ``decode_token_specs`` return fake tensors (``FakeTensorMode``): the
tree, shapes and dtypes that the JAX package's ``jax.eval_shape`` /
``ShapeDtypeStruct`` stand-ins have, on the requested device, with no
memory behind them. They are made under the fake mode the caller has
entered, or a fresh one, so that a dry run keeps all its stand-ins in
one mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.device import resolve as resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.parallel.sharding import axis_sizes
from repro_torch.tree import tree_map

PyTree = Any

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


def _fake():
    """The caller's fake mode if one is active (re-entering it is a
    no-op), else a fresh one."""
    mode = active_fake_mode()
    return contextlib.nullcontext() if mode is not None \
        else FakeTensorMode()


def _sds(shape, dtype, dev: torch.device) -> torch.Tensor:
    with _fake():
        return torch.empty(shape, dtype=dtype, device=dev)


def train_batch_specs(cfg: ModelConfig, seq: int, batch: int,
                      device=DEFAULT_DEVICE) -> PyTree:
    """Batch tree stand-in for one train/prefill step."""
    dev = resolve_device(device)
    s_text = seq - (cfg.n_prefix_embeds or 0)
    out = {
        "tokens": _sds((batch, s_text), torch.int32, dev),
        "labels": _sds((batch, s_text), torch.int32, dev),
    }
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = _sds((batch, cfg.n_prefix_embeds,
                                     cfg.d_model), cfg.dtype, dev)
    if cfg.is_encdec:
        out["enc_frames"] = _sds(
            (batch, max(seq // cfg.enc_len_divisor, 1), cfg.d_model),
            cfg.dtype, dev)
    return out


def abstract_params(cfg: ModelConfig, serve_dtype=None,
                    device=DEFAULT_DEVICE) -> PyTree:
    """Abstract param tree; ``serve_dtype`` casts float leaves (inference
    residency format - bf16 serving halves HBM bytes vs f32 master)."""
    dev = resolve_device(device)
    with _fake():
        tree = lm.init_lm(torch.Generator(dev).manual_seed(0), cfg)
        if serve_dtype is None:
            return tree
        return tree_map(lambda x: x.to(serve_dtype)
                        if x.is_floating_point() else x, tree)


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                          device=DEFAULT_DEVICE) -> PyTree:
    dev = resolve_device(device)
    with _fake():
        enc = None
        if cfg.is_encdec:
            enc_len = max(max_len // cfg.enc_len_divisor, 1)
            enc = torch.empty((batch, enc_len, cfg.d_model),
                              dtype=cfg.dtype, device=dev)
        return lm.init_decode_state(cfg, batch, max_len, enc_out=enc,
                                    device=dev)


def decode_token_specs(batch: int, device=DEFAULT_DEVICE
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    return _sds((batch,), torch.int32, dev), _sds((), torch.int32, dev)


def dryrun_config(cfg: ModelConfig, mesh=None) -> ModelConfig:
    """Full config tuned for lowering: bf16, scanned stacks, remat on;
    MoE dispatch blocked by the mesh's data-parallel extent and activation
    batch dims pinned to the DP axes. ``mesh`` is a ``DeviceMesh`` or
    has a ``.shape`` mapping axis names to sizes; without a mesh (one
    card) nothing is blocked or pinned."""
    nb = 1
    dp_axes = []
    if mesh is not None:
        sizes = axis_sizes(mesh)
        for ax in ("pod", "data"):
            if ax in sizes:
                nb *= sizes[ax]
                dp_axes.append(ax)
    return dataclasses.replace(cfg, dtype=torch.bfloat16, scan_layers=True,
                               remat=True, moe_dispatch_blocks=nb,
                               act_dp_axes=tuple(dp_axes) or None)
