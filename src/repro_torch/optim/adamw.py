"""AdamW with optional bf16 moments, plus Adafactor - functions over
param trees.

The same optimizers, state trees and arithmetic as the JAX package: the
learning rate, the bias corrections and Adafactor's decay are fp32
tensors, and every tree is walked in the reference's leaf order
(:mod:`repro_torch.tree`), so ``global_norm`` adds the leaves in the
same order.

``update`` writes the new params and moments into the tensors of
``params`` and ``state`` under ``torch.no_grad()`` and returns those
trees: the counterpart of the reference's buffer donation, it keeps one
copy of the params and moments alive, which is what lets a full-width
model train on one card. A caller that keeps the old params copies them
first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"          # adamw | adamw_bf16 | adamw_mp | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Any], Tuple[PyTree, PyTree]]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a tensor operand for a division: CUDA turns a division by a Python
    # scalar into a multiply by its rounded reciprocal, and torch
    # computes ``scalar / tensor`` as ``tensor.reciprocal() * scalar``;
    # either can differ from XLA's division in the last bit
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cosine_lr(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1),
                           step), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-12),
                       max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _clipped_f32(grads: PyTree, max_norm: float) -> Callable:
    """Per-leaf fp32 view of ``clip_by_global_norm(grads)``: the same
    values, without a clipped copy of the whole tree."""
    scale = _clip_scale(global_norm(grads), max_norm)
    return lambda g: (g.float() * scale).to(g.dtype).float()


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _step0(params: PyTree) -> torch.Tensor:
    return _zeros((), torch.int32, leaves(params)[0])


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    b1, b2 = cfg.b1, cfg.b2

    if cfg.kind == "adamw_mp":
        # ZeRO-1 mixed precision: compute params may be bf16; the f32
        # master copy and the moments live in the optimizer state
        def init(params):
            return {
                "master": tree_map(lambda p: p.float().clone(), params),
                "m": tree_map(lambda p: _zeros(p.shape, torch.float32, p),
                              params),
                "v": tree_map(lambda p: _zeros(p.shape, torch.float32, p),
                              params),
                "step": _step0(params),
            }

        @torch.no_grad()
        def update(grads, state, params, _step_unused=None):
            step = state["step"] + 1
            lr = cosine_lr(cfg, step)
            clipped = _clipped_f32(grads, cfg.grad_clip)
            bc1 = 1 - b1 ** step.float()
            bc2 = 1 - b2 ** step.float()

            def upd(p, g, w, m, v):
                g32 = clipped(g)
                m32 = b1 * m + (1 - b1) * g32
                v32 = b2 * v + (1 - b2) * g32 * g32
                delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
                if p.ndim >= 2:
                    delta = delta + cfg.weight_decay * w
                w_new = w - lr * delta
                p.copy_(w_new.to(p.dtype))
                w.copy_(w_new)
                m.copy_(m32)
                v.copy_(v32)

            tree_map(upd, params, grads, state["master"], state["m"],
                     state["v"])
            return params, {"master": state["master"], "m": state["m"],
                            "v": state["v"], "step": step}

        return Optimizer(init, update)

    if cfg.kind in ("adamw", "adamw_bf16"):
        mdt = torch.float32 if cfg.kind == "adamw" else torch.bfloat16

        def init(params):
            return {
                "m": tree_map(lambda p: _zeros(p.shape, mdt, p), params),
                "v": tree_map(lambda p: _zeros(p.shape, mdt, p), params),
                "step": _step0(params),
            }

        @torch.no_grad()
        def update(grads, state, params, _step_unused=None):
            step = state["step"] + 1
            lr = cosine_lr(cfg, step)
            clipped = _clipped_f32(grads, cfg.grad_clip)
            bc1 = 1 - b1 ** step.float()
            bc2 = 1 - b2 ** step.float()

            def upd(p, g, m, v):
                g32 = clipped(g)
                m32 = b1 * m.float() + (1 - b1) * g32
                v32 = b2 * v.float() + (1 - b2) * g32 * g32
                mh = m32 / bc1
                vh = v32 / bc2
                delta = mh / (torch.sqrt(vh) + cfg.eps)
                if p.ndim >= 2:   # decoupled weight decay on matrices only
                    delta = delta + cfg.weight_decay * p.float()
                p.copy_((p.float() - lr * delta).to(p.dtype))
                m.copy_(m32.to(mdt))
                v.copy_(v32.to(mdt))

            tree_map(upd, params, grads, state["m"], state["v"])
            return params, {"m": state["m"], "v": state["v"], "step": step}

        return Optimizer(init, update)

    if cfg.kind == "adafactor":
        # factored second moment: vr (row) / vc (col) trees parallel to
        # params; 1-d params keep a full accumulator in vr (vc is a dummy).
        def init(params):
            vr = tree_map(lambda p: _zeros(
                p.shape[:-1] if p.ndim >= 2 else p.shape, torch.float32, p),
                params)
            vc = tree_map(lambda p: _zeros(
                p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,),
                torch.float32, p), params)
            return {"vr": vr, "vc": vc, "step": _step0(params)}

        @torch.no_grad()
        def update(grads, state, params, _step_unused=None):
            step = state["step"] + 1
            lr = cosine_lr(cfg, step)
            clipped = _clipped_f32(grads, cfg.grad_clip)
            decay = 1.0 - step.float() ** -0.8

            def upd(p, g, vr, vc):
                g32 = clipped(g)
                g2 = g32 * g32 + 1e-30
                if p.ndim >= 2:
                    vr_n = decay * vr + (1 - decay) * g2.mean(dim=-1)
                    vc_n = decay * vc + (1 - decay) * g2.mean(dim=-2)
                    denom = vr_n.mean(dim=-1, keepdim=True)
                    vhat = (vr_n[..., None] * vc_n[..., None, :]
                            / torch.clamp(denom[..., None], min=1e-30))
                    upd_ = g32 / torch.sqrt(vhat + cfg.eps)
                    upd_ = upd_ + cfg.weight_decay * p.float()
                    vc.copy_(vc_n)
                else:
                    vr_n = decay * vr + (1 - decay) * g2
                    upd_ = g32 / torch.sqrt(vr_n + cfg.eps)
                p.copy_((p.float() - lr * upd_).to(p.dtype))
                vr.copy_(vr_n)

            tree_map(upd, params, grads, state["vr"], state["vc"])
            return params, {"vr": state["vr"], "vc": state["vc"],
                            "step": step}

        return Optimizer(init, update)

    raise ValueError(cfg.kind)
