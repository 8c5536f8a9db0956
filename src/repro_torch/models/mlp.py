"""Feed-forward blocks: SwiGLU / GeGLU / GELU MLPs."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str
             ) -> Dict[str, torch.Tensor]:
    if act in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff)),
            "w_up": dense_init(gen, (d_model, d_ff)),
            "w_down": dense_init(gen, (d_ff, d_model)),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff)),
        "w_down": dense_init(gen, (d_ff, d_model)),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(dt)
        u = x @ p["w_up"].to(dt)
        g = F.silu(g) if act == "swiglu" else _gelu(g)
        return (g * u) @ p["w_down"].to(dt)
    u = _gelu(x @ p["w_up"].to(dt))
    return u @ p["w_down"].to(dt)


def init_mlp_cfg(gen: torch.Generator, cfg: ModelConfig
                 ) -> Dict[str, torch.Tensor]:
    return init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act)


def mlp_cfg(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mlp(p, x, cfg.mlp_act)
