"""Model configuration and shared building blocks for the architecture zoo.

The numerics helpers (``rms_norm``, RoPE, ``dense_init``) serve every
family of :mod:`repro_torch.models.lm`. The sharding hints
(``replicate_for_gather``, ``shard_activations``, ``batch_only``) act on
DTensors only: on plain tensors, as on one card, they return their input.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.parallel.sharding import to_placements


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers all ten assigned architectures (DESIGN.md SS.5)."""

    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention
    attn_kind: str = "full"      # full | local
    local_window: int = 2048
    rope_kind: str = "full"      # full | 2d | none
    qkv_bias: bool = False
    mlp_act: str = "swiglu"      # swiglu | geglu | gelu

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_dense_ff: int = 0        # arctic: dense residual MLP alongside MoE
    moe_dispatch_blocks: int = 1  # launcher sets = data-parallel size
    # DeepSeekMoE (each default keeps the capacity-limited top-k layer):
    moe_d_ff: int = 0            # expert width (0: d_ff)
    moe_shared_ff: int = 0       # shared experts' SwiGLU width (0: none)
    # "topk_softmax": softmax over the top-k logits (renormalised), a
    # capacity limit; "softmax_topk": DeepSeekMoE, softmax over every
    # expert in fp32, then greedy top-k of those weights, not
    # renormalised, no token dropped (the two fields below need it)
    moe_router: str = "topk_softmax"
    # (first, count) of the routed experts this card holds; None: all.
    # The router keeps its n_experts outputs; the layer computes the
    # held experts' part of the result
    moe_held: Optional[Tuple[int, int]] = None
    first_dense_layers: int = 0  # leading blocks with a dense d_ff FFN

    # MLA, multi-head latent attention (kv_lora_rank > 0 makes every
    # attention block MLA): queries of qk_nope_dim + qk_rope_dim a head,
    # keys and values from a kv_lora_rank latent, one roped key of
    # qk_rope_dim shared by the heads, values of v_head_dim
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # YaRN RoPE scaling (yarn_factor 0: plain RoPE)
    yarn_factor: float = 0.0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_original_len: int = 4096
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    # hybrid / ssm block pattern, repeated through depth:
    #   "attn" | "rglru" | "mlstm" | "slstm"
    block_pattern: Tuple[str, ...] = ("attn",)

    # enc-dec
    n_encoder_layers: int = 0    # >0 => encoder-decoder
    enc_len_divisor: int = 1     # encoder frames = seq_len // divisor

    # modality frontend stub: none | patch | frames
    frontend: str = "none"
    n_prefix_embeds: int = 0     # vlm: patch embeddings prepended

    # numerics / compile hygiene
    dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: bool = True
    # activation batch-dim sharding hint (mesh axis names); set by the
    # launcher. Without it SPMD flip-flops layouts between FSDP-sharded
    # params and replicates multi-GiB FFN transients.
    act_dp_axes: Optional[Tuple[str, ...]] = None

    # serving: HH-PIM tier fractions (hp_bf16, hp_int8, lp_bf16, lp_int8)
    tier_fractions: Optional[Tuple[float, float, float, float]] = None

    def __post_init__(self):
        if self.moe_router not in ("topk_softmax", "softmax_topk"):
            raise ValueError(f"moe_router {self.moe_router!r}")
        if self.moe_router == "topk_softmax" and (
                self.moe_held is not None or self.moe_shared_ff):
            raise ValueError("moe_held and moe_shared_ff are DeepSeekMoE's: "
                             "they need moe_router='softmax_topk'")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def held_experts(self) -> Tuple[int, int]:
        """(first, count) of the routed experts held here."""
        return self.moe_held or (0, self.n_experts)

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_subquadratic(self) -> bool:
        """True if decode state does not grow linearly with full context
        (SSM / hybrid-with-local-attention)."""
        return all(k in ("rglru", "mlstm", "slstm") or
                   (k == "attn" and self.attn_kind == "local")
                   for k in self.block_pattern)

    def pattern_for_depth(self) -> Tuple[str, ...]:
        p = []
        while len(p) < self.n_layers:
            p.extend(self.block_pattern)
        return tuple(p[: self.n_layers])


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, 4)
    base = dict(
        n_layers=min(cfg.n_layers, len(cfg.block_pattern) * 2),
        d_model=64, n_heads=heads, n_kv_heads=kv, d_ff=128,
        vocab_size=512, head_dim=16, local_window=16,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_dense_ff=64 if cfg.moe_dense_ff else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_prefix_embeds=4 if cfg.n_prefix_embeds else 0,
        dtype=torch.float32, scan_layers=False, remat=False,
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)


# ---------------------------------------------------------------------------
# numerics helpers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def _rope_freqs(hd: int, theta: float = 10000.0,
                device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude correction, 0.1 mscale ln(factor) + 1 (1 at
    factor <= 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_freqs(dim: int, cfg: ModelConfig, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """YaRN's (dim/2,) frequencies, as DeepSeek-V2's rotary embedding
    computes them: the plain frequencies where a pair turns more than
    ``beta_fast`` times over the original context, those divided by the
    factor where it turns fewer than ``beta_slow`` times, a linear ramp
    between."""
    def corr(rot: float) -> float:
        return (dim * math.log(cfg.yarn_original_len / (rot * 2 * math.pi))
                / (2 * math.log(theta)))
    lo = max(math.floor(corr(cfg.yarn_beta_fast)), 0)
    hi = min(math.ceil(corr(cfg.yarn_beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    extra = _rope_freqs(dim, theta, device)
    inter = 1.0 / (cfg.yarn_factor * theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_freqs(dim: int, cfg: ModelConfig, device=None) -> torch.Tensor:
    """The (dim/2,) rotary frequencies of ``cfg``: YaRN's where it sets a
    factor, else the plain ones."""
    if cfg.yarn_factor:
        return yarn_freqs(dim, cfg, device=device)
    return _rope_freqs(dim, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               kind: str = "full", freqs: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, hd); positions: (B, S).

    kind="full": rotate all hd dims; kind="2d": ChatGLM-style - rotate only
    the first half of head_dim (two-dimensional RoPE), pass the rest through.
    ``freqs`` replaces the plain frequencies (YaRN's, :func:`rope_freqs`).
    """
    if kind == "none":
        return x
    hd = x.shape[-1]
    rot = hd if kind == "full" else hd // 2
    if freqs is None:
        freqs = _rope_freqs(rot, device=x.device)          # (rot/2,)
    ang = positions[..., None].float() * freqs             # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def dense_init(gen: torch.Generator, shape, in_axis: int = 0
               ) -> torch.Tensor:
    """Normal(0, 1/fan_in) fp32 weights on ``gen``'s device. Torch's and
    JAX's generators give different numbers from one seed: tests carry
    JAX's init across with ``lm.params_from_numpy``."""
    fan_in = shape[in_axis]
    return (torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=gen.device) / math.sqrt(fan_in))


# ---------------------------------------------------------------------------
# sharding hints (DTensors on a mesh; plain tensors pass through)
# ---------------------------------------------------------------------------


def replicate_for_gather(table: torch.Tensor, cfg: "ModelConfig"
                         ) -> torch.Tensor:
    """Explicitly all-gather a (sharded) lookup table before a token
    gather: one clean all-gather of the parameter instead of a gather
    from a d_model-sharded table and a reshard of its result."""
    if cfg.act_dp_axes is None or not isinstance(table, DTensor):
        return table
    return table.redistribute(table.device_mesh,
                              [Replicate()] * table.device_mesh.ndim)


def shard_activations(x: torch.Tensor, cfg: "ModelConfig",
                      *trailing) -> torch.Tensor:
    """Lay an activation's batch dim over the DP axes, every other dim
    whole (``trailing`` names the next dims' axes), as the JAX package's
    ``with_sharding_constraint``; a no-op on a plain tensor or when the
    launcher did not set ``act_dp_axes``."""
    if cfg.act_dp_axes is None or not isinstance(x, DTensor):
        return x
    spec = (cfg.act_dp_axes,) + tuple(trailing) + \
        (None,) * (x.ndim - 1 - len(trailing))
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


def batch_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor laid out with dim 0 as it is sharded now and every other
    dim whole; anything else as is. For work that is independent per row
    and folds other dims into one (attention folds batch and heads into
    one matmul batch dim, which DTensor cannot flatten while an inner dim
    of the fold is sharded)."""
    if not isinstance(x, DTensor):
        return x
    pl = [p if p == Shard(0) else Replicate() for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)
