"""deepseek-v2-lite [moe] - MLA + DeepSeekMoE, 64 experts top-6 + 2 shared
[hf:deepseek-ai/DeepSeek-V2-Lite config.json; arXiv:2405.04434].
27L d_model=2048 16H, MLA (kv_lora_rank=512, qk_nope 128, qk_rope 64,
v 128, no q LoRA), YaRN RoPE (factor 40, beta 32/1, original 4096,
mscale = mscale_all_dim = 0.707), vocab=102400 untied, RMS eps 1e-6.
Layer 0 is a dense SwiGLU of 10,944; layers 1-26 are DeepSeekMoE: a
softmax router over 64 experts of width 1,408 in fp32, greedy top-6,
weights not renormalised (routed_scaling_factor 1), and two shared
experts, one SwiGLU of 2,816. 15.7 B parameters.

``CONFIG`` holds every expert. A card of an expert-parallel deployment
holds a share: ``moe_held=(first, count)``, e.g. (0, 16) for the first
of four cards (the benchmark's ``deepseek_v2_lite``), computes its held
experts' part of each MoE layer and the whole of everything else.
Serving needs ``scan_layers=False`` (the leading dense layer).
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek_v2_lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10_944,
    vocab_size=102_400,
    n_experts=64,
    experts_per_token=6,
    moe_d_ff=1408,
    moe_shared_ff=2 * 1408,
    moe_router="softmax_topk",
    first_dense_layers=1,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    yarn_factor=40.0,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_original_len=4096,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    norm_eps=1e-6,
    scan_layers=False,
)

# one dense layer and two MoE layers at toy widths; a quarter of the 16
# experts held, as a card of the benchmark's four-card deployment holds
SMOKE_CONFIG = ModelConfig(
    name="deepseek_v2_lite",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    n_experts=16,
    experts_per_token=6,
    moe_d_ff=32,
    moe_shared_ff=64,
    moe_router="softmax_topk",
    moe_held=(0, 4),
    first_dense_layers=1,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    yarn_factor=40.0,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_original_len=4096,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    norm_eps=1e-6,
    dtype=torch.float32,
    scan_layers=False,
    remat=False,
)
