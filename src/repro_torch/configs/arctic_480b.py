"""arctic-480b [moe] - 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base; hf].
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.

Arctic's dense-MoE hybrid: every layer has a (small) dense residual MLP in
parallel with the 128-expert top-2 MoE (``moe_dense_ff``). This is the
paper-technique showcase arch: expert popularity is the dynamic "inference
load", and the HH-PIM placement LUT assigns cold experts to the LP/int8
tier (DESIGN.md SS.5).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="arctic_480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    n_experts=128,
    experts_per_token=2,
    moe_dense_ff=4864,
)
