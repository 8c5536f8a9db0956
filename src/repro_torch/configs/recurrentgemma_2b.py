"""recurrentgemma-2b [hybrid] - RG-LRU + local attention, 1:2 attn:recurrent
[arXiv:2402.19427; hf]. 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000, local window 2048.

26 = 8 x (rglru, rglru, attn) + (rglru, rglru) tail - the Griffin pattern.
Sub-quadratic: runs the long_500k shape (recurrent state + 2k-window KV).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    attn_kind="local",
    local_window=2048,
    rope_kind="full",
    block_pattern=("rglru", "rglru", "attn"),
)
