"""chatglm3-6b [dense] - 2d RoPE, GQA kv=2 [arXiv:2406.12793; hf].
28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3_6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab_size=65_024,
    rope_kind="2d",
)
