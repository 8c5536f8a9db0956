"""internlm2-1.8b [dense] - GQA [arXiv:2403.17297; hf].
24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internlm2_1_8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
)
