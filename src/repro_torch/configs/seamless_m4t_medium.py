"""seamless-m4t-medium [audio] - encoder-decoder, multimodal
[arXiv:2308.11596; hf]. 12L d_model=1024 16H d_ff=4096 vocab=256206.

Encoder-decoder: 12 encoder + 12 decoder layers. The speech frontend is a
STUB per the assignment: ``input_specs()`` provides precomputed frame
embeddings (seq_len // 4 frames at ~50 Hz) as encoder input; the decoder is
an autoregressive text LM with cross-attention.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    mlp_act="gelu",
    n_encoder_layers=12,
    enc_len_divisor=4,
    frontend="frames",
)
