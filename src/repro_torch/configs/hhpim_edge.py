"""The paper's own deployment point: a small edge LM served through the
HH-PIM tiered runtime (hp/lp x bf16/int8 weight segments, placement-driven).

The paper's benchmarks are TinyML CNNs (Table IV - see
``repro_torch.core.spaces.TINYML_MODELS``); for the LM-serving framework this
config is the equivalent-scale transformer (~125M params) with HH-PIM
tier placement enabled (``tier_fractions`` = init split, re-optimized per
time slice by the serving runtime).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="hhpim_edge",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=32_000,
    mlp_act="gelu",
    tier_fractions=(0.4, 0.24, 0.0, 0.36),   # paper's 16:9 HP:LP peak split
)
