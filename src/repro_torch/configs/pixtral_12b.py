"""pixtral-12b [vlm] - pixtral-ViT + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409; unverified].
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

The ViT frontend is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (n_prefix_embeds per sample) prepended to the
text sequence; loss is computed on text positions only.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="pixtral_12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131_072,
    frontend="patch",
    n_prefix_embeds=256,      # one 1024px image at 16x16 patches / 4
)
