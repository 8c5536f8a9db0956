"""Architecture registry: ``--arch <id>`` resolves here.

Each assigned architecture lives in its own module exporting ``CONFIG``;
``get_config(name)`` returns the full config, ``get_smoke_config(name)`` the
reduced same-family config used by CPU smoke tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig, reduced

ARCH_IDS: List[str] = [
    "recurrentgemma_2b",
    "qwen25_32b",
    "internlm2_1_8b",
    "chatglm3_6b",
    "phi3_medium_14b",
    "xlstm_1_3b",
    "pixtral_12b",
    "arctic_480b",
    "llama4_scout_17b_a16e",
    "seamless_m4t_medium",
    "deepseek_v2_lite",
]

# assignment ids (with dashes/dots) -> module names
ALIASES: Dict[str, str] = {
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen2.5-32b": "qwen25_32b",
    "internlm2-1.8b": "internlm2_1_8b",
    "chatglm3-6b": "chatglm3_6b",
    "phi3-medium-14b": "phi3_medium_14b",
    "xlstm-1.3b": "xlstm_1_3b",
    "pixtral-12b": "pixtral_12b",
    "arctic-480b": "arctic_480b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "deepseek-v2-lite": "deepseek_v2_lite",
    "DeepSeek-V2-Lite": "deepseek_v2_lite",
}


def canonical(name: str) -> str:
    return ALIASES.get(name, name)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    if hasattr(mod, "SMOKE_CONFIG"):
        return mod.SMOKE_CONFIG
    return reduced(mod.CONFIG)


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
