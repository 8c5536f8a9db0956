"""Architecture configs (assigned pool + the paper's own TinyML models)."""
from repro_torch.configs.registry import (ALIASES, ARCH_IDS, all_configs,
                                    canonical, get_config, get_smoke_config)

__all__ = ["ALIASES", "ARCH_IDS", "all_configs", "canonical", "get_config",
           "get_smoke_config"]
