"""Model zoo configs (the layers themselves are not ported yet)."""
from repro_torch.models.common import ModelConfig, reduced

__all__ = ["ModelConfig", "reduced"]
