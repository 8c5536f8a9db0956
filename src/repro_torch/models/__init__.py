"""Model zoo of the port: configs and the dense decoder family
(``lm``, ``attention``, ``mlp``) plus the tiered linear layers of the
serving runtime (``hetero_linear``)."""
from repro_torch.models.common import ModelConfig, reduced

__all__ = ["ModelConfig", "reduced"]
