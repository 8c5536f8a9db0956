from repro_torch.parallel import sharding
__all__ = ["sharding"]
