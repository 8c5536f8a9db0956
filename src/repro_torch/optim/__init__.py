from repro_torch.optim.adamw import Optimizer, OptimizerConfig, make_optimizer
__all__ = ["Optimizer", "OptimizerConfig", "make_optimizer"]
