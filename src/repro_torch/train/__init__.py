from repro_torch.train.step import make_train_step, default_optimizer_kind
__all__ = ["make_train_step", "default_optimizer_kind"]
