from .trainer import TrainConfig, Trainer, adam_optimizer  # noqa: F401
