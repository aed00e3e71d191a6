"""Training of the port (single device)."""

from .loop import TrainConfig, make_train_step, run, setup

__all__ = ["TrainConfig", "make_train_step", "run", "setup"]
