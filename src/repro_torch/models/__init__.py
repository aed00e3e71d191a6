"""Model zoo of the port (attention family so far)."""

from .model import Model, ModelConfig, build

__all__ = ["Model", "ModelConfig", "build"]
