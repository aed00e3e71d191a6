"""Model zoo of the port (the attention and attention + MoE families)."""

from .model import Model, ModelConfig, build

__all__ = ["Model", "ModelConfig", "build"]
