"""Config registry of the port (``ARCHS`` / ``get_config`` of
``repro.configs.common``, restricted to the architectures ported so far)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.model import ModelConfig

ARCHS = ("olmo-1b",)

_MODULES = {"olmo-1b": "olmo_1b"}


def get_module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = get_module(arch)
    cfg = mod.smoke() if smoke else mod.full()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
