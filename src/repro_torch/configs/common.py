"""Config registry of the port (``ARCHS`` / ``get_config`` of
``repro.configs.common``, restricted to the architectures ported so far:
the attention family and the attention + MoE family; hubert, qwen2-vl,
rwkv6 and jamba wait for their families)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.model import ModelConfig

ARCHS = ("olmo-1b", "granite-8b", "command-r-plus-104b", "minitron-4b",
         "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")

_MODULES = {
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "minitron-4b": "minitron_4b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
}


def get_module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = get_module(arch)
    cfg = mod.smoke() if smoke else mod.full()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
