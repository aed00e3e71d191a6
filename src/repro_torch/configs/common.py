"""Config registry of the port (``ARCHS`` / ``get_config`` of
``repro.configs.common``): every architecture of the reference, the
attention, attention + MoE, RWKV and Mamba hybrid families and the two
embed frontends (hubert-xlarge's encoder, qwen2-vl-72b's M-RoPE decoder),
in the reference's order."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.model import ModelConfig

ARCHS = ("hubert-xlarge", "olmo-1b", "granite-8b", "command-r-plus-104b",
         "minitron-4b", "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
         "rwkv6-3b", "qwen2-vl-72b", "jamba-v0.1-52b")

_MODULES = {
    "hubert-xlarge": "hubert_xlarge",
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "minitron-4b": "minitron_4b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "rwkv6-3b": "rwkv6_3b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def get_module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = get_module(arch)
    cfg = mod.smoke() if smoke else mod.full()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
