"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every other layer
[arXiv:2403.19887; hf].

Period (8 layers, as published): attention at index 4, MoE at odd indices;
the Mamba state is O(1) in context length, the 4 attention layers keep
paged K/V. Copy of ``repro.configs.jamba_v0_1_52b`` on the port's
``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig

_PERIOD = ("mamba", "mamba_moe", "mamba", "mamba_moe",
           "attn", "mamba_moe", "mamba", "mamba_moe")


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=14336, vocab=65536, norm="rms", pattern=_PERIOD,
        moe_experts=16, moe_top_k=2, moe_d_ff=14336, rope="none",
        mamba_expand=2, dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=96, norm="rms", pattern=_PERIOD, moe_experts=4,
        moe_top_k=2, moe_d_ff=128, rope="none", mamba_expand=2, mpd_c=4,
    )
