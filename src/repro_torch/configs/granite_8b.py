"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch code model [arXiv:2405.04324; hf].
Copy of ``repro.configs.granite_8b`` on the port's ``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="granite-8b", n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=49152, norm="rms", ffn_kind="swiglu",
        rope_theta=10000.0, dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=96, norm="rms", ffn_kind="swiglu", mpd_c=4,
    )
