"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm (the OLMo signature) [arXiv:2402.00838; hf].
Copy of ``repro.configs.olmo_1b`` on the port's ``ModelConfig``."""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="olmo-1b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, norm="none", ffn_kind="swiglu",
        rope_theta=10000.0, dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmo-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=96, norm="none", ffn_kind="swiglu", mpd_c=4,
    )
