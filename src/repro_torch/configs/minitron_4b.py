"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679; hf].
Copy of ``repro.configs.minitron_4b`` on the port's ``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="minitron-4b", n_layers=32, d_model=3072, n_heads=24,
        n_kv_heads=8, d_ff=9216, vocab=256000, norm="rms", ffn_kind="swiglu",
        rope_theta=10000.0, dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-smoke", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=192, vocab=160, norm="rms", ffn_kind="swiglu", mpd_c=4,
    )
