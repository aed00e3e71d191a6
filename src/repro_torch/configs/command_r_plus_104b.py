"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01; unverified].
Copy of ``repro.configs.command_r_plus_104b`` on the port's ``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv_heads=8, d_ff=33792, vocab=256000, norm="ln", ffn_kind="swiglu",
        use_bias=False, rope_theta=75000.0, dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode, mpd_min_block=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=264, vocab=128, norm="ln", ffn_kind="swiglu", mpd_c=4,
    )
