"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
Copy of ``repro.configs.qwen2_vl_72b`` on the port's ``ModelConfig``.

The ViT vision tower is a stub: the model takes precomputed patch and
token embeddings (B, T, 8192) (``frontend="embed"``); the language
backbone with M-RoPE (temporal/height/width rotary sections 16/24/24 of
head_dim/2 = 64) is complete.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=29568, vocab=152064, norm="rms",
        rope="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
        frontend="embed", dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode, mpd_min_block=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=96, norm="rms", rope="mrope", mrope_sections=(4, 2, 2),
        frontend="embed", mpd_c=4,
    )
