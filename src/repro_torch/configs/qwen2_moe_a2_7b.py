"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) expert d_ff=1408
vocab=151936, 60 routed experts top-4 + 4 shared (fused to one 5632-wide
gated FFN) [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].
Copy of ``repro.configs.qwen2_moe_a2_7b`` on the port's ``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=151936, norm="rms",
        pattern=("attn_moe",), moe_experts=60, moe_top_k=4, moe_d_ff=1408,
        moe_shared_d_ff=5632, moe_shared_gated=True, use_bias=False,
        moe_experts_pad=64,
        rope_theta=1e6, dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=96, norm="rms", pattern=("attn_moe",),
        moe_experts=8, moe_top_k=4, moe_d_ff=64, moe_shared_d_ff=128,
        moe_shared_gated=True, mpd_c=4,
    )
