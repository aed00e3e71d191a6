"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192, 128 routed experts top-1 + shared expert, MoE on alternating
layers (interleaved dense/MoE as in Llama-4)
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

The multimodal early-fusion frontend is out of assignment scope (text
backbone only); alternating ("attn", "attn_moe") reproduces the published
interleave and lands total params at ~400B with ~17B active.
Copy of ``repro.configs.llama4_maverick_400b_a17b`` on the port's
``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048, norm="rms",
        pattern=("attn", "attn_moe"), moe_experts=128, moe_top_k=1,
        moe_d_ff=8192, moe_shared_d_ff=8192, rope_theta=5e5,
        dtype="bfloat16", mpd_c=mpd_c, mpd_mode=mpd_mode, mpd_min_block=128,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=96, norm="rms", pattern=("attn", "attn_moe"),
        moe_experts=8, moe_top_k=1, moe_d_ff=128, moe_shared_d_ff=128,
        mpd_c=4,
    )
