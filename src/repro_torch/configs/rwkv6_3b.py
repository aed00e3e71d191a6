"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536 —
"Finch" data-dependent decay [arXiv:2404.05892; hf]; decode state is O(1)
in context length. Copy of ``repro.configs.rwkv6_3b`` on the port's
``ModelConfig``.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=8960, vocab=65536, norm="ln", pattern=("rwkv",),
        rwkv_head_dim=64, rope="none", dtype="bfloat16",
        mpd_c=mpd_c, mpd_mode=mpd_mode,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=128, vocab=96, norm="ln", pattern=("rwkv",), rwkv_head_dim=16,
        rope="none", mpd_c=4,
    )
