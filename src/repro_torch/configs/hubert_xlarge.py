"""hubert-xlarge [audio]: 48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504.
Encoder-only (w2v2 architecture) [arXiv:2106.07447; unverified].
Copy of ``repro.configs.hubert_xlarge`` on the port's ``ModelConfig``.

The conv waveform frontend is a stub: the model takes precomputed frame
embeddings (B, T, 1280) (``frontend="embed"``). Encoder: no decode step.
"""

from repro_torch.models.model import ModelConfig


def full(mpd_c: int = 8, mpd_mode: str = "packed") -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", n_layers=48, d_model=1280, n_heads=16,
        n_kv_heads=16, d_ff=5120, vocab=504, norm="ln", ffn_kind="gelu",
        use_bias=True, causal=False, rope="rope", frontend="embed",
        dtype="bfloat16", mpd_c=mpd_c, mpd_mode=mpd_mode, mpd_min_block=8,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=56, norm="ln", ffn_kind="gelu", use_bias=True,
        causal=False, rope="rope", frontend="embed", mpd_c=4,
    )
