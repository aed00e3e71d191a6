"""Norms, rotary encodings (RoPE and Qwen2-VL's M-RoPE) and embeddings
(the port of ``repro.models.layers``; no sharded embedding).

Numerics follow the reference: norms run in f32 (population variance) and
cast back; RoPE is half-split, with cos/sin in f32 and the product promoted
to f32 before the cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rmsnorm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layernorm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def nonparametric_layernorm(x, eps: float = 1e-5):
    """OLMo-style LN without learnable affine (arXiv:2402.00838)."""
    return layernorm(x, None, None, eps)


def init_norm(kind: str, dim: int, device=None):
    if kind == "rms":
        return {"w": torch.ones((dim,), device=device)}
    if kind == "ln":
        return {"w": torch.ones((dim,), device=device),
                "b": torch.zeros((dim,), device=device)}
    if kind == "none":
        return {}
    raise ValueError(kind)


def apply_norm(kind: str, params, x, eps: float = 1e-5):
    if kind == "rms":
        return rmsnorm(x, params["w"], eps)
    if kind == "ln":
        return layernorm(x, params["w"], params["b"], eps)
    if kind == "none":
        return nonparametric_layernorm(x, eps)
    raise ValueError(kind)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions, head_dim: int, theta: float = 10000.0):
    """positions: (..., T) int -> cos/sin of shape (..., T, head_dim/2)."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, T, H, D); cos/sin: (B, T, D/2) (broadcast over heads)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mrope_cos_sin(positions3, head_dim: int, sections=(16, 24, 24),
                  theta: float = 1_000_000.0):
    """Qwen2-VL's M-RoPE (arXiv:2409.12191): the rotary frequencies split
    into (temporal, height, width) sections, each rotated by its own row of
    ``positions3 (3, B, T)``. ``sections`` count half-dims and sum to
    ``head_dim / 2``. Returns cos/sin of shape ``(B, T, head_dim/2)``."""
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    freqs = rope_freqs(head_dim, theta, positions3.device)
    # each section's slots from its own position row (no host-made index:
    # a captured program may call this)
    parts, off = [], 0
    for row, n in zip(positions3, sections):
        parts.append(row[..., None].float() * freqs[off:off + n])
        off += n
    ang = torch.cat(parts, dim=-1)                       # (B, T, D/2)
    return torch.cos(ang), torch.sin(ang)


def init_embedding(generator: torch.Generator, vocab: int, dim: int,
                   dtype=torch.float32, device=None):
    t = torch.randn((vocab, dim), generator=generator, device=device,
                    dtype=torch.float32) * 0.02
    return {"table": t.to(dtype)}


def embed(params, ids):
    """Token embedding lookup."""
    return params["table"][ids]
