"""Per-request token sampling (the port of ``repro.serve.sampling``, without
the speculative-decoding helpers).

Greedy (``temperature == 0``) is exact: ``argmax``, first index on ties, as
``jnp.argmax``. Temperature and top-k draw Gumbel noise from a per-request
``torch.Generator`` seeded with the request's seed, so a request's stream
does not depend on which slot it lands in or who shares its batch. The
draws differ from ``jax.random``: sampled streams are compared by
distribution, never token by token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """``temperature == 0`` means greedy (``top_k`` and ``seed`` ignored);
    ``top_k == 0`` means no top-k truncation."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


def make_generator(seed: int, device) -> torch.Generator:
    """The request's own noise stream."""
    return torch.Generator(device=device).manual_seed(int(seed))


def sample_one(logits: torch.Tensor, temperature: float, top_k: int,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """One token from one row of logits ``(V,)`` (0-d int64 tensor)."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits)
    v = logits.shape[-1]
    k = top_k if 0 < top_k < v else v
    thresh = torch.topk(logits, k).values[-1]
    masked = torch.where(logits >= thresh, logits,
                         torch.tensor(-torch.inf, device=logits.device))
    # Gumbel-max: argmax(logits/T + g) ~ Categorical(softmax(logits/T))
    u = torch.rand(v, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(masked / max(temperature, 1e-6) + g)


def sample(logits: torch.Tensor, temperatures: Sequence[float],
           top_ks: Sequence[int],
           generators: Sequence[Optional[torch.Generator]]) -> torch.Tensor:
    """``logits (B, V)`` -> tokens ``(B,)`` int64 with per-row params.
    All-greedy batches (the default serving policy) are one ``argmax``."""
    if all(t <= 0.0 for t in temperatures):
        return torch.argmax(logits, dim=-1)
    return torch.stack([sample_one(logits[i], temperatures[i], top_ks[i],
                                   generators[i])
                        for i in range(logits.shape[0])])
