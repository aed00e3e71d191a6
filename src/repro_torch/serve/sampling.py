"""Per-request token sampling (the port of ``repro.serve.sampling``, with
the speculative-decoding helpers ``policy_probs``, ``sample_from_probs``,
``propose_token`` and ``spec_accept``).

Greedy (``temperature == 0``) is exact: ``argmax``, first index on ties, as
``jnp.argmax``. Temperature and top-k draw Gumbel noise from a per-request
``torch.Generator`` seeded with the request's seed, so a request's stream
does not depend on which slot it lands in or who shares its batch. The
draws differ from ``jax.random``: sampled streams are compared by
distribution, never token by token. The acceptance arithmetic of
speculative decoding (:func:`accept_window`) takes its noise as arguments,
so a test can feed it the reference's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


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


def _uniform(n: int, generator: Optional[torch.Generator],
             device) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=device)


def gumbel(n: int, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """``n`` standard Gumbel draws from ``generator``."""
    u = _uniform(n, generator, device)
    return -torch.log(-torch.log(u.clamp_min(1e-20)))


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
    g = gumbel(v, generator, logits.device)
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


# --------------------------------------------------- speculative decoding
def policy_probs(logits: torch.Tensor, temperatures: torch.Tensor,
                 top_ks: torch.Tensor) -> torch.Tensor:
    """The sampling distribution as probabilities ``(..., V)``:
    ``softmax(top-k-masked logits / T)``; rows with ``temperature == 0``
    get the greedy one-hot. ``temperatures``/``top_ks`` are tensors of
    ``logits.shape[:-1]``. The rejection sampler needs ``p`` and ``q`` as
    numbers, not only draws."""
    v = logits.shape[-1]
    logits = logits.float()
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kk = torch.clamp(torch.where(top_ks > 0, top_ks, v) - 1, 0, v - 1)
    thresh = torch.gather(sorted_desc, -1, kk[..., None].long())
    masked = torch.where(logits >= thresh, logits,
                         torch.tensor(-torch.inf, device=logits.device))
    t = torch.clamp_min(temperatures.float(), 1e-6)[..., None]
    p = torch.softmax(masked / t, dim=-1)
    greedy = F.one_hot(torch.argmax(logits, dim=-1), v).float()
    return torch.where((temperatures <= 0.0)[..., None], greedy, p)


def sample_from_probs(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One token per row from explicit probabilities ``p (..., V)`` with
    the Gumbel noise ``g`` of the same shape (Gumbel-max on ``log p``;
    zero-probability entries never win)."""
    logp = torch.where(p > 0, torch.log(torch.clamp_min(p, 1e-38)),
                       torch.tensor(-torch.inf, device=p.device))
    return torch.argmax(logp + g, dim=-1)


def _policy_tensors(temperatures, top_ks, device):
    return (torch.tensor(list(temperatures), dtype=torch.float32,
                         device=device),
            torch.tensor(list(top_ks), dtype=torch.int64, device=device))


def _noise(draw, generators, temperatures, n: int, device) -> torch.Tensor:
    """``(B, n)`` noise rows from ``draw`` (:func:`_uniform` or
    :func:`gumbel`): each sampled row draws from its own generator, greedy
    rows get zeros (their result ignores it)."""
    return torch.stack([draw(n, g, device) if t > 0.0
                        else torch.zeros(n, device=device)
                        for t, g in zip(temperatures, generators)])


def propose_token(logits: torch.Tensor, temperatures: Sequence[float],
                  top_ks: Sequence[int],
                  generators: Sequence[Optional[torch.Generator]]):
    """The draft's proposal for one speculative position: ``(tokens (B,),
    q (B, V))``, ``q`` the distribution each token was drawn from (the
    one-hot for greedy rows, which propose the argmax)."""
    greedy_tok = torch.argmax(logits.float(), dim=-1)
    if all(t <= 0.0 for t in temperatures):
        return greedy_tok, F.one_hot(greedy_tok, logits.shape[-1]).float()
    temps, ks = _policy_tensors(temperatures, top_ks, logits.device)
    q = policy_probs(logits, temps, ks)
    g = _noise(gumbel, generators, temperatures, logits.shape[-1],
               logits.device)
    toks = sample_from_probs(q, g)
    return torch.where(temps <= 0.0, greedy_tok, toks), q


def _greedy_accept(target_logits, draft_tokens):
    """Greedy rows: the longest prefix where ``d_{i+1} == argmax(L_i)``,
    then ``argmax(L_n)``. Returns ``(tgt_greedy (B, k+1), n_greedy (B,))``."""
    k = draft_tokens.shape[1]
    tgt = torch.argmax(target_logits.float(), dim=-1)
    match = (draft_tokens == tgt[:, :k]).long()
    return tgt, torch.cumprod(match, dim=1).sum(dim=1)


def _window(draft_tokens, n, bonus):
    """``out[:, i]`` is the accepted draft token for ``i < n``, else the
    bonus (or resampled) token."""
    B, k = draft_tokens.shape
    idx = torch.arange(k + 1, device=draft_tokens.device)[None, :]
    d_pad = torch.cat([draft_tokens, draft_tokens.new_zeros((B, 1))], dim=1)
    return torch.where(idx < n[:, None], d_pad, bonus[:, None])


def accept_window(target_logits, draft_tokens, draft_probs, temperatures,
                  top_ks, u, g):
    """The acceptance arithmetic of :func:`spec_accept` with its noise as
    arguments: ``u (B, k)`` uniforms and ``g (B, V)`` Gumbel noise for the
    residual draw; ``temperatures``/``top_ks`` tensors ``(B,)``.

    Greedy rows accept the longest matching prefix and emit ``argmax(L_n)``
    (token-identical to target-only greedy). Sampled rows accept ``d`` while
    ``u * q(d) < p(d)`` and at the first rejection draw from
    ``normalize(max(p - q, 0))``; with every proposal accepted, from ``p_k``
    (``q := 0``). This preserves the target distribution exactly. Returns
    ``(out (B, k+1), n_accepted (B,))``; the step advances ``n + 1``."""
    B, kp1, V = target_logits.shape
    k = kp1 - 1
    rows = torch.arange(B, device=target_logits.device)
    p = policy_probs(target_logits, temperatures[:, None].expand(B, kp1),
                     top_ks[:, None].expand(B, kp1))
    tgt_greedy, n_greedy = _greedy_accept(target_logits, draft_tokens)
    d = draft_tokens[..., None].long()
    p_d = torch.gather(p[:, :k], -1, d)[..., 0]
    q_d = torch.gather(draft_probs, -1, d)[..., 0]
    accept = (u * q_d < p_d).long()
    n_samp = torch.cumprod(accept, dim=1).sum(dim=1)
    greedy_row = temperatures <= 0.0
    n = torch.where(greedy_row, n_greedy, n_samp)
    q_pad = torch.cat([draft_probs, draft_probs.new_zeros((B, 1, V))], dim=1)
    p_n, q_n = p[rows, n], q_pad[rows, n]
    r = torch.clamp_min(p_n - q_n, 0.0)
    rs = r.sum(dim=-1, keepdim=True)
    r = torch.where(rs > 0, r / torch.clamp_min(rs, 1e-38), p_n)
    bonus = torch.where(greedy_row, tgt_greedy[rows, n],
                        sample_from_probs(r, g))
    return _window(draft_tokens, n, bonus), n


def spec_accept(target_logits, draft_tokens, draft_probs,
                temperatures: Sequence[float], top_ks: Sequence[int],
                generators: Sequence[Optional[torch.Generator]]):
    """Variable-advance acceptance of one verify window. ``target_logits
    (B, k+1, V)`` (``[:, i]`` predicts the token after window position
    ``i``), ``draft_tokens (B, k)``, ``draft_probs (B, k, V)``; the policy
    per row on the host, and each sampled row's generator, which draws
    ``u`` then the residual's Gumbel noise. Returns ``(out (B, k+1),
    n_accepted (B,))`` as :func:`accept_window`; an all-greedy batch (the
    default serving policy) takes the greedy arithmetic alone."""
    if all(t <= 0.0 for t in temperatures):
        tgt, n = _greedy_accept(target_logits, draft_tokens)
        return _window(draft_tokens, n,
                       torch.gather(tgt, 1, n[:, None])[:, 0]), n
    dev = target_logits.device
    temps, ks = _policy_tensors(temperatures, top_ks, dev)
    u = _noise(_uniform, generators, temperatures, draft_tokens.shape[1], dev)
    g = _noise(gumbel, generators, temperatures, target_logits.shape[-1], dev)
    return accept_window(target_logits, draft_tokens, draft_probs, temps, ks,
                         u, g)
