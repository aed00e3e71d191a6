"""RWKV-6 "Finch" time mix and channel mix (the port of
``repro.models.rwkv``).

Recurrence per head (head_dim N), state ``S (N_k, N_v)`` in f32::

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

with the data-dependent decay ``w_t = exp(-exp(w0 + tanh(x̃_t A) B))``,
computed in f32 from an f32 cast of ``w0``, and token-shift interpolation
``x̃`` between ``x_t`` and ``x_{t-1}``. The eight projections (r, k, v, g,
o and the channel mix's k, v, r) are :class:`Linear` s, so they run on the
bdmm and masked-matmul kernels; the channel mix's squared ReLU and sigmoid
ride their epilogues. The decay LoRA (``wA``, ``wB``) is two plain
matmuls, as in the reference.

The reference scans the sequence with ``lax.scan`` over jnp ops, outside
any Pallas body; the port's scan is a loop of PyTorch ops over T, two
kernels a step, with everything that does not depend on the carried state
(``k_t^T v_t`` and the bonus ``r_t diag(u) k_t^T v_t``) computed for all T
at once: the same function, summed in another order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.policy import CompressionPolicy
from .linear import Linear

PROJ = ("wr", "wk", "wv", "wg", "wo", "ck", "cv", "cr")


def _last_valid(x, valid):
    """``x (B, T, D) -> (B, 1, D)``: the last token, or with ``valid (B,
    T)`` (a right-padded batch) each row's last real token."""
    if valid is None:
        return x[:, -1:]
    last = (valid.sum(1) - 1).long()
    return torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[2]))


def _shift(x, x_prev):
    """``x`` shifted right by one token, ``x_prev (B, 1, D)`` in front."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    d_model: int
    n_heads: int
    head_dim: int
    d_ff: int
    decay_lora: int = 64
    wr: Linear = None
    wk: Linear = None
    wv: Linear = None
    wg: Linear = None
    wo: Linear = None
    ck: Linear = None
    cv: Linear = None
    cr: Linear = None

    @staticmethod
    def make(policy: CompressionPolicy, d_model, d_ff, head_dim=64,
             decay_lora=64, seed_salt=0) -> "RWKVSpec":
        n_heads = d_model // head_dim

        def mk(i, a, b, kind):
            return Linear.make(policy, a, b, kind,
                               seed_salt=seed_salt * 11 + i)
        D = d_model
        return RWKVSpec(
            d_model, n_heads, head_dim, d_ff, decay_lora,
            wr=mk(0, D, D, "ssm_proj"), wk=mk(1, D, D, "ssm_proj"),
            wv=mk(2, D, D, "ssm_proj"), wg=mk(3, D, D, "ssm_proj"),
            wo=mk(4, D, D, "ssm_proj"),
            ck=mk(5, D, d_ff, "mlp"), cv=mk(6, d_ff, D, "mlp"),
            cr=mk(7, D, D, "mlp"))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """The reference's leaves: the projections, the token-shift mixes
        (``mix (5, D)`` for r, k, v, g, w; ``mix_c (2, D)``) uniform in [0,
        1), the decay LoRA ``wA (D, L)`` / ``wB (L, D)`` normal at fan-in
        scale, the deterministic ``w0``, ``u`` zeros and the group-norm
        gain ``ln_x`` ones, all in ``dtype``."""
        D, H, N, L = self.d_model, self.n_heads, self.head_dim, self.decay_lora
        p = {k: getattr(self, k).init(generator, dtype, device) for k in PROJ}

        def draw(fn, shape, scale=1.0):
            t = fn(shape, generator=generator, device=device,
                   dtype=torch.float32)
            return (t * scale if scale != 1.0 else t).to(dtype)
        p["mix"] = draw(torch.rand, (5, D))
        p["mix_c"] = draw(torch.rand, (2, D))
        p["wA"] = draw(torch.randn, (D, L), float(1 / np.sqrt(D)))
        p["wB"] = draw(torch.randn, (L, D), float(1 / np.sqrt(L)))
        w0 = np.log(np.exp(np.linspace(-6.0, -0.3, D)) + 1e-9)
        p["w0"] = torch.as_tensor(w0.astype(np.float32), device=device).to(
            dtype)
        p["u"] = torch.zeros((H, N), dtype=dtype, device=device)
        p["ln_x"] = torch.ones((D,), dtype=dtype, device=device)
        return p

    # ---------------------------------------------------------- time mix
    def _branches(self, params, x, x_prev):
        """The token-shifted branch inputs through their projections:
        ``r, k, v (B, T, H, N)``, the silu gate ``g (B, T, D)`` and the
        decay ``w (B, T, H, N)`` in f32."""
        xs = _shift(x, x_prev)
        mix = params["mix"]
        xr, xk, xv, xg, xw = [x * mix[i] + xs * (1 - mix[i])
                              for i in range(5)]
        B, T, D = x.shape
        H, N = self.n_heads, self.head_dim
        r = self.wr.apply(params["wr"], xr).reshape(B, T, H, N)
        k = self.wk.apply(params["wk"], xk).reshape(B, T, H, N)
        v = self.wv.apply(params["wv"], xv).reshape(B, T, H, N)
        g = self.wg.apply(params["wg"], xg, activation="silu")
        w = torch.exp(-torch.exp(
            params["w0"].float()
            + torch.tanh(xw @ params["wA"]) @ params["wB"])).reshape(
                B, T, H, N)
        return r, k, v, g, w

    def time_mix(self, params, x, state, x_prev, valid=None):
        """``x (B, T, D)``, ``state (B, H, N, N)`` f32, ``x_prev (B, 1,
        D)``; returns ``(y, new_state, new_x_prev)`` as new tensors (the
        inputs are only read). ``valid (B, T)`` marks the real tokens of a
        right-padded batch: the state freezes at padded steps and the
        token-shift carry is each row's last real token, so the state
        returned is an unpadded run's."""
        B, T, D = x.shape
        r, k, v, g, w = self._branches(params, x, x_prev)
        y, S = self._scan(r, k, v, w, params["u"], state, valid)
        y = y.to(x.dtype)                                      # (B,T,H,N)
        # per-head group norm (statistics in f32, as jnp's mean and var of
        # a bf16 array), then the gate and the output projection
        yf = y.float()
        mu = yf.mean(-1, keepdim=True).to(y.dtype)
        var = yf.var(-1, keepdim=True, correction=0).to(y.dtype)
        y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, D)
        y = y * params["ln_x"] * g
        return self.wo.apply(params["wo"], y), S, _last_valid(x, valid)

    @staticmethod
    def _scan(r, k, v, w, u, S, valid=None):
        """The time scan in f32: ``(y (B, T, H, N), final S)`` from ``r, k,
        v, w (B, T, H, N)`` and ``S (B, H, N, N)``; ``S`` freezes where
        ``valid`` is False. Two kernels a step: ``y_t = r_t S_{t-1}`` (one
        batched product) and ``S_t = kv_t + w_t S_{t-1}`` (one fused
        multiply-add); the bonus term ``r_t diag(u) k_t^T v_t`` is summed
        for all T at once, and a padded step gets ``w = 1, kv = 0``, which
        leaves ``S`` as it is bit for bit."""
        B, T, H, N = r.shape
        rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
        bonus = (rf * u.float() * kf).sum(-1, keepdim=True) * vf
        # step-major layouts, so every step reads contiguous slices
        rT = rf.transpose(0, 1).unsqueeze(-2).contiguous()   # (T,B,H,1,N)
        kT, vT = kf.transpose(0, 1), vf.transpose(0, 1)
        kv = kT[..., :, None] * vT[..., None, :]              # (T,B,H,N,N)
        wT = wf.transpose(0, 1)[..., None]                   # (T,B,H,N,1)
        if valid is not None:
            v_t = valid.transpose(0, 1)[:, :, None, None, None]
            kv = torch.where(v_t, kv, torch.zeros_like(kv))
            wT = torch.where(v_t, wT, torch.ones_like(wT))
        wT = wT.contiguous()
        ys = []
        for t in range(T):
            ys.append(torch.matmul(rT[t], S))
            S = torch.addcmul(kv[t], wT[t], S)
        y = torch.stack(ys, dim=1)[..., 0, :]                # (B,T,H,N)
        return y + bonus, S

    # ------------------------------------------------------- channel mix
    def channel_mix(self, params, x, x_prev, valid=None):
        """Squared-ReLU channel mix with a sigmoid receptance; returns
        ``(y, new_x_prev)``."""
        xs = _shift(x, x_prev)
        mix = params["mix_c"]
        xk = x * mix[0] + xs * (1 - mix[0])
        xr = x * mix[1] + xs * (1 - mix[1])
        k = self.ck.apply(params["ck"], xk, activation="sqrelu")
        r = self.cr.apply(params["cr"], xr, activation="sigmoid")
        return r * self.cv.apply(params["cv"], k), _last_valid(x, valid)

    def init_state(self, batch: int, dtype=torch.float32, device=None):
        """``S`` f32, the token-shift carries in ``dtype``."""
        return {
            "S": torch.zeros((batch, self.n_heads, self.head_dim,
                              self.head_dim), dtype=torch.float32,
                             device=device),
            "x_tm": torch.zeros((batch, 1, self.d_model), dtype=dtype,
                                device=device),
            "x_cm": torch.zeros((batch, 1, self.d_model), dtype=dtype,
                                device=device),
        }
