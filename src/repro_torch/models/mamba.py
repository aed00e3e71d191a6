"""Mamba (S6) selective state-space block of the Jamba hybrid (the port of
``repro.models.mamba``)::

    h_t = exp(A Δ_t) h_{t-1} + Δ_t B_t x_t         h: (d_inner, d_state), f32
    y_t = C_t · h_t + D x_t

The in, x, dt and out projections are :class:`Linear` s on the bdmm and
masked-matmul kernels; ``dt``'s softplus and its extra bias ``dt_bias``
ride ``w_dt``'s epilogue. The causal depthwise conv, the gates and the
scan are plain PyTorch, as the reference's are jnp: the reference scans
with ``lax.scan`` outside any Pallas body, the port loops over T, two or
three kernels a step, with ``exp(A Δ_t)`` and ``Δ_t B_t x_t`` computed
for all T at once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.policy import CompressionPolicy
from .linear import Linear

PROJ = ("w_in", "w_x", "w_dt", "w_out")


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0
    w_in: Linear = None    # D -> 2 * d_inner (x | z)
    w_x: Linear = None     # d_inner -> dt_rank + 2 * d_state
    w_dt: Linear = None    # dt_rank -> d_inner
    w_out: Linear = None   # d_inner -> D

    @staticmethod
    def make(policy: CompressionPolicy, d_model, expand=2, d_state=16,
             d_conv=4, seed_salt=0) -> "MambaSpec":
        d_inner = expand * d_model
        dt_rank = max(1, d_model // 16)

        def mk(i, a, b):
            return Linear.make(policy, a, b, "ssm_proj",
                               seed_salt=seed_salt * 13 + i)
        return MambaSpec(
            d_model, d_inner, d_state, d_conv, dt_rank,
            w_in=mk(0, d_model, 2 * d_inner),
            w_x=mk(1, d_inner, dt_rank + 2 * d_state),
            w_dt=mk(2, dt_rank, d_inner),
            w_out=mk(3, d_inner, d_model))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """The reference's leaves: the projections, ``conv (d_conv,
        d_inner)`` normal at scale ``1/sqrt(d_conv)``, ``conv_b`` and
        ``dt_bias`` zeros, ``D`` ones (all in ``dtype``) and ``A_log =
        log(1 .. d_state)`` per channel in f32."""
        di, ds, dc = self.d_inner, self.d_state, self.d_conv
        p = {k: getattr(self, k).init(generator, dtype, device) for k in PROJ}
        conv = torch.randn((dc, di), generator=generator, device=device,
                           dtype=torch.float32)
        p["conv"] = (conv * float(1 / np.sqrt(dc))).to(dtype)
        p["conv_b"] = torch.zeros((di,), dtype=dtype, device=device)
        p["A_log"] = torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=device)).expand(
                di, ds).contiguous()
        p["D"] = torch.ones((di,), dtype=dtype, device=device)
        p["dt_bias"] = torch.zeros((di,), dtype=dtype, device=device)
        return p

    def _ssm_inputs(self, params, xc):
        """``xc (B, T, d_inner)`` post-conv activations -> ``(dt, Bm, Cm)``;
        softplus and ``dt_bias`` in ``w_dt``'s epilogue."""
        proj = self.w_x.apply(params["w_x"], xc)
        r, s = self.dt_rank, self.d_state
        dt, Bm, Cm = proj[..., :r], proj[..., r:r + s], proj[..., r + s:]
        dt = self.w_dt.apply(params["w_dt"], dt, activation="softplus",
                             extra_bias=params["dt_bias"])
        return dt, Bm, Cm

    def apply(self, params, x, state=None, valid=None):
        """``x (B, T, D)``; ``state`` ``{"conv": (B, d_conv - 1, d_inner),
        "h": (B, d_inner, d_state)}`` or None (zeros: a whole prompt).
        Returns ``(y, new_state)``, the state as new tensors (the input
        state is only read). ``valid (B, T)`` marks the real tokens of a
        right-padded batch: ``h`` freezes at padded steps and the conv
        window is gathered at each row's length, so the state returned is
        an unpadded run's (outputs at padded positions are garbage)."""
        B, T, D = x.shape
        di, ds, dc = self.d_inner, self.d_state, self.d_conv
        xz = self.w_in.apply(params["w_in"], x)
        xr, z = xz[..., :di], xz[..., di:]
        conv_state = (state["conv"].to(x.dtype) if state is not None
                      else torch.zeros((B, dc - 1, di), dtype=x.dtype,
                                       device=x.device))
        xpad = torch.cat([conv_state, xr], dim=1)       # causal depthwise conv
        conv = params["conv"]
        xc = xpad[:, 0:T] * conv[0]
        for i in range(1, dc):
            xc = xc + xpad[:, i:i + T] * conv[i]
        xc = F.silu(xc + params["conv_b"])
        if valid is None:
            new_conv = xpad[:, T:]                      # the last dc-1 inputs
        else:
            # xpad row j holds input j - (dc - 1): the window ending at a
            # row's last real token is rows len .. len + dc - 2
            idx = (valid.sum(1)[:, None]
                   + torch.arange(dc - 1, device=x.device)[None]).long()
            new_conv = torch.gather(xpad, 1, idx[..., None].expand(-1, -1, di))

        dt, Bm, Cm = self._ssm_inputs(params, xc)
        A = -torch.exp(params["A_log"].float())          # (di, ds)
        h = (state["h"].float() if state is not None
             else torch.zeros((B, di, ds), dtype=torch.float32,
                              device=x.device))
        y, h = self._scan(xc, dt, Bm, Cm, A, h, valid)
        y = y.to(x.dtype)                                # (B, T, di)
        y = y + xc * params["D"]
        y = y * F.silu(z)
        return self.w_out.apply(params["w_out"], y), {"conv": new_conv,
                                                       "h": h}

    @staticmethod
    def _scan(xc, dt, Bm, Cm, A, h, valid=None):
        """The selective scan in f32: ``(y (B, T, di), final h)`` from
        ``xc, dt (B, T, di)``, ``Bm, Cm (B, T, ds)`` and ``h (B, di, ds)``;
        ``h`` freezes where ``valid`` is False (``y`` there reads the
        unfrozen update, as the reference's). Two kernels a step (three
        with ``valid``): ``h_t = dBx_t + dA_t h_{t-1}`` (one fused
        multiply-add) and ``y_t = h_t C_t`` (one batched product), with
        ``dA = exp(dt A)`` and ``dBx = dt B x`` for all T at once."""
        xcf, dtf, Bf, Cf = (t.float() for t in (xc, dt, Bm, Cm))
        # step-major layouts, so every step reads contiguous slices
        dtT = dtf.transpose(0, 1)[..., None]                  # (T,B,di,1)
        dA = torch.exp(dtT * A).contiguous()                  # (T,B,di,ds)
        dBx = (dtT * Bf.transpose(0, 1)[:, :, None, :]
               * xcf.transpose(0, 1)[..., None]).contiguous()
        CT = Cf.transpose(0, 1)[..., None].contiguous()       # (T,B,ds,1)
        vT = None if valid is None else valid.transpose(0, 1)[:, :, None, None]
        ys = []
        for t in range(xc.shape[1]):
            h_new = torch.addcmul(dBx[t], dA[t], h)
            ys.append(torch.matmul(h_new, CT[t]))
            h = h_new if vT is None else torch.where(vT[t], h_new, h)
        return torch.stack(ys, dim=1)[..., 0], h

    def init_state(self, batch: int, dtype=torch.float32, device=None):
        """The conv window in ``dtype``, ``h`` in f32."""
        return {
            "conv": torch.zeros((batch, self.d_conv - 1, self.d_inner),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, self.d_inner, self.d_state),
                             dtype=torch.float32, device=device),
        }
