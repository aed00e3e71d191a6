"""Mixture-of-Experts with capacity-bounded dispatch, an optional shared
expert and MPD-compressed expert weights (the port of
``repro.models.moe``).

Routing follows the reference step for step: an f32 router over the
``n_experts`` routed experts, softmax, top-k, gates renormalised with
``+ 1e-9``; each routed (token, choice), taken token-major, gets the place
``pos`` in its expert from an integer cumsum over the one-hot assignment;
choices at or past the capacity ``C = max(1, ceil(t * K / n_experts *
capacity_factor))`` are dropped (Switch/GShard semantics), ``t`` being the
tokens of the call. The experts run on an ``(E, C, D)`` buffer,
``E = n_experts_padded``; padding experts get no traffic.

Where the reference scatter-adds every choice into the buffer (dropped ones
add zeros into its last row), the port gathers: each kept choice owns a
distinct buffer row, an inverse map built by a scatter without duplicate
indices names the token of every row, and rows no choice owns read a zero
row. No float atomics and no duplicate-index writes, so a replayed CUDA
graph equals the eager call bit for bit; the values are the reference's
(``0 + x == x``).

The routed-expert product is a plain ``torch.einsum`` / ``torch.bmm``, as it
is a plain ``jnp.einsum`` outside any Pallas body in the reference. The
router and the shared expert's gate are :class:`Linear` s of kind
``"head"`` (the policy decides whether they are packed); the shared expert
is an :class:`FFNSpec` (swiglu) on the bdmm routes.

MPD on experts: one mask per layer (paper: one mask per FC layer), shared
by every expert; the packed form stacks ``(E, nb, bi, bo)`` blocks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import fold as fold_lib
from repro_torch.core.mask import MaskSpec
from repro_torch.core.policy import CompressionPolicy
from .ffn import FFNSpec
from .linear import Linear


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matmuls at full f32 precision (never TF32) inside the block,
    whatever the caller set: a router logit rounded to TF32 can flip a
    top-k choice."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int               # per-expert hidden
    n_experts: int          # routed experts the router scores
    top_k: int
    n_experts_padded: int = 0  # physical expert count (>= n_experts)
    capacity_factor: float = 1.25
    gated: bool = True      # swiglu experts
    router: Linear = None
    # one MPD mask geometry shared by all experts of the layer
    mask_up: Optional[MaskSpec] = None
    mask_down: Optional[MaskSpec] = None
    mode: str = "packed"
    shared: Optional[FFNSpec] = None
    shared_gated: bool = False  # sigmoid gate on the shared branch
    w_shared_gate: Optional[Linear] = None

    @staticmethod
    def make(policy: CompressionPolicy, d_model, d_ff, n_experts, top_k,
             *, capacity_factor=1.25, d_ff_shared=0, shared_gated=False,
             mode="packed", seed_salt=0, n_experts_padded=0) -> "MoESpec":
        """The reference's seed salts: router ``7s``, up/gate mask
        ``7s + 1``, down mask ``7s + 2``, shared expert ``7s + 3``."""
        mask_up = policy.plan(d_model, d_ff, "moe_expert",
                              seed_salt=seed_salt * 7 + 1)
        mask_down = policy.plan(d_ff, d_model, "moe_expert",
                                seed_salt=seed_salt * 7 + 2)
        shared = w_sg = None
        if d_ff_shared:
            shared = FFNSpec.make(policy, d_model, d_ff_shared, "swiglu",
                                  seed_salt=seed_salt * 7 + 3)
            if shared_gated:
                w_sg = Linear.make(policy, d_model, 1, "head", seed_salt=0)
        return MoESpec(
            d_model, d_ff, n_experts, top_k,
            max(n_experts_padded, n_experts), capacity_factor, True,
            router=Linear.make(policy, d_model, n_experts, "head",
                               seed_salt=seed_salt * 7),
            mask_up=mask_up if mode != "dense" else None,
            mask_down=mask_down if mode != "dense" else None,
            mode=mode, shared=shared, shared_gated=shared_gated,
            w_shared_gate=w_sg)

    # ------------------------------------------------------------- params
    def _expert_shape(self, mask: Optional[MaskSpec], d_in, d_out):
        ep = self.n_experts_padded
        if mask is None or self.mode in ("dense", "masked_dense"):
            return (ep, d_in, d_out)
        return (ep, mask.nb, mask.block_in, mask.block_out)

    def expert_masks(self):
        """``(key, mask)`` of the three stacked expert weights."""
        return (("w_up", self.mask_up), ("w_gate", self.mask_up),
                ("w_down", self.mask_down))

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        """Normal init at the dense fan-in scale; a masked-dense expert
        stack is masked after the draw. The router is f32 in any model."""
        def expert_w(key, mask, d_in):
            d_out = self.d_model if key == "w_down" else self.d_ff
            w = torch.randn(self._expert_shape(mask, d_in, d_out),
                            generator=generator, device=device,
                            dtype=torch.float32) * float(1.0 / np.sqrt(d_in))
            w = w.to(dtype)
            if mask is not None and self.mode == "masked_dense":
                w = w * fold_lib.mask_tensor(mask, w.device)
            return w

        p = {"router": self.router.init(generator, torch.float32, device)}
        for key, mask in self.expert_masks():
            p[key] = expert_w(key, mask,
                              self.d_ff if key == "w_down" else self.d_model)
        if self.shared is not None:
            p["shared"] = self.shared.init(generator, dtype, device)
            if self.w_shared_gate is not None:
                p["shared_gate"] = self.w_shared_gate.init(generator, dtype,
                                                           device)
        return p

    # ------------------------------------------------------ expert matmuls
    def _expert_mm(self, x, w, mask: Optional[MaskSpec], activation=None):
        """``x (E, C, d_in)`` through every expert: ``w`` dense ``(E, d_in,
        d_out)`` (masked by ``mask`` on the masked-dense mode) or packed
        ``(E, nb, bi, bo)`` between the mask's pack and unpack gathers.
        ``activation`` applies before the unpack (it is elementwise)."""
        from repro_torch.kernels.ref import ACTIVATIONS
        act = ACTIVATIONS[activation]
        if mask is None or self.mode == "dense":
            return act(torch.bmm(x, w))
        if self.mode == "masked_dense":
            m = fold_lib.mask_tensor(mask, w.device).to(w.dtype)
            return act(torch.bmm(x, w * m))
        xp = fold_lib.pack_inputs(mask, x)
        E, C, _ = xp.shape
        xb = xp.reshape(E, C, mask.nb, mask.block_in)
        yb = act(torch.einsum("ecnk,enko->ecno", xb, w))
        return fold_lib.unpack_outputs(
            mask, yb.reshape(E, C, mask.nb * mask.block_out))

    def capacity(self, t: int) -> int:
        """Places per expert for a call of ``t`` tokens (host arithmetic on
        the reference's double-precision expression)."""
        return max(1, int(math.ceil(t * self.top_k / self.n_experts
                                    * self.capacity_factor)))

    def route(self, params, xf):
        """The router's decision for ``xf (t, D)``: ``(probs (t,
        n_experts) f32, gates (t*K,) f32, ids (t*K,), slot (t*K,), keep
        (t*K,) bool, onehot (t*K, E))``, choices token-major; ``slot`` is
        ``expert * C + pos`` for a kept choice and ``E * C - 1`` for a
        dropped one."""
        t = xf.shape[0]
        E, K = self.n_experts_padded, self.top_k
        C = self.capacity(t)
        with full_f32_matmul():
            logits = self.router.apply(params["router"], xf.float())
        probs = torch.softmax(logits, dim=-1)
        gate_vals, ids = torch.topk(probs, K, dim=-1)
        gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
        flat_ids = ids.reshape(t * K)
        oh = F.one_hot(flat_ids, E)                              # (tK, E)
        pos = torch.gather(torch.cumsum(oh, 0), 1, flat_ids[:, None])[:, 0] - 1
        keep = pos < C
        slot = torch.where(keep, flat_ids * C + pos.clamp_max(C - 1),
                           E * C - 1)
        return probs, gate_vals.reshape(t * K), flat_ids, slot, keep, oh

    def apply(self, params, x, with_aux: bool = True):
        """``x (B, T, D)`` -> ``(y (B, T, D), aux)``, ``aux`` the Switch
        load-balance term over the routed experts (f32 scalar), or None
        with ``with_aux=False`` (serving discards it, as the reference's
        compiled serving programs drop it as dead code)."""
        B, T, D = x.shape
        t = B * T
        xf = x.reshape(t, D)
        E, K = self.n_experts_padded, self.top_k
        C = self.capacity(t)
        probs, gates, _, slot, keep, oh = self.route(params, xf)

        # dispatch: the inverse map of the kept choices (distinct rows; each
        # dropped choice writes its own spare entry past E*C), then a gather
        tk = t * K
        ar = torch.arange(tk, device=x.device)
        owner = torch.full((E * C + tk,), tk, dtype=torch.long,
                           device=x.device)
        owner.scatter_(0, torch.where(keep, slot, E * C + ar), ar)
        owner = owner[:E * C]
        row = torch.where(owner < tk, owner // K, t)             # t: zeros
        eb = torch.cat([xf, xf.new_zeros((1, D))])[row].reshape(E, C, D)

        h = self._expert_mm(eb, params["w_up"], self.mask_up)
        if self.gated:
            g = self._expert_mm(eb, params["w_gate"], self.mask_up,
                                activation="silu")
            h = g * h
        out = self._expert_mm(h, params["w_down"], self.mask_down)

        # combine: every choice reads its row back, scaled by its gate (0
        # for a dropped one)
        scale = (gates * keep).to(out.dtype)[:, None]
        y = (out.reshape(E * C, D)[slot] * scale).reshape(t, K, D).sum(dim=1)

        if self.shared is not None:
            ys = self.shared.apply(params["shared"], xf)
            if self.shared_gated:
                ys = ys * torch.sigmoid(self.w_shared_gate.apply(
                    params["shared_gate"], xf))
            y = y + ys

        if not with_aux:
            return y.reshape(B, T, D), None
        me = probs.mean(dim=0)                                   # (n_experts,)
        ce = oh.reshape(t, K, E).sum(dim=1).float().mean(dim=0)
        aux = self.n_experts * torch.sum(me * ce[:self.n_experts])
        return y.reshape(B, T, D), aux
