"""Feed-forward blocks (the port of ``repro.models.ffn``).

Gated (SwiGLU) and plain (GELU/ReLU) MLPs; every projection is an
MPD-compressible :class:`Linear`. SwiGLU order as the reference: ``up`` has
no activation, ``gate`` runs silu in its kernel epilogue, each is cast to
the dtype, then the two multiply in that dtype.

With ``fuse_perms`` (paper Fig. 3) up and gate share one mask and down's
input permutation is up's output permutation, so the inner gathers cancel.
A packed FFN built so (or rewritten so by
:func:`repro_torch.core.export.apply_perm_fusion`) runs as one
:func:`repro_torch.kernels.ops.fused_ffn` call: the ``d_ff`` hidden stays in
block order and never leaves the kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fold as fold_lib
from repro_torch.core.mask import make_mask_spec
from repro_torch.core.policy import CompressionPolicy
from .linear import Linear

FUSED_ACTIVATION = {"swiglu": "silu", "gelu": "gelu", "relu": "relu"}


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    d_model: int
    d_ff: int
    kind: str = "swiglu"  # swiglu | gelu | relu
    use_bias: bool = False
    w_up: Linear = None
    w_gate: Linear = None
    w_down: Linear = None

    @staticmethod
    def make(policy: CompressionPolicy, d_model, d_ff, kind="swiglu",
             use_bias=False, seed_salt=0, fuse_perms=False) -> "FFNSpec":
        """``fuse_perms``: up and gate share up's mask (one input gather;
        the elementwise gate commutes with any fixed permutation), down's
        input permutation is up's output permutation, and the inner gathers
        are skipped. When up and down resolve to different block counts the
        unfused form is built instead, as in the reference."""
        gated = kind == "swiglu"
        if fuse_perms:
            m_up = policy.plan(d_model, d_ff, "mlp", seed_salt=seed_salt * 3)
            m_down = policy.plan(d_ff, d_model, "mlp",
                                 seed_salt=seed_salt * 3 + 2)
            if m_up is not None and m_down is not None and m_up.nb == m_down.nb:
                m_down = make_mask_spec(d_ff, d_model, m_down.nb,
                                        seed=m_down.seed,
                                        in_perm=m_up.out_perm,   # cancels
                                        out_perm=m_down.out_perm)

                def up_like():
                    return Linear.make(policy, d_model, d_ff, "mlp",
                                       use_bias=use_bias, mask_override=m_up,
                                       skip_out_perm=True)
                return FFNSpec(
                    d_model, d_ff, kind, use_bias, w_up=up_like(),
                    w_gate=up_like() if gated else None,
                    w_down=Linear.make(policy, d_ff, d_model, "mlp",
                                       use_bias=use_bias,
                                       mask_override=m_down,
                                       skip_in_perm=True))
        return FFNSpec(
            d_model, d_ff, kind, use_bias,
            w_up=Linear.make(policy, d_model, d_ff, "mlp", use_bias=use_bias,
                             seed_salt=seed_salt * 3 + 0),
            w_gate=(Linear.make(policy, d_model, d_ff, "mlp",
                                use_bias=use_bias, seed_salt=seed_salt * 3 + 1)
                    if gated else None),
            w_down=Linear.make(policy, d_ff, d_model, "mlp", use_bias=use_bias,
                               seed_salt=seed_salt * 3 + 2),
        )

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        p = {"w_up": self.w_up.init(generator, dtype, device)}
        if self.w_gate is not None:
            p["w_gate"] = self.w_gate.init(generator, dtype, device)
        p["w_down"] = self.w_down.init(generator, dtype, device)
        return p

    # ----------------------------------------------------------- fused route
    def fused_packed(self) -> bool:
        """Whether the whole MLP runs as one fused block-diagonal kernel:
        every projection packed, the inner permutations cancelled (up's
        output and down's input gathers skipped), one block count, and the
        gate sharing up's input permutation."""
        up, gate, down = self.w_up, self.w_gate, self.w_down
        su, sd = up.spec, down.spec
        if not (su.mode == "packed" and sd.mode == "packed"
                and su.mask is not None and sd.mask is not None):
            return False
        if not (su.skip_out_perm and sd.skip_in_perm):
            return False
        if su.mask.nb != sd.mask.nb:
            return False
        if gate is not None:
            sg = gate.spec
            if not (sg.mode == "packed" and sg.mask is not None
                    and sg.skip_out_perm and sg.mask.nb == su.mask.nb
                    and np.array_equal(sg.mask.in_perm, su.mask.in_perm)):
                return False
        return True

    @staticmethod
    def _packed_bias(lin: Linear, p):
        """The layer's bias re-indexed into the kernel's packed output
        order (None without a bias)."""
        if not lin.spec.use_bias:
            return None
        idx = fold_lib.gather_index(lin.spec.mask, "bias", p["b"].device)
        return p["b"] if idx is None else p["b"].index_select(-1, idx)

    def _apply_fused(self, params, x):
        from repro_torch.kernels import ops
        from repro_torch.kernels.quant import is_quantized

        up, gate, down = self.w_up, self.w_gate, self.w_down
        xp = fold_lib.pack_inputs(up.spec.mask, x, skip=up.spec.skip_in_perm)
        biases = dict(
            b_up=self._packed_bias(up, params["w_up"]),
            b_gate=(self._packed_bias(gate, params["w_gate"])
                    if gate is not None else None),
            b_down=self._packed_bias(down, params["w_down"]))
        act = FUSED_ACTIVATION[self.kind]
        if is_quantized(params["w_up"]):
            # the quantize pass converts all three projections together
            y = ops.fused_ffn_quant(
                xp, params["w_up"]["w_q"], params["w_down"]["w_q"],
                s_up=params["w_up"]["w_scale"],
                s_down=params["w_down"]["w_scale"],
                w_gate=params["w_gate"]["w_q"] if gate is not None else None,
                s_gate=(params["w_gate"]["w_scale"]
                        if gate is not None else None),
                activation=act, **biases)
        else:
            y = ops.fused_ffn(
                xp, params["w_up"]["w"], params["w_down"]["w"],
                w_gate=params["w_gate"]["w"] if gate is not None else None,
                activation=act, **biases)
        return fold_lib.unpack_outputs(down.spec.mask, y,
                                       skip=down.spec.skip_out_perm)

    def apply(self, params, x):
        if self.fused_packed():
            return self._apply_fused(params, x)
        if self.kind == "swiglu":
            h = self.w_up.apply(params["w_up"], x)
            g = self.w_gate.apply(params["w_gate"], x, activation="silu")
            h = g * h
        elif self.kind in ("gelu", "relu"):
            h = self.w_up.apply(params["w_up"], x, activation=self.kind)
        else:
            raise ValueError(self.kind)
        return self.w_down.apply(params["w_down"], h)
