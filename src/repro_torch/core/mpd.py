"""MPDLinear — one (possibly compressed) linear layer (the port of
``repro.core.mpd``).

Three modes, as in the reference:

* ``masked_dense`` — paper-faithful (Algorithm 1): the full dense weight,
  with the binary mask multiplied into it on every forward (inside the
  masked-matmul kernel) and re-applied after every optimizer update
  (:func:`reapply_mask`). Off-mask gradients are exact zeros.
* ``packed`` — the folded form: ``(nb, bi, bo)`` blocks between a pack and
  an unpack gather, run by the block-diagonal matmul.
* ``dense`` — no compression.

Params are plain dicts of tensors under the reference's key names: ``w``
(dense or masked-dense ``(d_in, d_out)``, packed ``(nb, bi, bo)``), optional
``b``, or the quantized ``{"w_q" int8, "w_scale" f32}`` leaf of the export
pass. Bias and activation ride the kernel epilogue on the compressed modes.
The mask is built on the device once per layer (:func:`fold.mask_tensor`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import fold as fold_lib
from .mask import MaskSpec

Params = Dict[str, Any]

MODES = ("dense", "masked_dense", "packed")


@dataclasses.dataclass(frozen=True)
class MPDLinearSpec:
    """Static config of one (possibly compressed) linear layer."""

    d_in: int
    d_out: int
    mask: Optional[MaskSpec]  # None => plain dense layer
    mode: str = "packed"
    use_bias: bool = True
    skip_in_perm: bool = False
    skip_out_perm: bool = False

    def __post_init__(self):
        assert self.mode in MODES, self.mode
        if self.mask is not None:
            assert self.mask.d_in == self.d_in and self.mask.d_out == self.d_out

    @property
    def compressed(self) -> bool:
        return self.mask is not None and self.mode != "dense"

    def param_count(self) -> int:
        n = self.d_in * self.d_out
        if self.compressed:
            n //= self.mask.nb
        return n + (self.d_out if self.use_bias else 0)


def _init_scale(d_in: int) -> float:
    return float(1.0 / np.sqrt(d_in))


def init(generator: torch.Generator, spec: MPDLinearSpec,
         dtype=torch.float32, device=None) -> Params:
    """Normal init with the dense layer's fan-in scale ``1/sqrt(d_in)``,
    drawn from ``generator`` (which must live on ``device``); a masked-dense
    weight is masked after the draw, as the paper masks after a standard
    init."""
    if spec.mask is None or spec.mode in ("dense", "masked_dense"):
        shape = (spec.d_in, spec.d_out)
    else:
        m = spec.mask
        shape = (m.nb, m.block_in, m.block_out)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32) * _init_scale(spec.d_in)
    w = w.to(dtype)
    if spec.mode == "masked_dense" and spec.mask is not None:
        w = w * fold_lib.mask_tensor(spec.mask, w.device)
    p: Params = {"w": w}
    if spec.use_bias:
        p["b"] = torch.zeros((spec.d_out,), dtype=dtype, device=device)
    return p


def from_dense(spec: MPDLinearSpec, w_dense: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> Params:
    """Params from an existing dense weight: kept (dense), masked
    (masked_dense) or folded (packed); a missing bias is zeros."""
    if spec.mask is None or spec.mode == "dense":
        w = w_dense
    elif spec.mode == "masked_dense":
        w = w_dense * fold_lib.mask_tensor(spec.mask, w_dense.device)
    else:
        w = fold_lib.fold(spec.mask, w_dense)
    p: Params = {"w": w}
    if spec.use_bias:
        p["b"] = (torch.zeros((spec.d_out,), dtype=w_dense.dtype,
                              device=w_dense.device) if b is None else b)
    return p


def to_packed(spec: MPDLinearSpec, params: Params) -> Params:
    """Fold a trained masked-dense layer into its packed form (Eq. 2)."""
    if spec.mode != "masked_dense" or spec.mask is None:
        raise ValueError(f"to_packed needs a masked_dense layer, got "
                         f"mode={spec.mode!r}")
    out: Params = {"w": fold_lib.fold(spec.mask, params["w"])}
    if spec.use_bias:
        out["b"] = params["b"]
    return out


def reapply_mask(spec: MPDLinearSpec, params: Params) -> Params:
    """Algorithm 1 line 14: re-zero the off-mask weights after an update
    (a no-op for the packed and dense modes). ``w`` may carry leading
    stacked axes."""
    if spec.mode != "masked_dense" or spec.mask is None:
        return params
    w = params["w"]
    return dict(params, w=w * fold_lib.mask_tensor(spec.mask, w.device))


def apply(spec: MPDLinearSpec, params: Params, x: torch.Tensor, *,
          activation: Optional[str] = None, extra_bias=None,
          packed_input: bool = False) -> torch.Tensor:
    """``y = act(x @ W_eff + b)`` for every mode.

    On the masked-dense mode the mask is multiplied into W inside the
    masked-matmul kernel. On the packed mode the bias is re-indexed into
    packed order and rides the kernel epilogue with the activation
    (elementwise activations commute with the output permutation);
    quantized leaves route to the int8 form. ``packed_input`` says that
    ``x`` was packed already (a packed-mode layer then skips its input
    gather), so layers that share an input permutation pack once.
    ``extra_bias (d_out,)`` adds to the layer's own bias (or stands in for
    it) before the packed re-index, so it rides the same epilogue (Mamba's
    ``dt_bias``).
    """
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.quant import is_quantized

    b = params["b"] if spec.use_bias else None
    if extra_bias is not None:
        b = extra_bias if b is None else b + extra_bias
    if spec.mask is None or spec.mode == "dense":
        y = x @ params["w"]
        if b is not None:
            y = y + b
        return ref.ACTIVATIONS[activation](y)
    if spec.mode == "masked_dense":
        mask = fold_lib.mask_tensor(spec.mask, params["w"].device)
        return ops.masked_matmul(x, params["w"], mask, b,
                                 activation=activation)
    m = spec.mask
    xp = fold_lib.pack_inputs(m, x, skip=spec.skip_in_perm or packed_input)
    bp = None
    if b is not None:
        idx = fold_lib.gather_index(m, "bias", b.device)
        bp = b if idx is None else b.index_select(-1, idx)
    if is_quantized(params):
        yp = ops.bdmm_quant(xp, params["w_q"], params["w_scale"], bp,
                            activation=activation)
    else:
        yp = ops.bdmm(xp, params["w"], bp, activation=activation)
    return fold_lib.unpack_outputs(m, yp, skip=spec.skip_out_perm)

