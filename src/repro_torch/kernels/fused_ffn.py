"""Fused block-diagonal MLP (the port of ``repro.kernels.fused_ffn``).

For a perm-fused packed FFN the three projections share one block
structure, and block ``n`` of the MLP is independent of the others::

    u_n = x_n @ Wu[n] + bu_n
    h_n = act(x_n @ Wg[n] + bg_n) * u_n        (gated; or act(u_n))
    y_n = h_n @ Wd[n] + bd_n

:func:`fused_ffn` runs that as one launch of ``csrc/fused_ffn.cu``: the
``(tokens, d_ff)`` hidden stays in the kernel and never reaches device
memory. Weights are fp (x's dtype) or int8 with per-output-channel scales
(``s_up``/``s_gate (nb, f)``, ``s_down (nb, bo)``). The f axis is split
across blocks to fill the card; f32 partial sums meet in a workspace and
the last block of each output tile reduces them in a fixed order, so the
result is deterministic. Inputs must lie on one CUDA device;
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain version
before they get here. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
F_TILE = 64                         # f channels per tile (csrc FS)
COLS_PER_BLOCK = 256                # output columns per block (csrc BO_T)
ROW_TILES = (4, 8, 16, 32, 64)      # rows per block the kernel is built for

launches = {"fused_ffn": 0}
_entry = None
# per (device, stream): the int32 tickets of the split-f reduction; the
# kernel leaves them zero, so one buffer serves every launch on the stream
_counters: Dict[Tuple[int, int], torch.Tensor] = {}
_sm_count: Dict[int, int] = {}


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("fused_ffn")
        fn = lib.fused_ffn_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 13 + [I] * 12 + [P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


def plan(m: int, nb: int, f: int, bo: int, n_sm: int) -> Tuple[int, int, int]:
    """``(rows per block, blocks along f, f tiles per block)``: the smallest
    row tile that holds ``m``, then enough f splits that the grid covers
    the card's ``n_sm`` SMs (one block per SM by register use)."""
    bm = next((t for t in ROW_TILES if m <= t), ROW_TILES[-1])
    cells = -(-m // bm) * nb * -(-bo // COLS_PER_BLOCK)
    n_ft = -(-f // F_TILE)
    split = min(n_ft, max(1, -(-n_sm // cells)))
    fpb = -(-n_ft // split)
    return bm, -(-n_ft // fpb), fpb


def _counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    key = (device.index, _build.stream_ptr(device))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _f32(t: Optional[torch.Tensor], shape, name: str):
    if t is None:
        return None
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_ffn: {name} {tuple(t.shape)} != {tuple(shape)}")
    return t.float().contiguous()


def fused_ffn(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              w_gate: Optional[torch.Tensor] = None,
              b_up: Optional[torch.Tensor] = None,
              b_gate: Optional[torch.Tensor] = None,
              b_down: Optional[torch.Tensor] = None,
              s_up: Optional[torch.Tensor] = None,
              s_gate: Optional[torch.Tensor] = None,
              s_down: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = "silu") -> torch.Tensor:
    """Fused block-diagonal MLP ``(..., nb*bi) -> (..., nb*bo)``.

    ``w_up``/``w_gate (nb, bi, f)``, ``w_down (nb, f, bo)``, contiguous, in
    x's dtype or all int8 with their scales; biases packed ``(nb*f,)`` /
    ``(nb*bo,)``. Gated when ``w_gate`` is given."""
    nb, bi, f = w_up.shape
    if w_down.dim() != 3 or tuple(w_down.shape[:2]) != (nb, f):
        raise ValueError(f"fused_ffn: w_up {tuple(w_up.shape)} vs w_down "
                         f"{tuple(w_down.shape)}")
    bo = w_down.shape[2]
    if x.shape[-1] != nb * bi:
        raise ValueError(f"fused_ffn: x {tuple(x.shape)} vs blocks "
                         f"{tuple(w_up.shape)}")
    gated = w_gate is not None
    if gated and tuple(w_gate.shape) != (nb, bi, f):
        raise ValueError(f"fused_ffn: w_gate {tuple(w_gate.shape)} != "
                         f"{(nb, bi, f)}")
    if not gated and (b_gate is not None or s_gate is not None):
        raise ValueError("fused_ffn: gate bias/scale given but w_gate is None")
    if activation not in ACT_CODES:
        raise ValueError(f"fused_ffn kernel: activation {activation!r} not in "
                         f"{sorted(k for k in ACT_CODES if k)} or None")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_ffn kernel: x dtype {x.dtype}")
    weights = [w for w in (w_up, w_gate, w_down) if w is not None]
    quant = w_up.dtype == torch.int8
    want = torch.int8 if quant else x.dtype
    if any(w.dtype != want for w in weights):
        raise ValueError(f"fused_ffn kernel: weights {[w.dtype for w in weights]}"
                         f" must all be {want} (x is {x.dtype})")
    if any(not w.is_contiguous() for w in weights):
        raise ValueError("fused_ffn kernel: weights must be contiguous")
    if quant and (s_up is None or s_down is None or (gated and s_gate is None)):
        raise ValueError("fused_ffn: int8 weights need s_up/s_down (and "
                         "s_gate when gated)")
    if not quant and any(s is not None for s in (s_up, s_gate, s_down)):
        raise ValueError("fused_ffn: scales passed with fp weights")
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, nb * bi).contiguous()
    y = torch.empty((m, nb * bo), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*lead, nb * bo)
    extras = [_f32(s_up, (nb, f), "s_up"), _f32(s_gate, (nb, f), "s_gate"),
              _f32(s_down, (nb, bo), "s_down"),
              _f32(b_up, (nb * f,), "b_up"), _f32(b_gate, (nb * f,), "b_gate"),
              _f32(b_down, (nb * bo,), "b_down")]
    _build.require_cuda("fused_ffn", x2, *weights,
                        *(t for t in extras if t is not None))
    dev = x.device
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    bm, split, fpb = plan(m, nb, f, bo, _sm_count[dev.index])
    part = counters = None
    if split > 1:
        part = torch.empty((split, m, nb * bo), dtype=torch.float32, device=dev)
        n_cells = -(-m // bm) * nb * -(-bo // COLS_PER_BLOCK)
        counters = _counter_buffer(dev, n_cells)
    vec = int(f % 4 == 0 and bo % 4 == 0
              and all(w.data_ptr() % 16 == 0 for w in weights))
    lib, fn = _launcher()
    ptr = lambda t: None if t is None else t.data_ptr()
    code = fn(x2.data_ptr(), w_up.data_ptr(), ptr(w_gate), w_down.data_ptr(),
              *(ptr(t) for t in extras), y.data_ptr(), ptr(part),
              ptr(counters), m, nb, bi, f, bo, _build.DTYPE_CODES[x.dtype],
              int(quant), ACT_CODES[activation], bm, split, fpb, vec,
              _build.stream_ptr(dev))
    _build.check(lib, "fused_ffn", code)
    launches["fused_ffn"] += 1
    return y.reshape(*lead, nb * bo)
