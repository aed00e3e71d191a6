"""Kernel entry points with backend routing (the port of
``repro.kernels.ops`` for the serving path).

* CPU tensors always take the plain PyTorch version.
* CUDA tensors launch the hand-written kernel, which raises on anything it
  cannot run (inputs on mixed devices included); it never falls back.
* ``set_backend("torch")`` forces the plain version on the card as well; it
  exists so that ``chip_smoke.py`` and the tests can hold the kernels
  against their plain versions on the same inputs. The default is
  ``"cuda"``.

The serving path has no backward pass, so nothing here carries an
autograd rule yet.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import bdmm as bdmm_kernel
from . import paged_attention as paged_attn_kernel
from . import paged_prefill as paged_prefill_kernel
from . import ref

BACKENDS = ("cuda", "torch")
_BACKEND = "cuda"
_KERNEL_MODULES = (bdmm_kernel, paged_attn_kernel, paged_prefill_kernel)


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in BACKENDS:
        raise ValueError(f"backend {name!r} not in {BACKENDS}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    out: Dict[str, int] = {}
    for mod in _KERNEL_MODULES:
        out.update(mod.launches)
    return out


def reset_launch_counts() -> None:
    for mod in _KERNEL_MODULES:
        for k in mod.launches:
            mod.launches[k] = 0


def _plain(*tensors) -> bool:
    """Whether a call takes the plain version: under the ``"torch"``
    backend, or when every tensor it was given lies on the CPU."""
    return _BACKEND == "torch" or all(
        t.device.type == "cpu" for t in tensors if t is not None)


def bdmm(x, wp, bias=None, *, activation: Optional[str] = None):
    """Fused block-diagonal matmul ``act(x @ blockdiag(wp) + bias)``,
    ``(..., nb*bi) -> (..., nb*bo)``; ``bias`` packed ``(nb*bo,)``."""
    if _plain(x, wp, bias):
        return ref.bdmm_ref(x, wp, bias, activation)
    return bdmm_kernel.bdmm(x, wp, bias, activation=activation)


def bdmm_quant(x, wq, scale, bias=None, *, activation: Optional[str] = None):
    """Int8-weight block-diagonal matmul; ``scale (nb, bo)`` per output
    channel, applied to the f32 accumulator before bias and activation."""
    if _plain(x, wq, scale, bias):
        return ref.bdmm_quant_ref(x, wq, scale, bias, activation)
    return bdmm_kernel.bdmm(x, wq, bias, scale, activation=activation)


def paged_attention(q, k_pages, v_pages, block_tables, lengths):
    """One decode step of attention against the paged KV pool."""
    if _plain(q, k_pages, v_pages, block_tables, lengths):
        return ref.paged_attention_ref(q, k_pages, v_pages, block_tables,
                                       lengths)
    return paged_attn_kernel.paged_attention(q, k_pages, v_pages,
                                             block_tables, lengths)


def paged_prefill_attention(q, k_pages, v_pages, bt_row, start, chunk_len):
    """Chunked-prefill attention for one request's ``(Tc, H, Dh)`` chunk
    against its paged context (chunk K/V already in the pool)."""
    if _plain(q, k_pages, v_pages, bt_row):
        return ref.paged_prefill_attention_ref(q, k_pages, v_pages, bt_row,
                                               int(start), int(chunk_len))
    return paged_prefill_kernel.paged_prefill_attention(
        q, k_pages, v_pages, bt_row, start, chunk_len)
