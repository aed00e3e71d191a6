"""Paged attention over the KV page pool (the port of
``repro.kernels.paged_attention``): the decode step and the speculative
verify window.

Layout: ``q (B, H, Dh)`` for a decode step, ``(B, Tq, H, Dh)`` for a verify
window; ``k_pages / v_pages (n_pages, page_size, Kh, Dh)``; ``block_tables
(B, P)`` int32 (entries past the used depth point at the null page 0);
``lengths (B,)`` >= 1 (>= ``Tq`` for a window: the depth at its last
token). :func:`paged_attention` launches ``csrc/paged_attention.cu`` and
:func:`paged_attention_verify` ``csrc/paged_verify.cu``, on tensors of one
CUDA device; both share the page loop of ``csrc/paged_attend.cuh``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_ROW_ELEMS = 2048    # q_tile * g * Dh: rows x Dh one 128-thread block owns

launches = {"paged_attention": 0, "paged_attention_verify": 0}
_entries = {}


def _launcher(source: str):
    if source not in _entries:
        lib = _build.library(source)
        fn = getattr(lib, f"{source}_launch")
        P, I = ctypes.c_void_p, ctypes.c_int
        if source == "paged_attention":
            fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I,
                           ctypes.c_float, I, P]
        else:
            fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                           ctypes.c_float, I, P]
        fn.restype = I
        _entries[source] = (lib, fn)
    return _entries[source]


def verify_q_tile(Tq: int, g: int, Dh: int) -> int:
    """Window tokens per block: as few tiles as one block's ``q_tile * g``
    rows of ``Dh`` columns allow, split evenly (olmo-1b's g 1, Dh 128 takes
    a window of up to 16 tokens in one tile; g 4 a window of 5 in tiles of
    3 and 2)."""
    cap = MAX_ROW_ELEMS // (g * Dh)
    if cap < 1:
        raise ValueError(f"paged_attention_verify kernel: g*Dh = {g * Dh} "
                         f"exceeds {MAX_ROW_ELEMS}")
    n_tiles = -(-Tq // cap)
    return -(-Tq // n_tiles)


def paged_attention(q, k_pages, v_pages, block_tables, lengths) -> torch.Tensor:
    """One decode step of paged attention: ``(B, H, Dh)`` out."""
    B, H, Dh = q.shape
    n_pages, page_size, n_kv, _ = k_pages.shape
    P = block_tables.shape[1]
    if tuple(block_tables.shape) != (B, P) or H % n_kv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, table {tuple(block_tables.shape)}")
    kp = k_pages.to(q.dtype).contiguous()
    vp = v_pages.to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    qc = q.contiguous()
    _build.require_cuda("paged_attention", qc, kp, vp, bt, ln)
    out = torch.empty_like(qc)
    lib, fn = _launcher("paged_attention")
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              ln.data_ptr(), out.data_ptr(), B, P, n_pages, page_size, H, n_kv,
              Dh, Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
              _build.stream_ptr(q.device))
    _build.check(lib, "paged_attention", code)
    launches["paged_attention"] += 1
    return out


def paged_attention_verify(q, k_pages, v_pages, block_tables, lengths
                           ) -> torch.Tensor:
    """Speculative-verify attention: ``(B, Tq, H, Dh)`` out for a window of
    ``Tq`` queries per row; query ``t`` sees ``kv_pos < lengths - (Tq-1) +
    t``. The window's K/V must already be in the pool; ``lengths >= Tq``
    (not read back to check: the kernel clamps a smaller depth to ``Tq``)."""
    B, Tq, H, Dh = q.shape
    n_pages, page_size, n_kv, _ = k_pages.shape
    P = block_tables.shape[1]
    if (tuple(block_tables.shape) != (B, P) or H % n_kv
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"paged_attention_verify: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, table "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    kp = k_pages.to(q.dtype).contiguous()
    vp = v_pages.to(q.dtype).contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    ln = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    qc = q.contiguous()
    _build.require_cuda("paged_attention_verify", qc, kp, vp, bt, ln)
    out = torch.empty_like(qc)
    q_tile = verify_q_tile(Tq, H // n_kv, Dh)
    lib, fn = _launcher("paged_verify")
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              ln.data_ptr(), out.data_ptr(), B, Tq, q_tile, P, n_pages,
              page_size, H, n_kv, Dh, Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
              _build.stream_ptr(q.device))
    _build.check(lib, "paged_attention_verify", code)
    launches["paged_attention_verify"] += 1
    return out
