"""Paged-attention decode step (the port of ``repro.kernels.paged_attention``,
decode form).

Layout: ``q (B, H, Dh)``; ``k_pages / v_pages (n_pages, page_size, Kh, Dh)``;
``block_tables (B, P)`` int32 (entries past the used depth point at the
null page 0); ``lengths (B,)`` >= 1. It launches
``csrc/paged_attention.cu`` on tensors of one CUDA device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"paged_attention": 0}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("paged_attention")
        fn = lib.paged_attention_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, ctypes.c_float, I, P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


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
    lib, fn = _launcher()
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              ln.data_ptr(), out.data_ptr(), B, P, n_pages, page_size, H, n_kv,
              Dh, Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
              _build.stream_ptr(q.device))
    _build.check(lib, "paged_attention", code)
    launches["paged_attention"] += 1
    return out
