"""Chunked-prefill attention over paged KV (the port of
``repro.kernels.paged_prefill``).

Layout: ``q (Tc, H, Dh)`` — one request's chunk at global positions
``start + t``; pools ``(n_pages, page_size, Kh, Dh)``; ``bt_row (P,)``
int32; ``start`` and ``chunk_len`` host integers. Query ``t`` attends to
``kv_pos <= start + t`` and ``kv_pos < start + chunk_len``. It launches
``csrc/paged_prefill.cu`` on tensors of one CUDA device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_ROW_ELEMS = 2048    # q_tile * g * Dh: rows x Dh one 128-thread block owns

launches = {"paged_prefill_attention": 0}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("paged_prefill")
        fn = lib.paged_prefill_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
                       ctypes.c_float, I, P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


def q_tile_for(Tc: int, g: int, Dh: int) -> int:
    """Query tokens per block: the largest power of two <= ``Tc`` whose
    ``q_tile * g`` rows of ``Dh`` columns one block can hold."""
    cap = MAX_ROW_ELEMS // (g * Dh)
    if cap < 1:
        raise ValueError(f"paged_prefill kernel: g*Dh = {g * Dh} exceeds "
                         f"{MAX_ROW_ELEMS}")
    t = 1
    while t * 2 <= min(Tc, cap):
        t *= 2
    return t


def paged_prefill_attention(q, k_pages, v_pages, bt_row, start, chunk_len
                            ) -> torch.Tensor:
    """Prefill-chunk attention: ``(Tc, H, Dh)`` out for one request's chunk
    against its paged context. The chunk's K/V must already be in the pool;
    ``start + chunk_len >= 1``."""
    Tc, H, Dh = q.shape
    n_pages, page_size, n_kv, _ = k_pages.shape
    if bt_row.ndim != 1 or H % n_kv:
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, row {tuple(bt_row.shape)}")
    start, chunk_len = int(start), int(chunk_len)
    kp = k_pages.to(q.dtype).contiguous()
    vp = v_pages.to(q.dtype).contiguous()
    bt = bt_row.to(torch.int32).contiguous()
    qc = q.contiguous()
    _build.require_cuda("paged_prefill_attention", qc, kp, vp, bt)
    out = torch.empty_like(qc)
    q_tile = q_tile_for(Tc, H // n_kv, Dh)
    lib, fn = _launcher()
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              out.data_ptr(), Tc, q_tile, start, chunk_len, bt.shape[0],
              n_pages, page_size, H, n_kv, Dh, Dh ** -0.5,
              _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(lib, "paged_prefill", code)
    launches["paged_prefill_attention"] += 1
    return out
