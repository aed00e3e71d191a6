"""Chunked-prefill attention over paged KV (the port of
``repro.kernels.paged_prefill``).

Layout: ``q (Tc, H, Dh)`` — one request's chunk at global positions
``start + t``; pools ``(n_pages, page_size, Kh, Dh)``; ``bt_row (P,)``
int32; ``start`` and ``chunk_len`` host integers. Query ``t`` attends to
``kv_pos <= start + t`` and ``kv_pos < start + chunk_len``. It launches
``csrc/paged_prefill.cu`` on tensors of one CUDA device, on the body that
:func:`repro_torch.kernels.paged_attention.plan` picks: the tensor-core
body for bf16, the SIMT body for f32.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from . import paged_attention as pa

launches = {"paged_prefill_attention": 0}
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("paged_prefill")
        fn = lib.paged_prefill_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 6 + [I] * 13 + [ctypes.c_float, I, I, I, P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


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
    qc, kp, vp, bt, vec = pa.launch_inputs(q, k_pages, v_pages, bt_row,
                                           "paged_prefill_attention")
    P = bt.shape[0]
    p = pa.plan(Tc, H, n_kv, Dh, P, page_size, q.dtype, prefill=True)
    out = torch.empty_like(qc)
    part = pa.scratch(Tc * H, p.splits, Dh, q.device)
    lib, fn = _launcher()
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              out.data_ptr(), part.data_ptr(), Tc, p.q_tile, start, chunk_len,
              P, n_pages, page_size, H, n_kv, Dh, p.splits, pa.SPLIT_PAGES,
              vec, Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
              pa.ROUTES[p.route], pa.STAGES, _build.stream_ptr(q.device))
    _build.check(lib, "paged_prefill", code)
    launches["paged_prefill_attention"] += 1
    pa.routes[p.route] += 1
    return out
