"""Chunked-prefill attention over paged KV (the port of
``repro.kernels.paged_prefill``).

Layout: ``q (Tc, H, Dh)`` — one request's chunk at global positions
``start + t``; pools ``(n_pages, page_size, Kh, Dh)``; ``bt_row (P,)``
int32; ``start`` and ``chunk_len`` host integers or 0-d integer tensors on the
device. Query ``t`` attends to ``kv_pos <= start + t`` and ``kv_pos < start
+ chunk_len``. The kernel reads the two from an int32 pair on the device,
as the Pallas kernel takes them by scalar prefetch, so a captured call
replays at any start and length; the launch plan depends on the table's
width alone. It launches
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
        fn.argtypes = [P] * 7 + [I] * 11 + [ctypes.c_float, I, I, I, P]
        fn.restype = I
        _entry = (lib, fn)
    return _entry


def chunk_info(start, chunk_len, device) -> torch.Tensor:
    """``(start, chunk_len)`` as the kernel reads them: an int32 pair on
    ``device``. Host integers are checked (``start + chunk_len >= 1``) and
    copied up; device scalars are never read back: two adjacent int32
    elements of one tensor (the engine's chunk scalars) are the pair
    itself, others are stacked on the device."""
    if not (torch.is_tensor(start) or torch.is_tensor(chunk_len)):
        if start + chunk_len < 1:
            raise ValueError(f"paged_prefill_attention: start {start} + "
                             f"chunk_len {chunk_len} < 1")
        return torch.tensor([start, chunk_len], dtype=torch.int32,
                            device=device)
    if (torch.is_tensor(start) and torch.is_tensor(chunk_len)
            and start.dtype == chunk_len.dtype == torch.int32
            and start.numel() == chunk_len.numel() == 1
            and start.device == chunk_len.device
            and start.untyped_storage().data_ptr()
            == chunk_len.untyped_storage().data_ptr()
            and chunk_len.data_ptr() == start.data_ptr() + 4):
        return start.as_strided((2,), (1,))
    return torch.stack([torch.as_tensor(v, device=device).reshape(())
                        for v in (start, chunk_len)]).to(torch.int32)


def paged_prefill_attention(q, k_pages, v_pages, bt_row, start, chunk_len
                            ) -> torch.Tensor:
    """Prefill-chunk attention: ``(Tc, H, Dh)`` out for one request's chunk
    against its paged context. The chunk's K/V must already be in the pool;
    ``start + chunk_len >= 1`` (checked when both are host integers)."""
    Tc, H, Dh = q.shape
    n_pages, page_size, n_kv, _ = k_pages.shape
    if bt_row.ndim != 1 or H % n_kv:
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, row {tuple(bt_row.shape)}")
    qc, kp, vp, bt, vec = pa.launch_inputs(q, k_pages, v_pages, bt_row,
                                           "paged_prefill_attention")
    info = chunk_info(start, chunk_len, q.device)
    _build.require_cuda("paged_prefill_attention", qc, info)
    P = bt.shape[0]
    p = pa.plan(Tc, H, n_kv, Dh, P, page_size, q.dtype, prefill=True)
    out = torch.empty_like(qc)
    part = pa.scratch(Tc * H, p.splits, Dh, q.device)
    lib, fn = _launcher()
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              info.data_ptr(), out.data_ptr(), part.data_ptr(), Tc, p.q_tile,
              P, n_pages, page_size, H, n_kv, Dh, p.splits, pa.SPLIT_PAGES,
              vec, Dh ** -0.5, _build.DTYPE_CODES[q.dtype],
              pa.ROUTES[p.route], pa.STAGES, _build.stream_ptr(q.device))
    _build.check(lib, "paged_prefill", code)
    launches["paged_prefill_attention"] += 1
    pa.routes[p.route] += 1
    return out
