"""Paged attention over the KV page pool (the port of
``repro.kernels.paged_attention``): the decode step and the speculative
verify window, and the launch plan the three paged kernels share.

Layout: ``q (B, H, Dh)`` for a decode step, ``(B, Tq, H, Dh)`` for a verify
window; ``k_pages / v_pages (n_pages, page_size, Kh, Dh)``; ``block_tables
(B, P)`` int32 (entries past the used depth point at the null page 0);
``lengths (B,)`` >= 1 (>= ``Tq`` for a window: the depth at its last
token). :func:`paged_attention` launches ``csrc/paged_attention.cu`` and
:func:`paged_attention_verify` ``csrc/paged_verify.cu``, on tensors of one
CUDA device; both, like the prefill chunk, run the split-KV scheme of
``csrc/paged_attend.cuh``.

A row's KV range is cut into splits of :data:`SPLIT_PAGES` pages, their
boundaries at multiples of that many pages from position 0, whatever the
lengths, the batch, the window or the table's width (:func:`split_ranges`).
Each split is one block, which writes f32 partials to scratch the wrapper
allocates; a second kernel combines them in split order. A block computes
on one of two bodies (:func:`plan`): ``split_tc`` (bf16: QKᵀ and PV on the
tensor cores, one warp a 16-row tile) or ``split_kv`` (f32, and shapes the
tensor cores do not take: SIMT). ``routes`` counts the launches of all
three paged kernels by the body that ran them.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

import torch

from . import _build

SPLIT_PAGES = 4        # pages of one split (S); its boundaries: multiples of S
SK_ROWS = 16           # query rows (tokens x group heads) a SIMT block owns
# query rows of a tensor-core tile: one warp of 16 for a decode step or a
# verify window, two for a prefill chunk
TC_ROWS = {"few": 16, "prefill": 32}
TC_MAX_KEYS = 64       # positions of a split the tensor-core body holds
# the bodies (csrc/paged_attend.cuh Route)
ROUTES = {"split_kv": 0, "split_tc": 1}
STAGES = 3             # the split blocks and the combine (csrc: Stage)

launches = {"paged_attention": 0, "paged_attention_verify": 0}
routes = {r: 0 for r in ROUTES}
_entries = {}


@dataclass(frozen=True)
class Plan:
    """How one paged-attention call runs on the card: the body, the query
    tokens a block owns (``q_tile``; ``q_tiles`` of them cover the tokens),
    the number of KV splits and the grid ``(splits * q_tiles, Kh, B)``."""
    route: str
    q_tile: int
    q_tiles: int
    splits: int
    grid: Tuple[int, int, int]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_ranges(P: int, split_pages: int = SPLIT_PAGES) -> List[Tuple[int, int]]:
    """The splits of a block table ``P`` pages wide: ``[first, end)`` page
    ranges, each ``split_pages`` long but the last."""
    return [(s, min(P, s + split_pages)) for s in range(0, P, split_pages)]


def _tc_fits(Dh: int, page_size: int) -> bool:
    keys = SPLIT_PAGES * page_size
    return Dh % 16 == 0 and 16 <= Dh <= 128 and keys % 16 == 0 and (
        keys <= TC_MAX_KEYS)


def plan(T: int, H: int, Kh: int, Dh: int, P: int, page_size: int,
         dtype: torch.dtype, B: int = 1, prefill: bool = False) -> Plan:
    """The launch plan of a paged-attention call of ``T`` query tokens a row
    (1 for a decode step, ``Tq`` for a verify window, ``Tc`` for a prefill
    chunk of one request) over a block table ``P`` pages wide. bf16 takes
    the tensor-core body where its tile fits (Dh a multiple of 16, a split
    of at most 64 positions); f32, the parity route, and other shapes the
    SIMT body. The tokens are tiled as evenly as a block's rows allow
    (``TC_ROWS`` or ``SK_ROWS`` rows of ``g = H / Kh`` heads a token)."""
    if H % Kh or Dh < 8 or Dh > 128 or Dh & (Dh - 1):
        raise ValueError(f"paged attention kernel: H {H}, Kh {Kh}, Dh {Dh} "
                         "(Dh a power of two in [8, 128], Kh dividing H)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged attention kernel: dtype {dtype}")
    route = ("split_tc" if dtype == torch.bfloat16 and _tc_fits(Dh, page_size)
             else "split_kv")
    g = H // Kh
    cap = (TC_ROWS["prefill" if prefill else "few"] if route == "split_tc"
           else SK_ROWS) // g
    if cap < 1:
        raise ValueError(f"paged attention kernel: {g} query heads a KV "
                         f"head exceed a {route} block's rows")
    q_tiles = _cdiv(T, cap)
    q_tile = _cdiv(T, q_tiles)
    q_tiles = _cdiv(T, q_tile)
    splits = len(split_ranges(P))
    return Plan(route, q_tile, q_tiles, splits, (splits * q_tiles, Kh, B))


def launch_inputs(q, k_pages, v_pages, tables, name):
    """Pools in q's dtype, int32 tables, all contiguous on one CUDA device;
    the copy width every row start is aligned to."""
    kp = k_pages.to(q.dtype).contiguous()
    vp = v_pages.to(q.dtype).contiguous()
    bt = tables.to(torch.int32).contiguous()
    qc = q.contiguous()
    _build.require_cuda(name, qc, kp, vp, bt)
    row = q.shape[-1] * q.element_size()
    vec = min(_build.copy_width(t, row) for t in (qc, kp, vp))
    return qc, kp, vp, bt, vec


def scratch(q_rows: int, splits: int, Dh: int, device) -> torch.Tensor:
    """The f32 partials of ``q_rows`` query rows: (m, l) pairs, then acc."""
    return torch.empty(q_rows * splits * (2 + Dh), dtype=torch.float32,
                       device=device)


def _launcher(source: str):
    if source not in _entries:
        lib = _build.library(source)
        fn = getattr(lib, f"{source}_launch")
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if source == "paged_attention":
            fn.argtypes = [P] * 7 + [I] * 10 + [F, I, I, I, P]
        else:
            fn.argtypes = [P] * 7 + [I] * 12 + [F, I, I, I, P]
        fn.restype = I
        _entries[source] = (lib, fn)
    return _entries[source]


def paged_attention(q, k_pages, v_pages, block_tables, lengths) -> torch.Tensor:
    """One decode step of paged attention: ``(B, H, Dh)`` out."""
    B, H, Dh = q.shape
    n_pages, page_size, n_kv, _ = k_pages.shape
    P = block_tables.shape[1]
    if tuple(block_tables.shape) != (B, P) or H % n_kv:
        raise ValueError(f"paged_attention: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, table {tuple(block_tables.shape)}")
    qc, kp, vp, bt, vec = launch_inputs(q, k_pages, v_pages, block_tables,
                                        "paged_attention")
    ln = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    _build.require_cuda("paged_attention", qc, ln)
    p = plan(1, H, n_kv, Dh, P, page_size, q.dtype, B)
    out = torch.empty_like(qc)
    part = scratch(B * H, p.splits, Dh, q.device)
    lib, fn = _launcher("paged_attention")
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              ln.data_ptr(), out.data_ptr(), part.data_ptr(), B, P, n_pages,
              page_size, H, n_kv, Dh, p.splits, SPLIT_PAGES, vec, Dh ** -0.5,
              _build.DTYPE_CODES[q.dtype], ROUTES[p.route], STAGES,
              _build.stream_ptr(q.device))
    _build.check(lib, "paged_attention", code)
    launches["paged_attention"] += 1
    routes[p.route] += 1
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
    qc, kp, vp, bt, vec = launch_inputs(q, k_pages, v_pages, block_tables,
                                        "paged_attention_verify")
    ln = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    _build.require_cuda("paged_attention_verify", qc, ln)
    p = plan(Tq, H, n_kv, Dh, P, page_size, q.dtype, B)
    out = torch.empty_like(qc)
    part = scratch(B * Tq * H, p.splits, Dh, q.device)
    lib, fn = _launcher("paged_verify")
    code = fn(qc.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
              ln.data_ptr(), out.data_ptr(), part.data_ptr(), B, Tq, p.q_tile,
              P, n_pages, page_size, H, n_kv, Dh, p.splits, SPLIT_PAGES, vec,
              Dh ** -0.5, _build.DTYPE_CODES[q.dtype], ROUTES[p.route], STAGES,
              _build.stream_ptr(q.device))
    _build.check(lib, "paged_attention_verify", code)
    launches["paged_attention_verify"] += 1
    routes[p.route] += 1
    return out
