"""Fused block-diagonal MLP (the port of ``repro.kernels.fused_ffn``).

For a perm-fused packed FFN the three projections share one block
structure, and block ``n`` of the MLP is independent of the others::

    u_n = x_n @ Wu[n] + bu_n
    h_n = act(x_n @ Wg[n] + bg_n) * u_n        (gated; or act(u_n))
    y_n = h_n @ Wd[n] + bd_n

:func:`fused_ffn` runs that as one launch of ``csrc/fused_ffn.cu``: the
``(tokens, d_ff)`` hidden stays in the kernel and never reaches device
memory. Weights are fp (x's dtype) or int8 with per-output-channel scales
(``s_up``/``s_gate (nb, f)``, ``s_down (nb, bo)``). bf16 x runs on a
tensor-core body, the hidden kept in registers as a hi + lo pair of bf16:
``tc`` (mma.sync, 16-token blocks) up to ``SPLIT_M_MAX`` rows (decode,
one prefill chunk), ``tc_tall`` (wgmma, 128-token blocks that reuse each
block's weights over their tokens) above (training batches, whole-prompt
admissions, the static prefill). f32 x runs on the exact SIMT bodies (FFMA
only), ``simt_small`` up to ``SPLIT_M_MAX`` rows and ``simt_tall`` (128
rows a block) above; the first f32 body, ``simt_f32``, runs only when
``force`` asks for it. The f axis is split across blocks to fill the
card; the split's f32 partial sums are added in a fixed order (inside a
cluster of the split's blocks; ``simt_f32``: by the last block of each
output tile, from a workspace), so the result is deterministic. Inputs
must lie on one CUDA device; :mod:`repro_torch.kernels.ops` sends CPU
tensors to the plain version before they get here. ``launches`` counts
kernel launches, ``routes`` the launches by the body that ran them.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import _build

ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
F_TILE = 64                         # f channels per tile (csrc FS, FT_F, TALL_F)
SMALL_F_TILE = 128                  # simt_small's (csrc SMALL_F)
COLS_PER_BLOCK = 256                # output columns per block (csrc BO_T, FT_COLS)
ROW_TILES = (4, 8, 16, 32, 64)      # rows per block of simt_small (and simt_f32)
TC_ROWS = 16                        # rows per block of the tc body
TALL_ROWS = 128                     # rows per block of tc_tall and simt_tall
SPLIT_M_MAX = 64                    # at or below, tc / simt_small (one split for every m)
# the bodies of csrc/fused_ffn.cu
ROUTES = {"simt_f32": 0, "tc": 1, "tc_tall": 2, "simt_small": 3,
          "simt_tall": 4}
F32_ROUTES = ("simt_small", "simt_tall")    # what plan() runs f32 x on

CLUSTER_MAX = 16                    # tc: a tile's f split is one cluster
TALL_CLUSTER_MAX = 8                # tc_tall: the same, in a portable cluster

launches = {"fused_ffn": 0}
routes = {r: 0 for r in ROUTES}
_entry = None
_sm_count: Dict[int, int] = {}
_counters: Dict[Tuple[Optional[int], int], torch.Tensor] = {}
_clusters: Dict[Tuple[Optional[int], str, bool, int], int] = {}


def _counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets of the ``simt_f32`` body's
    split-f reduction on the current stream; the kernel leaves them zero, so one
    buffer serves every launch on the stream. A call being captured into a
    CUDA graph gets tickets of its own, zeroed inside the graph (in the
    graph's memory pool), never the buffer of the capture stream."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(max(n, 1), dtype=torch.int32, device=device)
    key = (device.index, _build.stream_ptr(device))
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


class Plan(NamedTuple):
    """How one fused MLP runs: the body, the rows of a block, the blocks
    along f and the f tiles (of ``F_TILE``) each of them owns."""
    route: str
    rows: int
    split: int
    fpb: int


def _max_clusters(dev: torch.device, route: str, quant: bool,
                  split: int) -> int:
    """How many clusters of ``split`` blocks of the SIMT body ``route``
    (simt_small at its 64-row tile) the card runs at once, asked of the
    CUDA runtime once per device and kind."""
    rows = TALL_ROWS if route == "simt_tall" else ROW_TILES[-1]
    key = (dev.index, route, quant, split)
    if key not in _clusters:
        lib, _ = _launcher()
        _clusters[key] = lib.fused_ffn_max_clusters(ROUTES[route], rows,
                                                    int(quant), split)
    return _clusters[key]


def _launcher():
    global _entry
    if _entry is None:
        lib = _build.library("fused_ffn")
        fn = lib.fused_ffn_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 13 + [I] * 15 + [P]
        fn.restype = I
        lib.fused_ffn_max_clusters.argtypes = [I] * 4
        lib.fused_ffn_max_clusters.restype = I
        _entry = (lib, fn)
    return _entry


def plan(m: int, nb: int, f: int, bo: int, n_sm: int,
         dtype: torch.dtype = torch.bfloat16,
         clusters: Optional[Callable[[str, int], int]] = None) -> Plan:
    """The body, rows per block, blocks along f and f tiles per block.

    bf16 up to ``SPLIT_M_MAX`` rows (``tc``): tiles of 16 tokens, every f
    tile its own block whatever m is (16 blocks along f at f = 1024, 128
    blocks at olmo-1b's width), so a token's output does not depend on the
    chunk it rides in; a tile's split is one cluster, so at most
    ``CLUSTER_MAX`` blocks. bf16 above (``tc_tall``, int8 weights too):
    tiles of 128 tokens, split along f into the most blocks (at most
    ``TALL_CLUSTER_MAX``, one portable cluster) whose grid stays within
    three quarters of the card's ``n_sm`` SMs (a block an SM), or into two
    where nothing wider fits and two fill the card: in the sweep of
    ``benchmarks/torch_fused_ffn.py`` a full wave of wider clusters ran
    slower. None at m = 2048 and olmo-1b's width (128 blocks), 2 at m = 544
    and 1024, 3 at 512, 8 at 128.

    f32 (``simt_small`` up to ``SPLIT_M_MAX`` rows, on the smallest of
    ``ROW_TILES`` that holds m and f tiles of ``SMALL_F_TILE`` channels;
    ``simt_tall`` above, on 128-row tiles of ``F_TILE`` channels; a block
    an SM): the split of least cost, waves of clusters times f tiles a
    block, the fewest blocks among equals. ``clusters(route, split)`` is
    how many clusters of ``split`` blocks of the route's body the card runs
    at once (the wrapper asks the card, for simt_small at its 64-row tile
    whatever m is, so that the split is the same for every m up to a
    chunk); by default ``n_sm // split``. On the H100 80GB HBM3 a cluster
    of 16 such blocks fits 7 times, of 8 15 times, of 3 39 times (not 44),
    so at olmo-1b's width the plan splits 8 ways up to 64 rows (one
    128-channel tile a block), 8 at 544 rows (3 waves of 2 tiles a block)
    and not at 2048."""
    chunks = -(-bo // COLS_PER_BLOCK)
    small = m <= SPLIT_M_MAX
    if dtype == torch.bfloat16:
        route, bm = ("tc", TC_ROWS) if small else ("tc_tall", TALL_ROWS)
    elif dtype == torch.float32:
        route, bm = (("simt_small", next(t for t in ROW_TILES if m <= t))
                     if small else ("simt_tall", TALL_ROWS))
    else:
        raise ValueError(f"fused_ffn kernel: x dtype {dtype}")
    n_ft = -(-f // tile_f(route))
    cells = -(-m // bm) * nb * chunks
    if route == "tc":
        split = min(n_ft, CLUSTER_MAX)
    elif route == "tc_tall":
        split = min(n_ft, TALL_CLUSTER_MAX, max(1, 3 * n_sm // 4 // cells))
        if split == 1 and n_ft > 1 and 2 * cells <= n_sm:
            split = 2
    else:
        fit = clusters or (lambda r, s: n_sm // s)
        best = None
        for split in range(1, min(n_ft, CLUSTER_MAX if small
                                  else TALL_CLUSTER_MAX) + 1):
            fpb = -(-n_ft // split)
            if -(-n_ft // fpb) != split:    # the same blocks as a smaller split
                continue
            at_once = max(fit(route, split), int(split == 1))
            if at_once < 1:             # no cluster of that size fits
                continue
            cost = -(-cells // at_once) * fpb
            if best is None or cost < best[0]:
                best = (cost, split)
        split = best[1]
    fpb = -(-n_ft // split)
    return Plan(route, bm, -(-n_ft // fpb), fpb)


def device_plan(m: int, nb: int, f: int, bo: int, dev: torch.device,
                dtype: torch.dtype, quant: bool = False) -> Plan:
    """:func:`plan` on the card ``dev``: its SM count, and how many clusters
    of each size of the SIMT bodies (int8 weights: ``quant``) it runs at
    once. What :func:`fused_ffn` runs unless forced."""
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return plan(m, nb, f, bo, _sm_count[dev.index], dtype,
                lambda route, split: _max_clusters(dev, route, quant, split))


def tile_f(route: str) -> int:
    """The f channels of one tile of the body ``route`` (a plan's ``fpb``
    counts these)."""
    return SMALL_F_TILE if route == "simt_small" else F_TILE


def simt_f32_plan(m: int, nb: int, f: int, bo: int, n_sm: int) -> Plan:
    """The plan the first f32 body (``simt_f32``) ran under: the smallest
    row tile that holds m (64 above), then enough f splits that the grid
    covers the card. :func:`plan` never picks that body; ``fused_ffn(...,
    force=simt_f32_plan(...))`` times it beside the bodies that replaced
    it."""
    n_ft = -(-f // F_TILE)
    bm = next((t for t in ROW_TILES if m <= t), ROW_TILES[-1])
    cells = -(-m // bm) * nb * -(-bo // COLS_PER_BLOCK)
    split = min(n_ft, max(1, -(-n_sm // cells)))
    fpb = -(-n_ft // split)
    return Plan("simt_f32", bm, -(-n_ft // fpb), fpb)


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
              activation: Optional[str] = "silu",
              force: Optional[Plan] = None) -> torch.Tensor:
    """Fused block-diagonal MLP ``(..., nb*bi) -> (..., nb*bo)``.

    ``w_up``/``w_gate (nb, bi, f)``, ``w_down (nb, f, bo)``, contiguous, in
    x's dtype or all int8 with their scales; biases packed ``(nb*f,)`` /
    ``(nb*bo,)``. Gated when ``w_gate`` is given. ``force`` replaces
    :func:`plan`'s choice (the card tests and the benchmark's sweep run
    other bodies and splits with it)."""
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
    p = force or device_plan(m, nb, f, bo, dev, x.dtype, quant)
    part = counters = None
    if p.split > 1 and p.route == "simt_f32":
        part = torch.empty((p.split, m, nb * bo), dtype=torch.float32,
                           device=dev)
        counters = _counter_buffer(dev, -(-m // p.rows) * nb
                                   * -(-bo // COLS_PER_BLOCK))
    vec = int(f % 4 == 0 and bo % 4 == 0
              and all(w.data_ptr() % 16 == 0 for w in weights))
    es = w_up.element_size()
    vec_w = min(_build.copy_width(w, w.shape[2] * es) for w in weights)
    lib, fn = _launcher()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = fn(x2.data_ptr(), w_up.data_ptr(), ptr(w_gate), w_down.data_ptr(),
              *(ptr(t) for t in extras), y.data_ptr(), ptr(part),
              ptr(counters), m, nb, bi, f, bo, _build.DTYPE_CODES[x.dtype],
              int(quant), ACT_CODES[activation], ROUTES[p.route], p.rows,
              p.split, p.fpb, vec, _build.copy_width(x2, bi * x2.element_size()),
              vec_w,
              _build.stream_ptr(dev))
    _build.check(lib, "fused_ffn", code)
    launches["fused_ffn"] += 1
    routes[p.route] += 1
    return y.reshape(*lead, nb * bo)
