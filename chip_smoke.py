#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA device

Phases, each printed as one JSON line:

1. ``device`` — the card's name and ``nvidia-smi`` name / power limit.
2. ``build``  — compile every CUDA kernel of the serving path from
   ``src/repro_torch/csrc`` with nvcc (sm_90a) and load it.
3. ``kernels`` — hold each kernel against its plain PyTorch version on the
   card at the main path's shapes (bdmm fp/int8 at m in {1, 4, 64} for the
   olmo-1b projection shapes; paged decode attention with ragged lengths,
   null-page entries and NaN past every length; paged prefill at start 0
   and 128 with a short final chunk and NaN-poisoned cold pages), within
   the tolerance printed beside each check; time kernel, plain version and,
   where one exists, a single PyTorch library call.
4. ``serve`` — olmo-1b at its published widths (16 layers, d 2048, vocab
   50304, every projection packed with mpd_c=8 and quantized to int8, bf16)
   served by the paged engine: 4 slots, page 16, prefill chunk 64, 8
   requests of 256-512 prompt tokens with a 128-token shared prefix and
   16-32 new tokens. Launch counters are reset just before and read just
   after; every kernel must have launched.
5. ``exact`` — the same configuration in float32, served once through the
   kernels and once with ``ops.set_backend("torch")`` (plain versions on
   the card) on the same requests: the greedy streams must be identical.

The lines before the last are the ``nvidia-smi`` line and the ``kernels``
summary; the last line is ``{"ok": true, "device": {...}}``. Any failure
exits non-zero without that line, as does a run without a CUDA device or
outside the repository. Longer logs go to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 TC / fp32 SIMT

# (name, nb, bi, bo, activation): the four packed projection shapes of
# olmo-1b at mpd_c=8 (q/k/v/o, up/gate, down, unembed)
BDMM_SHAPES = [("qkvo", 8, 256, 256, None), ("up_gate", 8, 256, 1024, "silu"),
               ("down", 8, 1024, 256, None), ("unembed", 8, 256, 6288, None)]
# stated tolerances, |kernel - plain| <= atol + rtol * |plain|
TOL = {
    # one bf16 rounding in the kernel vs up to three in the plain bf16 path
    ("bdmm", "bfloat16"): (1e-3, 2e-2),
    # f32 accumulation order only
    ("bdmm", "float32"): (1e-4, 1e-4),
    ("attn", "float32"): (2e-5, 1e-4),
}
# bf16 attention is held against the plain version computed in f32 on the
# same bf16 values. The kernel rounds each p to bf16 before PV and rounds the
# output once, each to within u = 2^-8 relative, so
#   |kernel - plain_f32| <= atol + u * (|plain_f32| + sum_j p_j |v_j|)
# where sum_j p_j |v_j| is the plain version run on |V|. (The plain version
# at bf16 rounds every score to bf16 as well, which alone moves p by ~2^-8.)
ATTN_BF16 = {"atol": 2e-5, "u": 2.0 ** -8}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


# --------------------------------------------------------------- measuring
class Timer:
    """CUDA-event timing of single launches with the L2 cache flushed
    before each (the main path finds every weight and page cold: a decode
    step streams ~0.4 GB between two visits of the same tensor). A GPU
    sleep queued first lets the host enqueue every launch before the card
    reaches them, so the events time the device work and not the host's
    launch gaps."""

    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 15) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(100_000_000)          # ~50 ms of spinning
        for a, b in ev:
            self.flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def close(torch, got, want, kind, dtype, mag=None):
    """(ok, max |got - want|, max of |got - want| over its limit, tolerance).
    ``mag`` (sum_j p_j |v_j|) selects the bf16 attention rule."""
    g, w = got.float(), want.float()
    if mag is None:
        atol, rtol = TOL[(kind, dtype)]
        lim = atol + rtol * w.abs()
        tol = {"atol": atol, "rtol": rtol}
    else:
        lim = ATTN_BF16["atol"] + ATTN_BF16["u"] * (w.abs() + mag.float())
        tol = dict(ATTN_BF16, rule="atol + u * (|plain_f32| + sum p|v|)")
    err = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool((err <= lim).all())
    return ok, float(err.max()), float((err / lim).max()), tol


def attn_check(torch, got, plain32, dropped, dtype):
    """Hold an attention kernel's output against the f32 plain version
    ``plain32(v_pages)`` on the same values, and show that the same rule
    rejects ``dropped``: the plain output with the last page of context
    left out."""
    want = plain32(None)
    mag = plain32("abs") if dtype == "bfloat16" else None
    ok, err, ratio, tol = close(torch, got, want, "attn", dtype, mag)
    rejects = not close(torch, dropped, want, "attn", dtype, mag)[0]
    return ok and rejects, err, ratio, tol, rejects


# ----------------------------------------------------------------- kernels
def check_bdmm(torch, dev, timer, rows, summary):
    from repro_torch.kernels import bdmm as bk
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import quantize_blocks

    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(s, m, q, "bfloat16") for s in BDMM_SHAPES for m in (1, 4, 64)
             for q in (False, True)]
    # the f32 forms the exactness phase runs, one per grid
    cases += [(BDMM_SHAPES[1], m, True, "float32") for m in (4, 64)]
    for (name, nb, bi, bo, act), m, quant, dt in cases:
        dtype = getattr(torch, dt)
        x = torch.randn((m, nb * bi), generator=gen, device=dev).to(dtype)
        w = torch.randn((nb, bi, bo), generator=gen, device=dev) * bi ** -0.5
        if quant:
            wq, scale = quantize_blocks(w)
            run = lambda: bk.bdmm(x, wq, None, scale, activation=act)
            plain = lambda: ref.bdmm_quant_ref(x, wq, scale, None, act)
            library = None          # no PyTorch call takes int8 x bf16 blocks
            w_bytes = wq.numel() + scale.numel() * 4
        else:
            wf = w.to(dtype)
            run = lambda: bk.bdmm(x, wf, activation=act)
            plain = lambda: ref.bdmm_ref(x, wf, None, act)
            xt = x.view(m, nb, bi).transpose(0, 1)
            library = lambda: torch.bmm(xt, wf)
            w_bytes = wf.numel() * wf.element_size()
        ok, err, ratio, tol = close(torch, run(), plain(), "bdmm", dt)
        es = x.element_size()
        nbytes = m * nb * bi * es + w_bytes + m * nb * bo * es
        b_ms, b_by = bound(nbytes, 2.0 * m * nb * bi * bo, dt)
        grid = "bdmm_decode" if m <= bk.SMALL_M_MAX else "bdmm"
        row = {"phase": "kernels", "kernel": grid, "shape": name, "m": m,
               "weights": "int8" if quant else dt, "dtype": dt,
               "max_abs_err": err, "err_over_tol": ratio, "tol": tol,
               "ok": ok, "ms": timer.ms(run), "plain_ms": timer.ms(plain),
               "library_ms": timer.ms(library) if library else None,
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        emit(row)
        s = summary[grid]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
        # the summary line times the int8 bf16 call that carries the most
        # weight bytes on the main path: the unembed at the decode batch
        # (decode grid) and the up/gate projection of a prefill chunk
        if dt == "bfloat16" and quant and (
                (grid == "bdmm_decode" and name == "unembed" and m == 4)
                or (grid == "bdmm" and name == "up_gate")):
            s.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
            s["at"] = f"int8 {name} m={m}"


def _pool(torch, dev, gen, n_pages, ps, kh, dh, dtype):
    kp = torch.randn((n_pages, ps, kh, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_pages, ps, kh, dh), generator=gen, device=dev).to(dtype)
    return kp, vp


def _gather_sdpa(torch, q, kp, vp, bt, depth_mask, g):
    """The SDPA yardstick: K/V pre-gathered into a contiguous view (the
    gather is not timed), boolean mask per (query, key)."""
    import torch.nn.functional as F
    B, P = bt.shape
    _, ps, kh, dh = kp.shape
    k = kp[bt.long()].reshape(B, P * ps, kh, dh).transpose(1, 2)
    v = vp[bt.long()].reshape(B, P * ps, kh, dh).transpose(1, 2)
    k = k.repeat_interleave(g, dim=1).contiguous()
    v = v.repeat_interleave(g, dim=1).contiguous()
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=depth_mask)


def check_paged_attention(torch, dev, timer, rows, summary):
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(2)
    ps, P = 16, 34
    cases = [  # (H, Kh, lengths, dtype)
        (16, 16, [1, 37, 300, 544], "bfloat16"),
        (16, 16, [511, 512, 530, 544], "bfloat16"),   # timed: end of the run
        (16, 4, [1, 16, 17, 250], "bfloat16"),         # GQA 4:1
        (16, 16, [1, 37, 300, 544], "float32"),
    ]
    for idx, (H, kh, lengths, dt) in enumerate(cases):
        dtype = getattr(torch, dt)
        B, dh = len(lengths), 128
        n_pages = B * P + 1
        kp, vp = _pool(torch, dev, gen, n_pages, ps, kh, dh, dtype)
        q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        bt = torch.zeros((B, P), dtype=torch.int32, device=dev)
        for b, L in enumerate(lengths):
            n = math.ceil(L / ps)
            bt[b, :n] = perm[b * P:b * P + n].int()
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)

        def plain32(v_mode, ln=ln, q=q, kp=kp, vp=vp, bt=bt):
            v = vp.float().abs() if v_mode == "abs" else vp.float()
            return ref.paged_attention_ref(q.float(), kp.float(), v, bt, ln)
        dropped = ref.paged_attention_ref(q.float(), kp.float(), vp.float(),
                                          bt, (ln - ps).clamp(min=1))
        # poison everything the kernel must not read: the null page and
        # every position at or past each row's length
        kpp, vpp = kp.clone(), vp.clone()
        kpp[0] = float("nan")
        vpp[0] = float("nan")
        for b, L in enumerate(lengths):
            last = int(bt[b, (L - 1) // ps])
            kpp[last, (L - 1) % ps + 1:] = float("nan")
            vpp[last, (L - 1) % ps + 1:] = float("nan")
        run = lambda: pk.paged_attention(q, kpp, vpp, bt, ln)
        ok, err, ratio, tol, rejects = attn_check(torch, run(), plain32,
                                                  dropped, dt)
        es = q.element_size()
        kv_tok = sum(lengths)
        nbytes = 2 * q.numel() * es + 2 * kv_tok * kh * dh * es + bt.numel() * 4
        ops = 4.0 * H * dh * kv_tok
        b_ms, b_by = bound(nbytes, ops, dt)
        mask = (torch.arange(P * ps, device=dev)[None, :]
                < ln[:, None])[:, None, None, :]
        lib = _gather_sdpa(torch, q[:, :, None, :], kp, vp, bt, mask, H // kh)
        row = {"phase": "kernels", "kernel": "paged_attention", "H": H,
               "Kh": kh, "lengths": lengths, "dtype": dt, "max_abs_err": err,
               "err_over_tol": ratio, "tol": tol,
               "rejects_dropped_page": rejects, "ok": ok, "ms": timer.ms(run),
               "plain_ms": timer.ms(lambda: ref.paged_attention_ref(
                   q, kp, vp, bt, ln)),
               "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        emit(row)
        s = summary["paged_attention"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
        if idx == 1:
            s.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
            s["at"] = f"B=4 H=Kh=16 lengths={lengths}"


def check_paged_prefill(torch, dev, timer, rows, summary):
    from repro_torch.kernels import paged_prefill as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(3)
    ps, Tc, dh = 16, 64, 128
    cases = [  # (H, Kh, start, chunk_len, dtype)
        (16, 16, 0, 50, "bfloat16"),
        (16, 16, 128, 37, "bfloat16"),
        (16, 16, 448, 64, "bfloat16"),     # timed: last chunk of 512 tokens
        (16, 4, 128, 37, "bfloat16"),       # GQA 4:1
        (16, 16, 128, 37, "float32"),
    ]
    for idx, (H, kh, start, clen, dt) in enumerate(cases):
        dtype = getattr(torch, dt)
        P = 1 << (math.ceil((start + Tc) / ps) - 1).bit_length()
        n_pages = P + 8
        kp, vp = _pool(torch, dev, gen, n_pages, ps, kh, dh, dtype)
        q = torch.randn((Tc, H, dh), generator=gen, device=dev).to(dtype)
        bt = (torch.randperm(n_pages - 1, generator=gen, device=dev)[:P] + 1).int()
        depth = start + clen
        n_live = math.ceil(depth / ps)
        bt[n_live:] = 0                                     # null entries

        def plain32(v_mode, q=q, kp=kp, vp=vp, bt=bt, start=start, clen=clen):
            v = vp.float().abs() if v_mode == "abs" else vp.float()
            return ref.paged_prefill_attention_ref(q.float(), kp.float(), v,
                                                   bt, start, clen)
        dropped = ref.paged_prefill_attention_ref(
            q.float(), kp.float(), vp.float(), bt, start, clen - ps)
        kpp, vpp = kp.clone(), vp.clone()
        cold = [0] + [int(p) for p in bt[n_live:]]
        kpp[cold] = float("nan")
        vpp[cold] = float("nan")
        last = int(bt[n_live - 1])
        kpp[last, (depth - 1) % ps + 1:] = float("nan")
        vpp[last, (depth - 1) % ps + 1:] = float("nan")
        run = lambda: pk.paged_prefill_attention(q, kpp, vpp, bt, start, clen)
        ok, err, ratio, tol, rejects = attn_check(torch, run(), plain32,
                                                  dropped, dt)
        es = q.element_size()
        nbytes = 2 * q.numel() * es + 2 * depth * kh * dh * es + bt.numel() * 4
        visible = sum(min(start + t + 1, depth) for t in range(Tc))
        b_ms, b_by = bound(nbytes, 4.0 * H * dh * visible, dt)
        kv_pos = torch.arange(P * ps, device=dev)
        q_pos = start + torch.arange(Tc, device=dev)
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] < depth))[None, None]
        lib = _gather_sdpa(torch, q.transpose(0, 1)[None], kp, vp, bt[None],
                           mask, H // kh)
        row = {"phase": "kernels", "kernel": "paged_prefill_attention",
               "H": H, "Kh": kh, "Tc": Tc, "start": start,
               "chunk_len": clen, "dtype": dt, "max_abs_err": err,
               "err_over_tol": ratio, "tol": tol,
               "rejects_dropped_page": rejects, "ok": ok, "ms": timer.ms(run),
               "plain_ms": timer.ms(lambda: ref.paged_prefill_attention_ref(
                   q, kp, vp, bt, start, clen)),
               "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        emit(row)
        s = summary["paged_prefill_attention"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
        if idx == 2:
            s.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
            s["at"] = f"Tc=64 start={start} chunk_len={clen}"


# ------------------------------------------------------------------ serving
def olmo_engine(torch, dev, dtype, seed=0):
    from repro_torch.core import export
    from repro_torch.configs.common import get_config
    from repro_torch.models import build

    cfg = get_config("olmo-1b", dtype=dtype)
    model = build(cfg)
    params, report = export.quantize_packed(model, model.init(seed, device=dev))
    torch.cuda.synchronize()
    return cfg, model, params, report


def serve_phase(torch, dev, ops):
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.serve import Engine

    t0 = time.perf_counter()
    cfg, model, params, report = olmo_engine(torch, dev, "bfloat16")
    setup_s = time.perf_counter() - t0
    kw = dict(n_slots=4, max_len=512 + 32, page_size=16,
              prefill_chunk_tokens=64)
    # warm-up: first-call costs (library loads, allocator growth) stay out
    # of the measured run
    warm = Engine(model, params, **kw)
    warm.run(make_requests(cfg, n_requests=2, rate=1e9, prompt_len=128,
                           gen=4, seed=99))
    del warm

    engine = Engine(model, params, **kw)
    reqs = make_requests(cfg, n_requests=8, rate=16.0, prompt_len=512, gen=32,
                         seed=0, shared_prefix=128)
    step_ms = {"decode": [], "prefill": []}

    def timed(fn, key):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    model.decode_step = timed(model.decode_step, "decode")
    model.prefill_chunk = timed(model.prefill_chunk, "prefill")
    ops.reset_launch_counts()
    summary = serve_stream(engine, reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    del model.decode_step, model.prefill_chunk

    # where a steady decode step's time goes, from the profiler
    window = decode_window(torch, model, params, kw, cfg)

    done = summary["n_done"] == len(reqs) and all(
        len(r.generated) == r.max_new_tokens
        and all(0 <= t < cfg.vocab for t in r.generated) for r in reqs)
    ok = done and all(n > 0 for n in launches.values())
    row = {"phase": "serve", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "mpd_c": cfg.mpd_c, "weights": "int8",
        "dtype": cfg.dtype, "slots": 4, "page_size": 16, "prefill_chunk": 64},
        "setup_s": setup_s, "quant_max_rel_rms": report["max_rel_rms"],
        "requests_done": summary["n_done"], "requests": len(reqs),
        "prompt_tokens": [len(r.prompt) for r in reqs],
        "new_tokens": [len(r.generated) for r in reqs],
        "prefill_tokens_computed": engine.n_prefill_tokens,
        "prefill_tokens_reused": engine.n_prefill_tokens_skipped,
        "tok_s": summary["agg_tok_s"], "elapsed_s": summary["elapsed_s"],
        "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
        "ttft_p95_ms": summary["ttft_p95_s"] * 1e3,
        "e2e_p50_ms": summary["e2e_p50_s"] * 1e3,
        "e2e_p95_ms": summary["e2e_p95_s"] * 1e3,
        "decode_steps": len(step_ms["decode"]),
        "decode_step_ms_p50": statistics.median(step_ms["decode"]),
        "prefill_chunks": len(step_ms["prefill"]),
        "prefill_chunk_ms_p50": statistics.median(step_ms["prefill"]),
        "decode_window": window,
        "occupancy_mean": summary["occupancy_mean"],
        "kv_bytes_allocated_peak": summary["kv_bytes_allocated_peak"],
        "launches": launches}
    emit(row)
    return row


def decode_window(torch, model, params, kw, cfg, n_steps=16):
    """Where a steady decode step's time goes: 16 decode steps of 4 live
    slots at the serve phase's context depths (~250-540 tokens), under
    torch.profiler. Returns wall ms per step, device kernel ms per step by
    kernel family, and the device's busy share; the device entries are None
    when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    eng = Engine(model, params, **kw)
    for r in make_requests(cfg, n_requests=4, rate=1e9, prompt_len=448,
                           gen=32, seed=7, shared_prefix=128):
        r.max_new_tokens = 96           # every slot stays live in the window
        eng.submit(r)
    while eng._prefill_queue or eng.scheduler.waiting:
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    cuda = torch.autograd.DeviceType.CUDA
    families = {"bdmm_decode_kernel": 0.0, "bdmm_general_kernel": 0.0,
                "paged_attention_kernel": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != cuda:
            continue
        key = next((k for k in families if k in e.name), "other")
        families[key] += getattr(e, "self_device_time_total", 0) / 1e3
    device_ms = sum(families.values()) / n_steps
    return {"steps": n_steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": ({k: v / n_steps for k, v in families.items()}
                                   if device_ms > 0 else None),
            "device_busy_share": device_ms / wall_ms if device_ms > 0 else None}


def exact_phase(torch, dev, ops):
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    cfg, model, params, _ = olmo_engine(torch, dev, "float32")
    kw = dict(n_slots=4, max_len=256 + 16, page_size=16,
              prefill_chunk_tokens=64)
    streams = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        try:
            reqs = make_requests(cfg, n_requests=6, rate=1e9, prompt_len=256,
                                 gen=16, seed=1, shared_prefix=64)
            streams[backend] = Engine(model, params, **kw).run(reqs)
        finally:
            ops.set_backend("cuda")
    a, b = streams["cuda"], streams["torch"]
    diverge = []
    for rid in sorted(a):
        if a[rid] != b[rid]:
            first = next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                          if x != y), min(len(a[rid]), len(b[rid])))
            diverge.append({"request": rid, "first_index": first})
    row = {"phase": "exact", "ok": not diverge, "dtype": "float32",
           "n_layers": cfg.n_layers, "requests": len(a),
           "tokens": sum(len(v) for v in a.values()),
           "diverging_requests": diverge}
    emit(row)
    return row


# --------------------------------------------------------------------- main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    (OUT_DIR / "nvcc.log").write_text("\n".join(
        f"=== {n} ===\n{log}" for n, log in _build.build_log.items()))
    emit({"phase": "build", "ok": True,
          "seconds": time.perf_counter() - t0,
          "ptxas": [ln.strip() for log in _build.build_log.values()
                    for ln in log.splitlines() if "registers" in ln][:40]})

    names = {"bdmm": "src/repro/kernels/bdmm.py:67 (_bdmm_kernel)",
             "bdmm_decode": "src/repro/kernels/bdmm.py:100 (_bdmm_decode_kernel)",
             "paged_prefill_attention":
                 "src/repro/kernels/paged_prefill.py:72 (_paged_prefill_kernel)",
             "paged_attention":
                 "src/repro/kernels/paged_attention.py:56 (_paged_attn_kernel)"}
    sources = {"bdmm": "src/repro_torch/csrc/bdmm.cu",
               "bdmm_decode": "src/repro_torch/csrc/bdmm.cu",
               "paged_prefill_attention": "src/repro_torch/csrc/paged_prefill.cu",
               "paged_attention": "src/repro_torch/csrc/paged_attention.cu"}
    summary = {n: {"max_abs_err": 0.0, "err_over_tol": 0.0, "ok": True}
               for n in names}
    timer = Timer(torch, dev)
    rows = []
    check_bdmm(torch, dev, timer, rows, summary)
    check_paged_attention(torch, dev, timer, rows, summary)
    check_paged_prefill(torch, dev, timer, rows, summary)
    del timer
    (OUT_DIR / "kernels.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n")
    failed = [f"kernel {r['kernel']} {r}" for r in rows if not r["ok"]]
    served = serve_phase(torch, dev, ops)
    launches = served["launches"]
    if not served["ok"]:
        failed.append("serve")
    if not exact_phase(torch, dev, ops)["ok"]:
        failed.append("exact")

    kernels = []
    for n, replaces in names.items():
        s = summary[n]
        kernels.append({"name": n, "route": "cuda", "source": sources[n],
                        "replaces": replaces, "launches": launches.get(n, 0),
                        "max_abs_err": s["max_abs_err"],
                        "err_over_tol": s["err_over_tol"],
                        "ms": s.get("ms"), "plain_ms": s.get("plain_ms"),
                        "bound_ms": s.get("bound_ms"),
                        "bound_by": s.get("bound_by"),
                        "library_ms": s.get("library_ms"), "at": s.get("at")})
    if failed:
        emit({"phase": "result", "ok": False, "failed": failed[:20]})
        return 1
    print(smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
