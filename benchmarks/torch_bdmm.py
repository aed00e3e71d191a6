"""Time the port's bdmm (general grid, decode grid) and its SDDMM on the
card, and break their tensor-core bodies down by part.

    python benchmarks/torch_bdmm.py              # --mode time
    python benchmarks/torch_bdmm.py --mode breakdown
    python benchmarks/torch_bdmm.py --mode decode
    python benchmarks/torch_bdmm.py --mode decode_breakdown
    python benchmarks/torch_bdmm.py --mode decode_sweep
    python benchmarks/torch_bdmm.py --mode f32
    python benchmarks/torch_bdmm.py --mode f32_sweep
    python benchmarks/torch_bdmm.py --mode f32_breakdown

``time``: bf16 ``bdmm`` at olmo-1b's four packed shapes (nb 8; q/k/v/o,
up/gate with silu, down, unembed), forward and dx (the transposed-blocks
orientation) at m = 2048 tokens (4 x 512, packed training), and the forward
with bf16 and int8 blocks at m = 64 (one prefill chunk), each against the
plain version (max |error| in f32) and, for bf16 blocks, one ``torch.bmm``
over the same blocks; then the bf16 SDDMM at the four masked-dense
projection shapes at m = 2048 against its plain version and one
``torch.matmul`` ``xᵀ @ g``. Each row names the body that ran.

``breakdown``: builds variants of ``csrc/bdmm.cu`` and
``csrc/masked_matmul.cu`` with one part of a tensor-core body removed (the
wgmmas, the output stores - bdmm's TMA stores, the SDDMM's masked stores -
or both) and times each on the up/gate shape at m = 2048 (bdmm forward and
dx, the SDDMM). A variant computes wrong values; only its time means
anything. What is left when a part is gone bounds what that part costs.

``decode``: the decode grid (m <= 32, bf16 x) at the four packed shapes,
m = 1, 4, 20 and 32, with bf16 and int8 blocks, against the plain version,
one ``torch.bmm`` (bf16 blocks) and the bound (bytes at 3.35 TB/s or bf16
operations at 989 TFLOP/s), with the plan (split, K range) that ran.

``decode_breakdown``: the decode grid's mma.sync body built with its
phases cut (``-DREPRO_CUT``): the loads alone (every cp.async issued and
waited for), then + the products (kept in shared memory, so that every
mma is waited for), then the whole kernel (+ the epilogue and the split
reduction), at the four shapes, m = 4 and 32, both kinds of blocks. The cut variants compute nothing useful; only their times mean
anything.

``decode_sweep``: the decode grid with K cut into ranges of 64, 128, ...
rows a block (at most 8 splits, up to all of K) at the four shapes, m = 4
and 32.

``f32``: the exact f32 bodies (``decode_simt``, ``simt_small``,
``simt_f32``) at the paper path's shapes and the parity rows: the speedup
layer's (8, 256, 256) blocks at m = 2048 and 512 (forward and dx), each of
the nine LeNet blocks at m = 1, 50 (forward and dx) and 2048, and olmo-1b's
int8 up/gate with f32 x at m = 64 and 4; each
with its plan, the max |error| against the plain version, one
``torch.bmm`` over the same blocks (for int8 blocks a labelled yardstick:
``torch.bmm`` over the blocks widened to f32 outside the timed call, then
the scale) and the bound (bytes at 3.35 TB/s or operations at 67 TFLOP/s).

``f32_sweep``: the same calls launched under other plans than ``plan``
picks (the small and the tiled body, K splits of 1 to 16), through
``bdmm.launch``, so that the plan's choices are measured (the plan's own
choice is marked).

``f32_breakdown``: the f32 rows built as variants: on the small bodies
with their phases cut (``-DREPRO_CUT``: the launch alone, the loads alone,
+ the products, the whole kernel with its sums and stores), on the tiled
body with the forward's K step of 32 for 16 (``-DREPRO_SIMT_FWD_BK``) and
8 channels a thread for 4 (``-DREPRO_SIMT_TN``: 256 threads for 512).
A cut variant computes nothing useful; only its time means anything.

Times are CUDA-event medians of 10 calls with the L2 cache flushed before
each, after the card's clocks are brought up. Needs an NVIDIA GPU (sm_90a)
and nvcc; prints one JSON object a line
and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core.fold import mask_tensor  # noqa: E402
from repro_torch.core.mask import make_mask_spec  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import bdmm as bk  # noqa: E402
from repro_torch.kernels import masked_matmul as mk  # noqa: E402
from repro_torch.kernels.quant import quantize_blocks  # noqa: E402

# (name, nb, bi, bo, activation): olmo-1b's packed projections at mpd_c=8
BDMM_SHAPES = [("qkvo", 8, 256, 256, None), ("up_gate", 8, 256, 1024, "silu"),
               ("down", 8, 1024, 256, None), ("unembed", 8, 256, 6288, None)]
# (name, d_in, d_out): olmo-1b's masked-dense projections
MM_SHAPES = [("qkvo", 2048, 2048), ("up_gate", 2048, 8192),
             ("down", 8192, 2048), ("unembed", 2048, 50304)]

# the parts of a body a breakdown variant drops: (source, exact text, with)
PARTS = {
    "bdmm_mma": ("bdmm",
                 "        wgmma<BT_BQ, 0, TRANS ? 0 : 1>(acc, desc_k(sx + wg * 8192, kk),\n"
                 "                                       TRANS ? desc_k(sw, kk) : desc_mn(sw, kk));\n",
                 "        (void)sw;\n"),
    "bdmm_store": ("bdmm",
                   "      tma_store(&maps.y, smem_u32(out), ch0, blk, tok0 + wg * 64);\n"
                   "      tma_store(&maps.y, smem_u32(out) + 8192, ch0 + 64, blk, tok0 + wg * 64);\n",
                   ""),
    "sddmm_mma": ("masked_matmul",
                  "        wgmma<SD_BQ, 1, 1>(acc[j], desc_mn(sx + (wg * 2 + j) * 8192, kk), db);\n",
                  "        (void)db;\n"),
    "sddmm_store": ("masked_matmul",
                    "      *reinterpret_cast<uint4*>(a.dw + off) = v;\n",
                    "      if (v.x == 0x12345u) a.dw[0] = from_f32<bf16>(1.f);\n"),
}
VARIANTS = {"full": (), "no_store": ("store",), "no_mma": ("mma",),
            "loads_only": ("mma", "store")}


def timer(dev):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    a = torch.randn(4096, 4096, device=dev)
    for _ in range(100):      # bring the card's clocks up before the first row
        a @ a
    del a

    def ms(fn, iters=10):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(50_000_000)
        for a, b in ev:
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in ev)[iters // 2]
    return ms


def routed(fn):
    """``fn()`` and the general-grid bodies it launched."""
    before = dict(bk.routes)
    out = fn()
    return out, sorted(r for r in bk.routes if bk.routes[r] != before[r])


def mode_time(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    for name, nb, bi, bo, act in BDMM_SHAPES:
        w = r(nb, bi, bo) * bi ** -0.5
        wb = w.bfloat16()
        for m, role, quant in ((2048, "fwd", False), (2048, "dx", False),
                               (64, "fwd", False), (64, "fwd", True)):
            dx = role == "dx"
            k, n = (bo, bi) if dx else (bi, bo)
            a = None if dx else act
            x = r(m, nb * k).bfloat16()
            if quant:
                wq, s = quantize_blocks(w)
                run = lambda: bk.bdmm(x, wq, None, s, activation=a)  # noqa: E731
                plain = lambda: ref.bdmm_quant_ref(x, wq, s, None, a)  # noqa: E731
                want = ref.bdmm_quant_ref(x.float(), wq, s, None, a)
                library = None
            else:
                run = lambda: bk.bdmm(x, wb, activation=a, transpose=dx)  # noqa: E731
                if dx:
                    plain = lambda: ref.bdmm_t_ref(x, wb)  # noqa: E731
                    want = ref.bdmm_t_ref(x.float(), wb.float())
                    library = lambda: torch.bmm(  # noqa: E731
                        x.view(m, nb, k).transpose(0, 1), wb.transpose(1, 2))
                else:
                    plain = lambda: ref.bdmm_ref(x, wb, None, a)  # noqa: E731
                    want = ref.bdmm_ref(x.float(), wb.float(), None, a)
                    library = lambda: torch.bmm(  # noqa: E731
                        x.view(m, nb, k).transpose(0, 1), wb)
            got, used = routed(run)
            print(json.dumps({
                "kernel": "bdmm", "shape": name, "m": m, "role": role,
                "weights": "int8" if quant else "bfloat16", "routes": used,
                "max_abs_err": float((got.float() - want).abs().max()),
                "ms": ms(run), "plain_ms": ms(plain),
                "library_ms": ms(library) if library else None}), flush=True)
            del x, got, want
    m = 2048
    for name, d_in, d_out in MM_SHAPES:
        mask = mask_tensor(make_mask_spec(d_in, d_out, 8, seed=1), dev)
        x, g = r(m, d_in).bfloat16(), r(m, d_out).bfloat16()
        run = lambda: mk.sddmm_masked(x, g, mask)  # noqa: E731
        want = ref.matmul_masked_grad_ref(x.float(), g.float(), mask)
        before = dict(mk.sddmm_routes)
        got = run()
        print(json.dumps({
            "kernel": "sddmm_masked", "shape": name, "m": m,
            "routes": sorted(k for k in mk.sddmm_routes
                             if mk.sddmm_routes[k] != before[k]),
            "max_abs_err": float((got.float() - want).abs().max()),
            "offmask_exact_zero": bool((got[mask == 0] == 0).all()),
            "ms": ms(run),
            "plain_ms": ms(lambda: ref.matmul_masked_grad_ref(x, g, mask)),
            "library_ms": ms(lambda: torch.matmul(x.T, g))}), flush=True)
        del mask, x, g, got, want


def build_variants(out_dir: Path):
    """``{(source, variant): launch function}`` for every variant of both
    sources, built in parallel."""
    procs = {}
    for source in ("bdmm", "masked_matmul"):
        src = (_build.CSRC / f"{source}.cu").read_text()
        prefix = "bdmm" if source == "bdmm" else "sddmm"
        for name, drop in VARIANTS.items():
            text = src
            for part in drop:
                _, old, new = PARTS[f"{prefix}_{part}"]
                if old not in text:
                    raise SystemExit(f"breakdown: part {prefix}_{part} not found "
                                     "in the source; update PARTS")
                text = text.replace(old, new)
            cu = out_dir / f"{source}_{name}.cu"
            cu.write_text(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                   "-o", str(out_dir / f"{source}_{name}.so"), str(cu)]
            procs[(source, name)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for (source, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {source} {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{source}_{name}.so"))
        if source == "bdmm":
            fn = lib.bdmm_launch
            fn.argtypes = [P] * 6 + [I] * 14 + [P]
        else:
            fn = lib.sddmm_masked_launch
            fn.argtypes = [P, P, P, P] + [I] * 8 + [P]
        fn.restype = I
        fns[(source, name)] = fn
    return fns


def mode_breakdown(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    m, nb, bi, bo = 2048, 8, 256, 1024
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))

        def check(code):
            if code:
                raise SystemExit(f"launch failed: CUDA error {code}")

        w = (r(nb, bi, bo) * bi ** -0.5).bfloat16()
        bias = (0.1 * r(nb * bo)).float()
        x, g = r(m, nb * bi).bfloat16(), r(m, nb * bo).bfloat16()
        y, dx = (torch.empty(m, nb * bo, dtype=torch.bfloat16, device=dev),
                 torch.empty(m, nb * bi, dtype=torch.bfloat16, device=dev))

        def bdmm_call(fn, inp, out, k, n, trans, b, act):
            p = bk.plan(m, nb, k, n, torch.bfloat16, torch.bfloat16, trans)
            check(fn(inp.data_ptr(), w.data_ptr(), None,
                     b.data_ptr() if b is not None else None, out.data_ptr(),
                     None, m, nb, k, n, 1, 0, act, bk.ROUTES[p.route],
                     int(trans), 16, 16, p.grid[0], 1, p.k_chunk, stream))
        mask = mask_tensor(make_mask_spec(2048, 8192, 8, seed=1), dev)
        xs, gs = r(m, 2048).bfloat16(), r(m, 8192).bfloat16()
        dw = torch.empty(2048, 8192, dtype=torch.bfloat16, device=dev)
        for name in VARIANTS:
            fb, fs = fns[("bdmm", name)], fns[("masked_matmul", name)]
            print(json.dumps({
                "variant": name, "m": m, "bdmm": f"up/gate nb {nb} {bi}x{bo}",
                "fwd_silu_bias_ms": ms(lambda: bdmm_call(fb, x, y, bi, bo, False,
                                                         bias, 1)),
                "fwd_ms": ms(lambda: bdmm_call(fb, x, y, bi, bo, False, None, 0)),
                "dx_ms": ms(lambda: bdmm_call(fb, g, dx, bo, bi, True, None, 0)),
                "sddmm": "up/gate 2048x8192",
                "sddmm_ms": ms(lambda: check(fs(
                    xs.data_ptr(), gs.data_ptr(), mask.data_ptr(), dw.data_ptr(),
                    m, 2048, 8192, 1, mk.SDDMM_ROUTES["tc"], 16, 16, 16,
                    stream)))}), flush=True)


DECODE_M = (1, 4, 20, 32)
CUTS = {"loads": 1, "products": 2, "full": 0}


def _decode_case(gen, dev, nb, bi, bo, m, quant):
    """bf16 x, the blocks (bf16, or int8 with a scale) and what each moves."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    x = r(m, nb * bi).bfloat16()
    w = r(nb, bi, bo) * bi ** -0.5
    if quant:
        wq, s = quantize_blocks(w)
        return x, wq, s, wq.numel() + s.numel() * 4
    wb = w.bfloat16()
    return x, wb, None, wb.numel() * 2


def mode_decode(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, nb, bi, bo, act in BDMM_SHAPES:
        for quant in (False, True):
            for m in DECODE_M:
                x, wp, s, w_bytes = _decode_case(gen, dev, nb, bi, bo, m, quant)
                run = lambda: bk.bdmm(x, wp, None, s, activation=act)  # noqa: E731
                if quant:
                    plain = lambda: ref.bdmm_quant_ref(x, wp, s, None, act)  # noqa: E731
                    want = ref.bdmm_quant_ref(x.float(), wp, s, None, act)
                    library = None
                else:
                    plain = lambda: ref.bdmm_ref(x, wp, None, act)  # noqa: E731
                    want = ref.bdmm_ref(x.float(), wp.float(), None, act)
                    library = lambda: torch.bmm(  # noqa: E731
                        x.view(m, nb, bi).transpose(0, 1), wp)
                got, used = routed(run)
                p = bk.plan(m, nb, bi, bo, torch.bfloat16, wp.dtype)
                nbytes = m * nb * bi * 2 + w_bytes + m * nb * bo * 2
                bound = max(nbytes / 3.35e12, 2.0 * m * nb * bi * bo / 989e12) * 1e3
                print(json.dumps({
                    "kernel": "bdmm_decode", "shape": name, "m": m,
                    "weights": "int8" if quant else "bfloat16", "routes": used,
                    "split": p.split, "k_chunk": p.k_chunk, "grid": p.grid,
                    "max_abs_err": float((got.float() - want).abs().max()),
                    "ms": ms(run), "plain_ms": ms(plain),
                    "library_ms": ms(library) if library else None,
                    "bound_ms": bound}), flush=True)


def mode_decode_breakdown(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.variants("bdmm", {c: {"REPRO_CUT": v} if v else {}
                                        for c, v in CUTS.items()}, Path(tmp))
        fns = {c: lib.bdmm_launch for c, lib in libs.items()}
        for fn in fns.values():
            fn.argtypes = [P] * 6 + [I] * 14 + [P]
            fn.restype = I
        for name, nb, bi, bo, act in BDMM_SHAPES:
            for quant in (False, True):
                for m in (4, 32):
                    x, wp, s, _ = _decode_case(gen, dev, nb, bi, bo, m, quant)
                    p = bk.plan(m, nb, bi, bo, torch.bfloat16, wp.dtype)
                    y = torch.empty(m, nb * bo, dtype=torch.bfloat16, device=dev)

                    def call(fn):
                        code = fn(x.data_ptr(), wp.data_ptr(),
                                  s.data_ptr() if s is not None else None, None,
                                  y.data_ptr(), None, m, nb, bi, bo, 1, int(quant), bk.ACT_CODES[act],
                                  bk.ROUTES["decode_tc"], 0,
                                  _build.copy_width(x, bi * 2),
                                  _build.copy_width(wp, bo * wp.element_size()),
                                  1, p.split, p.k_chunk, stream)
                        if code:
                            raise SystemExit(f"launch failed: CUDA error {code}")
                    print(json.dumps({
                        "kernel": "bdmm_decode", "shape": name, "m": m,
                        "weights": "int8" if quant else "bfloat16",
                        "split": p.split,
                        **{f"{c}_ms": ms(lambda: call(fn))
                           for c, fn in fns.items()}}), flush=True)


def mode_decode_sweep(dev, ms):
    """The decode grid with K cut into other K ranges than the plan's (64,
    128, ... rows a block, at most 8 splits, up to all of K): what the split
    costs and buys."""
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    lib, fn = bk._launcher()
    for name, nb, bi, bo, act in BDMM_SHAPES:
        for quant in (False, True):
            for m in (4, 32):
                x, wp, s, _ = _decode_case(gen, dev, nb, bi, bo, m, quant)
                y = torch.empty(m, nb * bo, dtype=torch.bfloat16, device=dev)
                row = {"kernel": "bdmm_decode", "shape": name, "m": m,
                       "weights": "int8" if quant else "bfloat16",
                       "plan_k_chunk": bk.plan(m, nb, bi, bo, torch.bfloat16,
                                               wp.dtype).k_chunk}
                k_chunk = max(64, -(-bi // bk.DECODE_SPLIT_MAX))
                while True:
                    split = -(-bi // k_chunk)

                    def call():
                        code = fn(x.data_ptr(), wp.data_ptr(),
                                  s.data_ptr() if s is not None else None, None,
                                  y.data_ptr(), None, m, nb, bi, bo, 1, int(quant), bk.ACT_CODES[act],
                                  bk.ROUTES["decode_tc"], 0, 16, 16, 1, split,
                                  k_chunk, stream)
                        _build.check(lib, "bdmm", code)
                    row[f"k{k_chunk}_ms"] = ms(call)
                    if split == 1:
                        break
                    k_chunk *= 2
                print(json.dumps(row), flush=True)


HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
LENET_BLOCKS = [(10, 80, 30), (10, 30, 10), (10, 10, 1), (4, 200, 75),
                (4, 75, 25), (2, 50, 5), (5, 160, 60), (5, 60, 20), (5, 20, 2)]
SPEEDUP = (8, 256, 256)
UP_GATE = (8, 256, 1024)
# (label, (nb, bi, bo), m, transpose, int8 blocks): every f32 row of
# chip_smoke.py's kernels phase - each LeNet block at batch 1, a training
# batch of 50 (forward and dx) and the 2048-sample eval, the speedup's
# blocks, the int8 parity rows
F32_ROWS = ([("speedup", SPEEDUP, m, t, False)
             for m, t in ((2048, False), (512, False), (512, True))]
            + [("lenet", blk, m, t, False) for blk in LENET_BLOCKS
               for m, t in ((1, False), (50, False), (50, True), (2048, False))]
            + [("parity up/gate", UP_GATE, m, False, True) for m in (64, 4)])


def f32_case(gen, dev, blocks, m, transpose, quant):
    """f32 x, the blocks (f32, or int8 with a scale), the plain version and
    its output, the yardstick (one ``torch.bmm``; for int8 over blocks
    widened beforehand, then the scale) and the blocks' bytes."""
    nb, bi, bo = blocks
    k, n = (bo, bi) if transpose else (bi, bo)
    x = torch.randn((m, nb * k), generator=gen, device=dev)
    w = torch.randn((nb, bi, bo), generator=gen, device=dev) * k ** -0.5
    xt = x.view(m, nb, k).transpose(0, 1)
    if quant:
        wq, s = quantize_blocks(w)
        wide = wq.float()
        return dict(
            x=x, wp=wq, s=s, plain=lambda: ref.bdmm_quant_ref(x, wq, s),
            want=ref.bdmm_quant_ref(x, wq, s),
            library=lambda: torch.bmm(xt, wide) * s[:, None, :],
            library_label="yardstick: torch.bmm over the int8 blocks widened "
                          "to f32 beforehand, then the scale",
            w_bytes=wq.numel() + 4 * s.numel())
    wt = w.transpose(1, 2) if transpose else w
    plain = ((lambda: ref.bdmm_t_ref(x, w)) if transpose
             else (lambda: ref.bdmm_ref(x, w)))
    return dict(x=x, wp=w, s=None, plain=plain, want=plain(),
                library=lambda: torch.bmm(xt, wt),
                library_label="one torch.bmm over the blocks",
                w_bytes=4 * w.numel())


def f32_bound(m, blocks, transpose, w_bytes):
    nb, bi, bo = blocks
    nbytes = 4 * m * nb * (bi + bo) + w_bytes
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, 2.0 * m * nb * bi * bo / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def mode_f32(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, blocks, m, t, quant in F32_ROWS:
        c = f32_case(gen, dev, blocks, m, t, quant)
        run = lambda: bk.bdmm(c["x"], c["wp"], None, c["s"], transpose=t)  # noqa: E731
        got, used = routed(run)
        nb, bi, bo = blocks
        k, n = (bo, bi) if t else (bi, bo)
        p = bk.plan(m, nb, k, n, torch.float32, c["wp"].dtype, t)
        b_ms, b_by = f32_bound(m, blocks, t, c["w_bytes"])
        # the lower of two medians: a process's first rows read slow
        kern, lib = min(ms(run), ms(run)), min(ms(c["library"]), ms(c["library"]))
        print(json.dumps({
            "kernel": "bdmm_f32", "shape": label, "blocks": blocks, "m": m,
            "role": "dx" if t else "fwd",
            "weights": "int8" if quant else "float32", "routes": used,
            "plan": {"route": p.route, "tile": p.tile, "grid": p.grid,
                     "split": p.split, "k_chunk": p.k_chunk},
            "max_abs_err": float((got - c["want"]).abs().max()),
            "ms": kern, "plain_ms": ms(c["plain"]),
            ("yardstick_ms" if quant else "library_ms"): lib,
            "library": c["library_label"], "over_library": kern / lib,
            "bound_ms": b_ms, "bound_by": b_by}), flush=True)


def mode_f32_sweep(dev, ms):
    """The f32 rows under the small and the tiled body and K splits of 1
    to 16 (8 on the tiled one), the plan's choice marked."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, blocks, m, t, quant in F32_ROWS:
        c = f32_case(gen, dev, blocks, m, t, quant)
        nb, bi, bo = blocks
        k, n = (bo, bi) if t else (bi, bo)
        chosen = bk.plan(m, nb, k, n, torch.float32, c["wp"].dtype, t)
        x, wp = c["x"], c["wp"].contiguous()
        s = None if c["s"] is None else c["s"].float().contiguous()
        y = torch.empty(m, nb * n, device=dev)
        small = "decode_simt" if chosen.route == "decode_simt" else "simt_small"
        for route in (small, "simt_f32"):
            for split in (1, 2, 4, 8, 16):
                k_chunk = mk.k_chunk_of(k, split)
                if k_chunk is None or (route == "simt_f32" and split > 8):
                    continue
                p = bk.Plan(route, bk.TILES[route], chosen.grid, split, k_chunk)
                run = functools.partial(bk.launch, p, x, wp, s, None, y, None, t)
                run()
                print(json.dumps({
                    "kernel": "bdmm_f32", "shape": label, "blocks": blocks,
                    "m": m, "role": "dx" if t else "fwd",
                    "weights": "int8" if quant else "float32",
                    "route": route, "split": split, "k_chunk": k_chunk,
                    "chosen": (route, split) == (chosen.route, chosen.split),
                    "max_abs_err": float((y - c["want"]).abs().max()),
                    "ms": min(ms(run), ms(run))}), flush=True)


def mode_f32_breakdown(dev, ms):
    """Each f32 row under its plan, built as variants: on the small bodies
    with their phases cut (the launch alone, the loads alone, + the
    products, the whole kernel); on the tiled body the build's against a
    forward K step of 32 and against 8 channels a thread (256 threads)."""
    variants = {"launch": {"REPRO_CUT": 3}, "loads": {"REPRO_CUT": 1},
                "products": {"REPRO_CUT": 2}, "full": {},
                "fwd_bk32": {"REPRO_SIMT_FWD_BK": 32}, "tn8": {"REPRO_SIMT_TN": 8}}
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        libs = _build.variants("bdmm", variants, Path(tmp))
        fns = {c: lib.bdmm_launch for c, lib in libs.items()}
        for fn in fns.values():
            fn.argtypes = [P] * 6 + [I] * 14 + [P]
            fn.restype = I
        for label, blocks, m, t, quant in F32_ROWS:
            c = f32_case(gen, dev, blocks, m, t, quant)
            nb, bi, bo = blocks
            k, n = (bo, bi) if t else (bi, bo)
            p = bk.plan(m, nb, k, n, torch.float32, c["wp"].dtype, t)
            x, wp = c["x"], c["wp"]
            s = None if c["s"] is None else c["s"].float().contiguous()
            y = torch.empty(m, nb * n, device=dev)

            def call(fn):
                code = fn(x.data_ptr(), wp.data_ptr(),
                          s.data_ptr() if s is not None else None, None,
                          y.data_ptr(), None, m, nb, k, n, 0, int(quant), 0,
                          bk.ROUTES[p.route], int(t),
                          _build.copy_width(x, k * 4),
                          _build.copy_width(wp, bo * wp.element_size()),
                          p.grid[0], p.split, p.k_chunk, stream)
                if code:
                    raise SystemExit(f"launch failed: CUDA error {code}")
            names = (("full", "fwd_bk32", "tn8") if p.route == "simt_f32"
                     else ("launch", "loads", "products", "full"))
            print(json.dumps({
                "kernel": "bdmm_f32", "shape": label, "blocks": blocks, "m": m,
                "role": "dx" if t else "fwd",
                "weights": "int8" if quant else "float32",
                "route": p.route, "split": p.split,
                **{f"{v}_ms": min(ms(lambda: call(fns[v])), ms(lambda: call(fns[v])))
                   for v in names}}), flush=True)


MODES = {"time": mode_time, "breakdown": mode_breakdown, "decode": mode_decode,
         "decode_breakdown": mode_decode_breakdown, "decode_sweep": mode_decode_sweep,
         "f32": mode_f32, "f32_sweep": mode_f32_sweep,
         "f32_breakdown": mode_f32_breakdown}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bdmm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ms = timer(dev)
    MODES[args.mode](dev, ms)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
