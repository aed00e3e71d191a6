"""Time the port's fused MLP (``fused_ffn``) on the card, and break its
tensor-core body down by phase.

    python benchmarks/torch_fused_ffn.py              # --mode time
    python benchmarks/torch_fused_ffn.py --mode breakdown
    python benchmarks/torch_fused_ffn.py --mode sweep

``time``: olmo-1b's perm-fused FFN at mpd_c=8 (nb 8, bi 256, f 1024, bo
256, gated silu) with bf16 x and int8 or bf16 weights at m = 4 (a decode
step), 16, 37 and 64 (one prefill chunk), and f32 x (the exact parity
route) with int8 or f32 weights at m = 4, 20 (a verify window), 37, 64,
128, 544 (the dense engine's top admission) and 2048 (a training batch),
each against the plain version, a composed yardstick (bf16 int8: the
port's unfused route, three bdmm launches and the gate; bf16: three
``torch.bmm`` and the gate; f32: three ``torch.bmm`` with TF32 off and the
gate, over the int8 weights widened to f32 and scaled where they are int8;
no single PyTorch call computes the fused MLP) and the bound (bytes at
3.35 TB/s or operations at the dtype's peak), with the body and plan that
ran; the f32 rows also time the first f32 body (``simt_f32``, forced
under its own plan) on the same inputs.

``breakdown``: ``csrc/fused_ffn.cu`` built with the f32 bodies' phases
cut (``-DREPRO_SF_CUT``: the loads alone, + GEMM 1 and the hidden, + GEMM
2) at m = 4, 16, 64 and 2048 under their plans, then with the tensor-core
bodies' phases cut (``-DREPRO_CUT``): the loads alone (tc: every cp.async issued
and waited for; tc_tall: every ring item loaded, published and handed
back, int8 widened), then + the products (GEMM 1, the hidden, GEMM 2; tc
also stores the warps' partials, so that every mma is waited for), then
the whole kernel (+ the partials added, the cluster's split reduction and
the epilogue), at m = 4 and 64 (tc) and 512, 544 and 2048 (tc_tall) with
int8 and bf16 weights; for tc_tall also the products without the
hidden's arithmetic, without GEMM 2 and without GEMM 1, and the whole
kernel with gated silu on the generic hidden (the branching one of the
other activations). The cut variants compute nothing useful; only their
times mean anything.

``sweep``: the tc body with the f axis cut into 16, 8, 4 or 2 blocks (1,
2, 4 or 8 f tiles a block) at m = 4, 16 and 64; the tc_tall body with its
f split over 1, 2, 3, 4, 6, 8 and 16 blocks at m = 128, 512, 544, 1024
and 2048,
beside the tc body forced on the same inputs (one block a 16-row tile and
all f tiles: its plan above 64 rows before tc_tall), the port's unfused
route (three bdmm launches and the gate) and, for bf16 weights, three
``torch.bmm`` and the gate. Then f32 x (``--dtype`` picks one or both):
simt_small at every row tile that holds m (4 ... 64 rows) and its f
split over 8, 4, 2 and 1 blocks (of 128-channel tiles) at m = 4, 20, 37
and 64; simt_tall under every split at m = 128, 544 and 2048, beside
simt_small on 64-row tiles under the same splits; the first f32 body
under its own plan, and three ``torch.bmm`` in f32.

Times are CUDA-event medians of 10 calls with the L2 cache flushed before
each (``--hot``: not flushed, so weights and the kernel's code stay in L2). Needs an NVIDIA GPU (sm_90a) and nvcc; prints one JSON object a line
and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import bdmm as bk  # noqa: E402
from repro_torch.kernels import fused_ffn as fk  # noqa: E402
from repro_torch.kernels.quant import quantize_blocks  # noqa: E402

NB, BI, F_DIM, BO = 8, 256, 1024, 256       # olmo-1b's fused FFN at mpd_c=8
CUTS = {"loads": 1, "products": 2, "full": 0}
# tc_tall only: the products without a phase, and the generic hidden
TALL_CUTS = {"no_hidden": {"REPRO_CUT": 3}, "no_gemm2": {"REPRO_CUT": 4},
             "no_gemm1": {"REPRO_CUT": 5},
             "generic_hidden": {"REPRO_TALL_GENERIC": 1}}
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}


def timer(dev, flush_l2=True):
    flush = torch.empty((64 << 20) if flush_l2 else 16, dtype=torch.uint8,
                        device=dev)

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


def case(gen, dev, m, dtype, quant):
    """Inputs of one gated fused MLP: x, the three weights (int8 with their
    scales when ``quant``) and the bytes they move."""
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    a = {"x": r(m, NB * BI).to(dtype)}
    ws = {"w_up": r(NB, BI, F_DIM) * BI ** -0.5,
          "w_gate": r(NB, BI, F_DIM) * BI ** -0.5,
          "w_down": r(NB, F_DIM, BO) * F_DIM ** -0.5}
    for k, w in ws.items():
        if quant:
            a[k], a["s_" + k[2:]] = quantize_blocks(w)
        else:
            a[k] = w.to(dtype)
    nbytes = sum(t.numel() * t.element_size() for t in a.values())
    return a, nbytes + m * NB * BO * a["x"].element_size()


def mode_time(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = [(m, torch.bfloat16, q) for q in (True, False) for m in (4, 16, 37, 64)]
    rows += [(m, torch.float32, q) for q in (True, False) for m in F32_M]
    for m, dtype, quant in rows:
        a, nbytes = case(gen, dev, m, dtype, quant)
        scales = {k: a.get(k) for k in ("s_up", "s_gate", "s_down")}
        run = lambda: fk.fused_ffn(a["x"], a["w_up"], a["w_down"],  # noqa: E731
                                   a["w_gate"], **scales)
        if quant:
            plain = lambda: ref.fused_ffn_quant_ref(  # noqa: E731
                a["x"], a["w_up"], a["w_down"], a["w_gate"], **scales)
        else:
            plain = lambda: ref.fused_ffn_ref(  # noqa: E731
                a["x"], a["w_up"], a["w_down"], a["w_gate"])
        extra = {}
        if dtype == torch.float32:
            yard = f32_yardstick(a, m)
            old = fk.simt_f32_plan(m, NB, F_DIM, BO, n_sm)
            extra = {"simt_f32_plan": old._asdict(), "simt_f32_ms": ms(
                lambda: fk.fused_ffn(a["x"], a["w_up"], a["w_down"],
                                     a["w_gate"], **scales, force=old))}
        elif quant:
            def yard():
                u = bk.bdmm(a["x"], a["w_up"], None, a["s_up"])
                h = bk.bdmm(a["x"], a["w_gate"], None, a["s_gate"],
                            activation="silu") * u
                return bk.bdmm(h, a["w_down"], None, a["s_down"])
        else:
            def yard():
                return three_bmm(a, m)
        before = dict(fk.routes)
        got = run()
        used = sorted(r for r in fk.routes if fk.routes[r] != before[r])
        want = plain().float() if dtype == torch.float32 else None
        ops = 2.0 * m * NB * (2 * BI * F_DIM + F_DIM * BO)
        print(json.dumps({
            "kernel": "fused_ffn", "m": m, "dtype": str(dtype)[6:],
            "weights": "int8" if quant else str(dtype)[6:], "routes": used,
            "plan": fk.device_plan(m, NB, F_DIM, BO, dev, dtype,
                                   quant)._asdict(),
            "max_abs_err_f32": (float((got.float() - want).abs().max())
                                if want is not None else None),
            "ms": ms(run), "plain_ms": ms(plain), "yardstick_ms": ms(yard),
            "bound_ms": max(nbytes / 3.35e12, ops / PEAK[dtype]) * 1e3,
            **extra}), flush=True)


def build_cuts(out_dir: Path, defines):
    """``{cut: entry point}``: ``csrc/fused_ffn.cu`` built with each cut's
    preprocessor symbols of ``defines`` in parallel (none: the package's
    build)."""
    libs = _build.variants("fused_ffn", defines, out_dir)
    P, I = ctypes.c_void_p, ctypes.c_int
    fns = {}
    for c, lib in libs.items():
        fn = lib.fused_ffn_launch
        fn.argtypes = [P] * 13 + [I] * 15 + [P]
        fn.restype = I
        fns[c] = fn
    return fns


BREAKDOWN = [(q, m) for q in (True, False) for m in (4, 64)] + [
    (True, 544), (False, 512), (True, 2048), (False, 2048)]
# the f32 SIMT bodies' cuts (-DREPRO_SF_CUT): the loads alone, + GEMM 1 and
# the hidden, + GEMM 2 (all but the epilogue), then the whole kernel
F32_CUTS = {"loads": 1, "gemm1": 2, "no_epilogue": 3, "full": 0}


def launcher_args(a, y, p, dtype, quant, stream):
    """``fused_ffn_launch``'s arguments for the gated silu MLP ``a``."""
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    vec_w = min(_build.copy_width(a[k], a[k].shape[2] * a[k].element_size())
                for k in ("w_up", "w_gate", "w_down"))
    return (ptr(a["x"]), ptr(a["w_up"]), ptr(a["w_gate"]), ptr(a["w_down"]),
            ptr(a.get("s_up")), ptr(a.get("s_gate")), ptr(a.get("s_down")),
            None, None, None, ptr(y), None, None, a["x"].shape[0], NB, BI,
            F_DIM, BO, _build.DTYPE_CODES[dtype], int(quant),
            fk.ACT_CODES["silu"], fk.ROUTES[p.route], p.rows, p.split, p.fpb,
            1, _build.copy_width(a["x"], BI * a["x"].element_size()), vec_w,
            stream)


def breakdown_f32(dev, ms, tmp: Path):
    """The f32 bodies under their device plans, cut by phase."""
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    (tmp / "f32").mkdir()
    fns = build_cuts(tmp / "f32", {c: {"REPRO_SF_CUT": v} if v else {}
                                   for c, v in F32_CUTS.items()})
    for quant in (False, True):
        for m in (4, 16, 64, 2048):
            a, _ = case(gen, dev, m, torch.float32, quant)
            p = fk.device_plan(m, NB, F_DIM, BO, dev, torch.float32, quant)
            y = torch.empty(m, NB * BO, device=dev)
            args = launcher_args(a, y, p, torch.float32, quant, stream)

            def call(fn):
                code = fn(*args)
                if code:
                    raise SystemExit(f"launch failed: CUDA error {code}")
            print(json.dumps({
                "kernel": "fused_ffn", "m": m, "dtype": "float32",
                "weights": "int8" if quant else "float32",
                "plan": p._asdict(),
                **{f"{c}_ms": ms(lambda: call(fn)) for c, fn in fns.items()}}),
                flush=True)


def mode_breakdown(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        breakdown_f32(dev, ms, Path(tmp))
        fns = build_cuts(Path(tmp), {**{c: {"REPRO_CUT": v} if v else {}
                                        for c, v in CUTS.items()},
                                     **TALL_CUTS})
        for quant, m in BREAKDOWN:
            a, _ = case(gen, dev, m, torch.bfloat16, quant)
            p = fk.plan(m, NB, F_DIM, BO, n_sm)
            y = torch.empty(m, NB * BO, dtype=torch.bfloat16, device=dev)
            args = launcher_args(a, y, p, torch.bfloat16, quant, stream)

            def call(fn):
                code = fn(*args)
                if code:
                    raise SystemExit(f"launch failed: CUDA error {code}")
            print(json.dumps({
                "kernel": "fused_ffn", "m": m,
                "weights": "int8" if quant else "bfloat16",
                "plan": p._asdict(),
                **{f"{c}_ms": ms(lambda: call(fn)) for c, fn in fns.items()
                   if c in CUTS or p.route == "tc_tall"}}),
                flush=True)


SWEEP = ((16, 1), (8, 2), (4, 4), (2, 8))
TALL_SWEEP = (1, 2, 3, 4, 6, 8, 16)
F32_M = (4, 20, 37, 64, 128, 544, 2048)     # decode, verify, chunks, prompts, a batch


def unfused(a, quant):
    """The port's unfused route: three bdmm launches and the gate."""
    s = {k: a.get(k) for k in ("s_up", "s_gate", "s_down")}
    u = bk.bdmm(a["x"], a["w_up"], None, s["s_up"])
    h = bk.bdmm(a["x"], a["w_gate"], None, s["s_gate"], activation="silu") * u
    return bk.bdmm(h, a["w_down"], None, s["s_down"])


def three_bmm(a, m):
    xt = a["x"].view(m, NB, BI).transpose(0, 1)
    u = torch.bmm(xt, a["w_up"])
    return torch.bmm(F.silu(torch.bmm(xt, a["w_gate"])) * u, a["w_down"])


def f32_yardstick(a, m):
    """Three ``torch.bmm`` in f32 (TF32 off) and the gate on ``a``'s
    inputs; int8 weights are widened to f32 once, outside the timed call,
    and their scales applied after each product."""
    if a["w_up"].dtype != torch.int8:
        return lambda: three_bmm(a, m)
    w = {k: a[k].float() for k in ("w_up", "w_gate", "w_down")}
    s = {k: a["s_" + k[2:]][:, None, :] for k in w}
    xt = a["x"].view(m, NB, BI).transpose(0, 1)

    def yard():
        u = torch.bmm(xt, w["w_up"]) * s["w_up"]
        h = F.silu(torch.bmm(xt, w["w_gate"]) * s["w_gate"]) * u
        return torch.bmm(h, w["w_down"]) * s["w_down"]
    return yard


def timed_force(ms, a, scales, force):
    try:
        return ms(lambda: fk.fused_ffn(a["x"], a["w_up"], a["w_down"],
                                       a["w_gate"], **scales, force=force))
    except _build.KernelError as e:
        return f"error: {e}"[:200]


def mode_sweep(dev, ms, dtypes):
    """bf16: the tc body with the f axis cut into other (split, f tiles a
    block) than the plan's at m = 4, 16 and 64; the tc_tall body under
    every split at m = 128 ... 2048 beside the tc body, the unfused route
    and (bf16) three torch.bmm. f32: the SIMT bodies under other row tiles
    and splits. What each split and body costs and buys."""
    if "bfloat16" in dtypes:
        sweep_bf16(dev, ms)
    if "float32" in dtypes:
        sweep_f32(dev, ms)


def sweep_f32(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ft = -(-F_DIM // fk.F_TILE)
    n_small = -(-F_DIM // fk.SMALL_F_TILE)      # simt_small's wider tiles
    for quant in (True, False):
        for m in F32_M:
            a, _ = case(gen, dev, m, torch.float32, quant)
            scales = {k: a.get(k) for k in ("s_up", "s_gate", "s_down")}
            p = fk.device_plan(m, NB, F_DIM, BO, dev, torch.float32, quant)
            row = {"kernel": "fused_ffn", "m": m, "dtype": "float32",
                   "weights": "int8" if quant else "float32",
                   "plan": p._asdict()}
            small = [(s, -(-n_small // s)) for s in (8, 4, 2, 1)]
            if p.route == "simt_small":
                for rows in (t for t in fk.ROW_TILES if t >= m):
                    for split, fpb in small:
                        row[f"rows{rows}_split{split}_ms"] = timed_force(
                            ms, a, scales,
                            fk.Plan("simt_small", rows, split, fpb))
            else:
                for split in TALL_SWEEP:
                    fpb = -(-n_ft // split)
                    row[f"tall_split{-(-n_ft // fpb)}_ms"] = timed_force(
                        ms, a, scales,
                        fk.Plan("simt_tall", p.rows, -(-n_ft // fpb), fpb))
                for split, fpb in small:
                    row[f"rows64_split{split}_ms"] = timed_force(
                        ms, a, scales, fk.Plan("simt_small", 64, split, fpb))
            old = fk.simt_f32_plan(m, NB, F_DIM, BO, n_sm)
            row["simt_f32_ms"] = timed_force(ms, a, scales, old)
            row["yardstick_ms"] = ms(f32_yardstick(a, m))
            print(json.dumps(row), flush=True)


def sweep_bf16(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ft = -(-F_DIM // fk.F_TILE)
    for quant in (True, False):
        for m in (4, 16, 64, 128, 512, 544, 1024, 2048):
            a, _ = case(gen, dev, m, torch.bfloat16, quant)
            scales = {k: a.get(k) for k in ("s_up", "s_gate", "s_down")}
            p = fk.plan(m, NB, F_DIM, BO, n_sm)
            row = {"kernel": "fused_ffn", "m": m,
                   "weights": "int8" if quant else "bfloat16",
                   "plan": p._asdict()}

            def timed(force):
                return timed_force(ms, a, scales, force)
            if p.route == "tc":
                for split, fpb in SWEEP:
                    row[f"split{split}_ms"] = timed(fk.Plan("tc", p.rows,
                                                            split, fpb))
            else:
                for split in TALL_SWEEP:
                    fpb = -(-n_ft // split)
                    row[f"split{-(-n_ft // fpb)}_ms"] = timed(
                        fk.Plan("tc_tall", p.rows, -(-n_ft // fpb), fpb))
                row["tc_body_ms"] = timed(fk.Plan("tc", fk.TC_ROWS, 1, n_ft))
                row["unfused_route_ms"] = ms(lambda: unfused(a, quant))
                if not quant:
                    row["three_bmm_ms"] = ms(lambda: three_bmm(a, m))
            print(json.dumps(row), flush=True)


MODES = {"time": mode_time, "breakdown": mode_breakdown, "sweep": mode_sweep}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="time")
    ap.add_argument("--dtype", choices=("bfloat16", "float32", "all"),
                    default="all", help="x's dtype in --mode sweep")
    ap.add_argument("--hot", action="store_true",
                    help="no L2 flush between calls: weights and code stay cached")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_ffn: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ms = timer(dev, flush_l2=not args.hot)
    if args.mode == "sweep":
        mode_sweep(dev, ms, ("bfloat16", "float32") if args.dtype == "all"
                   else (args.dtype,))
    else:
        MODES[args.mode](dev, ms)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
