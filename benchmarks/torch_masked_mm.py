"""Time the port's masked matmul on the card, and break its tensor-core body
down by part.

    python benchmarks/torch_masked_mm.py              # --mode time
    python benchmarks/torch_masked_mm.py --mode f32
    python benchmarks/torch_masked_mm.py --mode f32_sweep
    python benchmarks/torch_masked_mm.py --mode breakdown

``time``: bf16 ``masked_matmul`` at olmo-1b's up/gate shape (2048 x 8192,
silu and bias forward, none transposed) at m = 4, 20, 64 and 2048, both
orientations, against the plain version in f32 (max |error|) and one
``torch.matmul`` on the pre-masked weight, with the plan each call takes.

``f32``: the exact f32 bodies on the paper's path and the parity route:
``masked_matmul`` at LeNet-300-100's three masked layers (c = 10) at m = 1,
50 and 2048, forward and transposed, the SDDMM at m = 50 (and 2048), and
olmo-1b's up/gate at m = 2048 (forward, transposed, SDDMM), each with its
plan, the max |error| against the plain version, one ``torch.matmul`` on
the same inputs (TF32 off) and the bound (bytes: x, the weights on the
mask, the mask and y once, the SDDMM its whole dW; operations: 2 m nnz at
67 TFLOP/s).

``f32_sweep``: the same LeNet calls launched with other plans than
``plan`` / ``sddmm_plan`` pick (the K split of ``simt_small_m`` and
``simt_f32``, the SDDMM's tile), to choose between them inside one call.

``breakdown``: builds variants of ``csrc/masked_matmul.cu`` with one part of
the tc body removed (the mask pass, the wgmmas, the output stores; or all
but the TMA loads) and times each at m = 2048 on the up/gate and down
shapes, forward with and without silu + bias and transposed. A variant
computes wrong values; only its time means anything. What is left when a
part is gone bounds what that part costs.

Times are CUDA-event medians of 10 calls with the L2 cache flushed before
each. Needs an NVIDIA GPU (sm_90a) and nvcc; prints one JSON object a line
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
from repro_torch.kernels import masked_matmul as mk  # noqa: E402

# the parts of the tc body a breakdown variant drops (exact source lines)
PARTS = {
    "mask": ("        mask_stage<BQ, TRANS_W, NT>(smem + st * S::BYTES + S::X,\n"
             "                                    smem + st * S::BYTES + S::X + S::W, pt);\n",
             ""),
    "mma": ("          wgmma<BQ, 0, TRANS_W ? 0 : 1>(\n"
            "              acc[j], desc(sx + (wg * 2 + j) * 8192 + kk * 32, 16, 1024), db);\n",
            "          (void)db;\n"),
    "store": ("    store_tc(a, acc, smem + wg * 128 * OUT_LD, tok0, ch0, wg, tid);",
              "    if (acc[0][0] == 12345.f) a.y[0] = from_f32<bf16>(acc[1][1]);"),
}
VARIANTS = {"full": (), "no_store": ("store",), "no_mask": ("mask",),
            "no_mma": ("mma",), "loads_only": ("mask", "mma")}
# Without its wgmmas the body needs fewer than the 128 registers a thread
# that the register split counts on, and the consumers' increase could wait
# for registers that never come free: such variants drop the split.
SPLIT = ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n" ::"n"(TC_PRODUCER_REGS));\n',
         '    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\\n" ::"n"(TC_CONSUMER_REGS));\n')


def timer(torch_mod, dev):
    flush = torch_mod.empty(64 << 20, dtype=torch_mod.uint8, device=dev)
    a = torch_mod.randn(4096, 4096, device=dev)
    for _ in range(100):      # bring the card's clocks up before the first row
        a @ a
    del a

    def ms(fn, iters=10):
        for _ in range(3):
            fn()
        torch_mod.cuda.synchronize()
        ev = [(torch_mod.cuda.Event(enable_timing=True),
               torch_mod.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch_mod.cuda._sleep(50_000_000)
        for a, b in ev:
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch_mod.cuda.synchronize()
        return sorted(a.elapsed_time(b) for a, b in ev)[iters // 2]
    return ms


def case(dev, gen, d_in, d_out, m):
    mask = mask_tensor(make_mask_spec(d_in, d_out, 8, seed=1), dev)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    w = (r(d_in, d_out) * d_in ** -0.5).bfloat16()
    return (mask, w, (0.1 * r(d_out)).bfloat16(), r(m, d_in).bfloat16(),
            r(m, d_out).bfloat16())


def mode_time(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    d_in, d_out = 2048, 8192
    for m in (4, 20, 64, 2048):
        mask, w, b, x, gy = case(dev, gen, d_in, d_out, m)
        wm = w * mask.bfloat16()
        fwd = lambda: mk.masked_matmul(x, w, mask, b, activation="silu")  # noqa: E731
        tr = lambda: mk.masked_matmul(gy, w, mask, transpose_rhs=True)  # noqa: E731
        want = ref.masked_matmul_ref(x.float(), w.float(), mask, b.float(),
                                     "silu")
        want_t = ref.masked_matmul_t_ref(gy.float(), w.float(), mask)
        print(json.dumps({
            "m": m, "shape": f"{d_in}x{d_out}",
            "plan": str(mk.plan(m, d_in, d_out, torch.bfloat16)),
            "plan_t": str(mk.plan(m, d_out, d_in, torch.bfloat16)),
            "max_abs_err": float((fwd().float() - want).abs().max()),
            "max_abs_err_t": float((tr().float() - want_t).abs().max()),
            "ms": ms(fwd), "ms_t": ms(tr),
            "library_ms": ms(lambda: torch.matmul(x, wm)),
            "library_ms_t": ms(lambda: torch.matmul(gy, wm.T))}), flush=True)


HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# LeNet-300-100's masked-dense layers at c = 10 (d_in, d_out, nb)
LENET = ((800, 300, 10), (300, 100, 10), (100, 10, 10))


def f32_case(dev, gen, d_in, d_out, nb, m):
    mask = mask_tensor(make_mask_spec(d_in, d_out, nb, seed=d_out), dev)
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    w = r(d_in, d_out) * d_in ** -0.5
    return mask, w, r(m, d_in), r(m, d_out)


def bound_ms(nbytes, ops):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def f32_rows(dev, ms, cases):
    """(label, d_in, d_out, nb, m, kind) -> one JSON line each: kernel ms,
    the plain version's max |error|, torch.matmul ms and the bound."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, d_in, d_out, nb, m, kind in cases:
        mask, w, x, gy = f32_case(dev, gen, d_in, d_out, nb, m)
        wm = w * mask
        nnz = int(mask.sum())
        if kind == "sddmm":
            run = lambda: mk.sddmm_masked(x, gy, mask)  # noqa: E731
            want = ref.matmul_masked_grad_ref(x, gy, mask)
            lib = lambda: torch.matmul(x.T, gy)  # noqa: E731
            pl = mk.sddmm_plan(d_in, d_out, torch.float32)
            nbytes = (m * d_in + m * d_out + d_in * d_out) * 4 + d_in * d_out
        else:
            t = kind == "t"
            inp = gy if t else x
            run = lambda: mk.masked_matmul(  # noqa: E731
                inp, w, mask, transpose_rhs=t)
            want = (ref.masked_matmul_t_ref(gy, w, mask) if t
                    else ref.masked_matmul_ref(x, w, mask))
            lib = lambda: torch.matmul(inp, wm.T if t else wm)  # noqa: E731
            k, n = (d_out, d_in) if t else (d_in, d_out)
            pl = mk.plan(m, k, n, torch.float32)
            nbytes = (m * k + nnz + m * n) * 4 + d_in * d_out
        b_ms, b_by = bound_ms(nbytes, 2.0 * m * nnz)
        # the lower of two medians: a process's first row has read up to
        # 8x slow
        kern, lib_ms = min(ms(run), ms(run)), min(ms(lib), ms(lib))
        print(json.dumps({
            "kernel": "sddmm_masked" if kind == "sddmm" else
            ("masked_matmul_t" if kind == "t" else "masked_matmul"),
            "shape": label, "d_in": d_in, "d_out": d_out, "m": m,
            "plan": str(pl),
            "max_abs_err": float((run() - want).abs().max()),
            "ms": kern, "library_ms": lib_ms, "over_library": kern / lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}), flush=True)


def mode_f32(dev, ms):
    cases = []
    for d_in, d_out, nb in LENET:
        label = f"lenet {d_in}x{d_out}"
        for m in (1, 50, 2048):
            cases += [(label, d_in, d_out, nb, m, "fwd"),
                      (label, d_in, d_out, nb, m, "t")]
        cases += [(label, d_in, d_out, nb, m, "sddmm") for m in (50, 2048)]
    cases += [("olmo up/gate", 2048, 8192, 8, 2048, kind)
              for kind in ("fwd", "t", "sddmm")]
    f32_rows(dev, ms, cases)


def mode_f32_sweep(dev, ms):
    """LeNet's f32 calls under other plans than ``plan`` / ``sddmm_plan``
    pick, launched through the module's own entry points (the plan's own
    choice is marked)."""
    _, mm = mk._launcher("mm")
    _, sd = mk._launcher("sddmm")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)

    def launch(fn, *args):
        code = fn(*args, stream)
        if code:
            raise SystemExit(f"launch failed: CUDA error {code}")

    for d_in, d_out, nb in LENET:
        for m, t in ((1, False), (50, False), (50, True), (2048, False)):
            mask, w, x, gy = f32_case(dev, gen, d_in, d_out, nb, m)
            inp = gy if t else x
            k, n = (d_out, d_in) if t else (d_in, d_out)
            y = torch.empty(m, n, device=dev)
            chosen = mk.plan(m, k, n, torch.float32)
            want = (ref.masked_matmul_t_ref(gy, w, mask) if t
                    else ref.masked_matmul_ref(x, w, mask))
            splits = [s for s in (1, 2, 4, 8, 16)
                      if s <= mk.SIMT_CLUSTER_MAX[chosen.route]
                      and mk.k_chunk_of(k, s) is not None]
            for split in splits:
                run = functools.partial(
                    launch, mm, inp.data_ptr(), w.data_ptr(), mask.data_ptr(),
                    None, y.data_ptr(), None, m, k, n,
                    _build.DTYPE_CODES[torch.float32], int(t), 0,
                    mk.ROUTES[chosen.route], *chosen.tile, split,
                    mk.k_chunk_of(k, split), mk._vec(inp, 4 * k),
                    mk._vec(w, 4 * (k if t else n)),
                    mk._vec(mask, k if t else n))
                run()
                print(json.dumps({
                    "kernel": "masked_matmul_t" if t else "masked_matmul",
                    "shape": f"{d_in}x{d_out}", "m": m,
                    "route": chosen.route, "split": split,
                    "blocks": chosen.grid[0] * chosen.grid[1] * split,
                    "chosen": split == chosen.split,
                    "max_abs_err": float((y - want).abs().max()),
                    "ms": ms(run)}), flush=True)
        m = 50
        mask, w, x, gy = f32_case(dev, gen, d_in, d_out, nb, m)
        dw = torch.empty(d_in, d_out, device=dev)
        want = ref.matmul_masked_grad_ref(x, gy, mask)
        chosen = mk.sddmm_plan(d_in, d_out, torch.float32)
        for tile in mk.SDDMM_F32_TILES:
            route = "simt_f32" if tile == mk.TILES["simt_f32"] else "simt_small_tile"
            run = functools.partial(
                launch, sd, x.data_ptr(), gy.data_ptr(), mask.data_ptr(),
                dw.data_ptr(), m, d_in, d_out, _build.DTYPE_CODES[torch.float32],
                mk.SDDMM_ROUTES[route], *tile, mk._vec(x, 4 * d_in),
                mk._vec(gy, 4 * d_out), mk._vec(mask, d_out))
            run()
            print(json.dumps({
                "kernel": "sddmm_masked", "shape": f"{d_in}x{d_out}", "m": m,
                "tile": tile, "chosen": tile == chosen.tile,
                "blocks": -(-d_in // tile[0]) * -(-d_out // tile[1]),
                "max_abs_err": float((dw - want).abs().max()),
                "ms": ms(run)}), flush=True)


def build_variants(out_dir: Path):
    src = (_build.CSRC / "masked_matmul.cu").read_text()
    procs = {}
    for name, drop in VARIANTS.items():
        text = src
        for part in drop:
            old, new = PARTS[part]
            if old not in text:
                raise SystemExit(f"breakdown: part {part!r} not found in the "
                                 "source; update PARTS")
            text = text.replace(old, new)
        if "mma" in drop:
            for line in SPLIT:
                if line not in text:
                    raise SystemExit("breakdown: the register split is not "
                                     "where SPLIT says; update it")
                text = text.replace(line, "")
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = lib.masked_matmul_launch
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P] + [I] * 14 + [P]
        fn.restype = I
        fns[name] = fn
    return fns


def mode_breakdown(dev, ms):
    gen = torch.Generator(device=dev).manual_seed(0)
    m = 2048
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))

        def call(fn, x, w, mask, bias, y, k, n, trans, act):
            p = mk.plan(m, k, n, torch.bfloat16)
            code = fn(x.data_ptr(), w.data_ptr(), mask.data_ptr(),
                      bias.data_ptr() if bias is not None else None,
                      y.data_ptr(), None, m, k, n, 1, int(trans), act,
                      mk.ROUTES[p.route], *p.tile, 1, p.k_chunk, 16, 16, 16,
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise SystemExit(f"launch failed: CUDA error {code}")

        for d_in, d_out in ((2048, 8192), (8192, 2048)):
            mask, w, b, x, gy = case(dev, gen, d_in, d_out, m)
            b32 = b.float()
            y = torch.empty(m, d_out, dtype=torch.bfloat16, device=dev)
            yt = torch.empty(m, d_in, dtype=torch.bfloat16, device=dev)
            for name, fn in fns.items():
                print(json.dumps({
                    "variant": name, "w": f"{d_in}x{d_out}", "m": m,
                    "fwd_silu_bias_ms": ms(lambda: call(
                        fn, x, w, mask, b32, y, d_in, d_out, False, 1)),
                    "fwd_ms": ms(lambda: call(
                        fn, x, w, mask, None, y, d_in, d_out, False, 0)),
                    "t_ms": ms(lambda: call(
                        fn, gy, w, mask, None, yt, d_out, d_in, True, 0))}),
                    flush=True)


MODES = {"time": mode_time, "f32": mode_f32, "f32_sweep": mode_f32_sweep,
         "breakdown": mode_breakdown}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=tuple(MODES), default="time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_masked_mm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ms = timer(torch, dev)
    MODES[args.mode](dev, ms)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
