"""Time the port's masked matmul on the card, and break its tensor-core body
down by part.

    python benchmarks/torch_masked_mm.py              # --mode time
    python benchmarks/torch_masked_mm.py --mode breakdown

``time``: bf16 ``masked_matmul`` at olmo-1b's up/gate shape (2048 x 8192,
silu and bias forward, none transposed) at m = 4, 20, 64 and 2048, both
orientations, against the plain version in f32 (max |error|) and one
``torch.matmul`` on the pre-masked weight, with the plan each call takes.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("time", "breakdown"), default="time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_masked_mm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ms = timer(torch, dev)
    (mode_time if args.mode == "time" else mode_breakdown)(dev, ms)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
