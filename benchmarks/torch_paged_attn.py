"""Time the port's paged-attention kernels on the card and break them down.

    python benchmarks/torch_paged_attn.py              # --mode time
    python benchmarks/torch_paged_attn.py --mode sweep
    python benchmarks/torch_paged_attn.py --mode breakdown

The shapes are olmo-1b's served ones (16 heads of 128, page 16): a decode
step of 4 rows at depths 511-544, a verify window of 5 queries (k = 4) at
depths 511-548, each over a table 35 and 64 pages wide, and a prefill chunk
of 64 tokens at start 448 (table 32 pages wide).

``time``: each kernel at bf16 and f32 against its plain version (max
|error| in f32), one ``scaled_dot_product_attention`` call on a pre-gathered
copy of the K/V (the yardstick; the port never calls it) and the bound
(the K/V, q and out bytes over 3.35 TB/s, or the flops over the peak), with
the body that ran.

``sweep``: the bf16 kernels with splits of S = 1, 2, 4 and 8 pages (the
tensor-core prefill body holds at most 64 positions a split: S <= 4),
launched through the libraries' entry points with S in place of
``SPLIT_PAGES``.

``breakdown``: the kernels at bf16 and f32 whole, their split blocks
alone, the combine alone, and the split blocks of variant builds of
``csrc/paged_attend.cuh`` that return once their K/V loads have landed
(``loads``; both bodies), after the scores (``scores``) and after the
softmax (``softmax``; the SIMT body, which f32 runs): a variant's output
is wrong, only its time means anything, and the step from one to the
next bounds what that phase costs.

Times are CUDA-event medians of 15 calls with the L2 cache flushed before
each. Needs an NVIDIA GPU (sm_90a) and nvcc; prints one JSON object a line
and the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import paged_prefill as pp  # noqa: E402

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
H, KH, DH, PS = 16, 16, 128, 16
DECODE_LENGTHS = [511, 512, 530, 544]
VERIFY_LENGTHS = [511, 530, 544, 548]
TQ = 5
PREFILL = (64, 448, 64)                          # Tc, start, chunk_len
STAGE_SPLIT, STAGE_COMBINE = 1, 2
# each variant's edits: (exact text of csrc/paged_attend.cuh, text put
# before it); the return stays conditional so that the compiler keeps the
# phases before it
STOP = "  cp_async_wait<0>();\n  __syncthreads();\n  if (p.scale > 0.f) return;\n"
VARIANTS = {
    "loads": ["  // scores: lpp lanes a position, each a dot over dpl columns (16 of 128:\n",
              "  const int r0 = warp * 16 + gq;  // this lane's rows r0 and r0 + 8\n"],
    "scores": ["  // softmax over the split, one warp a row: p = exp(s - m), 0 where masked\n"],
    "softmax": ["  // PV: a thread a (column pair, group of SK_GROUP rows); even and odd\n"],
}


def timer(dev):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def ms(fn, iters=15):
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


class Case:
    """One kernel call at a served shape: its inputs, its launch through a
    library entry point with any split size and stages, its plain version,
    the SDPA yardstick and its bound."""

    def __init__(self, kind, dtype, dev, P, gen):
        self.kind, self.dtype, self.P = kind, dtype, P
        r = lambda *s: torch.randn(s, generator=gen, device=dev).to(dtype)  # noqa: E731
        if kind == "prefill":
            Tc, start, clen = PREFILL
            self.B, self.T, self.start, self.clen = 1, Tc, start, clen
            # the kernel reads (start, chunk_len) from the device
            self.info = torch.tensor([start, clen], dtype=torch.int32,
                                     device=dev)
            depths = [start + clen]
        else:
            lengths = DECODE_LENGTHS if kind == "decode" else VERIFY_LENGTHS
            self.B, self.T = len(lengths), 1 if kind == "decode" else TQ
            depths = lengths
            self.ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        self.n_pages = self.B * P + 1
        self.kp, self.vp = (r(self.n_pages, PS, KH, DH), r(self.n_pages, PS, KH, DH))
        perm = torch.randperm(self.n_pages - 1, generator=gen, device=dev) + 1
        self.bt = torch.zeros((self.B, P), dtype=torch.int32, device=dev)
        for b, L in enumerate(depths):
            n = math.ceil(L / PS)
            self.bt[b, :n] = perm[b * P:b * P + n].int()
        shape = {"decode": (self.B, H, DH), "verify": (self.B, TQ, H, DH),
                 "prefill": (self.T, H, DH)}[kind]
        self.q = r(*shape)
        self.out = torch.empty_like(self.q)
        self.plan = pa.plan(self.T, H, KH, DH, P, PS, dtype, self.B,
                            prefill=kind == "prefill")
        self.depths = depths

    def launch(self, fn, S=pa.SPLIT_PAGES, stages=3):
        """A call through a library entry point ``fn`` with splits of S."""
        splits = -(-self.P // S)
        part = pa.scratch(self.B * self.T * H, splits, DH, self.q.device)
        es = self.q.element_size()
        common = (self.q.data_ptr(), self.kp.data_ptr(), self.vp.data_ptr(),
                  self.bt.data_ptr())
        tail = (splits, S, _build.copy_width(self.kp, DH * es), DH ** -0.5,
                _build.DTYPE_CODES[self.dtype], pa.ROUTES[self.plan.route])
        stream = torch.cuda.current_stream().cuda_stream
        if self.kind == "decode":
            args = (*common, self.ln.data_ptr(), self.out.data_ptr(),
                    part.data_ptr(), self.B, self.P, self.n_pages, PS, H, KH,
                    DH, *tail, stages, stream)
        elif self.kind == "verify":
            args = (*common, self.ln.data_ptr(), self.out.data_ptr(),
                    part.data_ptr(), self.B, TQ, self.plan.q_tile, self.P,
                    self.n_pages, PS, H, KH, DH, *tail, stages, stream)
        else:
            args = (*common, self.info.data_ptr(), self.out.data_ptr(),
                    part.data_ptr(), self.T, self.plan.q_tile, self.P,
                    self.n_pages, PS, H, KH, DH, *tail, stages, stream)
        code = fn(*args)
        if code:
            raise SystemExit(f"{self.kind}: CUDA error {code}")

    def kernel(self):
        if self.kind == "decode":
            return pa.paged_attention(self.q, self.kp, self.vp, self.bt, self.ln)
        if self.kind == "verify":
            return pa.paged_attention_verify(self.q, self.kp, self.vp, self.bt,
                                             self.ln)
        return pp.paged_prefill_attention(self.q, self.kp, self.vp, self.bt[0],
                                          self.info[0], self.info[1])

    def plain(self, f32=False):
        q, kp, vp = ((t.float() for t in (self.q, self.kp, self.vp)) if f32
                     else (self.q, self.kp, self.vp))
        if self.kind == "decode":
            return ref.paged_attention_ref(q, kp, vp, self.bt, self.ln)
        if self.kind == "verify":
            return ref.paged_attention_verify_ref(q, kp, vp, self.bt, self.ln)
        return ref.paged_prefill_attention_ref(q, kp, vp, self.bt[0],
                                               self.start, self.clen)

    def sdpa(self):
        """One SDPA call on K/V gathered beforehand (not timed), boolean
        mask per (query, key)."""
        dev, S = self.q.device, self.P * PS
        k = self.kp[self.bt.long()].reshape(self.B, S, KH, DH).transpose(1, 2)
        v = self.vp[self.bt.long()].reshape(self.B, S, KH, DH).transpose(1, 2)
        k = k.repeat_interleave(H // KH, dim=1).contiguous()
        v = v.repeat_interleave(H // KH, dim=1).contiguous()
        kv_pos = torch.arange(S, device=dev)
        if self.kind == "prefill":
            q = self.q.transpose(0, 1)[None]
            q_pos = self.start + torch.arange(self.T, device=dev)
            mask = ((kv_pos[None, :] <= q_pos[:, None])
                    & (kv_pos[None, :] < self.start + self.clen))[None, None]
        else:
            q = (self.q[:, :, None] if self.kind == "decode"
                 else self.q.transpose(1, 2))
            horizon = (self.ln[:, None] - (self.T - 1)
                       + torch.arange(self.T, device=dev))
            mask = (kv_pos[None, None, :] < horizon[:, :, None])[:, None]
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

    def bound(self):
        es = self.q.element_size()
        kv = sum(self.depths) * KH * DH * es * 2
        if self.kind == "prefill":
            visible = sum(min(self.start + t + 1, self.start + self.clen)
                          for t in range(self.T))
        else:
            visible = sum(L - self.T + t + 1 for L in self.depths
                          for t in range(self.T))
        nbytes = 2 * self.q.numel() * es + kv + self.bt.numel() * 4
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = 4.0 * H * DH * visible / PEAK_OPS[self.dtype] * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def cases(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(0)
    return [Case("decode", dtype, dev, 35, gen), Case("decode", dtype, dev, 64, gen),
            Case("verify", dtype, dev, 35, gen), Case("verify", dtype, dev, 64, gen),
            Case("prefill", dtype, dev, 32, gen)]


def entry(source):
    return pa._launcher(source)[1] if source != "paged_prefill" else pp._launcher()[1]


SOURCE = {"decode": "paged_attention", "verify": "paged_verify",
          "prefill": "paged_prefill"}


def mode_time(dev, ms):
    for dtype in (torch.bfloat16, torch.float32):
        for c in cases(dev, dtype):
            before = dict(pa.routes)
            got = c.kernel()
            b_ms, b_by = c.bound()
            print(json.dumps({
                "kernel": c.kind, "dtype": str(dtype).split(".")[1], "P": c.P,
                "route": [r for r in pa.routes if pa.routes[r] != before[r]],
                "splits": c.plan.splits, "grid": c.plan.grid,
                "max_abs_err": float((got.float() - c.plain(True)).abs().max()),
                "ms": ms(c.kernel), "plain_ms": ms(c.plain),
                "library_ms": ms(c.sdpa()), "bound_ms": b_ms,
                "bound_by": b_by}), flush=True)


def mode_sweep(dev, ms):
    for c in cases(dev, torch.bfloat16):
        fn = entry(SOURCE[c.kind])
        for S in (1, 2, 4, 8):
            if c.plan.route == "split_tc" and S * PS > pa.TC_MAX_KEYS:
                continue
            print(json.dumps({"kernel": c.kind, "P": c.P, "split_pages": S,
                              "blocks": -(-c.P // S) * c.plan.q_tiles * KH * c.B,
                              "ms": ms(lambda: c.launch(fn, S))}), flush=True)


def build_variants(out_dir: Path):
    """``{(variant, source): launch function}``: the three libraries built
    from a copy of csrc per variant, all nvcc runs at once."""
    procs = {}
    for variant, anchors in VARIANTS.items():
        src = out_dir / variant
        shutil.copytree(_build.CSRC, src)
        head = (src / "paged_attend.cuh").read_text()
        for old in anchors:
            if old not in head:
                raise SystemExit(f"breakdown: variant {variant} no longer "
                                 "matches csrc/paged_attend.cuh; update it")
            head = head.replace(old, STOP + old)
        (src / "paged_attend.cuh").write_text(head)
        for name in SOURCE.values():
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(src), "-o",
                   str(src / f"{name}.so"), str(src / f"{name}.cu")]
            procs[(variant, name)] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (variant, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {variant} {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out_dir / variant / f"{name}.so"))
        fn = getattr(lib, f"{name}_launch")
        ref_fn = entry(name)
        fn.argtypes, fn.restype = ref_fn.argtypes, ref_fn.restype
        fns[(variant, name)] = fn
    return fns


def mode_breakdown(dev, ms):
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(Path(tmp))
        for c in cases(dev, torch.bfloat16) + cases(dev, torch.float32):
            fn = entry(SOURCE[c.kind])
            row = {"kernel": c.kind, "dtype": str(c.dtype).split(".")[1],
                   "P": c.P, "route": c.plan.route,
                   "whole_ms": ms(lambda: c.launch(fn)),
                   "split_blocks_ms": ms(lambda: c.launch(fn, stages=STAGE_SPLIT)),
                   "combine_ms": ms(lambda: c.launch(fn, stages=STAGE_COMBINE))}
            for variant in VARIANTS:
                if c.plan.route == "split_tc" and variant != "loads":
                    continue
                v = fns[(variant, SOURCE[c.kind])]
                row[f"split_to_{variant}_ms"] = ms(
                    lambda: c.launch(v, stages=STAGE_SPLIT))
            print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("time", "sweep", "breakdown"),
                    default="time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_attn: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    ms = timer(dev)
    {"time": mode_time, "sweep": mode_sweep,
     "breakdown": mode_breakdown}[args.mode](dev, ms)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
