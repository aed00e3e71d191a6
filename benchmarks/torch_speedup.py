"""Inference speedup on the card (paper §3.3 / Table 1 mechanism; the
counterpart of ``benchmarks/speedup.py``).

    python benchmarks/torch_speedup.py

It runs three sections. ``layer``: one FC layer of 512 tokens,
2048 x 2048, c = 8, computed as
  (a) a dense matmul (the non-compressed baseline),
  (b) the masked-dense matmul in its plain form (the paper's training
      mode: the full dense cost plus the mask multiply),
  (c) the packed block-diagonal matmul between the pack and unpack
      gathers (the paper's Eq. 2 inference form, the port's bdmm kernel),
  (d) the packed matmul alone (the permutations fused away),
with the reference's cross-check (masked against packed: atol 2e-3 at
float32; the matmul-shaped rule ``BF16_RULE`` at bfloat16, against the
masked form in float32 on the same values).

``kernels``: the bdmm kernel at (512 | 2048, 8, 256, 256) and the masked
matmul kernel at 512 x 2048 x 2048.

``lenet``: LeNet-300-100 inference (800-300-100-10, float32, seed 0),
dense against masked_dense against packed at c = 10, at batch 1, 50 and
2048, each eager and captured as one CUDA graph (the counterpart of the
reference's ``jax.jit`` call); the replay must equal the eager output.

Every section runs at float32 (the reference's dtype) and bfloat16 (what
the card serves) except ``lenet``, which is the float32 model. Times are
medians of CUDA-event times of single calls, warm (as the reference's loop
is), with a GPU sleep queued ahead so that the events time device work and
not the host's launch gaps; ``host_us`` is the host clock per eager call.
TF32 is off, so the float32 dense baseline is the same IEEE computation as
the kernels'. Needs a CUDA device; prints ``name,value,derived`` rows and
the card's name and power limit last.
"""

from __future__ import annotations

import statistics
import sys
import time
from pathlib import Path
from typing import Callable, List, Tuple

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from benchmarks.torch_paper_repro import device_line  # noqa: E402
from repro_torch import device as device_lib  # noqa: E402
from repro_torch.configs.lenet300 import LeNet300  # noqa: E402
from repro_torch.core.fold import (fold, mask_tensor, pack_inputs,  # noqa: E402
                                   unpack_outputs)
from repro_torch.core.mask import MaskSpec, make_mask_spec  # noqa: E402
from repro_torch.core.policy import DENSE, uniform  # noqa: E402
from repro_torch.data import TeacherStudent  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
F32_ATOL = 2e-3                            # the reference's cross-check
# |packed - masked_f32| <= atol + u_out |masked_f32| + u_sum |x| @ |M o W|:
# one bf16 rounding of the output, the sums in another order
BF16_RULE = {"atol": 2e-5, "u_out": 2.0 ** -8, "u_sum": 2.0 ** -16}
LENET_BATCHES = (1, 50, 2048)


def _suffix(dtype) -> str:
    return "" if dtype == torch.float32 else "_bf16"


def time_us(fn: Callable, iters: int = 20) -> float:
    """Median device time of one call of ``fn`` in µs (CUDA events around
    each call, after three warm calls, with a GPU sleep queued first)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(50_000_000)
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev) * 1e3


def host_us(fn: Callable, iters: int = 20) -> float:
    """Host clock per call over ``iters`` calls, ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e6


def bound_us(nbytes: float, ops_: float, dtype) -> float:
    """The least time the card could take: bytes at the HBM rate or
    operations at the dtype's peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops_ / PEAK_OPS[dtype]) * 1e6


def packed_layer(spec: MaskSpec, x: torch.Tensor,
                 wp: torch.Tensor) -> torch.Tensor:
    return unpack_outputs(spec, ops.bdmm(pack_inputs(spec, x), wp))


def cross_check(spec: MaskSpec, x: torch.Tensor,
                w: torch.Tensor) -> Tuple[bool, float]:
    """The packed layer against the masked one on the same ``x`` and ``w``
    (the reference's check): ``(ok, max |error|)``. float32: atol 2e-3
    against the masked form; bfloat16: ``BF16_RULE`` against the masked form
    computed in float32 on the same values."""
    m = mask_tensor(spec, x.device)
    got = packed_layer(spec, x, fold(spec, w * m.to(w.dtype))).float()
    want = ref.masked_matmul_ref(x.float(), w.float(), m)
    err = (got - want).abs()
    if x.dtype == torch.float32:
        lim = torch.full_like(want, F32_ATOL)
    else:
        mag = x.float().abs() @ (w.float().abs() * m)
        lim = (BF16_RULE["atol"] + BF16_RULE["u_out"] * want.abs()
               + BF16_RULE["u_sum"] * mag)
    ok = bool(torch.isfinite(got).all()) and bool((err <= lim).all())
    return ok, float(err.max())


def layer_speedup(tokens: int = 512, d_in: int = 2048, d_out: int = 2048,
                  c: int = 8, dtype=torch.float32, device=None) -> List[str]:
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((tokens, d_in), generator=gen, device=dev).to(dtype)
    w = torch.randn((d_in, d_out), generator=gen, device=dev).to(dtype)
    spec = make_mask_spec(d_in, d_out, c, seed=0)
    m = mask_tensor(spec, dev)
    wp = fold(spec, w * m.to(dtype))

    t_d = time_us(lambda: x @ w)
    t_m = time_us(lambda: ref.masked_matmul_ref(x, w, m))
    t_p = time_us(lambda: packed_layer(spec, x, wp))
    t_f = time_us(lambda: ops.bdmm(x, wp))
    ok, err = cross_check(spec, x, w)
    if not ok:
        raise AssertionError(f"packed vs masked at {dtype}: max |err| {err}")

    es = x.element_size()
    act = (tokens * d_in + tokens * d_out) * es
    b_d = bound_us(act + d_in * d_out * es, 2.0 * tokens * d_in * d_out, dtype)
    b_f = bound_us(act + d_in * d_out // c * es,
                   2.0 * tokens * d_in * d_out / c, dtype)
    s, dt = _suffix(dtype), str(dtype).replace("torch.", "")
    return [
        f"speedup_dense_us{s},{t_d:.2f},tokens={tokens} d={d_in}x{d_out} "
        f"{dt} bound_us={b_d:.2f}",
        f"speedup_masked_us{s},{t_m:.2f},paper-train-mode",
        f"speedup_packed_us{s},{t_p:.2f},paper-inference-mode",
        f"speedup_packed_fused_us{s},{t_f:.2f},perms-fused bound_us={b_f:.2f}",
        f"speedup_vs_dense{s},{t_d/t_p:.2f}x,c={c} "
        "(paper reports ~4x on mobile GPUs)",
        f"speedup_fused_vs_dense{s},{t_d/t_f:.2f}x,"
        f"h100_bound_ratio={b_d/b_f:.2f}x",
        f"speedup_crosscheck_max_abs_err{s},{err:.3g},"
        f"{'atol=2e-3' if dtype == torch.float32 else 'bf16 rule'} ok",
    ]


def kernel_bench(dtype=torch.float32, device=None) -> List[str]:
    """The bdmm kernel at two token counts of the 8 x 256 x 256 blocks, and
    the masked matmul kernel at the layer's 512 x 2048 x 2048."""
    dev = device_lib.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, s = [], _suffix(dtype)
    for (m, nb, bi, bo) in [(512, 8, 256, 256), (2048, 8, 256, 256)]:
        x = torch.randn((m, nb * bi), generator=gen, device=dev).to(dtype)
        w = torch.randn((nb, bi, bo), generator=gen, device=dev).to(dtype)
        t = time_us(lambda: ops.bdmm(x, w))
        fl = 2 * m * nb * bi * bo
        rows.append(f"bdmm_{m}x{nb}x{bi}x{bo}_us{s},{t:.2f},"
                    f"{fl/t/1e3:.1f}GFLOP/s")
    x = torch.randn((512, 2048), generator=gen, device=dev).to(dtype)
    w = torch.randn((2048, 2048), generator=gen, device=dev).to(dtype)
    msk = mask_tensor(make_mask_spec(2048, 2048, 8), dev)
    t = time_us(lambda: ops.masked_matmul(x, w, msk))
    rows.append(f"masked_matmul_512x2048x2048_us{s},{t:.2f},train-mode")
    return rows


def lenet_models(c: int = 10):
    """LeNet-300-100 as dense, masked_dense and packed at ``c``."""
    return [("dense", LeNet300(policy=DENSE)),
            ("masked_dense", LeNet300(policy=uniform(c, min_block=1),
                                      mode="masked_dense")),
            ("packed", LeNet300(policy=uniform(c, min_block=1)))]


def lenet_inputs(dev, batches=LENET_BATCHES) -> torch.Tensor:
    """The eval inputs of ``TeacherStudent(seed=0)``, as many rows as the
    largest batch."""
    ev = TeacherStudent(seed=0).eval_set(max(batches))
    return torch.from_numpy(ev["inputs"]).to(dev)


def lenet_inference(c: int = 10, batches=LENET_BATCHES, device=None,
                    iters: int = 20) -> List[str]:
    """LeNet-300-100 forward at each batch, each mode eager and captured."""
    from repro_torch.serve.graphs import StepGraph

    dev = device_lib.resolve(device)
    xs = lenet_inputs(dev, batches)
    rows, t = [], {}
    for mode, model in lenet_models(c):
        params = model.init(0, device=dev)
        for b in batches:
            x = xs[:b].contiguous()
            with torch.no_grad():
                eager = lambda: model.apply(params, x)  # noqa: E731
                want = eager()
                graph = StepGraph(f"lenet_{mode}", b, eager, dev)
                same = bool(torch.equal(graph.replay(), want))
                t[mode, b, "eager"] = time_us(eager, iters)
                t[mode, b, "graph"] = time_us(graph.replay, iters)
                h = host_us(eager, iters)
            if not same:
                raise AssertionError(f"lenet {mode} batch {b}: the graph's "
                                     "replay differs from the eager call")
            rows.append(f"lenet_{mode}_b{b}_eager_us,"
                        f"{t[mode, b, 'eager']:.2f},host_us={h:.1f}")
            rows.append(f"lenet_{mode}_b{b}_graph_us,"
                        f"{t[mode, b, 'graph']:.2f},replay_equals_eager")
    for b in batches:
        for how in ("eager", "graph"):
            d = t["dense", b, how]
            rows.append(
                f"lenet_speedup_b{b}_{how},"
                f"{d / t['packed', b, how]:.2f}x,packed_vs_dense "
                f"masked_vs_dense={d / t['masked_dense', b, how]:.2f}x c={c}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_speedup: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows: List[str] = []
    for dtype in DTYPES:
        rows += layer_speedup(dtype=dtype, device=dev)
        rows += kernel_bench(dtype=dtype, device=dev)
    rows += lenet_inference(device=dev)
    for r in rows:
        print(r)
    print(device_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
