#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA device

Phases, each printed as one JSON line:

1. ``device`` — the card's name and ``nvidia-smi`` name / power limit.
2. ``build``  — compile every CUDA kernel of the port from
   ``src/repro_torch/csrc`` with nvcc (sm_90a) and load it.
3. ``kernels`` — first a probe of the timer: the first row it times
   (bdmm qkvo, m = 1, bf16) before and after keeping the card busy for a
   second, which then stays ahead of every timed row. Then hold each kernel
   against its plain PyTorch version on the
   card at the main path's shapes (bdmm fp/int8 at m in {1, 4, 20, 32, 64}
   for the olmo-1b projection shapes, each row naming the body that ran;
   paged decode attention with ragged lengths,
   lengths around a split's edge (63, 64, 65), null-page entries and NaN
   past every length; paged prefill at start 0, 128 and 448 with a short
   final chunk and NaN-poisoned cold pages; the speculative verify window
   of 5 queries (and of 1, and of 2; a GQA window of two tiles; windows
   across a split's edge) with the same poison, every query bit for bit the
   decode kernel at its own length over tables 35 and 64 pages wide; each
   attention case on the body its dtype takes, split-KV on the tensor
   cores at bf16 and SIMT at f32, from the route tally; the
   masked matmul in both orientations and the SDDMM at m = 2048 tokens for
   the four olmo-1b projection shapes at bf16 and f32, off-mask SDDMM
   entries exactly 0, and the forward at the served rows m = 4, 20 and 64;
   the fused MLP at olmo-1b's perm-fused FFN width, nb 8, bi 256, f 1024,
   bo 256, at m = 4 and 64, int8 / bf16 / f32 weights, gated, a plain-gelu
   form with every bias and a ragged m = 37, f = 1000 case, and at m = 512,
   544 (int8) and 2048, each of which must also reject the plain output
   with one f tile of w_down zeroed, and must run on the body its plan
   names: bf16 x on a tensor-core body, tc up to 64 rows and tc_tall
   above, whose rows also time the tc body forced on the same inputs),
   within the tolerance printed beside each check; time kernel, plain
   version and, where one exists, a single PyTorch library call (for the
   fused MLP, which no single call computes, a composition: three
   torch.bmm and the gate for fp weights, the port's unfused route of three
   bdmm launches and the gate for int8).
4. ``serve`` — olmo-1b at its published widths (16 layers, d 2048, vocab
   50304, every projection packed with mpd_c=8 and quantized to int8, bf16)
   served by the paged engine: 4 slots, page 16, prefill chunk 64, 8
   requests of 256-512 prompt tokens with a 128-token shared prefix and
   16-32 new tokens. The engine captures every program (decode step,
   prefill chunk final and not) at every width rung as a CUDA graph first
   (``warmup()``: its seconds and graph-pool bytes are reported) and serves
   by replays, capturing nothing more. Launch counters are reset just
   before and read just after; every kernel must have launched, every
   attention call on the tensor-core body, and the profiled decode window
   must count the attention combine kernel in its family. Then the same
   traffic, every request arriving at once, in turns of an eager engine
   (``graphs=False``) and a captured one (eager, captured, captured,
   eager): all four greedy streams identical, the captured turns' launch
   counts and route tallies equal to the eager turns'; per turn the step
   and chunk p50s, TTFT, e2e, tok/s and a profiled decode window.
5. ``exact`` — the same configuration in float32, served once through the
   kernels (captured) and once with ``ops.set_backend("torch")`` (plain
   versions on the card, eager) on the same requests: the greedy streams
   must be identical.
6. ``exact_spec`` — phase 5's model and requests with speculative decoding
   (k = 4), the draft perfect (the target itself) or skewed (seed 7),
   through the kernels (captured) and through the plain versions (eager):
   every greedy stream equals phase 5's kernel-route stream; acceptance >
   0.9 with the perfect draft and < 1 with the skewed one; verify launches
   16 x verify calls on the kernel route and no launch on the plain route;
   both page pools conserved at drain.
7. ``exact_dense`` — phase 5's model and requests through the slot-dense
   engine (``Engine(paged=False)``), on the kernel route (captured) and the
   plain route (eager): both streams identical to each other and to phase
   5's paged kernel-route streams; bdmm launched on the kernel route,
   nothing on the plain route.
8. ``dense`` — phase 4's model and traffic through the slot-dense engine:
   4 slots of 544 rows, one batch-1 prefill a request at its prompt's
   bucket. ``warmup()`` captures the decode and every bucket's admission
   (its seconds and graph-pool bytes are reported); nothing is captured
   while serving. Launch counters reset just before and read just after:
   8 of 8 served, every token in the vocabulary, bdmm's tensor-core general
   grid and its decode grid launched (route tally), no paged-attention
   kernel (dense attention is plain PyTorch, as the reference's is XLA).
   Then a profiled decode window and phase 4's eager and captured turns:
   identical streams, equal launch counts and route tallies; per turn the
   decode step and admission p50s, TTFT, e2e and tok/s; the dense
   reservation beside phase 4's paged peak.
9. ``static`` — the legacy lockstep path as the launcher runs it
   (``launch.serve.main(["--static", "--batch", "4", "--prompt-len",
   "512", "--gen", "32", "--quantize", "int8"])``, full width, one
   captured decode graph): prefill ms, decode tok/s; each row's greedy
   tokens equal to the slot-dense engine's stream for the same prompt.
10. ``cli`` — the serve launcher in-process at 2 of 16 layers: without
   ``--paged`` (the slot-dense engine), ``--quantize int4``, and at f32
   ``--paged`` on the kernel route and with ``--prefill-kernel jnp``,
   which launches the paged prefill kernel 0 times and streams the kernel
   route's tokens. Every run serves 4 of 4.
11. ``train`` — olmo-1b at its published widths in ``masked_dense`` mode
   (the paper-faithful training of Algorithm 1: dense bf16 weights under
   permuted block masks, mpd_c=8), random init from seed 0, ``SyntheticLM``
   batches of 4 x 512 tokens, 4 AdamW steps through
   ``repro_torch.train.run``. Every loss finite, the first within 1.0 of
   ln(50304); every off-mask weight exactly 0 after the last step; the
   masked-matmul kernels (both orientations) and the SDDMM launched
   (counters reset just before, read just after). Then one more step under
   torch.profiler: device time by kernel family.
12. ``train_exact`` — one step of the same model cut to 4 layers in float32
   on the first batch, through the kernels and through the plain versions,
   in masked_dense, packed and perm-fused packed mode: loss and updated
   params agree within the stated tolerance.
13. ``fold`` — the paper's deploy chain on the card: the float32 model of
   phase 12 folded to packed (``to_packed``) gives the masked-dense logits
   within the stated tolerance, and the bf16 model trained in phase 11,
   folded and quantized to int8, serves 2 greedy requests on the paged
   engine through the kernels.
14. ``fused_deploy`` — the Fig-3 deploy chain at olmo-1b's published
   widths: the model built in ``masked_dense`` mode with ``mpd_fuse`` from
   seed 0 takes one AdamW step on the next ``SyntheticLM`` batch of phase
   11's stream, is folded with the permutation fusion and quantized to int8
   and written as a packed artifact (``export_packed``) to a temporary
   directory, loaded back (``load_packed``: bit-identical to the in-memory
   fold, every FFN on the fused route) and served on the ``serve`` phase's
   engine and traffic. Every FFN is one ``fused_ffn`` launch: launches equal
   16 x model calls, and bdmm launches per model call are 3 x 16 fewer than
   in phase 4.
15. ``spec`` — speculative decoding as the deployment runs it: phase 14's
   trained masked_dense bf16 target drafted by the int8 artifact it
   exported (k = 4), on phase 4's traffic, in turns (non-spec, spec, spec,
   non-spec): 8 of 8 served in every turn, every token in the vocabulary,
   the verify, masked matmul, fused MLP and decode-attention kernels
   launched in the spec turns, both pools conserved; decode tok/s, TTFT,
   e2e, tokens per step, acceptance, the decode step and how many greedy
   streams equal the non-spec ones per turn; then profiled windows of
   non-spec and spec steps; then phase 4's eager and captured turns with
   the spec engine.
16. ``exact_fused`` — phase 5 for the perm-fused model: float32 greedy
   streams through the kernels (fused_ffn on every FFN, captured) and
   through the plain versions (eager) must be identical.
17. ``paper`` — the paper's own experiments (benchmarks/torch_paper_repro.py):
   LeNet-300-100 (800-300-100-10, float32) trained on TeacherStudent
   batches of 50 for Table 1 (400 steps), Fig 4a (8 masks, 200 steps),
   Fig 4b, the permutation ablation (400 steps) and Fig 5 (200 steps), one
   JSON line per figure with the reference's CPU value beside each row;
   Algorithm 1 (masked_dense at c = 10, 400 steps) folded with
   ``mpd.to_packed`` must give the masked logits within ``FOLD_TOL`` and
   the same accuracy; one eager inference pass per mode at batch 1, 50
   and 2048. Launch counters are reset before and read after that run:
   bdmm on an f32 body of its general grid (simt_small for LeNet's narrow
   blocks) forward and transposed, bdmm_decode on decode_simt and the
   three masked kernels must have launched. Then the c = 10 run on the
   plain route (within 0.5 points of the kernel route), one f32 step
   kernel vs plain in packed and masked_dense mode under train_exact's
   rule, every accuracy at least 90 %, and the speedup rows
   (benchmarks/torch_speedup.py: one 2048 x 2048 layer at c = 8, the bdmm
   and masked kernels, f32 and bf16; LeNet inference eager and captured).
   The paper's relative claims are recorded, not gated. The kernels phase
   also holds bdmm on f32 blocks at every LeNet block shape and at the
   speedup's (8, 256, 256) (``decode_simt`` at batch 1, ``simt_small`` for
   narrow blocks, the tiled ``simt_f32`` for the speedup's, each row with
   its plan's tile, K split and cluster) and the masked kernels at LeNet's
   widths against their plain versions, each on the f32 body its plan
   names (``simt_small_m`` up to 64 rows, the pipelined ``simt_f32``
   above; the SDDMM at the tile ``sddmm_plan`` picks).

18. ``train_fused`` (run after phase 11) — the train launcher's packed
   mode with ``--mpd-fuse`` at olmo-1b's published widths
   (``launch.train.main(["--arch", "olmo-1b", "--mpd-fuse", "--steps",
   "4", "--seq-len", "512", "--global-batch", "4"])``, bf16): every FFN
   trains through the fused_ffn autograd rule, one fused_ffn launch per
   layer and step forward (16 x 4) and bdmm launches backward, no bf16
   bdmm on an f32 body; every loss finite, the first within 1.0 of
   ln(50304); every fused launch on the tc_tall body; step time, tokens/s,
   peak device memory and the profiled step's fused_ffn device ms beside
   phase 11's packed launcher run.
19. ``resume`` (run after phase 18) — train checkpoints and resume through
   ``train.run``: the perm-fused packed bf16 model (RESUME's depth, full
   width) 4 steps with a checkpoint every 2 (written on a background
   thread), against 2 steps and then a fresh run resuming from the
   checkpoint at step 2: the resumed losses and every param and moment
   leaf equal bit for bit; the saves' bytes and seconds and the seconds
   the step loop waited on them are recorded. Phase 12 also runs its step
   in ``packed_fused`` mode (the fused_ffn rule at f32), and the kernels
   phase holds the fused MLP at m = 2048 (a training batch) too.
20. ``surface`` (run after phase 15) — the serving surface at full width
   on phase 4's model (int8, bf16, captured, 4 slots, page 16, prompts of
   64-128 tokens): 4 batch requests fill the slots and 4 interactive ones
   arrive (at least one preemption; every stream equal to the request's
   stream served alone); the storm schedule (NaN and Inf logits, an
   engine-step exception, a slow step, pool exhaustion) under the
   launcher's ``--chaos-verify`` rule (every completed stream equal to a
   fault-free engine's, the pools conserved, the metrics' counters equal
   to the injections, one caught step fault per injected one and no
   other); the same with speculation on phase 14's target and its int8
   draft, the schedule poisoning the draft and the target window at the
   first step of the fault-free run where both slots decode; a deadline
   abort whose pages come back within the step; ``GenerateServer`` on
   127.0.0.1 with 4 SSE clients streaming the direct engine's tokens, one
   more that disconnects (its pages come back), ``/metrics`` parsing as
   Prometheus text and ``/healthz``; then serve_bench's degraded traffic
   (mixed priorities with SLOs) on a self-drafting spec engine at ladder
   stages 0 and 1: SLO attainment per class and decode tok/s, recorded.
   No engine captures a graph after its ``warmup()``. Every earlier
   serving phase also fails on a step fault caught and retried.

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
# The masked matmul and its weight gradient are held against the plain
# version computed in f32 on the same values with a matmul-shaped bound,
#   |kernel - plain_f32| <= atol + u_out |plain_f32| + u_sum |x| @ |M o W|
# (|bias| added; for the SDDMM (|x|^T @ |g|) o M). bf16 inputs and their
# products are exact in f32, so at both dtypes the sums differ only in their
# order, within a few 2^-24 of the magnitude (u_sum = 2^-16); at bf16 the
# kernel also rounds its output once, within bf16's unit roundoff 2^-8 |y|
# (u_out = 2^-8: exactly one rounding fits, so worst cases read close to 1).
# Near-zero outputs make a plain rtol meaningless. The same rule must reject
# the plain output with one mask block dropped.
MM_TOL = {"bfloat16": {"atol": 2e-5, "u_out": 2.0 ** -8, "u_sum": 2.0 ** -16},
          "float32": {"atol": 2e-5, "u_out": 2.0 ** -16, "u_sum": 2.0 ** -16}}
MM_RULE = "atol + u_out * |plain_f32| + u_sum * |x| @ |M o W|"
# (name, d_in, d_out, activation): the masked-dense projections of olmo-1b
MM_SHAPES = [("qkvo", 2048, 2048, None), ("up_gate", 2048, 8192, "silu"),
             ("down", 8192, 2048, None), ("unembed", 2048, 50304, None)]
MM_TOKENS = 2048                                 # 4 sequences x 512
# cuBLAS / cuBLASLt kernel names (attention einsums, CE) in the profiler
LIBRARY_GEMM_NAMES = ("gemm", "xmma", "cutlass", "nvjet")
SERVING_KERNELS = ("bdmm", "bdmm_decode", "paged_attention",
                   "paged_prefill_attention")
MASKED_KERNELS = ("masked_matmul", "masked_matmul_t", "sddmm_masked")
# the masked matmul's CUDA kernels (csrc/masked_matmul.cu), one profiler
# family: the tc and small-m tensor-core bodies, the split-K reduction and
# the f32 SIMT body; a trailing ", true>" marks transpose_rhs
MASKED_MM_FAMILY = "masked_mm_"
# bdmm's general grid (csrc/bdmm.cu) at bf16: the tc and small-m bodies and
# the small-m body's split-K reduction; "_kernel<true" marks the transposed
# orientation (dx). (The f32 bodies, bdmm_simt_*, run in no profiled
# window.) The SDDMM's bodies (tc and the f32 SIMT one) share "sddmm_".
BDMM_GENERAL_FAMILY = "bdmm_general"
SDDMM_FAMILY = "sddmm_"
# the fused MLP's bodies (csrc/fused_ffn.cu: tc, tc_tall and the f32 SIMT one)
FUSED_FFN_FAMILY = "fused_ffn"
BDMM_KERNELS = ("bdmm", "bdmm_decode")
TRAIN = {"batch": 4, "seq": 512, "steps": 4}
# train_exact: one step at f32 of the model cut to this depth, with SGD
# (lr 1, clipped to norm 1) so the update is linear in the gradient. Updated
# params agree to |p_kernel - p_plain| <= 1e-7 + 1e-3 |p_plain - p_0|: a few
# f32 ulps of the params plus 1e-3 of each update, from the gradients'
# summation order. A gradient off by a mask block moves updates by 100 %.
EXACT_LAYERS = 4
# resume: the perm-fused packed bf16 model at this depth (16 = full), steps
# of TRAIN's batch, a checkpoint every ckpt_every steps
RESUME = {"n_layers": 16, "steps": 4, "ckpt_every": 2}
EXACT_TOL = {"atol": 1e-7, "update_rtol": 1e-3, "loss_rtol": 1e-5}
# The fused MLP is held against its plain version computed in f32 on the
# same values with the matmul-shaped rule of MM_TOL, its magnitude term
#   mag = (|h| + dh) @ |Wd| (* s_down) + |b_down|,
#   dh  = |act(g)| |x|@|Wu| + ACT_SLOPE |u| |x|@|Wg|   (gated; else
#         ACT_SLOPE |x|@|Wu|), with the scales and |biases| of each sum,
# bounding how far the summation order of the up and gate sums moves the
# hidden before the down sum adds its own (ACT_SLOPE bounds |act'| of silu,
# gelu and relu). The same rule must reject the plain output with the first
# f tile (64 channels) of w_down zeroed.
ACT_SLOPE = 1.2
FFN_RULE = ("atol + u_out * |plain_f32| + u_sum * ((|h| + dh) @ |Wd| "
            "+ |b_down|)")
# (label, m, weights, dtype, activation, gated, biases, f): olmo-1b's fused
# FFN at mpd_c=8 is nb 8, bi 256, f 1024, bo 256; m = 4 is a decode step
# of 4 slots, m = 64 one prefill chunk, m = 512 one 512-token prompt, m =
# 544 the dense engine's top admission bucket (int8, as served), m = 2048 a
# training batch
FFN_DIMS = (8, 256, 256)                          # nb, bi, bo
FFN_CASES = [
    ("decode", 4, "int8", "bfloat16", "silu", True, False, 1024),
    ("prefill", 64, "int8", "bfloat16", "silu", True, False, 1024),
    ("decode", 4, "fp", "bfloat16", "silu", True, False, 1024),
    ("prefill", 64, "fp", "bfloat16", "silu", True, False, 1024),
    ("decode", 4, "fp", "float32", "silu", True, False, 1024),
    ("prefill", 64, "fp", "float32", "silu", True, False, 1024),
    ("decode", 4, "int8", "float32", "silu", True, False, 1024),
    ("prefill", 64, "int8", "float32", "silu", True, False, 1024),
    ("plain gelu, biases", 64, "fp", "bfloat16", "gelu", False, True, 1024),
    ("ragged m and f, biases", 37, "int8", "bfloat16", "silu", True, True,
     1000),
    ("prompt", 512, "fp", "bfloat16", "silu", True, False, 1024),
    ("admission", 544, "int8", "bfloat16", "silu", True, False, 1024),
    # the training forward of phase train_fused: 4 x 512 tokens
    ("train", 2048, "fp", "bfloat16", "silu", True, False, 1024),
]
# fold: logits of the folded packed model against the masked-dense model at
# f32 (bdmm over the blocks vs the masked matmul over the full K).
FOLD_TOL = {"atol": 1e-4, "rtol": 1e-4}
# exact_fused: the perm-fused model's f32 streams at this depth (16 = full)
EXACT_FUSED_LAYERS = 16
# draft tokens proposed per speculative step (the launcher's default)
SPEC_K = 4
# paper: LeNet-300-100 (800-300-100-10, f32) on TeacherStudent batches of
# 50 (benchmarks/torch_paper_repro.py), at these step counts: Table 1, Fig
# 4a (over 8 masks), the permutation ablation, Fig 5, and Algorithm 1
# (masked_dense at c = 10, then folded)
PAPER = {"table1": 400, "fig4a": 200, "fig4a_masks": 8, "ablation": 400,
         "fig5": 200, "algorithm1": 400}
PAPER_MIN_ACC = 90.0          # every accuracy, in %; chance is 10 %
PAPER_ROUTE_GAP = 0.5         # points between the c = 10 kernel and plain routes
# the reference's rows at the same step counts: benchmarks/paper_repro.py's
# table1(400), fig4_masks(8, 200), fig4_permutation_ablation(400) and
# fig5_sparsity(200), run on a CPU (jax 0.9.0)
PAPER_REF_CPU = {
    "table1_dense_acc": 94.24, "table1_mpd10x_acc": 95.26,
    "table1_acc_delta_pts": -1.03, "fig4a_masks_acc_mean": 95.80,
    "fig4a_masks_acc_min": 95.70, "fig4b_mask_sum_mean": 10.00,
    "fig4b_mask_sum_std": 3.00, "fig4_permuted_acc": 95.26,
    "fig4_nonpermuted_acc": 93.65, "fig4_permutation_gain_pts": 1.61,
    "fig5_dense_acc": 94.92, "fig5_c4_acc": 95.70, "fig5_c8_acc": 95.70,
    "fig5_c16_acc": 95.75}
# compression factors whose LeNet-300-100 plans the kernels phase checks:
# under uniform(c, min_block=1), c = 16 takes the c = 10 plan
LENET_C = (10, 4, 8)
# (m, role) of those blocks on the paper path: batch-1 inference (the
# decode grid), a training batch (forward and dx), the 2048-sample eval
LENET_BDMM_M = [(1, "fwd"), (50, "fwd"), (50, "dx"), (2048, "fwd")]
# the speedup's blocks and their rows (512 tokens forward and dx, 2048)
SPEEDUP_BLOCKS = (8, 256, 256)
SPEEDUP_BDMM_M = [(512, "fwd"), (512, "dx"), (2048, "fwd")]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def mm_routes():
    """The masked matmul's launches by CUDA body (``tc``, ``tc_small_m``,
    ``simt_small_m``, ``simt_f32``) since the last
    ``ops.reset_launch_counts``."""
    from repro_torch.kernels import masked_matmul as mk
    return dict(mk.routes)


def all_routes():
    """Launches by CUDA body of the masked matmul, the SDDMM and bdmm's
    general grid since the last ``ops.reset_launch_counts``."""
    from repro_torch.kernels import bdmm as bk
    from repro_torch.kernels import masked_matmul as mk
    return {"masked_matmul": dict(mk.routes), "sddmm": dict(mk.sddmm_routes),
            "bdmm": dict(bk.routes)}


def f32_general(counts):
    """Launches of bdmm's f32 general-grid bodies (the small and the tiled
    one) in a route tally: ``decode_simt`` is the decode grid."""
    return counts["simt_small"] + counts["simt_f32"]


def run_routed(fn, counts=None):
    """``(fn(), the bodies that fn launched)``, from the tally ``counts``
    (by default the masked matmul's)."""
    if counts is None:
        from repro_torch.kernels import masked_matmul as mk
        counts = mk.routes
    before = dict(counts)
    out = fn()
    return out, sorted(k for k in counts if counts[k] != before[k])


def attn_body(dtype: str) -> str:
    """The body the paged-attention kernels must run at olmo-1b's shapes:
    the split-KV scheme on the tensor cores at bf16, SIMT at f32."""
    return "split_tc" if dtype == "bfloat16" else "split_kv"


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

    def warm_up(self, seconds: float = 1.0) -> float:
        """Keep the card busy with bf16 matmuls for ``seconds`` so that its
        clocks have risen before the first timed row; returns the seconds
        spent."""
        torch = self.torch
        a = torch.randn(4096, 4096, device=self.flush.device).bfloat16()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                a @ a
            torch.cuda.synchronize()
        return time.perf_counter() - t0


def timer_probe(torch, dev, timer) -> None:
    """The first row the kernels phase times (bdmm qkvo, m = 1, bf16) timed
    before and after the timer's warm-up: a first-timing cost shows as the
    difference. The warm-up then stays ahead of every timed row."""
    from repro_torch.kernels import bdmm as bk

    gen = torch.Generator(device=dev).manual_seed(0)
    _, nb, bi, bo, _ = BDMM_SHAPES[0]
    x = torch.randn((1, nb * bi), generator=gen, device=dev).bfloat16()
    w = (torch.randn((nb, bi, bo), generator=gen, device=dev)
         * bi ** -0.5).bfloat16()
    run = lambda: bk.bdmm(x, w)  # noqa: E731
    cold = [timer.ms(run), timer.ms(run)]
    warm_s = timer.warm_up()
    warm = [timer.ms(run), timer.ms(run)]
    emit({"phase": "timer_probe", "row": "bdmm_decode qkvo m=1 bf16",
          "before_warm_up_ms": cold, "warm_up_s": warm_s,
          "after_warm_up_ms": warm})


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
    # m = 1 and 4: decode steps; 20 and 32: a packed target's verify
    # windows (4 slots x 5 tokens) at the top of the decode grid; 64: one
    # prefill chunk
    cases = [(s, m, q, "bfloat16") for s in BDMM_SHAPES
             for m in (1, 4, 20, 32, 64) for q in (False, True)]
    cases = [c + ("fwd",) for c in cases]
    # the f32 forms the exactness phase runs, one per grid
    cases += [(BDMM_SHAPES[1], m, True, "float32", "fwd") for m in (4, 64)]
    # packed-mode training at olmo-1b's bf16 and 4 x 512 tokens: the forward
    # and dx = g @ blockdiag(wp)^T, the transposed-blocks orientation
    cases += [(s, MM_TOKENS, False, "bfloat16", role) for s in BDMM_SHAPES
              for role in ("fwd", "dx")]
    for (name, nb, bi, bo, act), m, quant, dt, role in cases:
        dtype = getattr(torch, dt)
        w = torch.randn((nb, bi, bo), generator=gen, device=dev) * bi ** -0.5
        dx = role == "dx"
        k, n = (bo, bi) if dx else (bi, bo)
        act = None if dx else act
        x = torch.randn((m, nb * k), generator=gen, device=dev).to(dtype)
        xt = x.view(m, nb, k).transpose(0, 1)
        yardstick = None
        if quant:
            wq, scale = quantize_blocks(w)
            run = lambda: bk.bdmm(x, wq, None, scale, activation=act)
            plain = lambda: ref.bdmm_quant_ref(x, wq, scale, None, act)
            library = None          # no PyTorch call takes int8 blocks
            w_bytes = wq.numel() + scale.numel() * 4
            if dt == "float32":     # the blocks widened outside the timed call
                wide = wq.float()
                yardstick = lambda: torch.bmm(xt, wide) * scale[:, None, :]
        elif dx:
            wf = w.to(dtype)
            run = lambda: bk.bdmm(x, wf, transpose=True)
            plain = lambda: ref.bdmm_t_ref(x, wf)
            library = lambda: torch.bmm(xt, wf.transpose(1, 2))
            w_bytes = wf.numel() * wf.element_size()
        else:
            wf = w.to(dtype)
            run = lambda: bk.bdmm(x, wf, activation=act)
            plain = lambda: ref.bdmm_ref(x, wf, None, act)
            library = lambda: torch.bmm(xt, wf)
            w_bytes = wf.numel() * wf.element_size()
        got, used = run_routed(run, bk.routes)
        ok, err, ratio, tol = close(torch, got, plain(), "bdmm", dt)
        del got
        pl = bk.plan(m, nb, k, n, dtype, torch.int8 if quant else dtype, dx)
        grid = "bdmm_decode" if pl.route in bk.DECODE_ROUTES else "bdmm"
        # the body the plan names ran; bf16 on the tensor cores (mma.sync
        # at m <= 32, wgmma above)
        ok = ok and used == [pl.route]
        if dt == "bfloat16":
            ok = ok and pl.route in ("decode_tc", "tc", "tc_small_m")
        else:
            ok = ok and pl.route in bk.F32_ROUTES
        es = x.element_size()
        nbytes = m * nb * k * es + w_bytes + m * nb * n * es
        b_ms, b_by = bound(nbytes, 2.0 * m * nb * bi * bo, dt)
        row = {"phase": "kernels", "kernel": grid, "shape": name, "m": m,
               "role": role, "weights": "int8" if quant else dt, "dtype": dt,
               "max_abs_err": err, "err_over_tol": ratio, "tol": tol,
               "ok": ok, "routes_launched": used,
               # a K split is one cluster but on tc_small_m (a second pass)
               "plan": {"route": pl.route, "tile": pl.tile, "grid": pl.grid,
                        "split": pl.split, "k_chunk": pl.k_chunk,
                        "cluster": (None if pl.route == "tc_small_m"
                                    else [1, 1, pl.split])},
               "ms": timer.ms(run), "plain_ms": timer.ms(plain),
               "library_ms": timer.ms(library) if library else None,
               "library": "one torch.bmm over the blocks" if library else None,
               "bound_ms": b_ms, "bound_by": b_by}
        if yardstick:
            row.update(yardstick_ms=timer.ms(yardstick),
                       yardstick="torch.bmm over the int8 blocks widened to "
                                 "f32 outside the timed call, then the scale")
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
            s["cuda_body"] = used
        # the other general-grid rows of the main paths: a bf16 prefill
        # chunk, and packed training's forward and dx
        if grid == "bdmm" and name == "up_gate" and dt == "bfloat16" and (
                not quant):
            s.setdefault("other_rows", []).append({k: row[k] for k in (
                "m", "role", "weights", "ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "routes_launched")})


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
        # around a split's edge: S * 16 - 1, S * 16 and S * 16 + 1 positions
        (16, 16, [1, 63, 64, 65], "bfloat16"),
        (16, 16, [1, 63, 64, 65], "float32"),
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
        got, used = run_routed(run, pk.routes)
        ok, err, ratio, tol, rejects = attn_check(torch, got, plain32,
                                                  dropped, dt)
        ok = ok and used == [attn_body(dt)]
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
               "err_over_tol": ratio, "tol": tol, "routes_launched": used,
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
            s["cuda_body"] = used


def check_paged_prefill(torch, dev, timer, rows, summary):
    from repro_torch.kernels import paged_attention as pa
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
        (16, 16, 448, 21, "bfloat16"),      # a short last chunk at 448
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
        # start and chunk_len reach the kernel as the device pair the
        # engine's captured chunks pass (two adjacent int32 scalars)
        info = torch.tensor([start, clen], dtype=torch.int32, device=dev)
        run = lambda: pk.paged_prefill_attention(q, kpp, vpp, bt,  # noqa: E731
                                                 info[0], info[1])
        got, used = run_routed(run, pa.routes)
        ok, err, ratio, tol, rejects = attn_check(torch, got, plain32,
                                                  dropped, dt)
        ok = ok and used == [attn_body(dt)]
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
               "err_over_tol": ratio, "tol": tol, "routes_launched": used,
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
            s["cuda_body"] = used


# (H, Kh, Tq, lengths, dtype): the spec phase's window (4 slots, k = 4) at the
# end of the serve traffic's depths, one query (the decode kernel, bitwise),
# two queries, a GQA 4:1 window of two tiles, and windows across a split's
# edge
VERIFY_CASES = [
    (16, 16, 5, [511, 530, 544, 548], "bfloat16"),   # timed
    (16, 16, 5, [511, 530, 544, 548], "float32"),
    (16, 16, 1, [1, 37, 300, 548], "bfloat16"),
    (16, 16, 1, [1, 37, 300, 548], "float32"),
    (16, 16, 2, [2, 17, 300, 548], "bfloat16"),
    (16, 4, 5, [5, 16, 250, 548], "bfloat16"),
    # windows across a split's edge (S * 16 = 64 positions)
    (16, 16, 5, [5, 64, 65, 68], "bfloat16"),
    (16, 16, 5, [5, 64, 65, 68], "float32"),
]


def window_equals_decode(torch, pk, got, q, kp, vp, bt, ln, wide_P=64):
    """Whether every query t of the window ``got`` equals, bit for bit, the
    decode kernel at its own length ``ln - (Tq - 1) + t``, and the window
    and the decode kernel over the block table widened to ``wide_P``
    columns (null entries) equal both."""
    Tq = q.shape[1]
    wide = torch.zeros((bt.shape[0], wide_P), dtype=bt.dtype, device=bt.device)
    wide[:, :bt.shape[1]] = bt
    same = torch.equal(pk.paged_attention_verify(q, kp, vp, wide, ln), got)
    for t in range(Tq):
        at = ln - (Tq - 1) + t
        for table in (bt, wide):
            same = same and torch.equal(
                got[:, t], pk.paged_attention(q[:, t].contiguous(), kp, vp,
                                              table, at))
    return bool(same)


def check_paged_verify(torch, dev, timer, rows, summary):
    """The speculative verify window against its plain version, with NaN
    in the null page and past every length; every query bit for bit
    against the decode kernel at its own length, over two table widths."""
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(8)
    ps, P, dh = 16, 35, 128
    for idx, (H, kh, Tq, lengths, dt) in enumerate(VERIFY_CASES):
        dtype = getattr(torch, dt)
        B = len(lengths)
        n_pages = B * P + 1
        kp, vp = _pool(torch, dev, gen, n_pages, ps, kh, dh, dtype)
        q = torch.randn((B, Tq, H, dh), generator=gen, device=dev).to(dtype)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev) + 1
        bt = torch.zeros((B, P), dtype=torch.int32, device=dev)
        for b, L in enumerate(lengths):
            n = math.ceil(L / ps)
            bt[b, :n] = perm[b * P:b * P + n].int()
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)

        def plain32(v_mode, ln=ln, q=q, kp=kp, vp=vp, bt=bt):
            v = vp.float().abs() if v_mode == "abs" else vp.float()
            return ref.paged_attention_verify_ref(q.float(), kp.float(), v,
                                                  bt, ln)
        dropped = ref.paged_attention_verify_ref(
            q.float(), kp.float(), vp.float(), bt, (ln - ps).clamp(min=Tq))
        kpp, vpp = kp.clone(), vp.clone()
        kpp[0] = float("nan")
        vpp[0] = float("nan")
        for b, L in enumerate(lengths):
            last = int(bt[b, (L - 1) // ps])
            kpp[last, (L - 1) % ps + 1:] = float("nan")
            vpp[last, (L - 1) % ps + 1:] = float("nan")
        run = lambda: pk.paged_attention_verify(q, kpp, vpp, bt, ln)
        got, used = run_routed(run, pk.routes)
        ok, err, ratio, tol, rejects = attn_check(torch, got, plain32,
                                                  dropped, dt)
        each = window_equals_decode(torch, pk, got, q, kpp, vpp, bt, ln)
        ok = ok and each and used == [attn_body(dt)]
        bitwise = None
        if Tq == 1:
            bitwise = bool(torch.equal(got[:, 0], pk.paged_attention(
                q[:, 0], kpp, vpp, bt, ln)))
            ok = ok and bitwise
        es = q.element_size()
        nbytes = (2 * q.numel() * es + 2 * sum(lengths) * kh * dh * es
                  + bt.numel() * 4 + B * 4)
        visible = sum(L - Tq + t + 1 for L in lengths for t in range(Tq))
        b_ms, b_by = bound(nbytes, 4.0 * H * dh * visible, dt)
        kv_pos = torch.arange(P * ps, device=dev)
        horizon = ln[:, None] - (Tq - 1) + torch.arange(Tq, device=dev)
        mask = (kv_pos[None, None, :] < horizon[:, :, None])[:, None]
        lib = _gather_sdpa(torch, q.transpose(1, 2), kp, vp, bt, mask,
                           H // kh)
        row = {"phase": "kernels", "kernel": "paged_attention_verify",
               "H": H, "Kh": kh, "Tq": Tq, "lengths": lengths, "dtype": dt,
               "q_tile": pk.plan(Tq, H, kh, dh, P, ps, dtype, B).q_tile,
               "max_abs_err": err, "err_over_tol": ratio, "tol": tol,
               "rejects_dropped_page": rejects, "routes_launched": used,
               "bitwise_equals_decode_kernel": bitwise,
               "each_query_bitwise_decode_at_its_length_P35_P64": each,
               "ok": ok,
               "ms": timer.ms(run),
               "plain_ms": timer.ms(lambda: ref.paged_attention_verify_ref(
                   q, kp, vp, bt, ln)),
               "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        emit(row)
        s = summary["paged_attention_verify"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
        if idx == 0:
            s.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")})
            s["at"] = f"B=4 Tq=5 H=Kh=16 lengths={lengths}"
            s["cuda_body"] = used


def masked_plan(mk, kname, m, d_in, d_out, dtype):
    """The launch plan of a masked kernel call as a row records it: the
    masked matmul's (K and N swap for the transposed form) or the
    SDDMM's."""
    if kname == "sddmm_masked":
        pl = mk.sddmm_plan(d_in, d_out, dtype)
        return {"route": pl.route, "tile": pl.tile, "grid": pl.grid}
    k, n = (d_out, d_in) if kname == "masked_matmul_t" else (d_in, d_out)
    pl = mk.plan(m, k, n, dtype)
    return {"route": pl.route, "tile": pl.tile, "grid": pl.grid,
            "split": pl.split}


def f32_row(s, row, at):
    """Add an f32 row of a masked kernel to its summary: the kernels line
    lists each with the body it ran, its time and its yardsticks."""
    s.setdefault("f32_rows", []).append(
        {"at": at, "cuda_body": row["routes_launched"],
         **{k: row[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")}})


def mm_close(torch, got, want32, mag, dtype):
    """(ok, max |got - want32|, max of the error over its limit) under the
    matmul-shaped rule of MM_TOL."""
    tol = MM_TOL[dtype]
    lim = tol["atol"] + tol["u_out"] * want32.abs() + tol["u_sum"] * mag
    err = (got.float() - want32).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= lim).all())
    return ok, float(err.max()), float((err / lim).max())


def check_masked(torch, dev, timer, rows, summary):
    """The masked matmul (both orientations) and the SDDMM at the olmo-1b
    masked-dense shapes, m = 2048 tokens, bf16 and f32."""
    from repro_torch.core.fold import mask_tensor
    from repro_torch.core.mask import block_id_of, make_mask_spec
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    m = MM_TOKENS
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        for name, d_in, d_out, act in MM_SHAPES:
            spec = make_mask_spec(d_in, d_out, 8, seed=d_out)
            mask = mask_tensor(spec, dev)
            in_block = torch.as_tensor(block_id_of(spec)[0], device=dev)
            dropped = mask * (in_block != 0).to(torch.uint8)[:, None]
            r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
            x = r(m, d_in).to(dtype)
            w = (r(d_in, d_out) * d_in ** -0.5).to(dtype)
            gy = r(m, d_out).to(dtype)
            b = (0.1 * r(d_out)).to(dtype) if act else None
            x32, w32, g32 = x.float(), w.float(), gy.float()
            b32 = None if b is None else b.float()
            wm = w * mask.to(dtype)                   # library yardstick only
            es = x.element_size()
            nnz = int(mask.sum())
            cases = {
                "masked_matmul": dict(
                    run=lambda: mk.masked_matmul(x, w, mask, b, activation=act),
                    plain=lambda: ref.masked_matmul_ref(x, w, mask, b, act),
                    want=lambda mk_: ref.masked_matmul_ref(x32, w32, mk_, b32,
                                                           act),
                    mag=lambda: x32.abs() @ (w32.abs() * mask)
                    + (0 if b32 is None else b32.abs()),
                    library=lambda: torch.matmul(x, wm),
                    nbytes=(m * d_in + nnz + m * d_out) * es
                    + d_in * d_out + (0 if b is None else d_out * 4)),
                "masked_matmul_t": dict(
                    run=lambda: mk.masked_matmul(gy, w, mask,
                                                 transpose_rhs=True),
                    plain=lambda: ref.masked_matmul_t_ref(gy, w, mask),
                    want=lambda mk_: ref.masked_matmul_t_ref(g32, w32, mk_),
                    mag=lambda: g32.abs() @ (w32.abs() * mask).T,
                    library=lambda: torch.matmul(gy, wm.T),
                    nbytes=(m * d_out + nnz + m * d_in) * es
                    + d_in * d_out),
                "sddmm_masked": dict(
                    run=lambda: mk.sddmm_masked(x, gy, mask),
                    plain=lambda: ref.matmul_masked_grad_ref(x, gy, mask),
                    want=lambda mk_: ref.matmul_masked_grad_ref(x32, g32, mk_),
                    mag=lambda: (x32.abs().T @ g32.abs()) * mask,
                    library=lambda: torch.matmul(x.T, gy),
                    nbytes=(m * d_in + m * d_out + d_in * d_out) * es
                    + d_in * d_out),
            }
            for kname, c in cases.items():
                got, used = run_routed(c["run"], mk.sddmm_routes
                                       if kname == "sddmm_masked" else None)
                want, mag = c["want"](mask), c["mag"]()
                ok, err, ratio = mm_close(torch, got, want, mag, dt)
                rejects = not mm_close(torch, c["want"](dropped), want, mag,
                                       dt)[0]
                exact_zeros = None
                if kname == "sddmm_masked":
                    exact_zeros = bool((got[mask == 0] == 0).all())
                    ok = ok and exact_zeros
                del got, want, mag
                ok = ok and rejects
                # the body the plan names ran (bf16 on the tensor cores)
                plan = masked_plan(mk, kname, m, d_in, d_out, dtype)
                ok = ok and used == [plan["route"]]
                b_ms, b_by = bound(c["nbytes"], 2.0 * m * nnz, dt)
                row = {"phase": "kernels", "kernel": kname, "shape": name,
                       "m": m, "d_in": d_in, "d_out": d_out,
                       "activation": act, "dtype": dt, "max_abs_err": err,
                       "err_over_tol": ratio,
                       "tol": dict(MM_TOL[dt], rule=MM_RULE),
                       "rejects_dropped_block": rejects,
                       "offmask_exact_zero": exact_zeros, "ok": ok,
                       "routes_launched": used, "plan": plan,
                       "ms": timer.ms(c["run"]),
                       "plain_ms": timer.ms(c["plain"]),
                       "library_ms": timer.ms(c["library"]),
                       "library": "one torch.matmul on the pre-masked "
                       "weight (mask multiply not timed)"
                       if kname != "sddmm_masked" else
                       "one torch.matmul x^T @ g (mask not applied)",
                       "bound_ms": b_ms, "bound_by": b_by}
                rows.append(row)
                emit(row)
                s = summary[kname]
                s["max_abs_err"] = max(s["max_abs_err"], err)
                s["err_over_tol"] = max(s["err_over_tol"], ratio)
                s["ok"] = s["ok"] and ok
                if dt == "bfloat16" and name == "up_gate":
                    s.update({k: row[k] for k in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by")})
                    s["at"] = f"bf16 up/gate {d_in}x{d_out}, m={m}"
                    s["cuda_body"] = used
                if dt == "float32" and name == "up_gate":
                    f32_row(s, row, f"olmo up/gate {d_in}x{d_out}, m={m}")
            del x, w, gy, wm, mask, dropped
    torch.cuda.empty_cache()


# m rows of a masked-dense target served: a decode step of 4 slots, a
# verify window of 4 x 5, a prefill chunk
MM_SERVE_M = (4, 20, 64)


def check_masked_serving(torch, dev, timer, rows, summary):
    """The masked matmul forward at the rows a served masked-dense model
    gives it: the bf16 up/gate projection with silu and bias, under the
    MM_TOL rule, which must reject one mask block dropped."""
    from repro_torch.core.fold import mask_tensor
    from repro_torch.core.mask import block_id_of, make_mask_spec
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(9)
    name, d_in, d_out, act = MM_SHAPES[1]
    spec = make_mask_spec(d_in, d_out, 8, seed=d_out)
    mask = mask_tensor(spec, dev)
    in_block = torch.as_tensor(block_id_of(spec)[0], device=dev)
    dropped = mask * (in_block != 0).to(torch.uint8)[:, None]
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    w = (r(d_in, d_out) * d_in ** -0.5).bfloat16()
    b = (0.1 * r(d_out)).bfloat16()
    w32, b32 = w.float(), b.float()
    wm = w * mask.bfloat16()
    s = summary["masked_matmul"]
    s["serving_rows"] = []
    # one block of rows, served at every m: a row's output must not depend
    # on how many rows share its call (greedy spec streams equal non-spec
    # streams only if verify at m = 20 scores as decode at m = 4 does)
    x_all = r(max(MM_SERVE_M), d_in).bfloat16()
    outs = {m: mk.masked_matmul(x_all[:m], w, mask, b, activation=act)
            for m in (1,) + MM_SERVE_M}
    ref_rows = outs[4]
    invariant = all(torch.equal(y[:min(m, 4)], ref_rows[:min(m, 4)])
                    for m, y in outs.items())
    del outs
    for m in MM_SERVE_M:
        x = x_all[:m]
        x32 = x.float()
        run = lambda: mk.masked_matmul(x, w, mask, b, activation=act)
        want = ref.masked_matmul_ref(x32, w32, mask, b32, act)
        mag = x32.abs() @ (w32.abs() * mask) + b32.abs()
        got, used = run_routed(run)
        ok, err, ratio = mm_close(torch, got, want, mag, "bfloat16")
        rejects = not mm_close(torch, ref.masked_matmul_ref(
            x32, w32, dropped, b32, act), want, mag, "bfloat16")[0]
        pl = mk.plan(m, d_in, d_out, torch.bfloat16)
        ok = (ok and rejects and invariant and used == [pl.route]
              and pl.route == "tc_small_m")
        nnz = int(mask.sum())
        nbytes = (m * d_in + nnz + m * d_out) * 2 + d_in * d_out + d_out * 4
        b_ms, b_by = bound(nbytes, 2.0 * m * nnz, "bfloat16")
        row = {"phase": "kernels", "kernel": "masked_matmul", "shape": name,
               "role": "serve", "m": m, "d_in": d_in, "d_out": d_out,
               "activation": act, "dtype": "bfloat16", "max_abs_err": err,
               "err_over_tol": ratio,
               "tol": dict(MM_TOL["bfloat16"], rule=MM_RULE),
               "rejects_dropped_block": rejects,
               "batch_invariant": invariant,
               "batch_invariant_at": "rows 0-3 bit for bit at m = 1, 4, 20, 64",
               "routes_launched": used,
               "plan": {"route": pl.route, "tile": pl.tile, "grid": pl.grid,
                        "split": pl.split}, "ok": ok,
               "ms": timer.ms(run),
               "plain_ms": timer.ms(lambda: ref.masked_matmul_ref(
                   x, w, mask, b, act)),
               "library_ms": timer.ms(lambda: torch.matmul(x, wm)),
               "library": "one torch.matmul on the pre-masked weight",
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        emit(row)
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
        s["serving_rows"].append({k: row[k] for k in (
            "m", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "batch_invariant")})
        s["serving_rows"][-1]["split"] = pl.split
    del w, wm, mask, dropped, x_all
    torch.cuda.empty_cache()


def ffn_plain32(torch, ref, a, act, w_down=None):
    """The plain fused MLP in f32 on the same values, ``(y, mag)`` with
    ``mag`` the magnitude term of the fused rule; ``w_down`` replaces the
    down weight."""
    f32 = {k: v if v.dtype == torch.int8 else v.float() for k, v in a.items()}
    wd = f32["w_down"] if w_down is None else w_down
    quant = a["w_up"].dtype == torch.int8

    def proj(x, w, s, b, absolute=False):
        if absolute:
            x, w, b = x.abs(), w.abs(), None if b is None else b.abs()
        if quant:
            return ref.bdmm_quant_ref(x, w, s, b)
        return ref.bdmm_ref(x, w.float(), b)
    x, act_fn = f32["x"], ref.ACTIVATIONS[act]
    up = (f32["w_up"], f32.get("s_up"), f32.get("b_up"))
    u, ua = proj(x, *up), proj(x, *up, True)
    if "w_gate" in a:
        gate = (f32["w_gate"], f32.get("s_gate"), f32.get("b_gate"))
        g, ga = act_fn(proj(x, *gate)), proj(x, *gate, True)
        h, dh = g * u, g.abs() * ua + ACT_SLOPE * u.abs() * ga
    else:
        h, dh = act_fn(u), ACT_SLOPE * ua
    down = (wd, f32.get("s_down"), f32.get("b_down"))
    return proj(h, *down), proj(h.abs() + dh, *down, True)


def check_fused_ffn(torch, dev, timer, rows, summary):
    """The fused MLP at olmo-1b's perm-fused FFN width (FFN_CASES) against
    its plain version, with the composed yardstick beside it."""
    import torch.nn.functional as F
    from repro_torch.kernels import bdmm as bk
    from repro_torch.kernels import fused_ffn as fk
    from repro_torch.kernels import ref
    from repro_torch.kernels.quant import quantize_blocks

    gen = torch.Generator(device=dev).manual_seed(6)
    nb, bi, bo = FFN_DIMS
    for label, m, weights, dt, act, gated, biases, f in FFN_CASES:
        dtype = getattr(torch, dt)
        quant = weights == "int8"
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
        a = {"x": r(m, nb * bi).to(dtype)}
        ws = {"w_up": r(nb, bi, f) * bi ** -0.5,
              "w_down": r(nb, f, bo) * f ** -0.5}
        if gated:
            ws["w_gate"] = r(nb, bi, f) * bi ** -0.5
        for k, w in ws.items():
            if quant:
                a[k], a["s_" + k[2:]] = quantize_blocks(w)
            else:
                a[k] = w.to(dtype)
        if biases:
            a["b_up"] = (0.1 * r(nb * f)).to(dtype)
            a["b_down"] = (0.1 * r(nb * bo)).to(dtype)
            if gated:
                a["b_gate"] = (0.1 * r(nb * f)).to(dtype)
        del ws
        args = [a.get(k) for k in ("w_gate", "b_up", "b_gate", "b_down",
                                   "s_up", "s_gate", "s_down")]
        run = lambda: fk.fused_ffn(a["x"], a["w_up"], a["w_down"], *args,
                                   activation=act)
        if quant:
            plain = lambda: ref.fused_ffn_quant_ref(
                a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                a.get("b_up"), a.get("b_gate"), a.get("b_down"), a["s_up"],
                a.get("s_gate"), a["s_down"], act)

            def yard():                 # the port's unfused int8 route
                u = bk.bdmm(a["x"], a["w_up"], a.get("b_up"), a["s_up"])
                if gated:
                    h = bk.bdmm(a["x"], a["w_gate"], a.get("b_gate"),
                                a["s_gate"], activation=act) * u
                else:
                    h = ref.ACTIVATIONS[act](u)
                return bk.bdmm(h, a["w_down"], a.get("b_down"), a["s_down"])
            yard_label = "three bdmm launches and the gate (unfused route)"
        else:
            plain = lambda: ref.fused_ffn_ref(
                a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                a.get("b_up"), a.get("b_gate"), a.get("b_down"), act)
            xt = a["x"].view(m, nb, bi).transpose(0, 1)

            def bmm(x3, w, b, n_out):
                if b is None:
                    return torch.bmm(x3, w)
                return torch.baddbmm(b.view(nb, 1, n_out), x3, w)

            def yard():                 # three torch.bmm and the gate
                u = bmm(xt, a["w_up"], a.get("b_up"), f)
                if gated:
                    h = F.silu(bmm(xt, a["w_gate"], a.get("b_gate"), f)) * u
                else:
                    h = ref.ACTIVATIONS[act](u)
                return bmm(h, a["w_down"], a.get("b_down"), bo)
            yard_label = "three torch.bmm and the gate"

            def unfused():              # the port's unfused route
                if gated:
                    h = bk.bdmm(a["x"], a["w_gate"], a.get("b_gate"),
                                activation=act) * bk.bdmm(
                                    a["x"], a["w_up"], a.get("b_up"))
                else:               # the kernel's epilogue runs silu only
                    h = ref.ACTIVATIONS[act](bk.bdmm(a["x"], a["w_up"],
                                                     a.get("b_up")))
                return bk.bdmm(h, a["w_down"], a.get("b_down"))
        got, used = run_routed(run, fk.routes)
        want, mag = ffn_plain32(torch, ref, a, act)
        ok, err, ratio = mm_close(torch, got, want, mag, dt)
        wd = a["w_down"].clone()
        wd[:, :fk.F_TILE] = 0
        dropped, _ = ffn_plain32(torch, ref, a, act,
                                 w_down=wd if quant else wd.float())
        rejects = not mm_close(torch, dropped, want, mag, dt)[0]
        # the body the plan names ran: bf16 on the tensor cores
        pl = fk.plan(m, nb, f, bo, torch.cuda.get_device_properties(
            dev).multi_processor_count, dtype)
        ok = ok and rejects and used == [pl.route]
        ok = ok and (dt != "bfloat16" or pl.route in ("tc", "tc_tall"))
        del got, want, mag, dropped, wd
        es = a["x"].element_size()
        w_bytes = sum(a[k].numel() * a[k].element_size()
                      for k in ("w_up", "w_gate", "w_down", "s_up", "s_gate",
                                "s_down", "b_up", "b_gate", "b_down")
                      if k in a)
        nbytes = m * nb * bi * es + w_bytes + m * nb * bo * es
        n_ops = 2.0 * m * nb * (bi * f * (2 if gated else 1) + f * bo)
        b_ms, b_by = bound(nbytes, n_ops, dt)
        row = {"phase": "kernels", "kernel": "fused_ffn", "case": label,
               "m": m, "nb": nb, "bi": bi, "f": f, "bo": bo,
               "weights": "int8" if quant else dt, "dtype": dt,
               "activation": act, "gated": gated, "biases": biases,
               "plan": pl._asdict(), "routes_launched": used,
               "max_abs_err": err, "err_over_tol": ratio,
               "tol": dict(MM_TOL[dt], rule=FFN_RULE, act_slope=ACT_SLOPE),
               "rejects_zeroed_f_tile": rejects, "ok": ok,
               "ms": timer.ms(run), "plain_ms": timer.ms(plain),
               "library_ms": None, "yardstick_ms": timer.ms(yard),
               "yardstick": yard_label, "bound_ms": b_ms, "bound_by": b_by}
        if not quant:
            row["unfused_route_ms"] = timer.ms(unfused)
        if pl.route == "tc_tall":       # the m <= 64 body on the same inputs
            old = fk.Plan("tc", fk.TC_ROWS, 1, -(-f // fk.F_TILE))
            row["tc_body_ms"] = timer.ms(lambda: fk.fused_ffn(
                a["x"], a["w_up"], a["w_down"], *args, activation=act,
                force=old))
        rows.append(row)
        emit(row)
        s = summary["fused_ffn"]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
        s.setdefault("bodies", {}).setdefault(pl.route, []).append(
            f"{label} m={m} {row['weights']}")
        if pl.route == "tc_tall":
            s.setdefault("tall_rows", []).append({k: row.get(k) for k in (
                "case", "m", "weights", "plan", "routes_launched", "ms",
                "plain_ms", "bound_ms", "bound_by", "yardstick_ms",
                "yardstick", "unfused_route_ms", "tc_body_ms",
                "max_abs_err", "err_over_tol")})
        if quant and dt == "bfloat16" and label == "decode":
            s.update({k: row[k] for k in ("ms", "plain_ms", "library_ms",
                                          "yardstick_ms", "yardstick",
                                          "bound_ms", "bound_by")})
            s["at"] = f"int8 gated, bf16, m={m} (decode), nb {nb} bi {bi} " \
                      f"f {f} bo {bo}"
            s["cuda_body"] = used
        del a, args
    torch.cuda.empty_cache()


# ------------------------------------------------------------------ serving
def check_lenet(torch, dev, timer, rows, summary):
    """bdmm on f32 blocks at every packed LeNet-300-100 block shape (the
    head's bo = 1 and 2 among them) and at the speedup's 8 x 256 x 256, in
    the roles the paper path gives it, and the masked matmul, its transpose
    and the SDDMM at LeNet's masked-dense layers (c = 10), each against its
    plain version on the card; f32 runs the SIMT bodies (bdmm: decode_simt
    at m <= 32, simt_small for narrow blocks and up to 64 rows, the tiled
    simt_f32 for the speedup's wide blocks; the masked matmul: simt_small_m
    at m <= 64, simt_f32 above; the SDDMM at the tile sddmm_plan picks),
    each the one its plan names."""
    from repro_torch.configs.lenet300 import LeNet300
    from repro_torch.core.fold import mask_tensor
    from repro_torch.core.policy import uniform
    from repro_torch.kernels import bdmm as bk
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(20)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
    specs = {c: LeNet300(policy=uniform(c, min_block=1)).specs
             for c in LENET_C}
    blocks = [(s.mask.nb, s.mask.block_in, s.mask.block_out)
              for c in LENET_C for s in specs[c]]
    cases = [(blk, m, role) for blk in blocks for m, role in LENET_BDMM_M]
    cases += [(SPEEDUP_BLOCKS, m, role) for m, role in SPEEDUP_BDMM_M]
    for (nb, bi, bo), m, role in cases:
        dx = role == "dx"
        k, n = (bo, bi) if dx else (bi, bo)
        w = r(nb, bi, bo) * bi ** -0.5
        x = r(m, nb * k)
        xt = x.view(m, nb, k).transpose(0, 1)
        if dx:
            run = lambda: bk.bdmm(x, w, transpose=True)  # noqa: E731
            plain = lambda: ref.bdmm_t_ref(x, w)  # noqa: E731
            library = lambda: torch.bmm(xt, w.transpose(1, 2))  # noqa: E731
        else:
            run = lambda: bk.bdmm(x, w)  # noqa: E731
            plain = lambda: ref.bdmm_ref(x, w)  # noqa: E731
            library = lambda: torch.bmm(xt, w)  # noqa: E731
        got, used = run_routed(run, bk.routes)
        ok, err, ratio, tol = close(torch, got, plain(), "bdmm", "float32")
        del got
        pl = bk.plan(m, nb, k, n, torch.float32, torch.float32, dx)
        grid = "bdmm_decode" if pl.route in bk.DECODE_ROUTES else "bdmm"
        ok = ok and used == [pl.route] and pl.route in bk.F32_ROUTES
        b_ms, b_by = bound(4.0 * (m * nb * k + nb * bi * bo + m * nb * n),
                           2.0 * m * nb * bi * bo, "float32")
        row = {"phase": "kernels", "kernel": grid, "shape": [nb, bi, bo],
               "m": m, "role": role, "weights": "float32",
               "dtype": "float32", "path": "paper",
               "max_abs_err": err, "err_over_tol": ratio, "tol": tol,
               "ok": ok, "routes_launched": used,
               "plan": {"route": pl.route, "tile": pl.tile, "grid": pl.grid,
                        "split": pl.split, "k_chunk": pl.k_chunk,
                        "cluster": [1, 1, pl.split]},
               "ms": timer.ms(run), "plain_ms": timer.ms(plain),
               "library_ms": timer.ms(library),
               "library": "one torch.bmm over the blocks",
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        emit(row)
        s = summary[grid]
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["err_over_tol"] = max(s["err_over_tol"], ratio)
        s["ok"] = s["ok"] and ok
    for spec in specs[10]:                  # the masked-dense layers at c = 10
        d_in, d_out, nb = spec.d_in, spec.d_out, spec.mask.nb
        mask = mask_tensor(spec.mask, dev)
        w = r(d_in, d_out) * d_in ** -0.5 * mask
        nnz = int(mask.sum())
        for m, kname in ((1, "masked_matmul"), (50, "masked_matmul"),
                         (50, "masked_matmul_t"), (50, "sddmm_masked"),
                         (2048, "masked_matmul")):
            x, gy = r(m, d_in), r(m, d_out)
            if kname == "masked_matmul":
                run = lambda: mk.masked_matmul(x, w, mask)  # noqa: E731
                plain = lambda: ref.masked_matmul_ref(x, w, mask)  # noqa: E731
                mag = x.abs() @ w.abs()
                library = lambda: torch.matmul(x, w)  # noqa: E731
                tally = mk.routes
            elif kname == "masked_matmul_t":
                run = lambda: mk.masked_matmul(gy, w, mask,  # noqa: E731
                                               transpose_rhs=True)
                plain = lambda: ref.masked_matmul_t_ref(gy, w, mask)  # noqa: E731
                mag = gy.abs() @ w.abs().T
                library = lambda: torch.matmul(gy, w.T)  # noqa: E731
                tally = mk.routes
            else:
                run = lambda: mk.sddmm_masked(x, gy, mask)  # noqa: E731
                plain = lambda: ref.matmul_masked_grad_ref(x, gy, mask)  # noqa: E731
                mag = (x.abs().T @ gy.abs()) * mask
                library = lambda: torch.matmul(x.T, gy)  # noqa: E731
                tally = mk.sddmm_routes
            got, used = run_routed(run, tally)
            ok, err, ratio = mm_close(torch, got, plain(), mag, "float32")
            if kname == "sddmm_masked":
                ok = ok and bool((got[mask == 0] == 0).all())
            # the f32 body the plan names ran
            plan = masked_plan(mk, kname, m, d_in, d_out, torch.float32)
            ok = ok and used == [plan["route"]]
            del got
            io = (m * d_in + m * d_out) * 4
            # the mask, and the whole dW the SDDMM writes or the weights on
            # the mask that the products read
            wbytes = d_in * d_out + 4 * (d_in * d_out
                                         if kname == "sddmm_masked" else nnz)
            b_ms, b_by = bound(io + wbytes, 2.0 * m * nnz, "float32")
            row = {"phase": "kernels", "kernel": kname, "shape": [d_in, d_out],
                   "nb": nb, "m": m, "dtype": "float32", "path": "paper",
                   "max_abs_err": err, "err_over_tol": ratio,
                   "tol": dict(MM_TOL["float32"], rule=MM_RULE), "ok": ok,
                   "routes_launched": used, "plan": plan, "ms": timer.ms(run),
                   "plain_ms": timer.ms(plain),
                   "library_ms": timer.ms(library),
                   "library": "one torch.matmul on the pre-masked weight",
                   "bound_ms": b_ms, "bound_by": b_by}
            rows.append(row)
            emit(row)
            s = summary[kname]
            s["max_abs_err"] = max(s["max_abs_err"], err)
            s["err_over_tol"] = max(s["err_over_tol"], ratio)
            s["ok"] = s["ok"] and ok
            if d_in == 800:
                f32_row(s, row, f"LeNet {d_in}x{d_out}, m={m}")


def olmo_engine(torch, dev, dtype, seed=0, **over):
    from repro_torch.core import export
    from repro_torch.configs.common import get_config
    from repro_torch.models import build

    cfg = get_config("olmo-1b", dtype=dtype, **over)
    model = build(cfg)
    params, report = export.quantize_packed(model, model.init(seed, device=dev))
    torch.cuda.synchronize()
    return cfg, model, params, report


SERVE_ENGINE = dict(n_slots=4, max_len=512 + 32, page_size=16,
                    prefill_chunk_tokens=64)
SERVE_TRAFFIC = dict(n_requests=8, rate=16.0, prompt_len=512, gen=32, seed=0,
                     shared_prefix=128)
# Every request stream and the training stream share seed 0, so the call
# draws one SyntheticLM transition table (~5 GB at vocab 50304, 17-27 s).


def program_calls(engine):
    """The engine's model calls as a serve phase reads them: host ms of
    every decode step and every prefill chunk (dense: every admission's
    whole-prompt prefill) (runs of the decode and chunk or admission
    programs, eager calls or graph replays, on a synchronised clock: set
    ``engine.time_programs`` before serving), and the number of calls that
    ran the unembed (every decode step, the final chunk of each prefill and
    every admission)."""
    ms, runs = engine.run_ms, engine.runs
    return {"decode": ms["decode"] + ms["decode_dense"],
            "prefill": ms["chunk"] + ms["chunk_final"] + ms["admit"],
            "unembed": (runs["decode"] + runs["chunk_final"]
                        + runs["decode_dense"] + runs["admit"])}


def warm_engine(torch, engine):
    """``engine.warmup()`` (every program captured at every width rung):
    its seconds, the bytes the graphs' memory pools added to the reserved
    device memory, and the graphs captured."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # each capture empties the cache too
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return {"warmup_s": seconds,
            "graph_pool_bytes": torch.cuda.memory_reserved() - reserved,
            "graphs_captured": engine.n_captures}


def bdmm_per_call(launches, calls) -> float:
    """bdmm launches per model call inside the layers (the unembed's one
    launch per call that ran it taken out)."""
    n = len(calls["decode"]) + len(calls["prefill"])
    return (sum(launches[k] for k in BDMM_KERNELS) - calls["unembed"]) / n


def serve_phase(torch, dev, ops):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.serve import Engine

    t0 = time.perf_counter()
    cfg, model, params, report = olmo_engine(torch, dev, "bfloat16")
    setup_s = time.perf_counter() - t0
    kw = SERVE_ENGINE
    # warm-up: every program captured at every width rung before the
    # measured run (the first-call costs land there)
    engine = Engine(model, params, **kw)
    warm = warm_engine(torch, engine)
    reqs = make_requests(cfg, **SERVE_TRAFFIC)
    engine.time_programs = True
    ops.reset_launch_counts()
    summary = serve_stream(engine, reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    attn_routes = dict(pa.routes)
    calls = program_calls(engine)
    captured_serving = engine.n_captures - warm["graphs_captured"]
    prefill_tokens = (engine.n_prefill_tokens, engine.n_prefill_tokens_skipped)
    del engine

    # where a steady decode step's time goes, from the profiler
    window = decode_window(torch, model, params, kw, cfg)
    # the same traffic eager and captured, in turns
    turns = graph_turns(torch, model, params, kw, cfg)

    done = summary["n_done"] == len(reqs) and no_hidden_faults(summary) and all(
        len(r.generated) == r.max_new_tokens
        and all(0 <= t < cfg.vocab for t in r.generated) for r in reqs)
    # bf16 prefill chunks and decode steps on the tensor-core body
    bodies = (attn_routes["split_tc"] == launches["paged_prefill_attention"]
              + launches["paged_attention"] and attn_routes["split_kv"] == 0)
    ok = (done and all(launches[k] > 0 for k in SERVING_KERNELS) and bodies
          and window["combine_in_family"] is not False
          and captured_serving == 0 and turns["ok"])
    row = {"phase": "serve", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "mpd_c": cfg.mpd_c, "weights": "int8",
        "dtype": cfg.dtype, "slots": 4, "page_size": 16, "prefill_chunk": 64},
        "setup_s": setup_s, "quant_max_rel_rms": report["max_rel_rms"],
        "requests_done": summary["n_done"], "requests": len(reqs),
        "prompt_tokens": [len(r.prompt) for r in reqs],
        "new_tokens": [len(r.generated) for r in reqs],
        "prefill_tokens_computed": prefill_tokens[0],
        "prefill_tokens_reused": prefill_tokens[1],
        "tok_s": summary["agg_tok_s"], "elapsed_s": summary["elapsed_s"],
        "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
        "ttft_p95_ms": summary["ttft_p95_s"] * 1e3,
        "e2e_p50_ms": summary["e2e_p50_s"] * 1e3,
        "e2e_p95_ms": summary["e2e_p95_s"] * 1e3,
        "decode_steps": len(calls["decode"]),
        "decode_step_ms_p50": statistics.median(calls["decode"]),
        "prefill_chunks": len(calls["prefill"]),
        "prefill_chunk_ms_p50": statistics.median(calls["prefill"]),
        "unembed_calls": calls["unembed"],
        "bdmm_launches_per_call": bdmm_per_call(launches, calls),
        "attention_routes": attn_routes,
        "decode_window": window,
        "occupancy_mean": summary["occupancy_mean"],
        "kv_bytes_allocated_peak": summary["kv_bytes_allocated_peak"],
        **warm, "graphs_captured_while_serving": captured_serving,
        "graph_turns": turns,
        "launches": launches}
    emit(row)
    return row


def device_families(torch, prof, n):
    """Device ms per unit (``n`` steps or chunks) by kernel family from a
    profiler run, the busy time summed, and how many paged-attention combine
    kernels it saw (in their family or in "other")."""
    cuda = torch.autograd.DeviceType.CUDA
    # the paged kernels' combine (paged_attention_kernel_combine,
    # paged_verify_kernel_combine) counts with its family; "bdmm_decode" takes
    # the bf16 decode grid (bdmm_decode_tc_kernel), "fused_ffn" both bodies
    # (fused_ffn_tc_kernel and fused_ffn_kernel)
    families = {"bdmm_decode": 0.0, BDMM_GENERAL_FAMILY: 0.0,
                "fused_ffn": 0.0, "paged_attention_kernel": 0.0,
                "paged_verify_kernel": 0.0, MASKED_MM_FAMILY: 0.0,
                "other": 0.0}
    combines = {"seen": 0, "in_other": 0}
    for e in prof.events():
        if e.device_type != cuda:
            continue
        name = e.name.replace("bdmm_reduce_kernel", BDMM_GENERAL_FAMILY)
        key = next((k for k in families if k in name), "other")
        families[key] += getattr(e, "self_device_time_total", 0) / 1e3
        if "_kernel_combine" in name:
            combines["seen"] += 1
            combines["in_other"] += key == "other"
    return {k: v / n for k, v in families.items()}, sum(families.values()), combines


def decode_window(torch, model, params, kw, cfg, n_steps=16, spec_draft=None,
                  graphs=None, profile_prefill=True):
    """Where a steady decode step's time goes: ``n_steps`` decode steps
    (speculative steps with ``spec_draft``) of 4 live slots at the serve
    phase's context depths (~250-540 tokens), under torch.profiler; the
    prefill of those 4 requests (64-token chunks; on the dense engine,
    ``kw["paged"]`` False, one whole-prompt admission each) is profiled on
    its way (with ``profile_prefill``). The engine captures its programs
    (``graphs``, the engine's argument) before the profile, so the profile
    holds replays and no capture. Returns wall ms per step, device kernel
    ms per step (per prefill chunk) by kernel family, and the device's busy
    share; then the wall of ``n_steps`` more steps without the profiler
    (whose recording of every host op slows the host, not the device) and
    the busy share against it. The device entries are None when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    t_start = time.perf_counter()
    eng = Engine(model, params, spec_draft=spec_draft, spec_k=SPEC_K,
                 graphs=graphs, **kw)
    eng.warmup()
    for r in make_requests(cfg, n_requests=4, rate=1e9, prompt_len=448,
                           gen=32, seed=0, shared_prefix=128):
        r.max_new_tokens = 96           # every slot stays live in the window
        eng.submit(r)
    chunks0 = eng.n_prefill_chunks + eng.runs["admit"]
    queue = getattr(eng, "_prefill_queue", ())
    prefill = None
    if profile_prefill:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            while queue or eng.scheduler.waiting:
                eng.step()
            torch.cuda.synchronize()
        prefill, prefill_ms, _ = device_families(
            torch, prof,
            max(eng.n_prefill_chunks + eng.runs["admit"] - chunks0, 1))
        prefill = prefill if prefill_ms > 0 else None
    else:
        while queue or eng.scheduler.waiting:
            eng.step()
        torch.cuda.synchronize()
    chunks = eng.n_prefill_chunks + eng.runs["admit"] - chunks0

    def steps():
        live = 0
        t0 = time.perf_counter()
        for _ in range(n_steps):
            live += int(eng._live.sum())
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n_steps, live / n_steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms, live = steps()
    families, busy, combines = device_families(torch, prof, n_steps)
    device_ms = busy / n_steps
    plain_wall_ms, plain_live = steps()
    on = device_ms > 0
    return {"steps": n_steps, "wall_ms_per_step": wall_ms,
            "live_rows_per_step": live,
            "device_ms_per_step": families if on else None,
            "device_ms_per_step_total": device_ms if on else None,
            "device_busy_share": device_ms / wall_ms if on else None,
            "wall_ms_per_step_unprofiled": plain_wall_ms,
            "live_rows_per_step_unprofiled": plain_live,
            "device_busy_share_unprofiled":
                device_ms / plain_wall_ms if on else None,
            "combine_launches": combines["seen"],
            "combine_in_family": (combines["seen"] > 0
                                  and combines["in_other"] == 0)
            if on else None,
            # the steps that ran the 4 prompts' chunks or admissions (some
            # also decode the slots already live)
            "prefill_chunks": chunks,
            "prefill_device_ms_per_chunk": prefill,
            "seconds": time.perf_counter() - t_start}


def graph_turns(torch, model, params, kw, cfg, spec_draft=None):
    """The serve traffic served by eager and captured engines in turns
    (eager, captured, captured, eager; speculative with ``spec_draft``).
    Every request arrives at once, so the schedule, and with it every
    launch count, does not depend on how fast the host is. Per turn: the
    engine step's and the programs' p50 ms (synchronised clock), TTFT and
    e2e p50/p95, tok/s, a profiled decode window and, captured, the
    warmup's seconds and graph-pool bytes. ``ok``: the four turns' greedy
    streams are identical and the captured turns' launch counts and route
    tallies equal the eager turns'."""
    import gc

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.serve import Engine

    traffic = dict(SERVE_TRAFFIC, rate=1e9)
    turns, streams, tallies = [], [], []
    for graphs in (False, None, None, False):
        t_turn = time.perf_counter()
        engine = Engine(model, params, spec_draft=spec_draft, spec_k=SPEC_K,
                        graphs=graphs, **kw)
        warm = warm_engine(torch, engine) if graphs is None else {}
        reqs = make_requests(cfg, **traffic)
        engine.time_programs = True
        steps = instrument_steps(torch, engine)
        ops.reset_launch_counts()
        summary = serve_stream(engine, reqs)
        torch.cuda.synchronize()
        tallies.append([dict(d) for d in ops.counters()])
        streams.append({r.id: list(r.generated) for r in reqs})
        calls = program_calls(engine)
        runs = dict(engine.runs)
        draft_ms = engine.run_ms["draft_decode"]
        verify_ms = engine.run_ms["verify"]
        done = (summary["n_done"] == len(reqs)
                and no_hidden_faults(summary))
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        window = decode_window(torch, model, params, kw, cfg,
                               n_steps=8 if spec_draft else 16,
                               spec_draft=spec_draft, graphs=graphs,
                               profile_prefill=False)
        pre = "prefill_chunk" if kw.get("paged", True) else "admit"
        turn = {"route": "eager" if graphs is False else "captured",
                "requests_done": summary["n_done"],
                "step_ms_p50": statistics.median(steps["step"]),
                "decode_steps": len(steps["step"]),
                f"{pre}_ms_p50": statistics.median(calls["prefill"]),
                f"{pre}s": len(calls["prefill"]),
                "tok_s": summary["agg_tok_s"],
                "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
                "ttft_p95_ms": summary["ttft_p95_s"] * 1e3,
                "e2e_p50_ms": summary["e2e_p50_s"] * 1e3,
                "e2e_p95_ms": summary["e2e_p95_s"] * 1e3,
                "program_runs": runs,
                "window_wall_ms_per_step": window["wall_ms_per_step"],
                "window_device_ms_per_step":
                    window["device_ms_per_step_total"],
                "window_busy_share": window["device_busy_share"],
                "window_wall_ms_per_step_unprofiled":
                    window["wall_ms_per_step_unprofiled"],
                "window_busy_share_unprofiled":
                    window["device_busy_share_unprofiled"],
                "window_live_rows": window["live_rows_per_step"],
                "window_device_ms_by_family": window["device_ms_per_step"],
                **warm}
        if spec_draft is None:
            turn["decode_program_ms_p50"] = statistics.median(calls["decode"])
        else:
            turn["draft_decode_program_ms_p50"] = statistics.median(draft_ms)
            turn["verify_program_ms_p50"] = statistics.median(verify_ms)
            turn["tokens_per_step_mean"] = summary["tokens_per_step_mean"]
        turn["ok"] = done
        turn["seconds"] = time.perf_counter() - t_turn
        turns.append(turn)
    same_streams = all(st == streams[0] for st in streams)
    same_counts = all(t == tallies[0] for t in tallies)
    return {"ok": (same_streams and same_counts
                   and all(t["ok"] for t in turns)),
            "traffic": "serve traffic, every request arriving at t = 0",
            "streams_identical": same_streams,
            "launch_counts_and_routes_equal": same_counts,
            "launches_per_turn": {k: v for d in tallies[0][:5]
                                  for k, v in d.items()},
            "turns": turns}


EXACT_ENGINE = dict(n_slots=4, max_len=256 + 16, page_size=16,
                    prefill_chunk_tokens=64)
EXACT_TRAFFIC = dict(n_requests=6, rate=1e9, prompt_len=256, gen=16, seed=0,
                     shared_prefix=64)


def exact_phase(torch, dev, ops, fuse=False):
    """f32 greedy streams through the kernels and through the plain
    versions (``fuse``: of the perm-fused model, ``exact_fused``, which must
    also launch fused_ffn on the kernel route and nothing on the plain
    route). Returns the row and ``(cfg, model, params, kernel-route
    streams)``."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    over = dict(mpd_fuse=True, n_layers=EXACT_FUSED_LAYERS) if fuse else {}
    cfg, model, params, _ = olmo_engine(torch, dev, "float32", **over)
    streams, counts, captures, faults = {}, {}, {}, {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            reqs = make_requests(cfg, **EXACT_TRAFFIC)
            # the kernel route captured, the plain route eager
            engine = Engine(model, params, **EXACT_ENGINE,
                            graphs=None if backend == "cuda" else False)
            streams[backend] = engine.run(reqs)
        finally:
            ops.set_backend("cuda")
        torch.cuda.synchronize()
        counts[backend] = ops.launch_counts()
        captures[backend] = engine.n_captures
        faults[backend] = engine.metrics.summary()
        del engine
    a, b = streams["cuda"], streams["torch"]
    diverge = []
    for rid in sorted(a):
        if a[rid] != b[rid]:
            first = next((i for i, (x, y) in enumerate(zip(a[rid], b[rid]))
                          if x != y), min(len(a[rid]), len(b[rid])))
            diverge.append({"request": rid, "first_index": first})
    routes_ok = not fuse or (counts["cuda"]["fused_ffn"] > 0
                             and not any(counts["torch"].values()))
    captured = captures["cuda"] > 0 and captures["torch"] == 0
    row = {"phase": "exact_fused" if fuse else "exact",
           "ok": (not diverge and routes_ok and captured
                  and all(map(no_hidden_faults, faults.values()))),
           "dtype": "float32",
           "graphs_captured": captures,
           "weights": "int8", "n_layers": cfg.n_layers,
           "cut": f"{cfg.n_layers} of 16 layers", "requests": len(a),
           "tokens": sum(len(v) for v in a.values()),
           "diverging_requests": diverge,
           "launches_kernel_route": counts["cuda"],
           "launches_plain_route": counts["torch"]}
    if fuse:
        row["mpd_fuse"] = True
    emit(row)
    return row, (cfg, model, params, a)


def instrument_steps(torch, engine):
    """Host ms of every decode step of ``engine`` (a speculative step when
    spec decoding is on) on a synchronised clock, and the number of verify
    calls; delete the instance attributes to undo."""
    calls = {"step": [], "verify": 0}
    name = "_step_spec" if engine.spec_active else "_step_decode"
    step, verify = getattr(engine, name), engine._verify

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        calls["step"].append((time.perf_counter() - t) * 1e3)
        return out

    def counted_verify(*a):
        calls["verify"] += 1
        return verify(*a)
    setattr(engine, name, timed_step)
    engine._verify = counted_verify
    return calls


def no_hidden_faults(summary, step_faults: int = 0,
                     quarantines: int = 0) -> bool:
    """No engine-step fault was caught and no row was quarantined beyond
    the ones a schedule injected: a real kernel fault that a retry hid, or
    a real non-finite row that a quarantine regenerated, fails the
    phase."""
    return (summary["n_step_faults"] == step_faults
            and summary["n_quarantines"] == quarantines)


def pools_conserved(engine) -> bool:
    """Every page of both pools is free or held by the trie alone, and no
    reservation or table entry is left."""
    caches = [engine.cache] + ([engine.draft_cache]
                               if engine.draft_cache is not None else [])
    return all(c.reserved == 0 and not c.block_tables.any()
               and c.pool.free_count + len(c.trie) == c.pool.n_pages - 1
               for c in caches)


def exact_spec_phase(torch, dev, ops, exact_run):
    """Greedy speculative decoding of the ``exact`` phase's f32 model and
    requests, with a perfect draft (the target itself) and a skewed one (the
    same config at seed 7), through the kernels and through the plain
    versions: every stream equals the non-spec kernel-route stream."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    cfg, model, params, base = exact_run
    _, skew_model, skew_params, _ = olmo_engine(torch, dev, "float32", seed=7)
    drafts = {"perfect": (model, params), "skewed": (skew_model, skew_params)}
    out, ok = {}, True
    for name, draft in drafts.items():
        streams, res = {}, {}
        for backend in ("cuda", "torch"):
            ops.set_backend(backend)
            ops.reset_launch_counts()
            try:
                engine = Engine(model, params, spec_draft=draft,
                                spec_k=SPEC_K, **EXACT_ENGINE,
                                graphs=None if backend == "cuda" else False)
                calls = instrument_steps(torch, engine)
                streams[backend] = engine.run(make_requests(cfg,
                                                            **EXACT_TRAFFIC))
            finally:
                ops.set_backend("cuda")
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            s = engine.metrics.summary()
            res[backend] = {
                "acceptance": s["draft_acceptance_rate"],
                "tokens_per_step": s["tokens_per_step_mean"],
                "verify_calls": calls["verify"], "launches": counts,
                "graphs_captured": engine.n_captures,
                "pools_conserved": pools_conserved(engine),
                "step_faults": s["n_step_faults"],
                "quarantines": s["n_quarantines"]}
        k_route, p_route = res["cuda"], res["torch"]
        diverge = [rid for rid in sorted(base)
                   if not (streams["cuda"][rid] == streams["torch"][rid]
                           == base[rid])]
        acc = k_route["acceptance"]
        acc_ok = acc > 0.9 if name == "perfect" else acc < 1.0
        launches_ok = (k_route["launches"]["paged_attention_verify"]
                       == cfg.n_layers * k_route["verify_calls"] > 0
                       and not any(p_route["launches"].values()))
        draft_ok = (not diverge and acc_ok and launches_ok
                    and k_route["pools_conserved"]
                    and p_route["pools_conserved"]
                    and k_route["graphs_captured"] > 0
                    and p_route["graphs_captured"] == 0
                    and k_route["step_faults"] == p_route["step_faults"] == 0
                    and k_route["quarantines"] == p_route["quarantines"] == 0)
        ok = ok and draft_ok
        out[name] = {"ok": draft_ok, "diverging_requests": diverge,
                     "acceptance_ok": acc_ok, "launches_ok": launches_ok,
                     "kernel_route": k_route, "plain_route": p_route}
    row = {"phase": "exact_spec", "ok": ok, "dtype": "float32",
           "weights": "int8", "n_layers": cfg.n_layers, "spec_k": SPEC_K,
           "requests": len(base), "tokens": sum(len(v) for v in base.values()),
           **out}
    emit(row)
    return row


DENSE_ENGINE = dict(n_slots=SERVE_ENGINE["n_slots"],
                    max_len=SERVE_ENGINE["max_len"], paged=False)


def dense_phase(torch, dev, ops, served):
    """The ``serve`` phase's model and traffic through the slot-dense engine
    (``paged=False``): every program (the decode at 4 slots, the admission
    at every prompt bucket) captured by ``warmup()`` first, nothing captured
    while serving; counters reset just before and read just after. Then a
    profiled decode window and the same traffic in eager and captured
    turns. Returns the row and ``(cfg, model, params)``."""
    from repro_torch.kernels import bdmm as bk
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.serve import Engine

    cfg, model, params, _ = olmo_engine(torch, dev, "bfloat16")
    kw = DENSE_ENGINE
    engine = Engine(model, params, **kw)
    warm = warm_engine(torch, engine)
    reqs = make_requests(cfg, **SERVE_TRAFFIC)
    engine.time_programs = True
    ops.reset_launch_counts()
    summary = serve_stream(engine, reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    routes = dict(bk.routes)
    calls = program_calls(engine)
    captured_serving = engine.n_captures - warm["graphs_captured"]
    buckets = list(engine.scheduler.buckets)
    del engine
    window = decode_window(torch, model, params, kw, cfg)
    turns = graph_turns(torch, model, params, kw, cfg)
    done = summary["n_done"] == len(reqs) and no_hidden_faults(summary) and all(
        len(r.generated) == r.max_new_tokens
        and all(0 <= t < cfg.vocab for t in r.generated) for r in reqs)
    # int8 blocks above 32 rows (the whole-prompt prefill) take the small-m
    # tensor-core body, the decode at 4 slots and the unembed the decode
    # grid; dense attention is plain PyTorch, as the reference's is XLA
    general = routes["tc_small_m"] + routes["tc"]
    bodies_ok = general > 0 and routes["decode_tc"] > 0 and not any(
        launches[k] for k in ("paged_attention", "paged_prefill_attention",
                              "paged_attention_verify"))
    ok = done and bodies_ok and captured_serving == 0 and turns["ok"]
    paged_turn = served["graph_turns"]["turns"][1]
    row = {"phase": "dense", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "weights": "int8",
        "dtype": cfg.dtype, "slots": kw["n_slots"], "max_len": kw["max_len"],
        "buckets": buckets}, "traffic": "serve",
        "requests_done": summary["n_done"], "requests": len(reqs),
        "new_tokens": [len(r.generated) for r in reqs],
        "tok_s": summary["agg_tok_s"], "elapsed_s": summary["elapsed_s"],
        "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
        "ttft_p95_ms": summary["ttft_p95_s"] * 1e3,
        "e2e_p50_ms": summary["e2e_p50_s"] * 1e3,
        "e2e_p95_ms": summary["e2e_p95_s"] * 1e3,
        "decode_steps": len(calls["decode"]),
        "decode_step_ms_p50": statistics.median(calls["decode"]),
        "admissions": len(calls["prefill"]),
        "admit_ms_p50": statistics.median(calls["prefill"]),
        "kv_bytes_reserved": summary["kv_bytes_reserved"],
        "paged_kv_bytes_allocated_peak": served["kv_bytes_allocated_peak"],
        "paged_captured_turn": {k: paged_turn.get(k) for k in (
            "decode_program_ms_p50", "prefill_chunk_ms_p50", "ttft_p50_ms",
            "e2e_p50_ms", "tok_s")},
        "occupancy_mean": summary["occupancy_mean"],
        "bdmm_routes": routes, "bodies_ok": bodies_ok,
        "decode_window": window, **warm,
        "graphs_captured_while_serving": captured_serving,
        "graph_turns": turns, "launches": launches}
    emit(row)
    return row, (cfg, model, params)


STATIC = dict(batch=4, prompt_len=512, gen=32)


def static_phase(torch, dev, ops, dense_run):
    """The legacy lockstep path as the launcher runs it at full width,
    int8: ``launch.serve.main(["--static", ...])``, one prefill of 4
    prompts of 512 tokens and 31 greedy decode steps (one captured decode
    graph). Each row's tokens must equal the slot-dense engine's stream
    for the same prompt (the ``dense`` phase's model: the launcher's init
    from seed 0 is the same)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve as launch
    from repro_torch.serve import Engine, Request

    cfg, model, params = dense_run
    ops.reset_launch_counts()
    out = launch.main(["--arch", "olmo-1b", "--static", "--batch",
                       str(STATIC["batch"]), "--prompt-len",
                       str(STATIC["prompt_len"]), "--gen", str(STATIC["gen"]),
                       "--quantize", "int8"])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    prompts = SyntheticLM(vocab=cfg.vocab, seq_len=STATIC["prompt_len"],
                          global_batch=STATIC["batch"],
                          seed=0).next()["inputs"]
    engine = Engine(model, params, n_slots=STATIC["batch"],
                    max_len=STATIC["prompt_len"] + STATIC["gen"], paged=False)
    streams = engine.run([Request(id=i, prompt=p,
                                  max_new_tokens=STATIC["gen"])
                          for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    rows = out["tokens"].tolist()
    diverge = [{"row": i, "first_index": next(
        (j for j, (a, b) in enumerate(zip(rows[i], streams[i])) if a != b),
        None)} for i in range(len(rows)) if rows[i] != streams[i]]
    ok = (not diverge and out["route"] == "captured"
          and no_hidden_faults(engine.metrics.summary())
          and launches["bdmm"] > 0 and launches["bdmm_decode"] > 0)
    row = {"phase": "static", "ok": ok, "argv": STATIC, "weights": "int8",
           "n_layers": cfg.n_layers, "decode_route": out["route"],
           "prefill_ms": out["prefill_ms"], "decode_ms": out["decode_ms"],
           "decode_tok_s": out["decode_tok_s"],
           "decode_step_ms": out["decode_ms"] / (STATIC["gen"] - 1),
           "diverging_rows": diverge, "launches": launches}
    emit(row)
    return row


def exact_dense_phase(torch, dev, ops, exact_run):
    """``exact``'s f32 model and requests through the slot-dense engine on
    the kernel route (captured) and the plain route (eager): both streams
    identical to each other and to ``exact``'s paged kernel-route ones."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    cfg, model, params, base = exact_run
    kw = dict(n_slots=EXACT_ENGINE["n_slots"], max_len=EXACT_ENGINE["max_len"],
              paged=False)
    streams, counts, captures, faults = {}, {}, {}, {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            engine = Engine(model, params, **kw,
                            graphs=None if backend == "cuda" else False)
            streams[backend] = engine.run(make_requests(cfg, **EXACT_TRAFFIC))
        finally:
            ops.set_backend("cuda")
        torch.cuda.synchronize()
        counts[backend] = ops.launch_counts()
        captures[backend] = engine.n_captures
        faults[backend] = engine.metrics.summary()
        del engine
    diverge = [rid for rid in sorted(base)
               if not (streams["cuda"][rid] == streams["torch"][rid]
                       == base[rid])]
    ok = (not diverge and captures["cuda"] > 0 and captures["torch"] == 0
          and all(map(no_hidden_faults, faults.values()))
          and counts["cuda"]["bdmm"] > 0 and counts["cuda"]["bdmm_decode"] > 0
          and not any(counts["torch"].values()))
    row = {"phase": "exact_dense", "ok": ok, "dtype": "float32",
           "weights": "int8", "n_layers": cfg.n_layers,
           "requests": len(base), "tokens": sum(len(v) for v in base.values()),
           "diverging_requests": diverge, "graphs_captured": captures,
           "launches_kernel_route": counts["cuda"],
           "launches_plain_route": counts["torch"]}
    emit(row)
    return row


CLI_LAYERS = 2
CLI = ["--arch", "olmo-1b", "--n-layers", str(CLI_LAYERS), "--requests", "4",
       "--prompt-len", "256", "--gen", "16", "--quantize", "int8"]


def cli_phase(torch, dev, ops):
    """The launcher in-process, depth cut to ``CLI_LAYERS``: without
    ``--paged`` (the slot-dense engine), with ``--quantize int4``, and at
    f32 ``--paged`` on the kernel route and with ``--prefill-kernel jnp``,
    which must launch the paged prefill kernel 0 times and stream the
    kernel route's tokens."""
    from repro_torch.launch import serve as launch

    runs, ok = {}, True
    f32 = ["--dtype", "float32", "--paged"]
    for name, extra in (("dense", []),
                        ("int4", ["--quantize", "int4"]),
                        ("paged_f32", f32),
                        ("paged_f32_prefill_jnp",
                         f32 + ["--prefill-kernel", "jnp"])):
        ops.reset_launch_counts()
        s = launch.main(CLI + extra)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        done = s["n_done"] == s["n_requests"] == 4 and no_hidden_faults(s)
        runs[name] = {"ok": done, "tok_s": s["agg_tok_s"],
                      "ttft_p50_ms": s["ttft_p50_s"] * 1e3,
                      "kv_bytes_reserved": s["kv_bytes_reserved"],
                      "launches": launches, "streams": s["streams"]}
        ok = ok and done
    kernel, plain = runs["paged_f32"], runs["paged_f32_prefill_jnp"]
    route_ok = (kernel["launches"]["paged_prefill_attention"] > 0
                and plain["launches"]["paged_prefill_attention"] == 0
                and plain["launches"]["paged_attention"] > 0
                and plain["streams"] == kernel["streams"]
                and ops.prefill_backend() == "cuda")
    ok = ok and route_ok and runs["dense"]["launches"]["bdmm_decode"] > 0
    for r in runs.values():
        r["tokens"] = sum(len(v) for v in r.pop("streams").values())
    row = {"phase": "cli", "ok": ok, "argv": CLI,
           "cut": f"{CLI_LAYERS} of 16 layers", "prefill_route_ok": route_ok,
           "runs": runs}
    emit(row)
    return row


def spec_phase(torch, dev, ops, target, draft):
    """Speculative decoding as the deployment runs it: the masked_dense +
    mpd_fuse bf16 target of ``fused_deploy`` drafted by its own loaded int8
    artifact, k = 4, on the serve phase's traffic, in turns (non-spec, spec,
    spec, non-spec), then profiled windows of non-spec and of spec steps."""
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.serve import Engine

    model, params = target
    cfg = model.cfg
    turns, streams, ok = [], {}, True
    launches = {}
    for route in ("plain_decode", "spec", "spec", "plain_decode"):
        t_turn = time.perf_counter()
        engine = Engine(model, params,
                        spec_draft=draft if route == "spec" else None,
                        spec_k=SPEC_K, **SERVE_ENGINE)
        # every program captured first: the first-call costs land there
        warm = warm_engine(torch, engine)
        reqs = make_requests(cfg, **SERVE_TRAFFIC)
        calls = instrument_steps(torch, engine)
        ops.reset_launch_counts()
        summary = serve_stream(engine, reqs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        routes = mm_routes()
        attn_routes = dict(pa.routes)
        done = summary["n_done"] == len(reqs) and no_hidden_faults(
            summary) and all(
            len(r.generated) == r.max_new_tokens
            and all(0 <= t < cfg.vocab for t in r.generated) for r in reqs)
        got = {r.id: list(r.generated) for r in reqs}
        # decode tok/s: the tokens decode steps emitted (each request's
        # first token comes from its prefill) over the steps' host time
        decode_tokens = sum(len(r.generated) - 1 for r in reqs)
        turn = {"route": route, "requests_done": summary["n_done"],
                "decode_tok_s": decode_tokens / (sum(calls["step"]) / 1e3),
                "tok_s": summary["agg_tok_s"],
                "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
                "ttft_p95_ms": summary["ttft_p95_s"] * 1e3,
                "e2e_p50_ms": summary["e2e_p50_s"] * 1e3,
                "e2e_p95_ms": summary["e2e_p95_s"] * 1e3,
                "tokens_per_step_mean": summary["tokens_per_step_mean"],
                "draft_acceptance_rate": summary["draft_acceptance_rate"],
                "decode_steps": len(calls["step"]),
                "decode_step_ms_p50": statistics.median(calls["step"]),
                "prefill_tokens_reused": engine.n_prefill_tokens_skipped,
                "pools_conserved": pools_conserved(engine), **warm,
                "graphs_captured_while_serving":
                    engine.n_captures - warm["graphs_captured"],
                "launches": counts, "mm_routes": routes,
                "attention_routes": attn_routes}
        # the bf16 target's rows (decode 4, verify 20, prefill chunks of
        # 64) take the small-m tensor-core body, never an f32 SIMT one;
        # every attention call of the target and the draft (prefill chunks,
        # decode steps, verify windows) the tensor-core attention body
        turn_ok = (done and turn["pools_conserved"]
                   and turn["graphs_captured_while_serving"] == 0
                   and routes["tc_small_m"] > 0
                   and not any(routes[r] for r in mk.F32_ROUTES)
                   and attn_routes["split_tc"] == sum(counts[k] for k in (
                       "paged_prefill_attention", "paged_attention",
                       "paged_attention_verify"))
                   and attn_routes["split_kv"] == 0)
        if route == "spec":
            turn_ok = turn_ok and all(counts[k] > 0 for k in (
                "paged_attention_verify", "masked_matmul", "fused_ffn",
                "paged_attention"))
            launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
            base = streams["plain_decode"]
            same = [rid for rid in sorted(base) if got[rid] == base[rid]]
            turn["streams_equal_non_spec"] = f"{len(same)} of {len(base)}"
            turn["divergence"] = [divergence(torch, model, params, r,
                                             base[r.id])
                                  for r in reqs if got[r.id] != base[r.id]]
        else:
            streams.setdefault(route, got)
        turn["ok"] = turn_ok
        turn["seconds"] = time.perf_counter() - t_turn
        ok = ok and turn_ok
        turns.append(turn)
    windows = {"decode": decode_window(torch, model, params, SERVE_ENGINE,
                                       cfg, n_steps=8),
               "spec": decode_window(torch, model, params, SERVE_ENGINE, cfg,
                                     spec_draft=draft, n_steps=8)}
    ok = ok and all(w["combine_in_family"] is not False
                    for w in windows.values())
    # the spec traffic eager and captured, in turns
    spec_turns = graph_turns(torch, model, params, SERVE_ENGINE, cfg,
                             spec_draft=draft)
    ok = ok and spec_turns["ok"]
    row = {"phase": "spec", "ok": ok, "config": {
        "target": f"{cfg.name} masked_dense + mpd_fuse, bf16, 1 AdamW step "
                  "(fused_deploy)", "draft": "its perm-fused int8 fold, "
                  "loaded from the exported artifact",
        "spec_k": SPEC_K, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, **SERVE_ENGINE},
        "turns": turns, "windows": windows, "graph_turns": spec_turns,
        "launches": launches}
    emit(row)
    return row


def divergence(torch, model, params, req, base):
    """Where a spec stream first leaves the non-spec stream, and the gap
    between the target's two largest logits there (one full-sequence
    forward of the prompt and the common tokens)."""
    first = next((i for i, (a, b) in enumerate(zip(req.generated, base))
                  if a != b), min(len(req.generated), len(base)))
    toks = list(req.prompt) + base[:first]
    with torch.no_grad():
        lg = model.logits(params, torch.tensor([toks], device=params[
            "embed"]["table"].device))[0, -1].float()
    top = torch.topk(lg, 2).values
    return {"request": req.id, "first_index": first,
            "top2_logit_gap": float(top[0] - top[1])}


# the serving surface: priorities and preemption, the watchdog under chaos
# (with and without speculation), deadlines, the HTTP/SSE frontend and the
# degradation ladder. Prompts of 64-128 tokens (one or two chunks) put the
# storm schedule's steps 3-13 among live decodes.
SURFACE_ENGINE = dict(n_slots=4, max_len=128 + 32, page_size=16,
                      prefill_chunk_tokens=64)
SURFACE_TRAFFIC = dict(n_requests=8, rate=1e9, prompt_len=128, gen=32,
                       seed=0, shared_prefix=32)
# serve_bench.run_degraded's mixed-priority stream and engine
# (benchmarks/serve_bench.py _mixed_requests and bench(), its full tier at
# its highest rate: 64 requests, max_gen 64, 8 slots, page 8)
DEGRADED = dict(n=64, rate=256.0, prompt_len=8, max_gen=64, seed=0)
DEGRADED_ENGINE = dict(n_slots=8, max_len=8 + 64, page_size=8)
PROM_SAMPLE = r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? -?([0-9.e+-]+|inf|nan)$'


def mixed_requests(cfg, *, n, rate, prompt_len, max_gen, seed):
    """``benchmarks/serve_bench.py::_mixed_requests`` on the port's
    ``Request``: alternating interactive (short answers, TTFT 2 s and e2e
    8 s SLOs) and batch (long answers, e2e 60 s) Poisson arrivals."""
    import numpy as np
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(n, prompt_len)).astype(np.int32)
    t, out = 0.0, []
    for i in range(n):
        t += rng.exponential(1.0 / rate)
        if i % 2 == 0:
            out.append(Request(
                id=i, prompt=toks[i], priority="interactive",
                max_new_tokens=int(rng.integers(2, max(max_gen // 8, 3))),
                ttft_slo_s=2.0, e2e_slo_s=8.0, arrival_time=t))
        else:
            out.append(Request(
                id=i, prompt=toks[i], priority="batch",
                max_new_tokens=int(rng.integers(max_gen - max_gen // 4,
                                                max_gen + 1)),
                e2e_slo_s=60.0, arrival_time=t))
    return out


def surface_requests(cfg, priorities=None):
    from repro_torch.launch.serve import make_requests

    reqs = make_requests(cfg, **SURFACE_TRAFFIC)
    for r, p in zip(reqs, priorities or ()):
        r.priority = p
    return reqs


def step_log(engine):
    """Record ``(step, live slots)`` of every speculative step of
    ``engine``; delete the instance attribute to undo."""
    log, step = [], engine._step_spec

    def logged():
        log.append((engine.step_count - 1,
                    [int(s) for s in engine._live.nonzero()[0]]))
        return step()
    engine._step_spec = logged
    return log


def serve_all(engine, reqs):
    """Serve ``reqs`` (all arrived) and whatever ``engine`` already holds
    to the end, within a bound of steps; the streams of ``reqs``."""
    engine.run(reqs, max_steps=20_000)
    return {r.id: list(r.generated) for r in reqs}


def chaos_check(engine, reqs, base, quarantines):
    """The launcher's ``--chaos-verify`` rule and the counters: every
    request the chaos run completed streamed the fault-free tokens; the
    pools are conserved; the metrics counted every injection, a caught step
    fault for each injected one and no other, and exactly ``quarantines``
    quarantines, the poisoned rows that were live (one more is a real
    non-finite row that a quarantine hid)."""
    inj = engine.resilience.injector
    aborted = [r.id for r in reqs if r.finish_reason in ("fault", "deadline")]
    diverged = [r.id for r in reqs
                if r.id not in aborted and list(r.generated) != base[r.id]]
    s = engine.metrics.summary()
    counted = engine.metrics.faults_injected == {
        k: v for k, v in inj.counts.items() if v}
    out = {"injected": {k: v for k, v in inj.counts.items() if v},
           "n_quarantines": engine.n_quarantines,
           "n_step_faults": s["n_step_faults"],
           "n_fault_failures": s["n_fault_failures"],
           "degradation_max_stage": (engine.resilience.ladder.max_stage
                                     if engine.resilience.ladder else None),
           "completed_identical": len(reqs) - len(aborted) - len(diverged),
           "aborted": aborted, "diverged": diverged,
           "pools_conserved": pools_conserved(engine),
           "counters_equal_injections": counted}
    out["ok"] = (not diverged and not aborted and counted
                 and out["pools_conserved"] and s["n_done"] == len(reqs)
                 and no_hidden_faults(s, inj.counts["engine_step"],
                                      quarantines)
                 and engine.n_quarantines == s["n_quarantines"])
    return out


def sse_clients(torch, engine, reqs, base):
    """``GenerateServer`` on 127.0.0.1 over ``engine``: one SSE client per
    request in ``reqs`` (each must stream its ``base`` tokens) and one more
    that disconnects after its first token (its pages must come back), then
    ``/metrics`` (every sample line parses as Prometheus text) and
    ``/healthz``. The clients are ``examples/torch_serve_http_client.py``'s."""
    import asyncio
    import contextlib
    import importlib.util
    import io
    import re

    from repro_torch.serve import GenerateServer

    path = ROOT / "examples" / "torch_serve_http_client.py"
    spec = importlib.util.spec_from_file_location("torch_serve_http_client",
                                                  path)
    client = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(client)
    host = "127.0.0.1"

    def body(req):
        return {"prompt": [int(t) for t in req.prompt],
                "max_new_tokens": req.max_new_tokens}

    async def generate(port, req):
        try:
            return await client.generate(host, port, body(req), str(req.id))
        except SystemExit:              # the client's non-200 exit
            return None, None

    async def drop(port, req):
        reader, writer = await asyncio.open_connection(host, port)
        data = json.dumps(body(req)).encode()
        writer.write(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                     + f"Content-Length: {len(data)}\r\n\r\n".encode()
                     + data)
        await writer.drain()
        got = b""
        while b"event: token" not in got:
            chunk = await reader.read(4096)
            if not chunk:
                break
            got += chunk
        writer.close()
        await writer.wait_closed()

    async def main():
        server = GenerateServer(engine, host=host, port=0, queue_limit=16)
        await server.start()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            results = await asyncio.wait_for(asyncio.gather(
                *[generate(server.port, r) for r in reqs],
                drop(server.port, reqs[0])), timeout=120)
        for _ in range(12_000):             # the cancelled request drains
            if not engine.has_work():
                break
            await asyncio.sleep(0.01)
        seconds = time.perf_counter() - t0
        metrics = await client.fetch_metrics(host, server.port)
        health = await client.wait_ready(host, server.port, 10)
        await server.close()
        return results[:-1], seconds, metrics, health

    results, seconds, metrics, info = asyncio.run(main())
    torch.cuda.synchronize()
    same = [toks == base[r.id] and done is not None
            and done["n_tokens"] == len(base[r.id])
            for r, (toks, done) in zip(reqs, results)]
    sample = re.compile(PROM_SAMPLE)
    lines = metrics.strip().splitlines()
    parses = bool(lines) and all(ln.startswith("# ") or sample.match(ln)
                                 for ln in lines)
    types = [ln.split()[2] for ln in lines if ln.startswith("# TYPE")]
    out = {"clients": len(reqs), "streams_equal_direct": sum(same),
           "seconds": seconds, "n_cancelled": engine.metrics.n_cancelled,
           "pools_conserved": pools_conserved(engine),
           "metrics_lines": len(lines), "metrics_families": len(types),
           "metrics_parse": parses and len(types) == len(set(types)),
           "healthz": info}
    out["ok"] = (all(same) and out["n_cancelled"] == 1
                 and out["pools_conserved"] and out["metrics_parse"]
                 and len(types) > 0 and info["ok"]
                 and info["n_slots"] == engine.n_slots
                 and no_hidden_faults(engine.metrics.summary()))
    return out


def timed_steps(torch, engine):
    """Host ms of every decode step, speculative or plain, on a
    synchronised clock; delete the instance attributes to undo."""
    ms = []

    def wrap(step):
        def timed():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            return out
        return timed
    engine._step_spec = wrap(engine._step_spec)
    engine._step_decode = wrap(engine._step_decode)
    return ms


def surface_phase(torch, dev, ops, target, draft):
    """The serving surface at full width on the serve phase's model (int8,
    bf16, captured): preemption, chaos with and without speculation (the
    latter on ``fused_deploy``'s target and draft), a deadline abort, the
    HTTP/SSE frontend, and serve_bench's degraded traffic at ladder stages
    0 and 1 (recorded, not gated)."""
    import gc

    from repro_torch.launch.serve import serve_stream
    from repro_torch.serve import (DegradationLadder, Engine, FaultInjector,
                                   FaultSpec, Resilience, storm_schedule)

    cfg, model, params, _ = olmo_engine(torch, dev, "bfloat16")
    launches, parts, t_part = {}, {}, {}

    def count(fn, *a):
        """Run ``fn`` with the launch counters reset just before and read
        just after; add them to the phase's."""
        ops.reset_launch_counts()
        out = fn(*a)
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            launches[k] = launches.get(k, 0) + v
        return out

    def engine(res=None, spec=None, kw=SURFACE_ENGINE):
        """A surface engine, every program captured first; ``spec``:
        ``(target model, params, draft)``."""
        m, p, d = spec if spec is not None else (model, params, None)
        eng = Engine(m, p, spec_draft=d, spec_k=SPEC_K, resilience=res,
                     **kw)
        warm_engine(torch, eng)
        eng.warm_captures = eng.n_captures
        return eng

    def done(name, row, *engines):
        """Record a part; no engine captured anything while serving."""
        row["graphs_captured_while_serving"] = sum(
            e.n_captures - e.warm_captures for e in engines)
        row["ok"] = row["ok"] and row["graphs_captured_while_serving"] == 0
        parts[name] = row

    # -- preemption: 4 batch requests fill the slots, 4 interactive arrive
    t0 = time.perf_counter()
    eng = engine()
    reqs = surface_requests(cfg, ["batch"] * 4 + ["interactive"] * 4)

    def preempt_run():
        for r in reqs[:4]:
            eng.submit(r)
        for _ in range(1000):
            if all(r.state.value == "decode" for r in reqs[:4]):
                break
            eng.step()
        for r in reqs[4:]:
            eng.submit(r)
        serve_all(eng, [])
    count(preempt_run)
    s = eng.metrics.summary()
    alone = {}
    for r in surface_requests(cfg):
        alone.update(serve_all(eng, [r]))
    got = {r.id: list(r.generated) for r in reqs}
    row = {"n_preemptions": eng.n_preemptions,
           "preempted": [r.id for r in reqs if r.n_preemptions],
           "streams_equal_alone": sum(got[i] == alone[i] for i in alone),
           "requests": len(reqs), "pools_conserved": pools_conserved(eng),
           "interactive_ttft_p50_ms": s["interactive_ttft_p50_s"] * 1e3,
           "batch_ttft_p50_ms": s["batch_ttft_p50_s"] * 1e3}
    row["ok"] = (eng.n_preemptions >= 1 and got == alone
                 and row["pools_conserved"] and no_hidden_faults(s)
                 and all(launches.get(k, 0) > 0 for k in SERVING_KERNELS))
    done("preemption", row, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t_part["preemption"] = time.perf_counter() - t0

    # -- chaos: the storm schedule against a fault-free run of the stream
    t0 = time.perf_counter()
    base_eng = engine(Resilience(ladder=DegradationLadder()))
    base = count(serve_all, base_eng, surface_requests(cfg))
    eng = engine(Resilience(injector=FaultInjector(storm_schedule()),
                            ladder=DegradationLadder()))
    reqs = surface_requests(cfg)
    count(serve_all, eng, reqs)
    # both decode_logits poisons land on live rows (steps 3 and 9, 8
    # requests on 4 slots)
    done("chaos", chaos_check(eng, reqs, base, quarantines=2), eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t_part["chaos"] = time.perf_counter() - t0

    # -- a deadline abort: its pages freed within the step
    t0 = time.perf_counter()
    now = [0.0]
    clock = base_eng.metrics.clock
    base_eng.metrics.clock = lambda: now[0]
    a, b = surface_requests(cfg)[:2]
    a.e2e_slo_s = b.e2e_slo_s = 0.5
    a.enforce_deadline = True

    def deadline_run():
        for r in (a, b):
            base_eng.submit(r)
        for _ in range(1000):
            if all(r.state.value == "decode" for r in (a, b)):
                break
            base_eng.step()
        base_eng.step()
        slot, pool = a.slot, base_eng.cache.pool
        held = int((base_eng.cache.block_tables[slot] != 0).sum())
        refs = int(pool.ref.sum())
        now[0] = 1.0
        base_eng.step()
        # the survivor's decode may take one new page in that step
        freed = (a.finish_reason == "deadline" and a.slot is None
                 and not base_eng.cache.block_tables[slot].any()
                 and refs - int(pool.ref.sum()) in (held, held - 1))
        serve_all(base_eng, [])
        return held, freed
    held, freed = count(deadline_run)
    base_eng.metrics.clock = clock
    row = {"pages_held": held, "freed_within_step": freed,
           "finish_reason": a.finish_reason,
           "n_deadline_aborts": base_eng.n_deadline_aborts,
           "survivor_equal": list(b.generated) == base[b.id],
           "pools_conserved": pools_conserved(base_eng)}
    row["ok"] = (freed and row["survivor_equal"] and row["pools_conserved"]
                 and base_eng.n_deadline_aborts == 1
                 and no_hidden_faults(base_eng.metrics.summary()))
    parts["deadline"] = row
    t_part["deadline"] = time.perf_counter() - t0

    # -- the HTTP/SSE frontend over the fault-free engine
    t0 = time.perf_counter()
    row = count(sse_clients, torch, base_eng, surface_requests(cfg)[:4],
                base)
    done("server", row, base_eng)
    del base_eng
    gc.collect()
    torch.cuda.empty_cache()
    t_part["server"] = time.perf_counter() - t0

    # -- chaos with speculation: fused_deploy's target and its int8 draft;
    # the schedule poisons the draft on slot 0 and the target on slot 1 at
    # the first speculative step of the fault-free run where both decode
    t0 = time.perf_counter()
    tmodel, tparams = target
    spec = (tmodel, tparams, draft)
    base_eng = engine(spec=spec)
    log = step_log(base_eng)
    base = count(serve_all, base_eng, surface_requests(tmodel.cfg))
    step = next(s for s, live in log if 0 in live and 1 in live)
    sched = [FaultSpec("draft_logits", step=step, slot=0),
             FaultSpec("decode_logits", step=step, slot=1,
                       value=float("inf"))]
    eng = engine(Resilience(injector=FaultInjector(sched, seed=1)),
                 spec=spec)
    reqs = surface_requests(tmodel.cfg)
    count(serve_all, eng, reqs)
    # one quarantine, the target's window: the greedy draft's poisoned
    # proposal comes from a one-hot distribution, finite, and is rejected
    row = chaos_check(eng, reqs, base, quarantines=1)
    row["schedule"] = [dict(site=f.site, step=f.step, slot=f.slot,
                            value=str(f.value)) for f in sched]
    row["spec_steps_fault_free"] = len(log)
    row["ok"] = row["ok"] and launches.get("paged_attention_verify", 0) > 0
    done("chaos_spec", row, eng, base_eng)
    del eng, base_eng
    gc.collect()
    torch.cuda.empty_cache()
    t_part["chaos_spec"] = time.perf_counter() - t0

    # -- serve_bench's degraded traffic: ladder stage 0 (spec on) and 1
    # (spec off), the int8 model drafting for itself; recorded, not gated
    t0 = time.perf_counter()
    lad = DegradationLadder()
    eng = engine(Resilience(ladder=lad), spec=(model, params,
                                               (model, params)),
                 kw=DEGRADED_ENGINE)
    degraded = {}
    for stage in (0, 1):
        lad.force(stage)
        ms = timed_steps(torch, eng)
        reqs = mixed_requests(cfg, **DEGRADED)
        eng.metrics = type(eng.metrics)()
        s = count(serve_stream, eng, reqs)
        del eng._step_spec, eng._step_decode
        decode_tokens = sum(len(r.generated) - 1 for r in reqs)
        degraded[f"stage_{stage}"] = {
            "n_done": s["n_done"], "requests": len(reqs),
            "no_hidden_faults": no_hidden_faults(s),
            "decode_tok_s": decode_tokens / (sum(ms) / 1e3),
            "agg_tok_s": s["agg_tok_s"], "decode_steps": len(ms),
            "decode_step_ms_p50": statistics.median(ms),
            "tokens_per_step_mean": s["tokens_per_step_mean"],
            "draft_acceptance_rate": s["draft_acceptance_rate"],
            "n_preempted": s["n_preempted"],
            **{f"{c}_{k}_slo_attainment": s[f"{c}_{k}_slo_attainment"]
               for c in ("interactive", "batch") for k in ("ttft", "e2e")},
            "interactive_ttft_p95_ms": s["interactive_ttft_p95_s"] * 1e3,
            "batch_e2e_p95_ms": s["batch_e2e_p95_s"] * 1e3}
    lad.force(0)
    lad.force(None)
    row = {"traffic": "benchmarks/serve_bench.py run_degraded: "
                      f"{DEGRADED}, spec k={SPEC_K}",
           "engine": DEGRADED_ENGINE, **degraded}
    row["ok"] = all(d["n_done"] == d["requests"] and d["no_hidden_faults"]
                    for d in degraded.values())
    done("degraded", row, eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    t_part["degraded"] = time.perf_counter() - t0

    ok = all(p["ok"] for p in parts.values())
    row = {"phase": "surface", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab, "mpd_c": cfg.mpd_c, "weights": "int8",
        "dtype": cfg.dtype, **SURFACE_ENGINE,
        "traffic": SURFACE_TRAFFIC}, **parts, "seconds": t_part,
        "launches": launches}
    emit(row)
    return row


def fused_deploy_phase(torch, dev, ops, data, served):
    """The Fig-3 deploy chain at full width: masked_dense + mpd_fuse, one
    AdamW step, fold with the permutation fusion and int8, export_packed,
    load_packed, and the serve phase's traffic on the loaded artifact."""
    import tempfile
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs.common import get_config
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.serve import Engine
    from repro_torch.train import TrainConfig, run

    cfg = get_config("olmo-1b", mpd_mode="masked_dense", mpd_fuse=True)
    model = build(cfg)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, clip_norm=1.0,
                                     schedule="cosine", warmup_steps=0,
                                     total_steps=1), log_every=1)
    t0 = time.perf_counter()
    out = run(model, tcfg, data, 1, params=model.init(0, device=dev),
              log_fn=lambda line: None)
    trained, loss = out["params"], out["history"][0]
    del out
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        d = ckpt_lib.export_packed(tmp, 1, model, trained, fuse=True,
                                   quantize="int8")
        export_s = time.perf_counter() - t0
        artifact_bytes = sum(p.stat().st_size for p in Path(d).iterdir())
        t0 = time.perf_counter()
        served_model, params = ckpt_lib.load_packed(tmp, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    _, mem = model.to_packed(trained, fuse=True, quantize="int8")
    got = list(tree_lib.leaves_with_paths(params))
    want = list(tree_lib.leaves_with_paths(mem))
    identical = len(got) == len(want) and all(
        ka == kb and a.dtype == b.dtype and torch.equal(a, b)
        for (ka, a), (kb, b) in zip(got, want))
    del got, want, mem
    fused = all(b["ffn"].fused_packed() for b in served_model.block_specs)
    torch.cuda.empty_cache()

    engine = Engine(served_model, params, **SERVE_ENGINE)
    warm = warm_engine(torch, engine)
    reqs = make_requests(served_model.cfg, **SERVE_TRAFFIC)
    engine.time_programs = True
    ops.reset_launch_counts()
    summary = serve_stream(engine, reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    calls = program_calls(engine)
    captured_serving = engine.n_captures - warm["graphs_captured"]
    del engine
    n_calls = len(calls["decode"]) + len(calls["prefill"])
    layers = served_model.cfg.n_layers
    turns = route_turns(torch, dev, served_model, params)
    window = decode_window(torch, served_model, params, SERVE_ENGINE,
                           served_model.cfg)
    per_call = bdmm_per_call(launches, calls)
    launches_ok = (launches["fused_ffn"] == layers * n_calls
                   and served["bdmm_launches_per_call"] - per_call
                   == 3 * layers)
    done = summary["n_done"] == len(reqs) and no_hidden_faults(summary) and all(
        len(r.generated) == r.max_new_tokens
        and all(0 <= t < cfg.vocab for t in r.generated) for r in reqs)
    ok = identical and fused and done and launches_ok and math.isfinite(
        loss) and all(launches[k] > 0 for k in SERVING_KERNELS) and (
        captured_serving == 0) and all(t["ok"] for t in turns)
    row = {"phase": "fused_deploy", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "mpd_c": cfg.mpd_c,
        "train": f"masked_dense + mpd_fuse, 1 AdamW step of "
                 f"{TRAIN['batch']} x {TRAIN['seq']} tokens",
        "served": "packed, perm-fused, int8, bf16", **SERVE_ENGINE},
        "train_loss": loss, "train_s": train_s, "export_s": export_s,
        "load_s": load_s,
        "artifact_bytes": artifact_bytes, "loaded_equals_fold": identical,
        "every_ffn_fused": fused,
        "quant_max_rel_rms": served_model.quant_report["max_rel_rms"],
        "requests_done": summary["n_done"], "requests": len(reqs),
        "new_tokens": [len(r.generated) for r in reqs],
        "tok_s": summary["agg_tok_s"], "elapsed_s": summary["elapsed_s"],
        "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
        "ttft_p95_ms": summary["ttft_p95_s"] * 1e3,
        "e2e_p50_ms": summary["e2e_p50_s"] * 1e3,
        "decode_steps": len(calls["decode"]),
        "decode_step_ms_p50": statistics.median(calls["decode"]),
        "prefill_chunks": len(calls["prefill"]),
        "prefill_chunk_ms_p50": statistics.median(calls["prefill"]),
        "model_calls": n_calls, "unembed_calls": calls["unembed"],
        "fused_ffn_launches_expected": layers * n_calls,
        "bdmm_launches_per_call": per_call,
        "bdmm_launches_per_call_serve_phase":
            served["bdmm_launches_per_call"],
        "launches_ok": launches_ok, "launches": launches, **warm,
        "graphs_captured_while_serving": captured_serving,
        "route_turns": turns, "decode_window": window}
    emit(row)
    return row, (model, trained), (served_model, params)


def route_turns(torch, dev, fused_model, fused_params):
    """The serve phase's traffic on the serve phase's unfused model and on
    the fused one, in turns (unfused, fused, fused, unfused): the host
    clock drifts between the phases of one run, so only turns compare the
    two routes end to end. Launch counts are not read here."""
    from repro_torch.launch.serve import make_requests, serve_stream
    from repro_torch.serve import Engine

    _, u_model, u_params, _ = olmo_engine(torch, dev, "bfloat16")
    pairs = {"unfused": (u_model, u_params),
             "fused": (fused_model, fused_params)}
    turns = []
    for route in ("unfused", "fused", "fused", "unfused"):
        model, params = pairs[route]
        engine = Engine(model, params, **SERVE_ENGINE)
        engine.warmup()
        engine.time_programs = True
        summary = serve_stream(engine, make_requests(model.cfg,
                                                     **SERVE_TRAFFIC))
        torch.cuda.synchronize()
        calls = program_calls(engine)
        del engine
        turns.append({
            "route": route, "ok": no_hidden_faults(summary),
            "tok_s": summary["agg_tok_s"],
            "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
            "decode_step_ms_p50": statistics.median(calls["decode"]),
            "prefill_chunk_ms_p50": statistics.median(calls["prefill"])})
    return turns


# ----------------------------------------------------------------- training


def off_mask_clean(torch, model, params) -> bool:
    """Every off-mask weight of every masked-dense linear is exactly 0."""
    from repro_torch.core.export import iter_linear_leaves
    from repro_torch.core.fold import mask_tensor
    for parent, key, lin, _ in iter_linear_leaves(model, params,
                                                  "masked_dense"):
        w = parent[key]["w"]
        off = mask_tensor(lin.spec.mask, w.device) == 0
        if bool((w[..., off] != 0).any()):
            return False
    return True


def train_phase(torch, dev, ops):
    """4 AdamW steps of olmo-1b masked_dense at full width, bf16."""
    import resource
    from repro_torch.configs.common import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, make_train_step, run

    cfg = get_config("olmo-1b", mpd_mode="masked_dense")
    model = build(cfg)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                       global_batch=TRAIN["batch"], seed=0)
    data_s = time.perf_counter() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    steps = TRAIN["steps"]
    # the launcher's optimizer at --steps 4 (no warm-up steps)
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, clip_norm=1.0,
                                     schedule="cosine",
                                     warmup_steps=min(20, steps // 5),
                                     total_steps=steps), log_every=1)
    log = []
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = run(model, tcfg, data, steps, params=params, log_fn=log.append)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    routes = all_routes()
    del params
    peak = torch.cuda.max_memory_allocated()
    losses = out["history"]
    clean = off_mask_clean(torch, model, out["params"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    p50 = statistics.median(out["step_s"])
    window = train_window(torch, model, out["params"], out["opt_state"],
                          make_train_step(model, tcfg), data, dev)
    finite = all(math.isfinite(v) for v in losses)
    # bf16 at m = 2048: the masked matmul and the SDDMM on their tiled
    # tensor-core bodies, never on the f32 SIMT ones
    mm_r, sd_r = routes["masked_matmul"], routes["sddmm"]
    ok = (finite and abs(losses[0] - math.log(cfg.vocab)) <= 1.0 and clean
          and all(launches[k] > 0 for k in MASKED_KERNELS)
          and mm_r["tc"] > 0 and not any(mm_r[r] for r in mk.F32_ROUTES)
          and sd_r["tc"] > 0
          and not any(sd_r[r] for r in mk.SDDMM_F32_ROUTES))
    packed = train_packed(torch, dev, ops)
    ok = ok and packed["ok"]
    dense = model.matmul_params(dense=True)
    useful = model.matmul_params(dense=False)
    row = {"phase": "train", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "mpd_c": cfg.mpd_c,
        "mpd_mode": cfg.mpd_mode, "dtype": cfg.dtype, **TRAIN,
        "params": model.param_count()},
        "losses": losses, "ln_vocab": math.log(cfg.vocab),
        "offmask_exact_zero": clean, "step_s": out["step_s"],
        "step_ms_p50": p50 * 1e3, "tokens_per_s": tokens / p50,
        "flop_share_dense": 6.0 * dense * tokens / p50 / PEAK_OPS["bfloat16"],
        "flop_share_useful": 6.0 * useful * tokens / p50
        / PEAK_OPS["bfloat16"],
        "matmul_params_dense": dense, "matmul_params_useful": useful,
        "peak_mem_bytes": peak, "init_s": init_s,
        "data_setup_s": data_s, "data_table_bytes": data.table_bytes,
        "host_maxrss_growth_bytes": (rss1 - rss0) * 1024,
        "log": log, "train_window": window, "launches": launches,
        "routes": routes, "packed": packed}
    emit(row)
    return row, model, out["params"], data


def train_packed(torch, dev, ops, fuse=False):
    """The train launcher's default (packed) mode at olmo-1b's published
    widths: every projection a bdmm over mpd_c=8 blocks, bf16, 4 AdamW
    steps of 4 x 512 SyntheticLM tokens, then one more step under
    torch.profiler. Fails if a bf16 bdmm ran on the SIMT body. ``fuse``
    adds ``--mpd-fuse``: every FFN one fused_ffn launch forward (the
    fused_ffn autograd rule), which must launch once per layer and step,
    and the first loss must lie within 1.0 of ln(vocab)."""
    import contextlib
    import io
    from repro_torch.configs.common import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import fused_ffn as fk
    from repro_torch.launch import train as launcher
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, make_train_step

    steps = TRAIN["steps"]
    argv = ["--arch", "olmo-1b", "--steps", str(steps), "--seq-len",
            str(TRAIN["seq"]), "--global-batch", str(TRAIN["batch"])]
    if fuse:
        argv.insert(2, "--mpd-fuse")
    # the peak above what earlier phases still hold, so that two runs of
    # the launcher compare whatever else is allocated around them
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = launcher.main(argv)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    routes = all_routes()["bdmm"]
    fused_routes = dict(fk.routes)
    peak = torch.cuda.max_memory_allocated() - held
    cfg = get_config("olmo-1b", mpd_fuse=fuse)
    model = build(cfg)
    # the launcher's optimizer, as main() builds it
    tcfg = TrainConfig(opt=OptConfig(lr=3e-3, clip_norm=1.0,
                                     schedule="cosine",
                                     warmup_steps=min(20, steps // 5),
                                     total_steps=steps))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                       global_batch=TRAIN["batch"], seed=0)
    data.step = steps
    window = train_window(torch, model, out["params"], out["opt_state"],
                          make_train_step(model, tcfg), data, dev)
    losses, step_s = out["history"], out["step_s"]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    p50 = statistics.median(step_s)
    ok = (all(math.isfinite(v) for v in losses) and launches["bdmm"] > 0
          and routes["tc"] > 0 and f32_general(routes) == 0)
    fused = {}
    if fuse:
        expected = cfg.n_layers * steps
        fused = {"fused_ffn_launches_expected": expected,
                 "every_ffn_fused": all(b["ffn"].fused_packed()
                                        for b in model.block_specs),
                 "ln_vocab": math.log(cfg.vocab),
                 "fused_ffn_routes": fused_routes}
        # a training batch (4 x 512 tokens) runs on the tc_tall body only
        ok = (ok and fused["every_ffn_fused"]
              and launches["fused_ffn"] == expected
              and fused_routes == {r: expected if r == "tc_tall" else 0
                                   for r in fk.ROUTES}
              and abs(losses[0] - math.log(cfg.vocab)) <= 1.0)
    del out
    torch.cuda.empty_cache()
    return {"ok": ok, "mode": cfg.mpd_mode, "mpd_fuse": fuse,
            "argv": " ".join(argv), "params": model.param_count(),
            "losses": losses, "step_s": step_s, "step_ms_p50": p50 * 1e3,
            "tokens_per_s": tokens / p50, "peak_mem_added_bytes": peak,
            "launcher_output": text.getvalue().strip().splitlines(),
            "launches": launches, "bdmm_routes": routes, **fused,
            "train_window": window}


def train_fused_phase(torch, dev, ops, trained):
    """``launch.train.main(["--arch", "olmo-1b", "--mpd-fuse", ...])``:
    packed training of the perm-fused model at full width, beside the
    ``train`` phase's packed (unfused) launcher run of the same call."""
    row = train_packed(torch, dev, ops, fuse=True)
    packed = trained["packed"]
    device = lambda r: r["train_window"]["device_ms"] or {}  # noqa: E731
    row = {"phase": "train_fused", **row,
           "fused_ffn_device_ms": device(row).get("fused_ffn"),
           "device_ms_total": sum(device(row).values()) or None,
           "packed_unfused": {**{k: packed[k] for k in (
               "step_ms_p50", "tokens_per_s", "peak_mem_added_bytes",
               "losses")},
               "device_ms_total": sum(device(packed).values()) or None}}
    emit(row)
    return row


def resume_phase(torch, dev, ops):
    """Train checkpoints and resume through ``train.run`` at full width,
    bf16, the perm-fused packed model (RESUME's depth): run A takes
    RESUME["steps"] steps with a checkpoint every RESUME["ckpt_every"]
    (written on a background thread); run B takes ckpt_every steps into a
    fresh directory, then a fresh ``run`` with a fresh data stream resumes
    from its checkpoint to the same step. B's resumed losses and every
    param and moment leaf must equal A's bit for bit."""
    import shutil
    import tempfile
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs.common import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build
    from repro_torch.optim import OptConfig
    from repro_torch.train import TrainConfig, run

    cfg = get_config("olmo-1b", mpd_fuse=True, n_layers=RESUME["n_layers"])
    model = build(cfg)
    steps, every = RESUME["steps"], RESUME["ckpt_every"]
    opt = OptConfig(lr=3e-3, clip_norm=1.0, schedule="cosine",
                    warmup_steps=0, total_steps=steps)

    def go(ckpt_dir, n):
        tcfg = TrainConfig(opt=opt, ckpt_dir=str(ckpt_dir), ckpt_every=every,
                           log_every=0)
        data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                           global_batch=TRAIN["batch"], seed=0)
        t0 = time.perf_counter()
        out = run(model, tcfg, data, n, seed=0, device=dev)
        torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["data_state"] = data.state()
        return out

    def summary(out):
        return {k: out[k] for k in ("start_step", "history", "step_s",
                                    "ckpt_save_s", "ckpt_wait_s", "wall_s",
                                    "data_state")}

    log0 = len(ckpt_lib.save_log)
    ops.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        a = go(Path(tmp) / "a", steps)
        shutil.rmtree(Path(tmp) / "a")
        b1 = go(Path(tmp) / "b", every)
        del b1["params"], b1["opt_state"]
        b2 = go(Path(tmp) / "b", steps)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    saves = ckpt_lib.save_log[log0:]
    want = {"params": a["params"], "opt": a["opt_state"]}
    got = {"params": b2["params"], "opt": b2["opt_state"]}
    leaves = list(zip(tree_lib.leaves_with_paths(want),
                      tree_lib.leaves_with_paths(got)))
    differing = [ka for (ka, x), (kb, y) in leaves
                 if ka != kb or not (torch.equal(x, y)
                                     if isinstance(x, torch.Tensor)
                                     else x == y)]
    losses_equal = b2["history"] == a["history"][every:]
    ok = (a["start_step"] == 0 and b1["start_step"] == 0
          and len(b1["history"]) == every and b2["start_step"] == every
          and losses_equal and not differing and len(leaves) > 0
          and got["opt"]["step"] == steps
          and all(math.isfinite(v) for v in a["history"])
          and len(saves) == 2 * (steps // every)
          and launches["fused_ffn"] > 0 and launches["bdmm"] > 0)
    row = {"phase": "resume", "ok": ok, "config": {
        "arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab, "mpd_c": cfg.mpd_c,
        "mpd_mode": cfg.mpd_mode, "mpd_fuse": True, "dtype": cfg.dtype,
        **RESUME, "batch": TRAIN["batch"], "seq": TRAIN["seq"]},
        "run_a": summary(a), "run_b_first": summary(b1),
        "run_b_resumed": summary(b2), "resumed_losses_equal": losses_equal,
        "leaves_compared": len(leaves), "leaves_differing": differing[:8],
        "saves": saves, "save_bytes": [e["bytes"] for e in saves],
        "save_write_s": [e["write_s"] for e in saves],
        "loop_blocked_s": sum(o["ckpt_save_s"] + o["ckpt_wait_s"]
                              for o in (a, b1, b2)),
        "launches": launches}
    del a, b2, want, got, leaves
    torch.cuda.empty_cache()
    emit(row)
    return row


def train_window(torch, model, params, opt_state, step_fn, data, dev):
    """Where a train step's time goes: one more step under torch.profiler,
    device time by kernel family. The device entries are None when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    batch = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in data.next().items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, {}, batch)
        float(out[3]["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    cuda = torch.autograd.DeviceType.CUDA
    families = {"masked_matmul": 0.0, "masked_matmul_t": 0.0,
                "sddmm_masked": 0.0, "bdmm_fwd": 0.0, "bdmm_dx": 0.0,
                "fused_ffn": 0.0, "library_gemm": 0.0, "other": 0.0}
    by_name = {}
    for e in prof.events():
        if e.device_type != cuda:
            continue
        t = getattr(e, "self_device_time_total", 0) / 1e3
        if MASKED_MM_FAMILY in e.name:
            key = ("masked_matmul_t" if ", true>" in e.name
                   else "masked_matmul")
        elif SDDMM_FAMILY in e.name:
            key = "sddmm_masked"
        elif BDMM_GENERAL_FAMILY in e.name or "bdmm_reduce_kernel" in e.name:
            key = "bdmm_dx" if "_kernel<true" in e.name else "bdmm_fwd"
        elif FUSED_FFN_FAMILY in e.name:
            key = "fused_ffn"
        elif any(k in e.name.lower() for k in LIBRARY_GEMM_NAMES):
            key = "library_gemm"
        else:
            key = "other"
        families[key] += t
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + t
    device_ms = sum(families.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"wall_ms": wall_ms,
            "device_ms": families if device_ms > 0 else None,
            "device_busy_share": device_ms / wall_ms if device_ms > 0 else None,
            "top_kernels_ms": top}


def update_errors(got, want, start):
    """(max |got - want|, max of |got - want| over EXACT_TOL's limit
    ``atol + update_rtol |want - start|``) over every leaf of two param
    trees updated from ``start``."""
    from repro_torch import tree as tree_lib

    worst, max_err = 0.0, 0.0
    for a, b, p0 in zip(tree_lib.leaves(got), tree_lib.leaves(want),
                        tree_lib.leaves(start)):
        lim = EXACT_TOL["atol"] + EXACT_TOL["update_rtol"] * (b - p0).abs()
        err = (a - b).abs()
        worst = max(worst, float((err / lim).max()))
        max_err = max(max_err, float(err.max()))
    return max_err, worst


def train_exact_phase(torch, dev, ops, data):
    """One f32 step of the model cut to EXACT_LAYERS, through the kernels
    and through the plain versions, from the same init and first batch: in
    masked_dense mode (the three masked kernels), in packed mode (bdmm
    forward and dx) and in packed mode with mpd_fuse (every FFN through the
    fused_ffn autograd rule: the fused kernel forward, bdmm backward). Each
    route's launch counts are reset before it and read after it: the
    kernel route must launch every kernel of its mode, the plain route
    none."""
    from repro_torch.configs.common import get_config
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.models import build
    from repro_torch.optim import OptConfig, init_state
    from repro_torch.train import TrainConfig, make_train_step

    tcfg = TrainConfig(opt=OptConfig(kind="sgd", lr=1.0, momentum=0.0,
                                     clip_norm=1.0))
    data.step = 0
    batch = {k: torch.from_numpy(v).to(dev, torch.long)
             for k, v in data.next().items()}
    modes, ok, masked = {}, True, None
    for mode, kernels in (("masked_dense", MASKED_KERNELS),
                          ("packed", ("bdmm",)),
                          ("packed_fused", ("fused_ffn", "bdmm"))):
        cfg = get_config("olmo-1b", mpd_mode=mode.replace("_fused", ""),
                         mpd_fuse=mode == "packed_fused", dtype="float32",
                         n_layers=EXACT_LAYERS)
        model = build(cfg)
        params = model.init(0, device=dev)
        step = make_train_step(model, tcfg)
        res, counts, routes = {}, {}, {}
        for backend in ("cuda", "torch"):
            ops.set_backend(backend)
            ops.reset_launch_counts()
            try:
                new, _, _, metrics = step(
                    params, init_state(tcfg.opt, params), {}, batch)
                res[backend] = (new, float(metrics["loss"]),
                                float(metrics["grad_norm"]))
            finally:
                ops.set_backend("cuda")
            torch.cuda.synchronize()
            counts[backend] = ops.launch_counts()
            routes[backend] = mm_routes()
        (pk, lk, gk), (pp, lp, gp) = res["cuda"], res["torch"]
        max_err, worst = update_errors(pk, pp, params)
        loss_ok = abs(lk - lp) <= EXACT_TOL["loss_rtol"] * abs(lp)
        # f32 stays on the exact SIMT bodies
        f32_mm = counts["cuda"]["masked_matmul"] + counts["cuda"]["masked_matmul_t"]
        routes_ok = (all(counts["cuda"][k] > 0 for k in kernels)
                     and not any(counts["torch"].values())
                     and sum(routes["cuda"][r] for r in mk.F32_ROUTES) == f32_mm
                     and not any(routes["torch"].values()))
        mode_ok = math.isfinite(lk) and loss_ok and worst <= 1.0 and routes_ok
        ok = ok and mode_ok
        modes[mode] = {"ok": mode_ok, "loss_kernels": lk, "loss_plain": lp,
                       "grad_norm_kernels": gk, "grad_norm_plain": gp,
                       "param_max_abs_err": max_err,
                       "param_err_over_tol": worst,
                       "launches_kernel_route": counts["cuda"],
                       "launches_plain_route": counts["torch"],
                       "mm_routes_kernel_route": routes["cuda"]}
        if mode == "masked_dense":
            masked = (model, pk)
        del params, res, pp
    row = {"phase": "train_exact", "ok": ok, "dtype": "float32",
           "n_layers": EXACT_LAYERS, "cut": f"{EXACT_LAYERS} of 16 layers",
           "widths": "full (d 2048, d_ff 8192, vocab 50304)",
           "optimizer": "sgd lr 1, clip 1", "tol": EXACT_TOL, **modes}
    emit(row)
    return row, masked[0], masked[1], batch


def fold_phase(torch, dev, ops, f32_model, f32_params, batch, bf16_model,
               bf16_params):
    """Train -> fold -> serve on the card: f32 logits of the folded model
    against the masked-dense model, then the bf16 trained model folded to
    int8 serving 2 greedy requests through the kernels."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    tokens = batch["inputs"][:1, :128]
    pk_model, pk_params = f32_model.to_packed(f32_params)
    want = f32_model.logits(f32_params, tokens)
    got = pk_model.logits(pk_params, tokens)
    err = (got - want).abs()
    lim = FOLD_TOL["atol"] + FOLD_TOL["rtol"] * want.abs()
    logits_ok = bool(torch.isfinite(got).all()) and bool((err <= lim).all())
    del pk_params, want, got

    q_model, q_params = bf16_model.to_packed(bf16_params, quantize="int8")
    reqs = make_requests(q_model.cfg, n_requests=2, rate=1e9, prompt_len=256,
                         gen=16, seed=0, shared_prefix=64)
    ops.reset_launch_counts()
    engine = Engine(q_model, q_params, n_slots=2, max_len=256 + 16,
                    page_size=16, prefill_chunk_tokens=64)
    streams = engine.run(reqs)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    served = (len(streams) == 2 and all(
        len(streams[r.id]) == r.max_new_tokens
        and all(0 <= t < q_model.cfg.vocab for t in streams[r.id])
        for r in reqs) and no_hidden_faults(engine.metrics.summary()))
    del engine
    kernels_used = all(launches[k] > 0 for k in SERVING_KERNELS)
    row = {"phase": "fold", "ok": logits_ok and served and kernels_used,
           "logits": {"dtype": "float32", "n_layers": f32_model.cfg.n_layers,
                      "tokens": int(tokens.numel()), "tol": FOLD_TOL,
                      "max_abs_err": float(err.max()),
                      "err_over_tol": float((err / lim).max()),
                      "ok": logits_ok},
           "serve": {"dtype": "bfloat16", "weights": "int8",
                     "n_layers": q_model.cfg.n_layers,
                     "quant_max_rel_rms": q_model.quant_report["max_rel_rms"],
                     "requests_done": sum(
                         len(streams.get(r.id, ())) == r.max_new_tokens
                         for r in reqs),
                     "new_tokens": [len(v) for v in streams.values()],
                     "launches": launches, "ok": served and kernels_used}}
    emit(row)
    return row


def paper_rows(rows):
    """``name,value,derived`` rows as dicts, each beside the reference's
    CPU value of the same row where there is one."""
    out = []
    for text in rows:
        name, value, derived = text.split(",", 2)
        out.append({"name": name, "value": float(value.rstrip("x")),
                    "derived": derived,
                    "reference_cpu": PAPER_REF_CPU.get(name)})
    return out


def lenet_step_exact(torch, dev, ops):
    """One f32 step of LeNet-300-100 at c = 10 from the same init and first
    batch, through the kernels and through the plain versions, in packed
    mode (bdmm forward and dx on the SIMT bodies) and in masked_dense mode
    (the three masked kernels on their SIMT bodies), under train_exact's
    rule (SGD, lr 1, clipped to norm 1). The kernel route must launch every
    kernel of its mode, the plain route none."""
    from benchmarks import torch_paper_repro as pr
    from repro_torch.configs.lenet300 import LeNet300
    from repro_torch.core.policy import uniform
    from repro_torch.data import TeacherStudent
    from repro_torch.kernels import bdmm as bk
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.optim import OptConfig, init_state

    ocfg = OptConfig(kind="sgd", lr=1.0, momentum=0.0, clip_norm=1.0)
    batch = pr.to_device(TeacherStudent(seed=0).next(), dev)
    modes, ok = {}, True
    for mode, kernels in (("packed", ("bdmm",)),
                          ("masked_dense", MASKED_KERNELS)):
        model = LeNet300(policy=uniform(10, min_block=1), mode=mode)
        params = model.init(0, device=dev)
        step = pr.make_step(model, ocfg)
        res, counts, routes = {}, {}, {}
        for backend in ("cuda", "torch"):
            ops.set_backend(backend)
            ops.reset_launch_counts()
            try:
                new, _, loss = step(params, init_state(ocfg, params), batch)
                res[backend] = (new, float(loss))
            finally:
                ops.set_backend("cuda")
            torch.cuda.synchronize()
            counts[backend] = ops.launch_counts()
            routes[backend] = dict(all_routes(),
                                   bdmm_dx=dict(bk.transposed_routes))
        (pk, lk), (pp, lp) = res["cuda"], res["torch"]
        max_err, worst = update_errors(pk, pp, params)
        kr = routes["cuda"]
        if mode == "packed":
            bodies_ok = f32_general(kr["bdmm"]) > f32_general(kr["bdmm_dx"]) > 0
        else:                   # every masked call on an f32 SIMT body
            bodies_ok = (sum(kr["masked_matmul"][r] for r in mk.F32_ROUTES)
                         == counts["cuda"]["masked_matmul"]
                         + counts["cuda"]["masked_matmul_t"]
                         and sum(kr["sddmm"][r] for r in mk.SDDMM_F32_ROUTES)
                         == counts["cuda"]["sddmm_masked"] > 0)
        routes_ok = (all(counts["cuda"][k] > 0 for k in kernels)
                     and not any(counts["torch"].values()) and bodies_ok)
        loss_ok = abs(lk - lp) <= EXACT_TOL["loss_rtol"] * abs(lp)
        mode_ok = math.isfinite(lk) and loss_ok and worst <= 1.0 and routes_ok
        ok = ok and mode_ok
        modes[mode] = {"ok": mode_ok, "loss_kernels": lk, "loss_plain": lp,
                       "param_max_abs_err": max_err,
                       "param_err_over_tol": worst,
                       "launches_kernel_route": counts["cuda"],
                       "launches_plain_route": counts["torch"],
                       "routes_kernel_route": kr}
    return {"ok": ok, "tol": EXACT_TOL, "optimizer": "sgd lr 1, clip 1",
            **modes}


def paper_phase(torch, dev, ops):
    """The paper's own experiments on the card: LeNet-300-100 trained on
    TeacherStudent (benchmarks/torch_paper_repro.py) for Table 1, Fig 4a/b,
    the permutation ablation and Fig 5, Algorithm 1 (masked_dense at c =
    10, folded with ``mpd.to_packed``), and one eager inference pass per
    mode and batch; then, outside the counted run, the c = 10 run on the
    plain route, one f32 step kernel vs plain, and the speedup rows
    (benchmarks/torch_speedup.py)."""
    from benchmarks import torch_paper_repro as pr
    from benchmarks import torch_speedup as sp
    from repro_torch.configs.lenet300 import LeNet300
    from repro_torch.core import mpd
    from repro_torch.core.policy import uniform
    from repro_torch.data import TeacherStudent
    from repro_torch.kernels import bdmm as bk

    t0 = time.perf_counter()
    c10 = uniform(10, min_block=1)
    ops.reset_launch_counts()
    figures = {
        "table1": pr.table1(PAPER["table1"], device=dev),
        "fig4": pr.fig4_masks(PAPER["fig4a_masks"], PAPER["fig4a"],
                              device=dev),
        "ablation": pr.fig4_permutation_ablation(PAPER["ablation"],
                                                 device=dev),
        "fig5": pr.fig5_sparsity(PAPER["fig5"], device=dev)}
    masked = pr.train_lenet(c10, "masked_dense", steps=PAPER["algorithm1"],
                            device=dev)
    xs = sp.lenet_inputs(dev)
    with torch.no_grad():
        for _, model in sp.lenet_models():
            params = model.init(0, device=dev)
            for b in sp.LENET_BATCHES:
                model.apply(params, xs[:b])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    routes = dict(all_routes(), bdmm_dx=dict(bk.transposed_routes))
    train_s = time.perf_counter() - t0

    # Algorithm 1's model folded to packed: the same logits within fold's
    # rule, the same accuracy
    m_model = LeNet300(policy=c10, mode="masked_dense")
    p_model = LeNet300(policy=c10, mode="packed")
    folded = [mpd.to_packed(s, p) for s, p in zip(m_model.specs,
                                                   masked["params"])]
    ev = pr.to_device(TeacherStudent(seed=0).eval_set(2048), dev)
    with torch.no_grad():
        want = m_model.apply(masked["params"], ev["inputs"])
        got = p_model.apply(folded, ev["inputs"])
        folded_acc = float(p_model.accuracy(folded, ev))
    err = (got - want).abs()
    lim = FOLD_TOL["atol"] + FOLD_TOL["rtol"] * want.abs()
    fold_ok = (bool(torch.isfinite(got).all()) and bool((err <= lim).all())
               and folded_acc == masked["accuracy"])
    fold = {"ok": fold_ok, "tol": FOLD_TOL, "max_abs_err": float(err.max()),
            "err_over_tol": float((err / lim).max()),
            "masked_acc": masked["accuracy"] * 100,
            "folded_acc": folded_acc * 100}

    # the c = 10 run again on the plain route
    ops.set_backend("torch")
    try:
        plain = pr.train_lenet(c10, steps=PAPER["table1"], device=dev)
    finally:
        ops.set_backend("cuda")
    rows = {k: paper_rows(v) for k, v in figures.items()}
    values = {r["name"]: r["value"] for v in rows.values() for r in v}
    kernel_acc = values["table1_mpd10x_acc"]
    plain_acc = plain["accuracy"] * 100
    step = lenet_step_exact(torch, dev, ops)

    accs = [r["value"] for v in rows.values() for r in v
            if "_acc" in r["name"] and "delta" not in r["name"]]
    accs += [fold["masked_acc"], fold["folded_acc"], plain_acc]
    acc_ok = all(math.isfinite(a) and a >= PAPER_MIN_ACC for a in accs)
    kernels_ok = (f32_general(routes["bdmm"]) > f32_general(routes["bdmm_dx"]) > 0
                  and routes["bdmm"]["decode_simt"] > 0
                  and all(launches[k] > 0 for k in MASKED_KERNELS))
    gap_ok = abs(kernel_acc - plain_acc) <= PAPER_ROUTE_GAP
    claims = {"table1_delta_within_1pt": values["table1_acc_delta_pts"] <= 1.0,
              "permuted_above_nonpermuted":
                  values["fig4_permuted_acc"] > values["fig4_nonpermuted_acc"],
              "fig4b_mean_10": values["fig4b_mask_sum_mean"] == 10.0}
    for name, v in rows.items():
        emit({"phase": "paper", "figure": name, "rows": v})

    t1 = time.perf_counter()
    speed = []
    ops.reset_launch_counts()       # the speedup rows' own launches
    for dtype in (torch.float32, torch.bfloat16):
        speed += sp.layer_speedup(dtype=dtype, device=dev)
        speed += sp.kernel_bench(dtype=dtype, device=dev)
    speed += sp.lenet_inference(device=dev)
    speed = paper_rows(speed)
    emit({"phase": "paper", "figure": "speedup", "rows": speed,
          "launches": ops.launch_counts(),
          "timing": "median CUDA-event time of one warm call, a GPU sleep "
                    "queued ahead; host_us: host clock per eager call"})
    ok = (acc_ok and kernels_ok and gap_ok and fold_ok and step["ok"])
    row = {"phase": "paper", "ok": ok, "steps": PAPER,
           "model": "LeNet-300-100 (800-300-100-10), float32",
           "data": "TeacherStudent seed 0, batch 50, eval 2048",
           "reference_cpu": "benchmarks/paper_repro.py on a CPU, jax 0.9.0",
           "accuracies_ok": acc_ok, "min_acc": min(accs),
           "kernels_ok": kernels_ok, "launches": launches, "routes": routes,
           "route_gap": {"kernel_acc": kernel_acc, "plain_acc": plain_acc,
                         "limit_pts": PAPER_ROUTE_GAP, "ok": gap_ok},
           "algorithm1_fold": fold, "step_exact": step,
           "claims_recorded_not_gated": claims,
           "train_s": train_s, "speedup_s": time.perf_counter() - t1}
    emit(row)
    return row


# --------------------------------------------------------------------- main
def main() -> int:
    import resource

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found — run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path[:0] = [str(SRC), str(ROOT)]
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
                 "src/repro/kernels/paged_attention.py:56 (_paged_attn_kernel)",
             "masked_matmul":
                 "src/repro/kernels/masked_matmul.py:41 (_mm_kernel)",
             "masked_matmul_t": "src/repro/kernels/masked_matmul.py:41 "
                                "(_mm_kernel, transpose_rhs)",
             "sddmm_masked":
                 "src/repro/kernels/masked_matmul.py:141 (_sddmm_kernel)",
             "fused_ffn": "src/repro/kernels/fused_ffn.py:58 (_ffn_kernel)",
             "paged_attention_verify": "src/repro/kernels/paged_attention.py:"
                                       "109 (_paged_verify_kernel)"}
    sources = {"bdmm": "src/repro_torch/csrc/bdmm.cu",
               "bdmm_decode": "src/repro_torch/csrc/bdmm.cu",
               "paged_prefill_attention": "src/repro_torch/csrc/paged_prefill.cu",
               "paged_attention": "src/repro_torch/csrc/paged_attention.cu",
               **{k: "src/repro_torch/csrc/masked_matmul.cu"
                  for k in MASKED_KERNELS},
               "fused_ffn": "src/repro_torch/csrc/fused_ffn.cu",
               "paged_attention_verify": "src/repro_torch/csrc/paged_verify.cu"}
    summary = {n: {"max_abs_err": 0.0, "err_over_tol": 0.0, "ok": True}
               for n in names}
    timer = Timer(torch, dev)
    rows = []
    seconds = {"build": time.perf_counter() - t0}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out
    timed("timer_probe", timer_probe, torch, dev, timer)
    timed("kernels_bdmm", check_bdmm, torch, dev, timer, rows, summary)
    timed("kernels_attention", check_paged_attention, torch, dev, timer, rows,
          summary)
    timed("kernels_prefill", check_paged_prefill, torch, dev, timer, rows,
          summary)
    timed("kernels_verify", check_paged_verify, torch, dev, timer, rows,
          summary)
    timed("kernels_masked", check_masked, torch, dev, timer, rows, summary)
    timed("kernels_masked_serving", check_masked_serving, torch, dev, timer,
          rows, summary)
    timed("kernels_fused_ffn", check_fused_ffn, torch, dev, timer, rows,
          summary)
    timed("kernels_lenet", check_lenet, torch, dev, timer, rows, summary)
    del timer
    (OUT_DIR / "kernels.jsonl").write_text(
        "\n".join(json.dumps(r) for r in rows) + "\n")
    failed = [f"kernel {r['kernel']} {r}" for r in rows if not r["ok"]]
    served = timed("serve", serve_phase, torch, dev, ops)
    launches = served["launches"]
    if not served["ok"]:
        failed.append("serve")
    exact, exact_run = timed("exact", exact_phase, torch, dev, ops)
    if not exact["ok"]:
        failed.append("exact")
    if not timed("exact_spec", exact_spec_phase, torch, dev, ops,
                 exact_run)["ok"]:
        failed.append("exact_spec")
    if not timed("exact_dense", exact_dense_phase, torch, dev, ops,
                 exact_run)["ok"]:
        failed.append("exact_dense")
    del exact_run
    torch.cuda.empty_cache()
    dense, dense_run = timed("dense", dense_phase, torch, dev, ops, served)
    if not dense["ok"]:
        failed.append("dense")
    static = timed("static", static_phase, torch, dev, ops, dense_run)
    if not static["ok"]:
        failed.append("static")
    del dense_run
    torch.cuda.empty_cache()
    if not timed("cli", cli_phase, torch, dev, ops)["ok"]:
        failed.append("cli")
    torch.cuda.empty_cache()
    trained, bf16_model, bf16_params, data = timed("train", train_phase,
                                                   torch, dev, ops)
    if not trained["ok"]:
        failed.append("train")
    train_fused = timed("train_fused", train_fused_phase, torch, dev, ops,
                        trained)
    if not train_fused["ok"]:
        failed.append("train_fused")
    resumed = timed("resume", resume_phase, torch, dev, ops)
    if not resumed["ok"]:
        failed.append("resume")
    torch.cuda.empty_cache()
    exact, f32_model, f32_params, batch = timed(
        "train_exact", train_exact_phase, torch, dev, ops, data)
    if not exact["ok"]:
        failed.append("train_exact")
    if not timed("fold", fold_phase, torch, dev, ops, f32_model, f32_params,
                 batch, bf16_model, bf16_params)["ok"]:
        failed.append("fold")
    del f32_model, f32_params, batch, bf16_model, bf16_params
    torch.cuda.empty_cache()
    deployed, target, draft = timed("fused_deploy", fused_deploy_phase, torch,
                                    dev, ops, data, served)
    del data
    if not deployed["ok"]:
        failed.append("fused_deploy")
    spec = timed("spec", spec_phase, torch, dev, ops, target, draft)
    if not spec["ok"]:
        failed.append("spec")
    torch.cuda.empty_cache()
    surface = timed("surface", surface_phase, torch, dev, ops, target, draft)
    if not surface["ok"]:
        failed.append("surface")
    del target, draft
    torch.cuda.empty_cache()
    if not timed("exact_fused", exact_phase, torch, dev, ops, True)[0]["ok"]:
        failed.append("exact_fused")
    torch.cuda.empty_cache()
    paper = timed("paper", paper_phase, torch, dev, ops)
    if not paper["ok"]:
        failed.append("paper")
    # the main path's launches: paged and slot-dense serving, the static
    # lockstep batch, training (perm-fused packed and resumed too), the
    # fused deploy, the speculative turns, the serving surface and the
    # paper's experiments
    launches = {k: sum(p["launches"][k]
                       for p in (served, dense, static, trained, train_fused,
                                 resumed, deployed, spec, surface, paper))
                for k in launches}
    from repro_torch.data import pipeline
    emit({"phase": "timing", "seconds": seconds,
          "total_s": sum(seconds.values()),
          "synthetic_lm_tables": pipeline.TABLE_DRAWS,
          "table_draw_s": sum(d["seconds"] for d in pipeline.TABLE_DRAWS),
          "host_peak_rss_bytes":
              resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024})

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
                        "library_ms": s.get("library_ms"), "at": s.get("at"),
                        **({"yardstick_ms": s.get("yardstick_ms"),
                            "yardstick": s.get("yardstick")}
                           if "yardstick" in s else {}),
                        **({"serving_rows": s["serving_rows"]}
                           if "serving_rows" in s else {}),
                        **({"cuda_body": s["cuda_body"]}
                           if "cuda_body" in s else {}),
                        **({"f32_rows": s["f32_rows"]}
                           if "f32_rows" in s else {}),
                        **({k: s[k] for k in ("bodies", "tall_rows")
                            if k in s})})
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
