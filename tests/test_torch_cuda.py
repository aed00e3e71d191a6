"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips (at run time, through the
``cuda_device`` fixture) where there is no NVIDIA GPU: a CUDA kernel has no
CPU mode. The file imports no JAX, so it runs on a machine that has only
PyTorch:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances, |kernel - plain| <= atol + rtol |plain|: float32 atol 1e-4 /
rtol 1e-4 for bdmm (f32 accumulation order) and 2e-5 / 1e-4 for attention
(online vs one-shot softmax); bf16 bdmm atol 1e-3 / rtol 2e-2 (one bf16
rounding in the kernel against up to three in the plain path). bf16
attention is held against the plain version computed in float32 on the same
bf16 values: the kernel rounds each p to bf16 before PV and rounds the output
once, each within u = 2^-8 relative, so |kernel - plain_f32| <= 2e-5 +
u (|plain_f32| + sum_j p_j |v_j|), the last term being the plain version run
on |V|. The same rule must reject the plain output with one page of context
left out. The speculative verify window takes the same rule, and each of
its queries is the decode kernel's output at that query's own length bit
for bit, over block tables of two widths. The three paged kernels run the
split-KV scheme on the tensor-core body at bf16 and the SIMT body at f32,
as their route tally shows.

The masked matmul (both orientations) and its weight gradient are held
against the plain version computed in float32 on the same values with a
matmul-shaped bound, |kernel - plain_f32| <= 2e-5 + u_out |plain_f32| +
u_sum |x| @ |M∘W|. The sums differ only in their order (bf16 inputs and
their products are exact in f32), within a few 2^-24 of the magnitude:
u_sum = 2^-16 at both dtypes. At bf16 the kernel also rounds its output
once, within bf16's unit roundoff 2^-8 of it: u_out = 2^-8, which admits
exactly one rounding (2^-16 at float32). The same rule
must reject the plain output with one mask block dropped, and every
off-mask weight gradient from the kernel must be exactly 0.

The fused MLP is held against its plain version computed in float32 on the
same values, |kernel - plain_f32| <= 2e-5 + u_out |plain_f32| + 2^-16 mag,
where mag = (|h| + dh) @ |Wd| (times s_down) + |b_down| and dh = |act(g)|
|x|@|Wu| + 1.2 |u| |x|@|Wg| bounds how far the summation order of the up
and gate sums moves the hidden (1.2 bounds |act'| for silu, gelu and relu;
1.2 |x|@|Wu| for the plain form). u_out as above. The same rule must reject
the plain output with the first f tile (64 channels) of w_down zeroed. Both
bf16 bodies take it: tc up to 64 rows, tc_tall above (with its f split over
a cluster or forced to one block).

bdmm's tensor-core bodies (bf16 above 32 rows, both orientations) take
the bf16 rule above against the plain version in float32 on the same
values, which must reject the plain output with one block of the weights
zeroed; the transposed orientation equals a forward bdmm over a transposed
copy of the blocks bit for bit. The SDDMM's tensor-core body takes the
matmul-shaped rule and writes exact zeros off the mask, NaN and Inf inputs
included.

A train step of the smoke model, masked-dense, packed or perm-fused
packed (the fused_ffn autograd rule), gives the same loss (atol/rtol 1e-5) and grads (atol 2e-6, rtol 1e-4) through the kernels
as through the plain versions; so does a step of LeNet-300-100 at c = 10,
whose f32 blocks bdmm runs on its SIMT bodies at every block shape the
paper's policy gives (the f32 tolerance above). bdmm's f32 bodies also
take the f32 rule on ragged and misaligned rows, reject the plain output
with a block zeroed, and give the same bits on two runs and under a
CUDA-graph replay where K is split over a cluster.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.lenet300 import LeNet300
from repro_torch.core.fold import mask_tensor
from repro_torch.core.mask import block_id_of, make_mask_spec
from repro_torch.core.policy import uniform
from repro_torch.kernels import bdmm as tbdmm
from repro_torch.kernels import fused_ffn as tffn
from repro_torch.kernels import masked_matmul as tmm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import paged_prefill as tpp
from repro_torch.kernels import ref as tref
from repro_torch.kernels.quant import quantize_blocks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _close(got, want, dtype):
    atol, rtol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2e-2)}[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def _attn_within(got, plain32, dtype):
    """Whether ``got`` is within the attention tolerance of the f32 plain
    version; ``plain32(abs_v)`` runs it on V or on |V|."""
    want = plain32(False)
    if dtype == torch.float32:
        lim = 2e-5 + 1e-4 * want.abs()
    else:
        lim = 2e-5 + 2.0 ** -8 * (want.abs() + plain32(True))
    return bool(((got.float() - want).abs() <= lim).all())


# ---------------------------------------------------------------------- bdmm
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 33, 64])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_bdmm_matches_plain(cuda_device, quant, m, dtype):
    """Both grids (decode-shaped for m <= 32), ragged bo (1000 is no
    multiple of the 32- or 64-column tiles), bias and silu epilogue."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    nb, bi, bo = 8, 256, 1000
    x = torch.randn((m, nb * bi), generator=g, device=cuda_device).to(dtype)
    w = torch.randn((nb, bi, bo), generator=g, device=cuda_device) * bi ** -0.5
    b = (0.1 * torch.randn((nb * bo,), generator=g, device=cuda_device)).to(dtype)
    before = dict(tbdmm.launches)
    if quant:
        wq, s = quantize_blocks(w)
        got = tbdmm.bdmm(x, wq, b, s, activation="silu")
        want = tref.bdmm_quant_ref(x, wq, s, b, "silu")
    else:
        got = tbdmm.bdmm(x, w.to(dtype), b, activation="silu")
        want = tref.bdmm_ref(x.float(), w.to(dtype).float(), b.float(),
                             "silu").to(dtype)
    grid = "bdmm_decode" if m <= tbdmm.SMALL_M_MAX else "bdmm"
    assert tbdmm.launches[grid] == before[grid] + 1
    _close(got, want, dtype)


def _within(got, want, dtype):
    """Whether ``got`` is within ``_close``'s tolerance of ``want``."""
    atol, rtol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-3, 2e-2)}[dtype]
    return bool(torch.isfinite(got).all()) and bool(
        ((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


def _bdmm_case(m, nb, bi, bo, dev, seed, quant=False, transpose=False,
               dtype=torch.bfloat16):
    """Inputs of ``dtype`` (bf16 unless said) for one bdmm (x of width
    nb*bo when transposed), blocks (int8 with a scale when ``quant``), a
    bias of the output width, and the f32 plain output with silu;
    ``plain(wp)`` recomputes it for other blocks."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    k, n = (bo, bi) if transpose else (bi, bo)
    x = r(m, nb * k).to(dtype)
    w = r(nb, bi, bo) * k ** -0.5
    b = (0.1 * r(nb * n)).to(dtype)
    if quant:
        wq, s = quantize_blocks(w)

        def plain(wp):
            return tref.bdmm_quant_ref(x.float(), wp, s, b.float(), "silu")
        return x, (wq, s), b, plain
    wb = w.to(dtype)

    def plain(wp):
        y = (tref.bdmm_t_ref if transpose else tref.bdmm_ref)(x.float(), wp.float())
        return tref.ACTIVATIONS["silu"](y + b.float())
    return x, (wb, None), b, plain


# (m, nb, bi, bo) against the tensor-core tiles: m 33, 65 and 300 (no
# multiple of the 64- or 128-token tiles), nb 3, bi and bo no multiples of
# 64 (bo 200 and 136 no multiple of the 128-channel tile), the unembed's bo
# 6288, and rows TMA refuses (bo 75: 150-byte bf16 rows)
BDMM_RAGGED = [(33, 3, 200, 136), (65, 3, 136, 200), (300, 3, 200, 136),
               (300, 3, 136, 200), (200, 2, 256, 6288), (65, 3, 100, 75),
               (300, 3, 100, 75)]


@pytest.mark.parametrize("quant,transpose", [(False, False), (False, True),
                                             (True, False)],
                         ids=["bf16-fwd", "bf16-t", "int8-fwd"])
@pytest.mark.parametrize("shape", BDMM_RAGGED)
def test_bdmm_tensor_core_bodies_ragged_shapes(cuda_device, shape, quant,
                                               transpose):
    """The general grid's bf16 bodies with bias, silu and (int8, forward:
    the inference weights) the scale, both orientations, on ragged and
    unaligned shapes: the body the plan names ran (a tensor-core one), and
    the bf16 rule holds."""
    m, nb, bi, bo = shape
    x, (wp, s), b, plain = _bdmm_case(m, nb, bi, bo, cuda_device, seed=m + bo,
                                      quant=quant, transpose=transpose)
    k, n = (bo, bi) if transpose else (bi, bo)
    route = tbdmm.plan(m, nb, k, n, torch.bfloat16, wp.dtype, transpose,
                       tbdmm._build.copy_width(x, k * 2),
                       tbdmm._build.copy_width(wp, bo * wp.element_size())).route
    assert route in ("tc", "tc_small_m")
    before = dict(tbdmm.routes)
    got = tbdmm.bdmm(x, wp, b, s, activation="silu", transpose=transpose)
    after = dict(tbdmm.routes)
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    _close(got, plain(wp).bfloat16(), torch.bfloat16)


@pytest.mark.parametrize("m,transpose,dtype,route", [
    (64, False, torch.bfloat16, "tc"), (64, True, torch.bfloat16, "tc"),
    (2048, False, torch.bfloat16, "tc"), (2048, True, torch.bfloat16, "tc"),
    (4, False, torch.float32, "decode_simt"),
    (64, False, torch.float32, "simt_small"),
    (50, True, torch.float32, "simt_small"),
    (2048, False, torch.float32, "simt_f32"),
    (512, True, torch.float32, "simt_f32")],
    ids=["64-fwd", "64-t", "2048-fwd", "2048-t", "f32-4-fwd", "f32-64-fwd",
         "f32-50-t", "f32-2048-fwd", "f32-512-t"])
def test_bdmm_rule_rejects_a_zeroed_block(cuda_device, m, transpose, dtype,
                                          route):
    """The rule of each dtype that the kernel passes at the olmo-1b up/gate
    shape, on the body the plan names (the tiled f32 one with its K split
    at m = 512 transposed), rejects the plain output with block 3 of the
    weights zeroed."""
    x, (wp, _), b, plain = _bdmm_case(m, 8, 256, 1024, cuda_device, seed=3,
                                      transpose=transpose, dtype=dtype)
    before = dict(tbdmm.routes)
    got = tbdmm.bdmm(x, wp, b, activation="silu", transpose=transpose)
    assert tbdmm.routes[route] == before[route] + 1
    assert _within(got, plain(wp).to(dtype), dtype)
    zeroed = wp.clone()
    zeroed[3] = 0
    assert not _within(plain(zeroed).to(dtype), plain(wp).to(dtype), dtype)
    assert not _within(got, plain(zeroed).to(dtype), dtype)


@pytest.mark.parametrize("m,dtype", [(64, torch.bfloat16), (300, torch.bfloat16),
                                     (2048, torch.bfloat16), (64, torch.float32)])
def test_bdmm_dx_equals_the_transposed_copy_route(cuda_device, m, dtype):
    """dx through the transposed-blocks orientation, which reads the blocks
    as stored, equals the former route (a forward bdmm over a transposed
    copy of the blocks) bit for bit: the same body, tiles and K order."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    nb, bi, bo = 8, 256, 1024
    gy = torch.randn((m, nb * bo), generator=g, device=cuda_device).to(dtype)
    wp = (torch.randn((nb, bi, bo), generator=g, device=cuda_device)
          * bo ** -0.5).to(dtype)
    got = tbdmm.bdmm(gy, wp, transpose=True)
    want = tbdmm.bdmm(gy, wp.transpose(1, 2).contiguous())
    assert torch.equal(got, want)
    assert torch.equal(ops.bdmm_t(gy, wp), got)


@pytest.mark.parametrize("m,dtype,quant,transpose,route", [
    (1, torch.bfloat16, False, False, "decode_tc"),
    (4, torch.bfloat16, True, False, "decode_tc"),
    (32, torch.float32, True, False, "decode_simt"),
    (1, torch.bfloat16, False, True, "tc"),
    (64, torch.bfloat16, True, False, "tc_small_m"),
    (64, torch.bfloat16, False, False, "tc"),
    (129, torch.bfloat16, False, True, "tc"), (2048, torch.bfloat16, False, False, "tc"),
    (2048, torch.bfloat16, True, False, "tc_small_m"),
    (64, torch.float32, False, True, "simt_small"), (50, torch.float32, True, False, "simt_small"),
    (2048, torch.float32, True, False, "simt_f32"), (512, torch.float32, False, True, "simt_f32")])
def test_bdmm_route_tally(cuda_device, m, dtype, quant, transpose, route):
    """bf16 bdmm above 32 rows runs on a tensor-core body (bf16 blocks on
    the tiled one, int8 blocks on the small-m one), f32 on a SIMT body (the
    small one up to 64 rows, the tiled one above for these wide blocks);
    the forward at m <= 32 takes the decode grid (mma.sync at bf16, SIMT at
    f32); the tally shows which."""
    x, (wp, s), b, plain = _bdmm_case(m, 8, 256, 512, cuda_device, seed=1,
                                      quant=quant, transpose=transpose)
    x = x.to(dtype)
    wp = wp if quant else wp.to(dtype)
    before, dec = dict(tbdmm.routes), tbdmm.launches["bdmm_decode"]
    got = tbdmm.bdmm(x, wp, b, s, activation="silu", transpose=transpose)
    after = dict(tbdmm.routes)
    assert {r: after[r] - before[r] for r in after} == {
        r: int(r == route) for r in after}
    assert tbdmm.launches["bdmm_decode"] == dec + (route in tbdmm.DECODE_ROUTES)
    if dtype == torch.bfloat16:
        _close(got, plain(wp).bfloat16(), dtype)


# olmo-1b's packed projections at mpd_c=8: (nb, bi, bo, activation)
OLMO_BDMM = {"qkvo": (8, 256, 256, None), "up_gate": (8, 256, 1024, "silu"),
             "down": (8, 1024, 256, None), "unembed": (8, 256, 6288, None)}


# LeNet-300-100's packed blocks (c = 10, 4, 8) as decode shapes, f32 only:
# the paper path's batch-1 inference
LENET_DECODE = {f"lenet-{nb}x{bi}x{bo}": (nb, bi, bo, None)
                for nb, bi, bo in ((10, 80, 30), (10, 30, 10), (10, 10, 1),
                                   (4, 200, 75), (4, 75, 25), (2, 50, 5),
                                   (5, 160, 60), (5, 60, 20), (5, 20, 2))}
DECODE_ROW_CASES = (
    [(name, dt, q) for name in OLMO_BDMM
     for dt, q in ((torch.bfloat16, False), (torch.bfloat16, True),
                   (torch.float32, False), (torch.float32, True))]
    + [(name, torch.float32, False) for name in LENET_DECODE])


@pytest.mark.parametrize(
    "name,dtype,quant", DECODE_ROW_CASES,
    ids=[f"{n}-{'bf16' if d == torch.bfloat16 else 'f32'}{'-int8' if q else ''}"
         for n, d, q in DECODE_ROW_CASES])
def test_bdmm_decode_rows_do_not_depend_on_m(cuda_device, name, dtype, quant):
    """Row r of an m-row call on the decode grid is bit for bit row r of
    the same input cut to fewer rows (the verify windows of m = 20 are held
    to the decode steps at m = 4): rows of m = 20 and 32 equal the m = 1
    and m = 4 calls, with bias and the projection's activation; at olmo-1b's
    projections and, f32, at LeNet's blocks (K split in a cluster)."""
    nb, bi, bo, act = {**OLMO_BDMM, **LENET_DECODE}[name]
    g = torch.Generator(device=cuda_device).manual_seed(bi + bo)
    x = torch.randn((32, nb * bi), generator=g, device=cuda_device).to(dtype)
    w = torch.randn((nb, bi, bo), generator=g, device=cuda_device) * bi ** -0.5
    b = 0.1 * torch.randn((nb * bo,), generator=g, device=cuda_device)
    wp, s = quantize_blocks(w) if quant else (w.to(dtype), None)
    run = lambda m: tbdmm.bdmm(x[:m], wp, b, s, activation=act)  # noqa: E731
    before = dict(tbdmm.routes)
    outs = {m: run(m) for m in (1, 4, 20, 32)}
    body = "decode_tc" if dtype == torch.bfloat16 else "decode_simt"
    assert tbdmm.routes[body] == before[body] + 4
    assert bool(torch.isfinite(outs[32].float()).all())
    for big in (20, 32):
        for small in (1, 4):
            assert torch.equal(outs[big][:small], outs[small])
    assert torch.equal(outs[32][:20], outs[20])


def _offset(t: torch.Tensor, elems: int) -> torch.Tensor:
    """A copy of ``t`` whose storage starts ``elems`` elements past a
    16-byte boundary (row starts no wider copy than that can read)."""
    buf = torch.empty(t.numel() + elems + 16, dtype=t.dtype, device=t.device)
    lead = (-buf.data_ptr() // t.element_size()) % (16 // t.element_size())
    out = buf[lead + elems:lead + elems + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# (m, nb, bi, bo, x offset, w offset) on the decode grid: the unembed's bo
# 6288, bi and bo no multiples of the 64-row stage or the 64-channel tile,
# bo 75 (150-byte bf16 and 75-byte int8 rows), and x or the blocks starting
# off a 16-byte boundary
DECODE_RAGGED = [(5, 8, 256, 6288, 0, 0), (32, 3, 200, 136, 0, 0),
                 (1, 3, 200, 136, 1, 0), (20, 3, 136, 200, 0, 4),
                 (7, 2, 100, 75, 2, 3), (32, 3, 1000, 24, 3, 0)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("shape", DECODE_RAGGED)
def test_bdmm_decode_grid_ragged_and_misaligned(cuda_device, shape, quant):
    """The bf16 decode grid on ragged shapes and rows that are not 16-byte
    aligned (copied in narrower pieces inside the kernel, never by a plain
    fallback): the mma.sync body ran and the bf16 rule holds."""
    m, nb, bi, bo, x_off, w_off = shape
    x, (wp, s), b, plain = _bdmm_case(m, nb, bi, bo, cuda_device, seed=m + bi,
                                      quant=quant)
    x, wp = _offset(x, x_off), _offset(wp, w_off)
    before = dict(tbdmm.routes)
    got = tbdmm.bdmm(x, wp, b, s, activation="silu")
    assert tbdmm.routes["decode_tc"] == before["decode_tc"] + 1
    _close(got, plain(wp).bfloat16(), torch.bfloat16)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("m", [4, 32])
def test_bdmm_decode_rule_rejects_a_zeroed_block(cuda_device, m, quant):
    """The bf16 rule that the decode grid passes at the olmo-1b down shape
    (K split over the 4 blocks of a cluster) rejects the plain output with
    block 3 of the weights zeroed."""
    x, (wp, s), b, plain = _bdmm_case(m, 8, 1024, 256, cuda_device, seed=5,
                                      quant=quant)
    got = tbdmm.bdmm(x, wp, b, s, activation="silu")
    assert _within(got, plain(wp).bfloat16(), torch.bfloat16)
    zeroed = wp.clone()
    zeroed[3] = 0
    assert not _within(got, plain(zeroed).bfloat16(), torch.bfloat16)


# (m, transpose, nb, bi, bo, quant) of f32 calls whose K is split over a
# cluster: LeNet's first block at batch 50 (small body, split 4), the c = 4
# block's dx, olmo-1b's down on the decode grid (K 1024, split 4) with int8
# and f32 blocks, and the speedup's (8, 256, 256) at m = 512 both ways
# (tiled body, split 2)
F32_SPLIT_CASES = [(50, False, 10, 80, 30, False), (50, True, 4, 200, 75, False),
                   (4, False, 8, 1024, 256, True), (32, False, 8, 1024, 256, False),
                   (512, False, 8, 256, 256, False), (512, True, 8, 256, 256, False)]


@pytest.mark.parametrize("m,transpose,nb,bi,bo,quant", F32_SPLIT_CASES)
def test_bdmm_f32_split_is_deterministic_and_replays(cuda_device, m, transpose,
                                                     nb, bi, bo, quant):
    """A K-split f32 call (partials added over DSMEM in rank order, no
    atomics) gives the same bits on two runs, and a CUDA-graph replay of it
    equals the eager call bit for bit; the f32 rule holds."""
    x, (wp, s), b, plain = _bdmm_case(m, nb, bi, bo, cuda_device, seed=m + bo,
                                      quant=quant, transpose=transpose,
                                      dtype=torch.float32)
    k, n = (bo, bi) if transpose else (bi, bo)
    assert tbdmm.plan(m, nb, k, n, torch.float32, wp.dtype, transpose).split > 1
    run = lambda: tbdmm.bdmm(x, wp, b, s, activation="silu",  # noqa: E731
                             transpose=transpose)
    eager = run()
    assert torch.equal(run(), eager)
    _close(eager, plain(wp), torch.float32)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(cuda_device)
        assert torch.equal(captured, eager)


@pytest.mark.parametrize("m", [64, 128])
def test_bdmm_f32_int8_tiled_body_at_up_gate(cuda_device, m):
    """The tiled f32 body with int8 blocks (widened exactly on the load)
    and the per-channel scale at olmo-1b's up/gate, silu and bias: at m =
    128 as the plan picks it, at m = 64 launched in its place (the plan
    gives 64 rows to the small body), with the K split of its grid."""
    x, (wq, s), b, plain = _bdmm_case(m, 8, 256, 1024, cuda_device, seed=m,
                                      quant=True, dtype=torch.float32)
    p = tbdmm.plan(128, 8, 256, 1024, torch.float32, torch.int8)
    assert p.route == "simt_f32" and p.split == 2
    if m == 128:
        before = dict(tbdmm.routes)
        got = tbdmm.bdmm(x, wq, b, s, activation="silu")
        assert tbdmm.routes["simt_f32"] == before["simt_f32"] + 1
    else:
        got = torch.empty(m, 8 * 1024, device=cuda_device)
        tbdmm.launch(p, x, wq, s.float().contiguous(), b.float(), got, "silu")
    _close(got, plain(wq), torch.float32)


# (m, nb, bi, bo, x offset, w offset, transpose) for the f32 bodies: LeNet's
# heads (bo 1, 2 and 5: dx reduces over K = 1, 2 or 5), rows of 30, 75 or 5
# floats (8- or 4-byte copies), x or the blocks starting off a 16-byte
# boundary, on every f32 body
F32_RAGGED = [(1, 10, 10, 1, 0, 0, False), (50, 10, 10, 1, 1, 0, True),
              (3, 5, 20, 2, 0, 3, False), (50, 5, 20, 2, 0, 1, True),
              (50, 2, 50, 5, 2, 0, False), (2048, 2, 50, 5, 0, 0, False),
              (7, 4, 200, 75, 1, 2, False), (50, 4, 200, 75, 3, 0, True),
              (300, 4, 75, 25, 2, 1, False), (20, 3, 136, 200, 0, 1, False),
              (300, 3, 136, 200, 1, 0, False), (200, 3, 200, 136, 0, 3, True)]


@pytest.mark.parametrize("shape,quant", [(s, False) for s in F32_RAGGED]
                         + [(s, True) for s in F32_RAGGED if not s[-1]])
def test_bdmm_f32_ragged_and_misaligned(cuda_device, shape, quant):
    """The f32 bodies' copies on ragged shapes and rows that are no
    multiple of 16 bytes or start off a 16-byte boundary (copied in the
    widest piece they allow inside the kernel, never by a plain fallback),
    with bias, silu and (int8, forward) the scale: the body the plan names
    ran and the f32 rule holds."""
    m, nb, bi, bo, x_off, w_off, transpose = shape
    x, (wp, s), b, plain = _bdmm_case(m, nb, bi, bo, cuda_device, seed=m + bi,
                                      quant=quant, transpose=transpose,
                                      dtype=torch.float32)
    x, wp = _offset(x, x_off), _offset(wp, w_off)
    k, n = (bo, bi) if transpose else (bi, bo)
    route = tbdmm.plan(m, nb, k, n, torch.float32, wp.dtype, transpose).route
    before = dict(tbdmm.routes)
    got = tbdmm.bdmm(x, wp, b, s, activation="silu", transpose=transpose)
    assert tbdmm.routes[route] == before[route] + 1
    _close(got, plain(wp), torch.float32)


# every epilogue code of ref.ACTIVATIONS, and the body each (m, dtype,
# weights) takes at nb 8, bi 256, bo 1024
ALL_ACTS = [None, "silu", "gelu", "relu", "sigmoid", "softplus", "sqrelu"]
ACT_BODIES = [(4, torch.bfloat16, False, "decode_tc"),
              (4, torch.bfloat16, True, "decode_tc"),
              (64, torch.bfloat16, False, "tc"),
              (64, torch.bfloat16, True, "tc_small_m"),
              (4, torch.float32, False, "decode_simt"),
              (4, torch.float32, True, "decode_simt"),
              (64, torch.float32, False, "simt_small"),
              (64, torch.float32, True, "simt_small"),
              (2048, torch.float32, False, "simt_f32"),
              (2048, torch.float32, True, "simt_f32")]


def _act_case(m, nb, bi, bo, dev, dtype, quant, act, seed):
    """One bdmm with bias and ``act`` and its plain version in f32 on the
    same values (int8: the kernel's own order, rounded to ``dtype``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, nb * bi), generator=g, device=dev).to(dtype)
    w = torch.randn((nb, bi, bo), generator=g, device=dev) * bi ** -0.5
    b = (0.5 * torch.randn((nb * bo,), generator=g, device=dev)).to(dtype)
    if quant:
        wq, s = quantize_blocks(w)
        return ((lambda: tbdmm.bdmm(x, wq, b, s, activation=act)),
                tref.bdmm_quant_ref(x, wq, s, b, act))
    wd = w.to(dtype)
    return ((lambda: tbdmm.bdmm(x, wd, b, activation=act)),
            tref.bdmm_ref(x.float(), wd.float(), b.float(), act).to(dtype))


@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("m,dtype,quant,route", ACT_BODIES,
                         ids=[f"{r}-{'int8' if q else str(d)[6:]}-{m}"
                              for m, d, q, r in ACT_BODIES])
def test_bdmm_every_activation_on_every_body(cuda_device, m, dtype, quant,
                                             route, act):
    """Each epilogue code (scale, then bias, then the activation, each
    rounded on its own) on each body, fp and int8: the body the plan names
    ran and the dtype's rule holds against the plain version."""
    run, want = _act_case(m, 8, 256, 1024, cuda_device, dtype, quant, act,
                          seed=m + ALL_ACTS.index(act))
    before = dict(tbdmm.routes)
    got = run()
    assert tbdmm.routes[route] == before[route] + 1
    _close(got, want, dtype)


# the packed projections of the recurrent families at mpd_c = 8 (name, nb,
# bi, bo, activation): jamba's w_x (bo 36) and w_dt (bi 32, softplus with
# dt_bias), rwkv6's time-mix projections (320 x 320) and its channel mix's
# k (sqrelu), v and r (sigmoid)
RECURRENT_BLOCKS = [("w_x", 8, 1024, 36, None),
                    ("w_dt", 8, 32, 1024, "softplus"),
                    ("rwkv_proj", 8, 320, 320, None),
                    ("ck", 8, 320, 1120, "sqrelu"),
                    ("cv", 8, 1120, 320, None),
                    ("cr", 8, 320, 320, "sigmoid")]


@pytest.mark.parametrize("m,dtype", [(4, torch.bfloat16), (64, torch.bfloat16),
                                     (4, torch.float32), (64, torch.float32)])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("block", RECURRENT_BLOCKS, ids=lambda b: b[0])
def test_bdmm_at_the_recurrent_block_shapes(cuda_device, block, quant, m,
                                            dtype):
    """The recurrent families' block shapes with their epilogues, at a
    decode batch and a prefill chunk: one launch, on a body of the dtype
    (bf16 on the tensor cores, f32 on an exact SIMT body), and the rule
    holds."""
    _, nb, bi, bo, act = block
    run, want = _act_case(m, nb, bi, bo, cuda_device, dtype, quant, act,
                          seed=bi + bo + m)
    before = dict(tbdmm.routes)
    got = run()
    used = [r for r in tbdmm.routes for _ in range(tbdmm.routes[r]
                                                   - before[r])]
    bodies = (tbdmm.F32_ROUTES if dtype == torch.float32
              else ("decode_tc", "tc", "tc_small_m"))
    assert len(used) == 1 and used[0] in bodies, used
    _close(got, want, dtype)


def test_bdmm_raises_instead_of_falling_back(cuda_device):
    x = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(ValueError):
        tbdmm.bdmm(x, torch.zeros(4, 16, 8, device=cuda_device),
                   activation="tanh")
    with pytest.raises(ValueError):
        tbdmm.bdmm(x.cpu(), torch.zeros(4, 16, 8, device=cuda_device))


# ------------------------------------------------------------- masked matmul
def _mm_within(got, want32, mag, dtype):
    u_out = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -16
    lim = 2e-5 + u_out * want32.abs() + 2.0 ** -16 * mag
    return bool(torch.isfinite(got).all()) and bool(
        ((got.float() - want32).abs() <= lim).all())


def _mm_case(m, d_in, d_out, dev, dtype, seed, nb=8):
    """Inputs at ``dtype``, a permuted ``nb``-block mask, and the same mask
    with block 0's rows dropped."""
    spec = make_mask_spec(d_in, d_out, nb, seed=seed)
    mask = mask_tensor(spec, dev)
    in_block = torch.as_tensor(block_id_of(spec)[0], device=dev)
    dropped = mask * (in_block != 0).to(torch.uint8)[:, None]
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x, w = r(m, d_in).to(dtype), (r(d_in, d_out) * d_in ** -0.5).to(dtype)
    gy, b = r(m, d_out).to(dtype), (0.1 * r(d_out)).to(dtype)
    return mask, dropped, x, w, gy, b


# (m, d_in, d_out): every edge ragged against the 128x128x16 tiles in one
MM_SHAPES = [(64, 256, 512), (100, 384, 200), (33, 136, 1000)]


@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_masked_matmul_matches_plain(cuda_device, shape, dtype, act):
    mask, dropped, x, w, _, b = _mm_case(*shape, cuda_device, dtype, seed=7)
    before = tmm.launches["masked_matmul"]
    got = tmm.masked_matmul(x, w, mask, b, activation=act)
    assert tmm.launches["masked_matmul"] == before + 1
    x32, w32, b32 = x.float(), w.float(), b.float()
    want = tref.masked_matmul_ref(x32, w32, mask, b32, act)
    mag = x32.abs() @ (w32.abs() * mask) + b32.abs()
    assert _mm_within(got, want, mag, dtype)
    assert not _mm_within(tref.masked_matmul_ref(x32, w32, dropped, b32, act),
                          want, mag, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_masked_matmul_transposed_matches_plain(cuda_device, shape, dtype):
    mask, dropped, _, w, gy, _ = _mm_case(*shape, cuda_device, dtype, seed=8)
    before = tmm.launches["masked_matmul_t"]
    got = tmm.masked_matmul(gy, w, mask, transpose_rhs=True)
    assert tmm.launches["masked_matmul_t"] == before + 1
    g32, w32 = gy.float(), w.float()
    want = tref.masked_matmul_t_ref(g32, w32, mask)
    mag = g32.abs() @ (w32.abs() * mask).T
    assert _mm_within(got, want, mag, dtype)
    assert not _mm_within(tref.masked_matmul_t_ref(g32, w32, dropped), want,
                          mag, dtype)


# (m, d_in, d_out, nb) against the tensor-core tiles: m 1, the route border
# (64 | 65), K no multiple of 64, and rows aligned to 8, 4, 2 and 1 bytes
# (mask rows of 1000, 200, 250 and 75 bytes; bf16 rows of 260 and 150)
MM_RAGGED = [(1, 200, 1000, 8), (65, 136, 200, 8), (64, 130, 250, 2),
             (3, 75, 45, 5)]


@pytest.mark.parametrize("act", ALL_ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "t"])
@pytest.mark.parametrize("shape", MM_RAGGED)
def test_masked_matmul_ragged_shapes(cuda_device, shape, transpose, dtype,
                                     act):
    """Both orientations with bias and every activation on ragged and
    unaligned shapes: each launches its route's kernel (no fallback) and
    passes the matmul-shaped rule, which rejects the dropped block."""
    m, d_in, d_out, nb = shape
    mask, dropped, x, w, gy, _ = _mm_case(m, d_in, d_out, cuda_device, dtype,
                                          seed=11, nb=nb)
    inp = gy if transpose else x
    n = d_in if transpose else d_out
    g = torch.Generator(device=cuda_device).manual_seed(12)
    b = (0.1 * torch.randn(n, generator=g, device=cuda_device)).to(dtype)
    route = tmm.plan(m, inp.shape[1], n, dtype).route
    before = tmm.routes[route]
    got = tmm.masked_matmul(inp, w, mask, b, activation=act,
                            transpose_rhs=transpose)
    assert tmm.routes[route] == before + 1
    i32, w32, b32 = inp.float(), w.float(), b.float()

    def plain(mk):
        wm = w32 * mk
        return tref.ACTIVATIONS[act](i32 @ (wm.T if transpose else wm) + b32)

    wa = w32.abs() * mask
    mag = i32.abs() @ (wa.T if transpose else wa) + b32.abs()
    want = plain(mask)
    assert _mm_within(got, want, mag, dtype)
    assert not _mm_within(plain(dropped), want, mag, dtype)


@pytest.mark.parametrize("dtype,d_in,d_out", [
    (torch.bfloat16, 2048, 8192), (torch.float32, 2048, 8192),
    (torch.float32, 800, 300)], ids=["bf16-up_gate", "f32-up_gate",
                                     "f32-lenet800x300"])
@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "t"])
def test_masked_matmul_rows_do_not_depend_on_m(cuda_device, transpose, dtype,
                                               d_in, d_out):
    """The first rows are bit for bit the same in calls of 1, 4, 20 and 64
    rows, bf16 (tc_small_m) and f32 (simt_small_m, whose K split is one
    cluster): the small-m plans depend on (K, N) alone, so greedy spec
    streams (verify at m = 20) can equal non-spec streams (decode at m =
    4), and a LeNet row scores the same alone as in its batch."""
    mask, _, x, w, gy, b = _mm_case(64, d_in, d_out, cuda_device, dtype,
                                    seed=5, nb=10 if d_in == 800 else 8)
    inp, bias = (gy, None) if transpose else (x, b)
    run = lambda rows: tmm.masked_matmul(  # noqa: E731
        inp[:rows], w, mask, bias, activation=None if transpose else "silu",
        transpose_rhs=transpose)
    base = run(4)
    for m in (1, 20, 64):
        r = min(m, 4)
        assert torch.equal(run(m)[:r], base[:r]), m


@pytest.mark.parametrize("m,dtype,route", [
    (1, torch.bfloat16, "tc_small_m"), (64, torch.bfloat16, "tc_small_m"),
    (65, torch.bfloat16, "tc"), (2048, torch.bfloat16, "tc"),
    (4, torch.float32, "simt_small_m"), (64, torch.float32, "simt_small_m"),
    (65, torch.float32, "simt_f32"), (2048, torch.float32, "simt_f32")])
def test_masked_matmul_route_tally(cuda_device, m, dtype, route):
    """Both dtypes take a small-m body at m <= 64 and a tiled one above
    (bf16 on the tensor cores, f32 on the SIMT bodies), in both
    orientations; the tally by route shows which ran."""
    mask, _, x, w, gy, _ = _mm_case(m, 256, 512, cuda_device, dtype, seed=2)
    for inp, transpose in ((x, False), (gy, True)):
        before = dict(tmm.routes)
        tmm.masked_matmul(inp, w, mask, transpose_rhs=transpose)
        after = dict(tmm.routes)
        assert {k: after[k] - before[k] for k in after} == {
            k: int(k == route) for k in after}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MM_SHAPES)
def test_sddmm_matches_plain_with_exact_zeros(cuda_device, shape, dtype):
    mask, dropped, x, _, gy, _ = _mm_case(*shape, cuda_device, dtype, seed=9)
    before = tmm.launches["sddmm_masked"]
    got = tmm.sddmm_masked(x, gy, mask)
    assert tmm.launches["sddmm_masked"] == before + 1
    assert torch.all(got[mask == 0] == 0)
    x32, g32 = x.float(), gy.float()
    want = tref.matmul_masked_grad_ref(x32, g32, mask)
    mag = (x32.abs().T @ g32.abs()) * mask
    assert _mm_within(got, want, mag, dtype)
    assert not _mm_within(tref.matmul_masked_grad_ref(x32, g32, dropped),
                          want, mag, dtype)


def test_sddmm_off_mask_stays_zero_on_non_finite_sums(cuda_device):
    """An infinite input makes non-finite sums; off the mask the kernel
    still writes exact zeros (a select, where the plain multiply gives
    NaN)."""
    mask, _, x, _, gy, _ = _mm_case(32, 64, 64, cuda_device, torch.float32, 3)
    x[0, :] = float("inf")
    got = tmm.sddmm_masked(x, gy, mask)
    assert torch.all(got[mask == 0] == 0)
    assert not torch.isfinite(got[mask == 1]).all()


# (m, d_in, d_out, nb) for the SDDMM's tensor-core body: m no multiple of
# the 64-token step, d_in / d_out no multiple of the 256 x 128 tile, and rows
# TMA refuses (d_in 100 / d_out 75: 200- and 150-byte rows, masks of 75)
SDDMM_RAGGED = [(100, 384, 200, 8), (33, 136, 1000, 8), (65, 100, 75, 5),
                (2048, 256, 512, 8)]


@pytest.mark.parametrize("shape", SDDMM_RAGGED)
def test_sddmm_tensor_core_body_ragged_and_non_finite(cuda_device, shape):
    """bf16 SDDMM on the tensor-core body at ragged and unaligned shapes:
    the rule holds and rejects a dropped block, off-mask entries are exact
    zeros; then with an infinite and a NaN token row the off-mask entries
    stay exact zeros (the select) while on-mask sums go non-finite."""
    m, d_in, d_out, nb = shape
    mask, dropped, x, _, gy, _ = _mm_case(m, d_in, d_out, cuda_device,
                                          torch.bfloat16, seed=m, nb=nb)
    before = dict(tmm.sddmm_routes)
    got = tmm.sddmm_masked(x, gy, mask)
    assert tmm.sddmm_routes["tc"] == before["tc"] + 1
    assert tmm.sddmm_routes["simt_f32"] == before["simt_f32"]
    assert torch.all(got[mask == 0] == 0)
    x32, g32 = x.float(), gy.float()
    want = tref.matmul_masked_grad_ref(x32, g32, mask)
    mag = (x32.abs().T @ g32.abs()) * mask
    assert _mm_within(got, want, mag, torch.bfloat16)
    assert not _mm_within(tref.matmul_masked_grad_ref(x32, g32, dropped),
                          want, mag, torch.bfloat16)
    x[0, :] = float("inf")
    gy[m - 1, :] = float("nan")
    bad = tmm.sddmm_masked(x, gy, mask)
    assert torch.all(bad[mask == 0] == 0)
    assert not torch.isfinite(bad[mask == 1]).any()


@pytest.mark.parametrize("dtype,route,d_in,d_out", [
    (torch.bfloat16, "tc", 256, 512), (torch.float32, "simt_f32", 2048, 2048),
    (torch.float32, "simt_small_tile", 256, 512)])
def test_sddmm_route_tally(cuda_device, dtype, route, d_in, d_out):
    """bf16 on the tensor-core body; f32 on the SIMT body at 128 x 128
    where those tiles cover the SMs, at a smaller tile where they would
    not (the plan's choice)."""
    assert tmm.sddmm_plan(d_in, d_out, dtype).route == route
    mask, _, x, _, gy, _ = _mm_case(2048, d_in, d_out, cuda_device, dtype,
                                    seed=2)
    before = dict(tmm.sddmm_routes)
    tmm.sddmm_masked(x, gy, mask)
    after = dict(tmm.sddmm_routes)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == route) for k in after}


def test_masked_kernels_raise_instead_of_falling_back(cuda_device):
    mask, _, x, w, gy, _ = _mm_case(64, 256, 512, cuda_device, torch.float32, 1)
    with pytest.raises(ValueError):
        tmm.masked_matmul(x, w, mask.float())            # not a binary mask
    with pytest.raises(ValueError):
        tmm.masked_matmul(x, w, mask, activation="tanh")
    with pytest.raises(ValueError):
        tmm.masked_matmul(x.cpu(), w, mask)              # mixed devices
    with pytest.raises(ValueError):
        tmm.sddmm_masked(x, gy.bfloat16(), mask)


# LeNet-300-100's masked-dense layers (d_in, d_out, nb) at c = 10 and c = 4:
# K and N of 800, 300, 100 and 10, rows of 40 bytes and masks of 10
LENET_MASKED = sorted({(s.d_in, s.d_out, s.mask.nb) for c in (10, 4)
                       for s in LeNet300(policy=uniform(c, min_block=1)).specs})


@pytest.mark.parametrize("transpose", [False, True], ids=["fwd", "t"])
@pytest.mark.parametrize("m", [1, 50, 64, 65, 2048])
@pytest.mark.parametrize("layer", LENET_MASKED,
                         ids=lambda s: "x".join(map(str, s)))
def test_masked_matmul_f32_at_lenet_layers(cuda_device, layer, m, transpose):
    """The f32 masked matmul at every masked LeNet layer in the paper
    path's roles (batch-1 inference, a training batch forward and dx, the
    2048-sample eval) and at the route border (64 | 65): the body the plan
    names ran (simt_small_m with its cluster K split, or the pipelined
    simt_f32), the f32 rule holds, and it rejects a dropped mask block.
    The forward carries the bias (an activation could clamp the dropped
    block's few channels to the same zeros at m = 1)."""
    d_in, d_out, nb = layer
    mask, dropped, x, w, gy, b = _mm_case(m, d_in, d_out, cuda_device,
                                          torch.float32, seed=m + d_in,
                                          nb=nb)
    inp, n = (gy, d_in) if transpose else (x, d_out)
    bias = None if transpose else b
    route = tmm.plan(m, inp.shape[1], n, torch.float32).route
    assert route == ("simt_small_m" if m <= tmm.SMALL_M_MAX else "simt_f32")
    before = dict(tmm.routes)
    got = tmm.masked_matmul(inp, w, mask, bias, transpose_rhs=transpose)
    assert {r: tmm.routes[r] - before[r] for r in before} == {
        r: int(r == route) for r in before}

    def plain(mk):
        wm = w * mk
        y = inp @ (wm.T if transpose else wm)
        return y if transpose else y + b

    wa = w.abs() * mask
    mag = inp.abs() @ (wa.T if transpose else wa) + (0 if transpose
                                                     else b.abs())
    want = plain(mask)
    assert _mm_within(got, want, mag, torch.float32)
    assert not _mm_within(plain(dropped), want, mag, torch.float32)


@pytest.mark.parametrize("m", [50, 2048])
@pytest.mark.parametrize("layer", LENET_MASKED,
                         ids=lambda s: "x".join(map(str, s)))
def test_sddmm_f32_at_lenet_layers(cuda_device, layer, m):
    """The f32 SDDMM at every masked LeNet layer (d_out 10 takes the scalar
    epilogue): the body sddmm_plan names ran, the rule holds and rejects a
    dropped block, off-mask entries are exact zeros; with an infinite and
    a NaN token row they stay exact zeros while on-mask sums go
    non-finite."""
    d_in, d_out, nb = layer
    mask, dropped, x, _, gy, _ = _mm_case(m, d_in, d_out, cuda_device,
                                          torch.float32, seed=d_out, nb=nb)
    route = tmm.sddmm_plan(d_in, d_out, torch.float32).route
    before = dict(tmm.sddmm_routes)
    got = tmm.sddmm_masked(x, gy, mask)
    assert {r: tmm.sddmm_routes[r] - before[r] for r in before} == {
        r: int(r == route) for r in before}
    assert torch.all(got[mask == 0] == 0)
    want = tref.matmul_masked_grad_ref(x, gy, mask)
    mag = (x.abs().T @ gy.abs()) * mask
    assert _mm_within(got, want, mag, torch.float32)
    assert not _mm_within(tref.matmul_masked_grad_ref(x, gy, dropped), want,
                          mag, torch.float32)
    x[0, :] = float("inf")
    gy[m - 1, :] = float("nan")
    bad = tmm.sddmm_masked(x, gy, mask)
    assert torch.all(bad[mask == 0] == 0)
    assert not torch.isfinite(bad[mask == 1]).any()


@pytest.mark.parametrize("kind,m,d_in,d_out", [
    ("mm", 1, 800, 300), ("mm", 50, 800, 300), ("mm_t", 50, 800, 300),
    ("mm", 4, 2048, 8192), ("mm", 2048, 800, 300), ("mm", 2048, 256, 512),
    ("sddmm", 50, 800, 300),
    ("sddmm", 2048, 2048, 2048)])
def test_masked_f32_bodies_replay_equal_eager_calls(cuda_device, kind, m,
                                                   d_in, d_out):
    """A CUDA-graph replay of each f32 body (simt_small_m with and without
    its cluster split, simt_f32 with and without one, the SDDMM at a small
    tile and at 128 x 128) equals the eager call bit for bit: the bodies
    keep no state between calls and add their split partials in a fixed
    order."""
    mask, _, x, w, gy, b = _mm_case(m, d_in, d_out, cuda_device,
                                    torch.float32, seed=3,
                                    nb=10 if d_in == 800 else 8)
    run = {"mm": lambda: tmm.masked_matmul(x, w, mask, b, activation="relu"),
           "mm_t": lambda: tmm.masked_matmul(gy, w, mask, transpose_rhs=True),
           "sddmm": lambda: tmm.sddmm_masked(x, gy, mask)}[kind]
    eager = run()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize(cuda_device)
        assert torch.equal(captured, eager)


def test_masked_training_step_kernel_route_equals_plain(cuda_device):
    """One masked-dense train step of the smoke model on the card, through
    the kernels and through the plain versions: the same loss and grads
    within the f32 tolerance, all three masked kernels launched on the
    kernel route and none on the plain route."""
    _train_step_routes(cuda_device, "masked_dense",
                       ("masked_matmul", "masked_matmul_t", "sddmm_masked"))


def test_packed_training_step_kernel_route_equals_plain(cuda_device):
    """The same in packed mode: the forward and ``dx`` of every compressed
    linear run the bdmm kernel (general grid, 64 tokens)."""
    _train_step_routes(cuda_device, "packed", ("bdmm",))


def test_fused_packed_training_step_kernel_route_equals_plain(cuda_device):
    """The perm-fused packed model: every FFN's forward one fused_ffn
    launch under grad, its backward bdmm launches (the recomputed
    pre-activations, then dh and dx with transposed blocks)."""
    _train_step_routes(cuda_device, "packed", ("fused_ffn", "bdmm"),
                       mpd_fuse=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_grad_launches_the_kernels(cuda_device, dtype):
    """Under grad, ``ops.fused_ffn`` on the card is one fused_ffn launch
    forward; its backward is five bdmm launches (z_u and z_g recomputed,
    then dh, and dx through up and gate, those three transposed) and no
    fused launch. At f32 the grads equal the plain route's within the
    bdmm tolerance; at bf16, whose recomputed hidden may differ from the
    plain one's by an ulp where the sums round differently, each grad
    within 2e-2 of the plain one in norm."""
    a = _ffn_case(cuda_device, 96, 4, 64, 256, 64, dtype, False, True, True,
                  seed=3)
    names = ("x", "w_up", "w_gate", "w_down", "b_up", "b_gate", "b_down")
    cot = torch.randn(96, 4 * 64, device=cuda_device).to(dtype)
    out = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        try:
            live = {k: a[k].detach().clone().requires_grad_(True)
                    for k in names}
            ops.reset_launch_counts()
            y = ops.fused_ffn(live["x"], live["w_up"], live["w_down"],
                              w_gate=live["w_gate"], b_up=live["b_up"],
                              b_gate=live["b_gate"], b_down=live["b_down"])
            fwd = ops.launch_counts()
            ops.reset_launch_counts()
            grads = torch.autograd.grad((y.float() * cot.float()).sum(),
                                        [live[k] for k in names])
            torch.cuda.synchronize(cuda_device)
            bwd = ops.launch_counts()
            transposed = sum(tbdmm.transposed_routes.values())
        finally:
            ops.set_backend("cuda")
        if backend == "cuda":
            assert fwd["fused_ffn"] == 1 and fwd["bdmm"] == 0
            assert bwd["fused_ffn"] == 0 and bwd["bdmm"] == 5
            assert transposed == 3
        else:
            assert not any(fwd.values()) and not any(bwd.values())
        out[backend] = grads
    for k, got, want in zip(names, out["cuda"], out["torch"]):
        assert got.dtype == want.dtype == dtype, k
        if dtype == torch.float32:
            _close(got, want, dtype)
        else:
            diff = (got.float() - want.float()).norm()
            assert bool(torch.isfinite(got).all()), k
            assert float(diff) <= 2e-2 * float(want.float().norm()), k


def _train_step_routes(cuda_device, mode, kernels, **over):
    from repro_torch.configs.common import get_config
    from repro_torch.models import build

    model = build(get_config("olmo-1b", smoke=True, mpd_mode=mode, **over))
    params = model.init(0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    toks = torch.randint(0, 96, (2, 33), generator=g, device=cuda_device)
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    _grads_agree_across_routes(lambda p: model.train_loss(p, batch), params,
                               kernels)


def _grads_agree_across_routes(loss_fn, params, kernels):
    """``loss_fn(params)`` and its gradients through the kernels and
    through the plain versions: the same within the f32 tolerance, every
    kernel of ``kernels`` launched on the kernel route, none on the plain
    route."""
    from repro_torch import tree as tree_lib

    out = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            live = [p.detach().requires_grad_(True)
                    for p in tree_lib.leaves(params)]
            loss = loss_fn(tree_lib.unflatten(params, live))
            out[backend] = (loss, torch.autograd.grad(loss, live))
        finally:
            ops.set_backend("cuda")
        counts = ops.launch_counts()
        if backend == "cuda":
            assert all(counts[k] > 0 for k in kernels), counts
        else:
            assert not any(counts.values()), counts
    torch.testing.assert_close(out["cuda"][0], out["torch"][0], atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=1e-4)


# LeNet-300-100's packed blocks under uniform(c, min_block=1): c = 10 (and
# 16), c = 4, c = 8; the heads' bo of 1, 2 and 5 make the transposed form
# reduce over K = 1, 2 or 5, and rows of 30, 75 or 5 floats are no multiple
# of 16 bytes
LENET_BLOCKS = [(s.mask.nb, s.mask.block_in, s.mask.block_out)
                for c in (10, 4, 8)
                for s in LeNet300(policy=uniform(c, min_block=1)).specs]


@pytest.mark.parametrize("m,transpose,route", [
    (1, False, "decode_simt"), (50, False, "simt_small"),
    (50, True, "simt_small"), (2048, False, "simt_small")],
    ids=["b1", "b50", "b50-dx", "b2048"])
@pytest.mark.parametrize("blocks", LENET_BLOCKS,
                         ids=lambda b: "x".join(map(str, b)))
def test_bdmm_f32_at_lenet_blocks(cuda_device, blocks, m, transpose, route):
    """bdmm on f32 blocks at every LeNet block shape, in the paper path's
    roles (batch-1 inference on the decode grid, a training batch forward
    and dx, the 2048-sample eval), with the packed bias on the forward:
    the SIMT body the plan names ran and the f32 tolerance holds."""
    nb, bi, bo = blocks
    g = torch.Generator(device=cuda_device).manual_seed(nb * bi + bo)
    k, n = (bo, bi) if transpose else (bi, bo)
    x = torch.randn((m, nb * k), generator=g, device=cuda_device)
    w = torch.randn((nb, bi, bo), generator=g, device=cuda_device) * k ** -0.5
    b = None if transpose else torch.randn((nb * n,), generator=g,
                                           device=cuda_device)
    before, t_before = dict(tbdmm.routes), dict(tbdmm.transposed_routes)
    got = tbdmm.bdmm(x, w, b, transpose=transpose)
    assert {r: tbdmm.routes[r] - before[r] for r in before} == {
        r: int(r == route) for r in before}
    assert {r: tbdmm.transposed_routes[r] - t_before[r] for r in t_before} == {
        r: int(transpose and r == route) for r in t_before}
    want = (tref.bdmm_t_ref(x, w) if transpose else tref.bdmm_ref(x, w, b))
    _close(got, want, torch.float32)


@pytest.mark.parametrize("mode,kernels", [
    ("packed", ("bdmm",)),
    ("masked_dense", ("masked_matmul", "masked_matmul_t", "sddmm_masked"))])
def test_lenet_step_kernel_route_equals_plain(cuda_device, mode, kernels):
    """One f32 step of LeNet-300-100 at c = 10 on a TeacherStudent batch of
    50: loss and grads through the kernels equal the plain versions'."""
    from repro_torch.data import TeacherStudent

    model = LeNet300(policy=uniform(10, min_block=1), mode=mode)
    params = model.init(0, device=cuda_device)
    b = TeacherStudent(seed=0).next()
    batch = {"inputs": torch.from_numpy(b["inputs"]).to(cuda_device),
             "labels": torch.from_numpy(b["labels"]).to(cuda_device,
                                                        torch.long)}
    _grads_agree_across_routes(lambda p: model.loss(p, batch), params,
                               kernels)


# ------------------------------------------------------------ paged attention
def _pool_case(B, H, Kh, Dh, ps, n_pages, P, seed, dev, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    vp = rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)
    ln = rng.integers(1, P * ps + 1, size=(B,)).astype(np.int32)
    ln[0] = 1
    pool = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    for b in range(B):
        n = -(-int(ln[b]) // ps)
        bt[b, :n] = pool[b * P:b * P + n]
    t = lambda a, d=None: torch.from_numpy(a).to(dev, d)
    return t(q, dtype), t(kp, dtype), t(vp, dtype), t(bt), t(ln)


DECODE_SHAPES = [  # (B, H, Kh, Dh, page_size, n_pages, P)
    (4, 4, 4, 16, 8, 24, 5),
    (3, 8, 2, 32, 16, 20, 4),
    (4, 16, 16, 128, 16, 140, 34),     # olmo-1b heads, page 16
    (4, 32, 8, 128, 16, 140, 34),      # granite-8b: GQA 4:1, page 16
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_paged_attention_matches_plain(cuda_device, shape, dtype):
    """Ragged lengths (one of them 1), null-page entries, and NaN in the
    null page and past every length: the kernel must never read them."""
    q, kp, vp, bt, ln = _pool_case(*shape, seed=11, dev=cuda_device,
                                   dtype=dtype)
    ps = shape[4]
    f32 = [t.float() for t in (q, kp, vp)]
    plain32 = lambda abs_v, lengths=ln: tref.paged_attention_ref(
        f32[0], f32[1], f32[2].abs() if abs_v else f32[2], bt, lengths)
    dropped = plain32(False, (ln - ps).clamp(min=1))
    kp[0] = vp[0] = float("nan")
    for b, L in enumerate(ln.tolist()):
        last = int(bt[b, (L - 1) // ps])
        kp[last, (L - 1) % ps + 1:] = float("nan")
        vp[last, (L - 1) % ps + 1:] = float("nan")
    got = tpa.paged_attention(q, kp, vp, bt, ln)
    assert torch.isfinite(got).all()
    assert _attn_within(got, plain32, dtype)
    assert not _attn_within(dropped, plain32, dtype)


PREFILL_SHAPES = [  # (H, Kh, Dh, page_size, n_pages, P, Tc, start, chunk_len)
    (4, 4, 16, 8, 24, 8, 16, 0, 16),
    (4, 4, 16, 8, 24, 8, 16, 16, 11),
    (8, 2, 16, 4, 32, 8, 8, 8, 5),
    (16, 16, 128, 16, 40, 16, 64, 128, 37),   # olmo-1b heads, chunk 64
    (32, 8, 128, 16, 40, 16, 64, 128, 37),    # granite-8b: GQA 4:1
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_paged_prefill_matches_plain(cuda_device, shape, dtype):
    """Start past page 0, short final chunk, NaN in every cold page."""
    H, Kh, Dh, ps, n_pages, P, Tc, start, clen = shape
    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    q = t(rng.standard_normal((Tc, H, Dh)).astype(np.float32)).to(dtype)
    kp = t(rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)).to(dtype)
    vp = t(rng.standard_normal((n_pages, ps, Kh, Dh)).astype(np.float32)).to(dtype)
    bt = t(rng.choice(np.arange(1, n_pages), size=P, replace=False)
           .astype(np.int32))
    f32 = [x.float() for x in (q, kp, vp)]
    plain32 = lambda abs_v, n=clen: tref.paged_prefill_attention_ref(
        f32[0], f32[1], f32[2].abs() if abs_v else f32[2], bt, start, n)
    dropped = plain32(False, max(clen - ps, 1))
    depth = start + clen
    n_live = -(-depth // ps)
    cold = bt[n_live:].long()
    kp[cold] = vp[cold] = float("nan")
    last = int(bt[n_live - 1])
    kp[last, (depth - 1) % ps + 1:] = vp[last, (depth - 1) % ps + 1:] = float("nan")
    got = tpp.paged_prefill_attention(q, kp, vp, bt, start, clen)
    assert torch.isfinite(got).all()
    assert _attn_within(got, plain32, dtype)
    assert not _attn_within(dropped, plain32, dtype)


# ------------------------------------------------------ speculative verify
def _verify_case(B, Tq, H, Kh, Dh, ps, P, lengths, seed, dev, dtype):
    """A window of ``Tq`` queries per row over ragged ``lengths`` (each at
    least ``Tq``), table entries past each length on the null page, and NaN
    in the null page and past every length."""
    rng = np.random.default_rng(seed)
    n_pages = B * P + 1
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    q, kp, vp = (t(f(B, Tq, H, Dh)).to(dtype),
                 t(f(n_pages, ps, Kh, Dh)).to(dtype),
                 t(f(n_pages, ps, Kh, Dh)).to(dtype))
    pool = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, P), np.int32)
    for b, L in enumerate(lengths):
        n = -(-L // ps)
        bt[b, :n] = pool[b * P:b * P + n]
    bt, ln = t(bt), t(np.asarray(lengths, np.int32))
    f32 = [x.float() for x in (q, kp, vp)]
    plain32 = lambda abs_v, lengths=ln: tref.paged_attention_verify_ref(
        f32[0], f32[1], f32[2].abs() if abs_v else f32[2], bt, lengths)
    kp[0] = vp[0] = float("nan")
    for b, L in enumerate(lengths):
        last = int(bt[b, (L - 1) // ps])
        kp[last, (L - 1) % ps + 1:] = float("nan")
        vp[last, (L - 1) % ps + 1:] = float("nan")
    return q, kp, vp, bt, ln, plain32


VERIFY_SHAPES = [  # (B, Tq, H, Kh, Dh, page_size, P, lengths)
    (4, 5, 16, 16, 128, 16, 35, [511, 530, 544, 548]),  # olmo-1b, k = 4
    (4, 1, 16, 16, 128, 16, 35, [511, 530, 544, 548]),
    (4, 2, 16, 16, 128, 16, 35, [2, 17, 300, 548]),
    (4, 5, 16, 4, 128, 16, 35, [5, 16, 250, 548]),      # GQA 4:1, two tiles
    (3, 3, 8, 2, 32, 8, 6, [3, 9, 40]),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", VERIFY_SHAPES)
def test_paged_attention_verify_matches_plain(cuda_device, shape, dtype):
    B, Tq, H, Kh, Dh, ps, P, lengths = shape
    q, kp, vp, bt, ln, plain32 = _verify_case(B, Tq, H, Kh, Dh, ps, P,
                                              lengths, 17, cuda_device, dtype)
    dropped = plain32(False, (ln - ps).clamp(min=Tq))
    before = tpa.launches["paged_attention_verify"]
    got = tpa.paged_attention_verify(q, kp, vp, bt, ln)
    assert tpa.launches["paged_attention_verify"] == before + 1
    assert torch.isfinite(got).all()
    assert _attn_within(got, plain32, dtype)
    assert not _attn_within(dropped, plain32, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_verify_one_query_is_the_decode_kernel(cuda_device,
                                                               dtype):
    """A window of one query runs the decode kernel's page loop on the same
    rows: bit for bit the same output."""
    q, kp, vp, bt, ln, _ = _verify_case(4, 1, 16, 16, 128, 16, 35,
                                        [1, 37, 300, 548], 19, cuda_device,
                                        dtype)
    got = tpa.paged_attention_verify(q, kp, vp, bt, ln)
    want = tpa.paged_attention(q[:, 0], kp, vp, bt, ln)
    assert torch.equal(got[:, 0], want)


def test_paged_attention_verify_raises_instead_of_falling_back(cuda_device):
    q, kp, vp, bt, ln, _ = _verify_case(2, 3, 4, 4, 16, 8, 3, [3, 20], 1,
                                        cuda_device, torch.float32)
    with pytest.raises(ValueError):
        tpa.paged_attention_verify(q.cpu(), kp, vp, bt, ln)
    with pytest.raises(ValueError):
        tpa.paged_attention_verify(q, kp, vp, bt[:1], ln)
    with pytest.raises(ValueError):
        tpa.paged_attention_verify(q[:, :, :3], kp, vp, bt, ln)   # H % Kh


@pytest.mark.parametrize("P", [35, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_window_query_is_the_decode_kernel_at_its_length(cuda_device,
                                                                dtype, P):
    """Query t of a window at depth L equals the decode kernel at length
    L - (Tq - 1) + t bit for bit (what keeps greedy speculative streams
    equal to non-spec ones), on a table 35 or 64 pages wide, windows inside
    a split and across a split's edge (S * 16 = 64 positions)."""
    lengths = [5, 64, 66, 548]
    q, kp, vp, bt, ln, _ = _verify_case(4, 5, 16, 16, 128, 16, 35, lengths,
                                        23, cuda_device, dtype)
    wide = torch.zeros((4, P), dtype=bt.dtype, device=cuda_device)
    wide[:, :35] = bt
    got = tpa.paged_attention_verify(q, kp, vp, wide, ln)
    assert torch.equal(got, tpa.paged_attention_verify(q, kp, vp, bt, ln))
    for t in range(5):
        want = tpa.paged_attention(q[:, t].contiguous(), kp, vp, wide,
                                   ln - 4 + t)
        assert torch.equal(got[:, t], want), t


@pytest.mark.parametrize("Tq", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_across_a_split_edge(cuda_device, dtype, Tq):
    """Depths of 1 and S * 16 - 1, S * 16, S * 16 + 1 positions: the last
    split of a row empty, full, or holding one position."""
    lengths = [max(Tq, 1), 63, 64, 65]
    q, kp, vp, bt, ln, plain32 = _verify_case(4, Tq, 16, 16, 128, 16, 8,
                                              lengths, 29, cuda_device, dtype)
    got = (tpa.paged_attention_verify(q, kp, vp, bt, ln) if Tq > 1 else
           tpa.paged_attention(q[:, 0].contiguous(), kp, vp, bt, ln)[:, None])
    assert torch.isfinite(got).all()
    assert _attn_within(got, plain32, dtype)
    assert not _attn_within(plain32(False, (ln - 16).clamp(min=Tq)), plain32,
                            dtype)


def _prefill_case(H, Kh, Tc, start, clen, seed, dev, dtype, ps=16, Dh=128):
    """One request's chunk over a table of the engine's ladder width, its
    entries past the depth on the null page; NaN there and past the
    depth."""
    rng = np.random.default_rng(seed)
    P = 1 << (-(-(start + Tc) // ps) - 1).bit_length()
    n_pages = P + 8
    t = lambda a: torch.from_numpy(a).to(dev)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q = t(f(Tc, H, Dh)).to(dtype)
    kp, vp = t(f(n_pages, ps, Kh, Dh)).to(dtype), t(f(n_pages, ps, Kh, Dh)).to(dtype)
    bt = t(rng.choice(np.arange(1, n_pages), size=P, replace=False)
           .astype(np.int32))
    depth = start + clen
    n_live = -(-depth // ps)
    bt[n_live:] = 0
    f32 = [x.float() for x in (q, kp, vp)]
    plain32 = lambda abs_v, n=clen: tref.paged_prefill_attention_ref(
        f32[0], f32[1], f32[2].abs() if abs_v else f32[2], bt, start, n)
    kp[0] = vp[0] = float("nan")                  # every cold entry's page
    last = int(bt[n_live - 1])
    kp[last, (depth - 1) % ps + 1:] = vp[last, (depth - 1) % ps + 1:] = float("nan")
    return q, kp, vp, bt, plain32


@pytest.mark.parametrize("Kh", [16, 4])
@pytest.mark.parametrize("start,clen", [(0, 50), (128, 37), (448, 21),
                                        (448, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_at_served_starts(cuda_device, dtype, start, clen, Kh):
    """olmo-1b's chunk of 64 at starts 0, 128 and 448 (a short last chunk
    and a full one), 16 heads of 128 over 16 or 4 KV heads (GQA 4:1)."""
    q, kp, vp, bt, plain32 = _prefill_case(16, Kh, 64, start, clen, 31,
                                           cuda_device, dtype)
    got = tpp.paged_prefill_attention(q, kp, vp, bt, start, clen)
    assert torch.isfinite(got).all()
    assert _attn_within(got, plain32, dtype)
    assert not _attn_within(plain32(False, clen - 16), plain32, dtype)


@pytest.mark.parametrize("start,clen", [(0, 50), (448, 21)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_prefill_reads_its_scalars_from_the_device(cuda_device, dtype,
                                                        start, clen):
    """start and chunk_len as host ints, as the device pair (two adjacent
    int32 scalars, no copy) and as separate 0-d tensors give the same
    output bit for bit; the pair's values change under one captured launch
    without a new capture."""
    q, kp, vp, bt, _ = _prefill_case(16, 16, 64, start, clen, 43, cuda_device,
                                     dtype)
    want = tpp.paged_prefill_attention(q, kp, vp, bt, start, clen)
    info = torch.tensor([start, clen], dtype=torch.int32, device=cuda_device)
    assert tpp.chunk_info(info[0], info[1], cuda_device).data_ptr() \
        == info.data_ptr()
    assert torch.equal(tpp.paged_prefill_attention(q, kp, vp, bt, info[0],
                                                   info[1]), want)
    sep = [torch.tensor(v, device=cuda_device) for v in (start, clen)]
    assert torch.equal(tpp.paged_prefill_attention(q, kp, vp, bt, *sep), want)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        tpp.paged_prefill_attention(q, kp, vp, bt, info[0], info[1])
    torch.cuda.current_stream().wait_stream(s)
    with torch.cuda.graph(g):
        out = tpp.paged_prefill_attention(q, kp, vp, bt, info[0], info[1])
    info.copy_(torch.tensor([start, clen - 5], dtype=torch.int32))
    g.replay()
    assert torch.equal(out, tpp.paged_prefill_attention(q, kp, vp, bt, start,
                                                        clen - 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_route_tally(cuda_device, dtype):
    """All three kernels run the split-KV scheme, on the tensor-core body at
    bf16 and on the SIMT body at f32."""
    q, kp, vp, bt, ln, _ = _verify_case(4, 5, 16, 16, 128, 16, 35,
                                        [5, 64, 300, 548], 37, cuda_device,
                                        dtype)
    ops.reset_launch_counts()
    tpa.paged_attention(q[:, 0].contiguous(), kp, vp, bt, ln)
    tpa.paged_attention_verify(q, kp, vp, bt, ln)
    qp, kpp, vpp, btp, _ = _prefill_case(16, 16, 64, 128, 37, 41, cuda_device,
                                         dtype)
    tpp.paged_prefill_attention(qp, kpp, vpp, btp, 128, 37)
    body = "split_tc" if dtype == torch.bfloat16 else "split_kv"
    assert tpa.routes == {"split_kv": 0, "split_tc": 0, body: 3}
    ops.reset_launch_counts()
    assert not any(tpa.routes.values())


@pytest.mark.parametrize("m", [4, 20, 64])
def test_masked_matmul_at_serving_rows(cuda_device, m):
    """A masked-dense model served: the bf16 up/gate projection with silu
    and bias at a decode step of 4 slots (m 4), a verify window of 4 x 5
    (m 20) and a prefill chunk (m 64)."""
    mask, dropped, x, w, _, b = _mm_case(m, 2048, 8192, cuda_device,
                                         torch.bfloat16, seed=m)
    got = tmm.masked_matmul(x, w, mask, b, activation="silu")
    x32, w32, b32 = x.float(), w.float(), b.float()
    want = tref.masked_matmul_ref(x32, w32, mask, b32, "silu")
    mag = x32.abs() @ (w32.abs() * mask) + b32.abs()
    assert _mm_within(got, want, mag, torch.bfloat16)
    assert not _mm_within(tref.masked_matmul_ref(x32, w32, dropped, b32,
                                                 "silu"),
                          want, mag, torch.bfloat16)


def test_spec_engine_kernel_route_equals_plain_and_non_spec(cuda_device):
    """The smoke model served with speculative decoding on the card: greedy
    streams at float32 through the kernels equal the plain route's and the
    non-spec streams, and every verify ran the verify kernel once per
    layer."""
    from repro_torch.configs.common import get_config
    from repro_torch.core.export import quantize_packed
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build
    from repro_torch.serve import Engine

    cfg = get_config("olmo-1b", smoke=True)
    model = build(cfg)
    params, _ = quantize_packed(model, model.init(0, device=cuda_device))
    kw = dict(n_slots=2, max_len=48, page_size=8, prefill_chunk_tokens=40)
    reqs = lambda: make_requests(cfg, n_requests=5, rate=1e9, prompt_len=40,
                                 gen=8, seed=3, shared_prefix=16)
    base = Engine(model, params, **kw).run(reqs())
    streams = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            eng = Engine(model, params, spec_draft=(model, params), spec_k=3,
                         graphs=None if backend == "cuda" else False, **kw)
            verifies = []
            fn = eng._verify
            eng._verify = lambda *a: (verifies.append(1), fn(*a))[1]
            streams[backend] = eng.run(reqs())
        finally:
            ops.set_backend("cuda")
        want = cfg.n_layers * len(verifies) if backend == "cuda" else 0
        assert ops.launch_counts()["paged_attention_verify"] == want
    assert streams["cuda"] == streams["torch"] == base


# -------------------------------------------------------------------- routing
def test_backend_torch_skips_kernels(cuda_device):
    x = torch.randn(4, 64, device=cuda_device)
    w = torch.randn(4, 16, 24, device=cuda_device)
    ops.reset_launch_counts()
    ops.set_backend("torch")
    try:
        plain = ops.bdmm(x, w)
    finally:
        ops.set_backend("cuda")
    assert ops.launch_counts()["bdmm_decode"] == 0
    kern = ops.bdmm(x, w)
    assert ops.launch_counts()["bdmm_decode"] == 1
    torch.testing.assert_close(kern, plain, atol=1e-4, rtol=1e-4)


def test_engine_kernel_route_equals_plain_route(cuda_device):
    """The smoke model served on the card through the kernels and through
    the plain versions gives the same greedy streams at float32, and the
    kernel run launched every serving kernel."""
    from repro_torch.configs.common import get_config
    from repro_torch.core.export import quantize_packed
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build
    from repro_torch.serve import Engine

    cfg = get_config("olmo-1b", smoke=True)
    model = build(cfg)
    params, _ = quantize_packed(model, model.init(0, device=cuda_device))
    streams = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            reqs = make_requests(cfg, n_requests=5, rate=1e9, prompt_len=40,
                                 gen=8, seed=3, shared_prefix=16)
            # chunks of 40 tokens take the general bdmm grid (m > 32)
            streams[backend] = Engine(
                model, params, n_slots=2, max_len=48, page_size=8,
                prefill_chunk_tokens=40,
                graphs=None if backend == "cuda" else False).run(reqs)
        finally:
            ops.set_backend("cuda")
        counts = ops.launch_counts()
        serving = ("bdmm", "bdmm_decode", "paged_attention",
                   "paged_prefill_attention")
        assert all(counts[k] > 0 for k in serving) == (backend == "cuda"), counts
    assert streams["cuda"] == streams["torch"]


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_recurrent_engine_kernel_route_equals_plain_route(cuda_device, arch,
                                                          paged):
    """The recurrent smokes (int8 packed projections, f32) served on the
    card through the kernels (captured) and through the plain versions
    (eager) give the same greedy streams; the kernel run launched bdmm's
    grids (and, jamba, the paged attention kernels)."""
    from repro_torch.configs.common import get_config
    from repro_torch.core.export import quantize_packed
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build
    from repro_torch.serve import Engine

    cfg = get_config(arch, smoke=True)
    model = build(cfg)
    params, _ = quantize_packed(model, model.init(0, device=cuda_device))
    streams = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            reqs = make_requests(cfg, n_requests=5, rate=1e9, prompt_len=40,
                                 gen=8, seed=3, shared_prefix=16)
            streams[backend] = Engine(
                model, params, n_slots=2, max_len=48, page_size=8,
                prefill_chunk_tokens=40, paged=paged,
                graphs=None if backend == "cuda" else False).run(reqs)
        finally:
            ops.set_backend("cuda")
        counts = ops.launch_counts()
        kernels = ["bdmm", "bdmm_decode"]
        if paged and arch.startswith("jamba"):
            kernels += ["paged_attention", "paged_prefill_attention"]
        assert all(counts[k] > 0 for k in kernels) == (backend == "cuda"), \
            counts
    assert streams["cuda"] == streams["torch"]


# ------------------------------------------------------------- fused MLP
ACT_SLOPE = 1.2           # >= max |act'| of silu (1.1), gelu (1.13), relu


def _ffn_case(dev, m, nb, bi, f, bo, dtype, quant, gated, bias, seed):
    """Inputs at ``dtype``; int8 weights with their scales when ``quant``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x = r(m, nb * bi).to(dtype)
    ws = {"w_up": r(nb, bi, f) * bi ** -0.5, "w_down": r(nb, f, bo) * f ** -0.5}
    if gated:
        ws["w_gate"] = r(nb, bi, f) * bi ** -0.5
    a = {"x": x}
    for k, w in ws.items():
        if quant:
            a[k], a["s_" + k[2:]] = quantize_blocks(w)
        else:
            a[k] = w.to(dtype)
    if bias:
        a["b_up"] = (0.1 * r(nb * f)).to(dtype)
        a["b_down"] = (0.1 * r(nb * bo)).to(dtype)
        if gated:
            a["b_gate"] = (0.1 * r(nb * f)).to(dtype)
    return a


def _ffn_plain32(a, act, w_down=None):
    """The plain fused MLP in f32 on the same values: ``(y, |y| bound of
    the summation-order error)``; ``w_down`` replaces the down weight."""
    f32 = {k: v.float() if v.dtype != torch.int8 else v for k, v in a.items()}
    wd = f32["w_down"] if w_down is None else w_down
    quant = a["w_up"].dtype == torch.int8

    def proj(x, w, s, b, absolute=False):
        if absolute:
            x, w = x.abs(), w.abs()
            b = None if b is None else b.abs()
        if quant:
            return tref.bdmm_quant_ref(x, w, s, b)
        return tref.bdmm_ref(x, w.float(), b)
    x = f32["x"]
    u = proj(x, f32["w_up"], f32.get("s_up"), f32.get("b_up"))
    ua = proj(x, f32["w_up"], f32.get("s_up"), f32.get("b_up"), True)
    fn = tref.ACTIVATIONS[act]
    if "w_gate" in a:
        gt = proj(x, f32["w_gate"], f32.get("s_gate"), f32.get("b_gate"))
        ga = proj(x, f32["w_gate"], f32.get("s_gate"), f32.get("b_gate"), True)
        h = fn(gt) * u
        dh = fn(gt).abs() * ua + ACT_SLOPE * u.abs() * ga
    else:
        h = fn(u)
        dh = ACT_SLOPE * ua
    y = proj(h, wd, f32.get("s_down"), f32.get("b_down"))
    mag = proj(h.abs() + dh, wd, f32.get("s_down"), f32.get("b_down"), True)
    return y, mag


def _ffn_within(got, want32, mag, dtype):
    u_out = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -16
    lim = 2e-5 + u_out * want32.abs() + 2.0 ** -16 * mag
    return bool(torch.isfinite(got).all()) and bool(
        ((got.float() - want32).abs() <= lim).all())


# (m, nb, bi, f, bo): decode and a prefill chunk at olmo-1b's width, then
# every edge ragged (m, bi, f and bo against the 4..64-row, 32-deep, 64-f
# and 256-column tiles; f = 200 splits into 4 tiles, the last partial), and
# bi 320, deeper than the tensor-core body keeps resident (its K ring
# turns). Above 64 rows the tc_tall body: a training batch and the dense
# engine's top admission bucket at olmo-1b's width, ragged edges against
# its 128-row tiles (bo 300: rows TMA refuses), bi 320 past its resident x,
# and olmo-1b's width at mpd_c=4 (bi 512, bo 512: two column chunks)
FFN_SHAPES = [(4, 8, 256, 1024, 256), (64, 8, 256, 1024, 256),
              (1, 2, 40, 200, 24), (37, 3, 72, 200, 300), (100, 2, 64, 130, 20),
              (20, 2, 320, 200, 24), (2048, 8, 256, 1024, 256),
              (544, 8, 256, 1024, 256), (200, 3, 72, 200, 300),
              (129, 2, 320, 200, 24), (512, 4, 512, 2048, 512)]


@pytest.mark.parametrize("act,gated,bias", [("silu", True, False),
                                            ("gelu", False, True),
                                            ("silu", True, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("shape", FFN_SHAPES)
def test_fused_ffn_matches_plain(cuda_device, shape, quant, dtype, act, gated,
                                 bias):
    _check_fused_ffn(cuda_device, shape, quant, dtype, act, gated, bias)


def _check_fused_ffn(dev, shape, quant, dtype, act, gated, bias):
    """One launch of the body the plan names, within the fused rule of the
    plain version in f32, which rejects w_down's first f tile zeroed; a
    rerun equal bit for bit."""
    m, nb, bi, f, bo = shape
    a = _ffn_case(dev, m, nb, bi, f, bo, dtype, quant, gated, bias,
                  seed=m + f)
    before, routes = tffn.launches["fused_ffn"], dict(tffn.routes)
    got = tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                         a.get("b_up"), a.get("b_gate"), a.get("b_down"),
                         a.get("s_up"), a.get("s_gate"), a.get("s_down"),
                         activation=act)
    assert tffn.launches["fused_ffn"] == before + 1
    body = tffn.plan(m, nb, f, bo, _sm_count(dev), dtype).route
    assert {r: tffn.routes[r] - routes[r] for r in routes} == {
        r: int(r == body) for r in routes}
    assert got.dtype == dtype and got.shape == (m, nb * bo)
    want, mag = _ffn_plain32(a, act)
    assert _ffn_within(got, want, mag, dtype)
    wd = a["w_down"].clone()
    wd[:, :tffn.F_TILE] = 0
    dropped, _ = _ffn_plain32(a, act, w_down=wd if quant else wd.float())
    assert not _ffn_within(dropped, want, mag, dtype)
    # the split-f reduction runs in a fixed order: bit-identical reruns
    again = tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                           a.get("b_up"), a.get("b_gate"), a.get("b_down"),
                           a.get("s_up"), a.get("s_gate"), a.get("s_down"),
                           activation=act)
    assert torch.equal(got, again)


# f32 x on both SIMT bodies at ragged f (1000) and bo (300): simt_small at
# a 37-row chunk, simt_tall with its f split over a cluster at 65, 200 and
# 544 rows
F32_FFN_SHAPES = [(37, 8, 256, 1000, 300), (65, 8, 256, 1000, 300),
                  (200, 8, 256, 1000, 300), (544, 8, 256, 1000, 300)]


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("act", [None, "silu", "gelu", "relu"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("shape", F32_FFN_SHAPES)
def test_fused_ffn_f32_bodies_match_plain(cuda_device, shape, quant, act,
                                          gated, bias):
    """Every activation code, gated and plain, with and without biases, fp
    and int8 weights, on the f32 SIMT bodies: the checks of
    test_fused_ffn_matches_plain."""
    _check_fused_ffn(cuda_device, shape, quant, torch.float32, act, gated,
                     bias)


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_fused_ffn_tall_split_equals_one_split(cuda_device, quant, gated):
    """The tc_tall body with its f split over a cluster (m = 512 at
    olmo-1b's width: 4 blocks of 4 f tiles) against the same call forced to
    one block of all 16 tiles: both within the bf16 rule of the plain
    version in f32."""
    a = _ffn_case(cuda_device, 512, 8, 256, 1024, 256, torch.bfloat16, quant,
                  gated, True, seed=11)
    act = "silu" if gated else "gelu"
    p = tffn.plan(512, 8, 1024, 256, _sm_count(cuda_device))
    assert p.route == "tc_tall" and p.split > 1

    def run(force=None):
        return tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                              a.get("b_up"), a.get("b_gate"), a.get("b_down"),
                              a.get("s_up"), a.get("s_gate"), a.get("s_down"),
                              activation=act, force=force)
    split = run()
    one = run(tffn.Plan("tc_tall", tffn.TALL_ROWS, 1, 16))
    want, mag = _ffn_plain32(a, act)
    assert _ffn_within(split, want, mag, torch.bfloat16)
    assert _ffn_within(one, want, mag, torch.bfloat16)


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_fused_ffn_f32_tall_split_equals_one_split(cuda_device, quant, gated):
    """simt_tall with its f split over a cluster (m = 544 at olmo-1b's
    width: on the H100 8 blocks of 2 f tiles, added in rank order) against
    the same call forced to one block of all 16 tiles: both within the f32
    rule of the plain version, and within 2^-20 (|h| + dh) @ |Wd| + 1e-6
    of each other (the two orders round the three partials' sum, a few f32
    ulps of the magnitude, nothing more)."""
    a = _ffn_case(cuda_device, 544, 8, 256, 1024, 256, torch.float32, quant,
                  gated, True, seed=12)
    act = "silu" if gated else "gelu"
    p = tffn.device_plan(544, 8, 1024, 256, cuda_device, torch.float32, quant)
    assert p.route == "simt_tall" and p.split > 1

    def run(force=None):
        return tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                              a.get("b_up"), a.get("b_gate"), a.get("b_down"),
                              a.get("s_up"), a.get("s_gate"), a.get("s_down"),
                              activation=act, force=force)
    split = run()
    one = run(tffn.Plan("simt_tall", tffn.TALL_ROWS, 1, 16))
    want, mag = _ffn_plain32(a, act)
    assert _ffn_within(split, want, mag, torch.float32)
    assert _ffn_within(one, want, mag, torch.float32)
    assert bool(((split - one).abs() <= 2.0 ** -20 * mag + 1e-6).all())


@pytest.mark.parametrize("m", [4, 64, 544, 2048])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_fused_ffn_f32_replay_equals_eager(cuda_device, quant, m):
    """A CUDA-graph replay of each f32 body (simt_small at decode and one
    chunk, simt_tall with a split at 544 rows and none at 2048)
    equals the eager call bit for bit: no workspace, no ticket, no float
    atomics."""
    a = _ffn_case(cuda_device, m, 8, 256, 1024, 256, torch.float32, quant,
                  True, True, seed=13)

    def run():
        return tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                              a.get("b_up"), a.get("b_gate"), a.get("b_down"),
                              a.get("s_up"), a.get("s_gate"), a.get("s_down"))
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    before = dict(tffn.routes)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert tffn.routes == before          # a replay launches nothing new


@pytest.mark.parametrize("m", [4, 64, 544])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_fused_ffn_old_simt_f32_body_forced_matches_plain(cuda_device, quant,
                                                          m):
    """The first f32 body stays reachable through ``force`` (its plan,
    ``simt_f32_plan``: a 16-way split through the workspace at m <= 64),
    launches simt_f32 alone and holds the f32 rule."""
    a = _ffn_case(cuda_device, m, 8, 256, 1024, 256, torch.float32, quant,
                  True, True, seed=14)
    old = tffn.simt_f32_plan(m, 8, 1024, 256, _sm_count(cuda_device))
    before = dict(tffn.routes)
    got = tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a.get("w_gate"),
                         a.get("b_up"), a.get("b_gate"), a.get("b_down"),
                         a.get("s_up"), a.get("s_gate"), a.get("s_down"),
                         force=old)
    assert {r: tffn.routes[r] - before[r] for r in before} == {
        r: int(r == "simt_f32") for r in before}
    want, mag = _ffn_plain32(a, "silu")
    assert _ffn_within(got, want, mag, torch.float32)


@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_fused_ffn_rows_do_not_depend_on_the_chunk(cuda_device, quant, dtype,
                                                  gated):
    """A token's output does not change with the chunk it rides in: the
    rows of an m = 4 call (a decode step) equal the same tokens inside an m
    = 64 call (a prefill chunk), and those of m = 37, bit for bit, at
    olmo-1b's width."""
    a = _ffn_case(cuda_device, 64, 8, 256, 1024, 256, dtype, quant, gated,
                  True, seed=9)
    act = "silu" if gated else "gelu"

    def run(rows):
        return tffn.fused_ffn(a["x"][rows], a["w_up"], a["w_down"],
                              a.get("w_gate"), a.get("b_up"), a.get("b_gate"),
                              a.get("b_down"), a.get("s_up"), a.get("s_gate"),
                              a.get("s_down"), activation=act)
    full = run(slice(0, 64))
    assert torch.equal(run(slice(0, 4)), full[:4])
    assert torch.equal(run(slice(16, 20)), full[16:20])
    assert torch.equal(run(slice(0, 37)), full[:37])


def test_fused_ffn_raises_instead_of_falling_back(cuda_device):
    a = _ffn_case(cuda_device, 4, 2, 16, 32, 8, torch.float32, False, True,
                  False, 0)
    with pytest.raises(ValueError):
        tffn.fused_ffn(a["x"].cpu(), a["w_up"], a["w_down"], a["w_gate"])
    with pytest.raises(ValueError):
        tffn.fused_ffn(a["x"], a["w_up"].bfloat16(), a["w_down"], a["w_gate"])
    with pytest.raises(ValueError):
        tffn.fused_ffn(a["x"], a["w_up"], a["w_down"], a["w_gate"],
                       activation="sigmoid")
    with pytest.raises(ValueError):
        tffn.fused_ffn(a["x"], a["w_up"].transpose(1, 2).contiguous()
                       .transpose(1, 2), a["w_down"], a["w_gate"])
    # the f32 bodies refuse what they were not built for: bf16 x, a row
    # tile of the other body, a split past one cluster or with an empty block
    run = lambda x, p: tffn.fused_ffn(  # noqa: E731
        x, a["w_up"].to(x.dtype), a["w_down"].to(x.dtype),
        a["w_gate"].to(x.dtype), force=p)
    for x, p in ((a["x"].bfloat16(), tffn.Plan("simt_small", 4, 1, 1)),
                 (a["x"], tffn.Plan("simt_small", tffn.TALL_ROWS, 1, 1)),
                 (a["x"], tffn.Plan("simt_tall", 64, 1, 1)),
                 (a["x"], tffn.Plan("simt_small", 4, 2, 1)),
                 (a["x"].bfloat16(), tffn.Plan("simt_tall", 128, 1, 1))):
        with pytest.raises(tffn._build.KernelError):
            run(x, p)
    q = _ffn_case(cuda_device, 4, 2, 16, 32, 8, torch.float32, True, True,
                  False, 0)
    with pytest.raises(ValueError, match="s_up"):
        tffn.fused_ffn(q["x"], q["w_up"], q["w_down"], q["w_gate"])
    # under grad the autograd rule's forward launches the kernel, which
    # raises on mixed devices as well: no plain fallback
    with pytest.raises(ValueError):
        ops.fused_ffn(a["x"].cpu().requires_grad_(True), a["w_up"],
                      a["w_down"], w_gate=a["w_gate"])
    with pytest.raises(NotImplementedError, match="autograd"):
        ops.fused_ffn_quant(a["x"].requires_grad_(True), q["w_up"],
                            q["w_down"], w_gate=q["w_gate"], s_up=q["s_up"],
                            s_gate=q["s_gate"], s_down=q["s_down"])


def test_fused_model_engine_kernel_route_equals_plain_route(cuda_device):
    """A perm-fused int8 smoke model served on the card: every FFN is one
    fused_ffn launch per model call, and the greedy streams at float32 equal
    the plain route's."""
    from repro_torch.configs.common import get_config
    from repro_torch.core.export import quantize_packed
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import build
    from repro_torch.serve import Engine

    cfg = get_config("olmo-1b", smoke=True, mpd_fuse=True)
    model = build(cfg)
    params, _ = quantize_packed(model, model.init(0, device=cuda_device))
    streams = {}
    for backend in ("cuda", "torch"):
        ops.set_backend(backend)
        ops.reset_launch_counts()
        try:
            reqs = make_requests(cfg, n_requests=5, rate=1e9, prompt_len=40,
                                 gen=8, seed=3, shared_prefix=16)
            eng = Engine(model, params, n_slots=2, max_len=48, page_size=8,
                         prefill_chunk_tokens=40,
                         graphs=None if backend == "cuda" else False)
            streams[backend] = eng.run(reqs)
        finally:
            ops.set_backend("cuda")
        # model calls: the engine's program runs (eager calls or replays)
        calls = sum(eng.runs.values())
        want = cfg.n_layers * calls if backend == "cuda" else 0
        assert calls > 0 and ops.launch_counts()["fused_ffn"] == want
    assert streams["cuda"] == streams["torch"]



# ------------------------------------------------- captured serving steps
GRAPH_KW = dict(n_slots=2, max_len=48, page_size=8, prefill_chunk_tokens=16)


def _graph_model(dev, dtype):
    from repro_torch.configs.common import get_config
    from repro_torch.core.export import quantize_packed
    from repro_torch.models import build

    cfg = get_config("olmo-1b", smoke=True,
                     dtype="float32" if dtype == torch.float32 else "bfloat16")
    model = build(cfg)
    params, _ = quantize_packed(model, model.init(0, device=dev))
    return cfg, model, params


def _graph_requests(cfg, n=5, seed=3):
    from repro_torch.launch.serve import make_requests
    return make_requests(cfg, n_requests=n, rate=1e9, prompt_len=40, gen=8,
                         seed=seed, shared_prefix=16)


def _graph_engine(dev, dtype, spec=True, graphs=None):
    from repro_torch.serve import Engine
    cfg, model, params = _graph_model(dev, dtype)
    kw = dict(GRAPH_KW, graphs=graphs)
    if spec:
        kw.update(spec_draft=(model, params), spec_k=3)
    return cfg, Engine(model, params, **kw)


def _pools(eng):
    caches = eng.cache.caches + (eng.draft_cache.caches if eng.spec_active
                                 else [])
    return [t for c in caches for t in c.values()]


def _random_inputs(eng, kind, w, gen):
    """Real-looking inputs for program ``kind`` at ``w``: tables and rows of
    real pages, every row live, depths inside the table."""
    dev, B, ps = eng.device, eng.n_slots, eng.cache.page_size
    rand = lambda lo, hi, *shape: torch.randint(  # noqa: E731
        lo, hi, shape, generator=gen, device=dev)
    n_pages, vocab = eng.cache.n_pages, eng.model.cfg.vocab
    # distinct pages: two writes to one page and offset land in no set order
    pages = lambda n: torch.randperm(  # noqa: E731
        n_pages - 1, generator=gen, device=dev)[:n].int() + 1
    for draft in (False, True) if eng.spec_active else (False,):
        eng._block_tables_dev(w, draft).copy_(pages(B * w).reshape(B, w))
        eng._row(w, draft).copy_(pages(w))
    eng._live_dev.fill_(True)
    eng._tokens.copy_(rand(0, vocab, B))
    if eng.spec_active:
        k = eng.spec_k
        eng._pos0.copy_(rand(0, max(w * ps - k, 1), B))
        eng._draft_in.copy_(rand(0, vocab, B))
        eng._window.copy_(rand(0, vocab, B, k + 1))
    for t in _pools(eng):
        if t.dim() == 2:                    # pos (n_periods, n_slots)
            t.copy_(rand(0, w * ps, *t.shape))
    tc = eng.chunk_tokens
    start = ps * int(rand(0, max(w - tc // ps, 0) + 1, 1))
    eng._chunk_info.copy_(torch.stack([rand(0, B, 1)[0],
                                       torch.tensor(start, device=dev),
                                       rand(1, tc + 1, 1)[0]]).int())


def _replay_equals_eager(eng, kind, w):
    pools = _pools(eng)
    before = [t.clone() for t in pools]
    with torch.no_grad():
        want = eng._program(kind, w)()
    want = None if want is None else want.clone()
    eager = [t.clone() for t in pools]
    for t, b in zip(pools, before):
        t.copy_(b)
    got = eng._graph(kind, w).replay()
    torch.cuda.synchronize()
    same = (got is None) == (want is None) and (
        want is None or torch.equal(got, want))
    return same and all(torch.equal(t, e) for t, e in zip(pools, eager))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_programs_equal_eager_calls_at_every_rung(cuda_device, dtype):
    """Every program at every rung, replayed, gives the eager call's logits
    and pools (K/V and pos) bit for bit, on inputs of real pages."""
    cfg, eng = _graph_engine(cuda_device, dtype)
    eng.run(_graph_requests(cfg))          # pools hold real K/V
    eng.warmup()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for w in eng.decode_widths():
        for kind in ("decode", "draft_decode", "verify"):
            _random_inputs(eng, kind, w, gen)
            assert _replay_equals_eager(eng, kind, w), (kind, w)
    for w in eng.prefill_widths():
        for kind in ("chunk", "chunk_final", "draft_chunk"):
            _random_inputs(eng, kind, w, gen)
            assert _replay_equals_eager(eng, kind, w), (kind, w)


def test_replay_reads_the_pools_as_they_are(cuda_device):
    """A replay after the pools change computes on the new contents."""
    cfg, eng = _graph_engine(cuda_device, torch.bfloat16, spec=False)
    eng.run(_graph_requests(cfg))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    w = 4
    _random_inputs(eng, "decode", w, gen)
    pos = [c["pos"].clone() for c in eng.cache.caches]
    first = eng._graph("decode", w).replay().clone()
    for c, p in zip(eng.cache.caches, pos):
        c["pos"].copy_(p)
        c["kp"][1:].mul_(0.5)
        c["vp"][1:].neg_()
    assert _replay_equals_eager(eng, "decode", w)
    for c, p in zip(eng.cache.caches, pos):
        c["pos"].copy_(p)
    assert not torch.equal(eng._graph("decode", w).replay(), first)


@pytest.mark.parametrize("spec", [False, True], ids=["decode", "spec"])
def test_warmup_leaves_the_engine_state_untouched(cuda_device, spec):
    """warmup() in the middle of serving (slots live, one mid-prefill)
    changes no real page, no pos and no pending token, and the streams
    stay those of an engine that never captured."""
    cfg, eng = _graph_engine(cuda_device, torch.bfloat16, spec=spec)
    _, eager = _graph_engine(cuda_device, torch.bfloat16, spec=spec,
                             graphs=False)
    streams, steps = [], 0
    for e in (eng, eager):
        reqs = _graph_requests(cfg, n=4, seed=5)
        for r in reqs:
            e.submit(r)
        if e is eng:
            while not (eng._prefill_queue and eng._live.any()):
                eng.step()
                steps += 1
                assert steps < 50
            state = [t.clone() for t in _pools(eng)] + [eng._tokens.clone()]
            eng.warmup()
            for a, b in zip(state, _pools(eng) + [eng._tokens]):
                assert torch.equal(a[:, 1:], b[:, 1:]) if a.dim() == 5 \
                    else torch.equal(a, b)
        else:
            for _ in range(steps):
                e.step()
        while e.has_work():
            e.step()
        streams.append({r.id: list(r.generated) for r in reqs})
    assert streams[0] == streams[1]


def _static_addresses(eng):
    named = {"tokens": eng._tokens, "live": eng._live_dev,
             "chunk_toks": eng._chunk_toks, "chunk_info": eng._chunk_info}
    named.update({("table", *k): v for k, v in eng._tables.items()})
    named.update({("row", *k): v for k, v in eng._rows.items()})
    if eng.spec_active:
        named.update(pos0=eng._pos0, draft_in=eng._draft_in,
                     window=eng._window)
    return {k: v.data_ptr() for k, v in named.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spec", [False, True], ids=["decode", "spec"])
def test_captured_serving_counts_equal_eager(cuda_device, spec, dtype):
    """The same traffic served captured (after warmup) and eagerly: the
    same streams, program runs, launch counts and route tallies; serving
    captures nothing new, and params, pools and static inputs keep their
    addresses."""
    from repro_torch import tree as tree_lib
    results = []
    for graphs in (True, False):
        cfg, eng = _graph_engine(cuda_device, dtype, spec=spec, graphs=graphs)
        eng.warmup()
        n = eng.n_captures
        assert (n > 0) == graphs
        held = lambda: [t.data_ptr() for t in (  # noqa: E731
            *tree_lib.leaves(eng.params), *_pools(eng))]
        addrs, statics = held(), _static_addresses(eng)
        ops.reset_launch_counts()
        streams = eng.run(_graph_requests(cfg, n=6, seed=7))
        torch.cuda.synchronize()
        assert eng.n_captures == n
        assert held() == addrs
        now = _static_addresses(eng)
        assert {k: now[k] for k in statics} == statics
        assert not graphs or now == statics
        results.append((streams, dict(eng.runs),
                        [dict(d) for d in ops.counters()]))
    assert results[0] == results[1]
    assert sum(results[0][2][0].values()) > 0


# ------------------------------------------------------ slot-dense serving
DENSE_KW = dict(n_slots=2, max_len=48, paged=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_engine_captured_equals_eager(cuda_device, dtype):
    """The slot-dense engine captured (after ``warmup()``: the decode and
    every bucket's admission) and eager on the same traffic: the same
    streams, program runs, launch counts and route tallies; serving
    captures nothing new; bdmm's general grid and decode grid launched, no
    paged-attention kernel."""
    from repro_torch.serve import Engine
    cfg, model, params = _graph_model(cuda_device, dtype)
    results = []
    for graphs in (True, False):
        eng = Engine(model, params, graphs=graphs, **DENSE_KW)
        eng.warmup()
        n = eng.n_captures
        assert n == (1 + len(eng.scheduler.buckets) if graphs else 0)
        ops.reset_launch_counts()
        streams = eng.run(_graph_requests(cfg, n=6, seed=7))
        torch.cuda.synchronize()
        assert eng.n_captures == n
        counts = ops.launch_counts()
        assert counts["bdmm"] > 0 and counts["bdmm_decode"] > 0
        assert not any(counts[k] for k in ("paged_attention",
                                           "paged_prefill_attention",
                                           "paged_attention_verify"))
        results.append((streams, dict(eng.runs),
                        [dict(d) for d in ops.counters()]))
    assert results[0] == results[1]


def test_dense_and_paged_engines_stream_alike_on_the_kernel_route(
        cuda_device):
    """f32 greedy streams of the slot-dense and the paged engine, both
    captured on the kernel route, are identical (and the static lockstep
    greedy of each prompt alone gives them too)."""
    from repro_torch.launch.serve import static_decode
    from repro_torch.serve import Engine
    cfg, model, params = _graph_model(cuda_device, torch.float32)
    reqs = lambda: _graph_requests(cfg, n=6, seed=11)  # noqa: E731
    dense = Engine(model, params, **DENSE_KW).run(reqs())
    paged = Engine(model, params, **GRAPH_KW).run(reqs())
    assert dense == paged
    for r in reqs():
        p = torch.as_tensor(r.prompt, device=cuda_device)[None]
        out = static_decode(model, params, p, r.max_new_tokens)
        assert out["route"] == "captured"
        assert out["tokens"][0].tolist() == dense[r.id]


def test_prefill_backend_is_read_at_capture(cuda_device):
    """``set_prefill_backend`` before a capture decides the route the
    captured chunks replay on: "torch" captures the plain prefill attention
    (no kernel launch on replay), "cuda" the kernel; both stream alike at
    f32, and the route is put back."""
    cfg, model, params = _graph_model(cuda_device, torch.float32)
    from repro_torch.serve import Engine
    out = {}
    for route in ("torch", "cuda"):
        ops.set_prefill_backend(route)
        try:
            eng = Engine(model, params, **GRAPH_KW)
            eng.warmup()
        finally:
            ops.set_prefill_backend(None)
        ops.reset_launch_counts()
        out[route] = eng.run(_graph_requests(cfg, n=4, seed=5))
        torch.cuda.synchronize()
        launched = ops.launch_counts()["paged_prefill_attention"]
        assert (launched > 0) == (route == "cuda"), (route, launched)
        assert ops.launch_counts()["paged_attention"] > 0
    assert out["torch"] == out["cuda"]
    assert ops.prefill_backend() == ops.get_backend() == "cuda"


def test_duplicate_page_writes_keep_the_last_row(cuda_device):
    """Non-live rows all scatter their K/V to the null page; a CUDA
    ``index_put_`` with duplicate destinations keeps an arbitrary one, so
    the paged writes gather every duplicate's value from the last writer
    first (``attention._last_writes``): the null page then holds the last
    row's K/V on every run, as a sequential scatter leaves it."""
    from repro_torch.models import attention as tattn
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    dest = torch.tensor([0, 5, 0, 0, 5, 7, 0], device=cuda_device)
    vals = torch.randn((7, 64), generator=gen, device=cuda_device)
    last = tattn._last_writes(dest)
    assert last.tolist() == [6, 4, 6, 6, 4, 5, 6]
    for _ in range(20):
        pool = torch.zeros((8, 64), device=cuda_device)
        pool.index_put_((dest,), vals[last])
        assert torch.equal(pool[0], vals[6]) and torch.equal(pool[5], vals[4])
        assert torch.equal(pool[7], vals[5])
