"""Port parity, the recurrent families: ``repro_torch.models.rwkv.RWKVSpec``
and ``repro_torch.models.mamba.MambaSpec`` against the reference's on the
same params and inputs (numpy from a seed), the new epilogue activations,
``extra_bias``, and the recurrent models' fold and packed artifact across
the packages.

* ``time_mix`` + ``channel_mix`` and ``MambaSpec.apply`` in the dense,
  masked-dense and packed modes: over a full sequence from zeros, on a
  right-padded batch (``valid``) and from a carried state; outputs and the
  returned state within 1e-5 at float32;
* gradients of every param and of the input against ``jax.grad``;
* every entry of ``ref.ACTIVATIONS`` (sigmoid, softplus and sqrelu new)
  through the port's registry and its bdmm (fp and int8) and masked-matmul
  plain versions against ``repro.kernels.ref``, and through ``ops`` (which
  take the plain versions on the CPU);
* ``mpd.apply`` with ``extra_bias`` (Mamba's ``dt_bias``) in all three
  modes, with and without the layer's own bias;
* ``fold_model`` of masked-dense rwkv6 and jamba smokes (fp and int8)
  equals the reference's leaf for leaf, bit for bit, the raw leaves fp;
  an int8 ``export_packed`` artifact written by either package loads in
  the other, bit for bit.

Tolerance: atol 1e-5 at float32, as the other parity files: the frameworks
sum the same products in different orders.
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import common as jcommon
from repro.core import mpd as jmpd
from repro.core.policy import CompressionPolicy as JPolicy
from repro.kernels import ref as jref
from repro.kernels.quant import quantize_blocks as jquantize_blocks
from repro.models import build as jbuild
from repro.models import mamba as jmamba
from repro.models import rwkv as jrwkv
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.core import mpd as tmpd
from repro_torch.core.policy import CompressionPolicy as TPolicy
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import build as tbuild
from repro_torch.models import mamba as tmamba
from repro_torch.models import rwkv as trwkv
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
MODES = ["dense", "masked_dense", "packed"]
CASES = ["full", "valid", "carried"]
B, T = 2, 8
LENGTHS = np.array([8, 5])


def _policies(mode, min_block=8):
    # "dense": every layer unmasked (the policy plans none at c = 1)
    c = 1 if mode == "dense" else 4
    m = "packed" if mode == "dense" else mode
    return (JPolicy(c=c, mode=m, min_block=min_block),
            TPolicy(c=c, mode=m, min_block=min_block))


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _randomized(tree, keys, seed):
    """``tree`` (numpy) with the leaves named in ``keys`` redrawn, so the
    zeros and ones of the reference's init (``u``, ``ln_x``, ``conv_b``,
    ``D``, ``dt_bias``) do not hide a term."""
    rng = np.random.default_rng(seed)
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(v.dtype)
            if k in keys else v for k, v in tree.items()}


# ---------------------------------------------------------------------- rwkv
RD, RFF, RHD = 32, 64, 8


@functools.lru_cache(maxsize=None)
def _rwkv(mode):
    jpol, tpol = _policies(mode)
    js = jrwkv.RWKVSpec.make(jpol, RD, RFF, RHD, seed_salt=2)
    ts = trwkv.RWKVSpec.make(tpol, RD, RFF, RHD, seed_salt=2)
    jp = jax.tree.map(np.asarray, jax.jit(js.init)(jax.random.PRNGKey(3)))
    jp = _randomized(jp, ("u", "ln_x"), 4)
    # the port's init makes the reference's structure and shapes
    want = tree_lib.map_leaves(lambda t: tuple(t.shape),
                               ts.init(None, device="meta"))
    assert want == tree_lib.map_leaves(lambda t: tuple(t.shape),
                                       _torch_tree(jp))
    return js, ts, jp


def _rwkv_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    t = 3 if case == "carried" else T
    x = rng.standard_normal((B, t, RD)).astype(np.float32)
    x2 = rng.standard_normal((B, t, RD)).astype(np.float32)
    H = RD // RHD
    if case == "carried":
        S = rng.standard_normal((B, H, RHD, RHD)).astype(np.float32)
        xp = rng.standard_normal((B, 1, RD)).astype(np.float32)
        xc = rng.standard_normal((B, 1, RD)).astype(np.float32)
    else:
        S = np.zeros((B, H, RHD, RHD), np.float32)
        xp = xc = np.zeros((B, 1, RD), np.float32)
    valid = (np.arange(t)[None] < LENGTHS[:, None]) if case == "valid" \
        else None
    return x, x2, S, xp, xc, valid


def _rwkv_jax(js, jp, x, x2, S, xp, xc, valid):
    v = None if valid is None else jnp.asarray(valid)
    y, S2, xtm = js.time_mix(jp, jnp.asarray(x), jnp.asarray(S),
                             jnp.asarray(xp), valid=v)
    y2, xcm = js.channel_mix(jp, jnp.asarray(x2), jnp.asarray(xc), valid=v)
    return y, S2, xtm, y2, xcm


def _rwkv_port(ts, tp, x, x2, S, xp, xc, valid):
    v = None if valid is None else torch.from_numpy(valid)
    y, S2, xtm = ts.time_mix(tp, x, torch.from_numpy(S), torch.from_numpy(xp),
                             valid=v)
    y2, xcm = ts.channel_mix(tp, x2, torch.from_numpy(xc), valid=v)
    return y, S2, xtm, y2, xcm


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_rwkv_time_and_channel_mix_match_reference(mode, case):
    js, ts, jp = _rwkv(mode)
    x, x2, S, xp, xc, valid = _rwkv_inputs(case)
    want = _rwkv_jax(js, jax.tree.map(jnp.asarray, jp), x, x2, S, xp, xc,
                     valid)
    with torch.no_grad():
        got = _rwkv_port(ts, _torch_tree(jp), torch.from_numpy(x),
                         torch.from_numpy(x2), S, xp, xc, valid)
    for g, w in zip(got, want):
        _close(g, w)
    assert got[1].dtype == torch.float32
    assert (ts.wr.spec.mask is not None) == (mode != "dense")


@pytest.mark.parametrize("mode", MODES)
def test_rwkv_grads_match_jax_grad(mode):
    js, ts, jp = _rwkv(mode)
    x, x2, S, xp, xc, _ = _rwkv_inputs("carried", seed=1)
    rng = np.random.default_rng(2)
    cots = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, 3, RD), S.shape, (B, 1, RD), (B, 3, RD),
                      (B, 1, RD))]

    def jloss(p, xx):
        outs = _rwkv_jax(js, p, xx, x2, S, xp, xc, None)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                              jnp.asarray(x))
    tp = _torch_tree(jp, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    outs = _rwkv_port(ts, tp, tx, torch.from_numpy(x2), S, xp, xc, None)
    sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(outs, cots)
        ).backward()
    _close(tx.grad, jgx)
    got = tree_lib.map_leaves(lambda t: t.grad.numpy(), tp)
    for (path, g), w in zip(tree_lib.leaves_with_paths(got),
                            jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=path)


# --------------------------------------------------------------------- mamba
MD = 64


@functools.lru_cache(maxsize=None)
def _mamba(mode):
    # min_block 2 lets the policy pack w_dt (dt_rank 4 -> 128) too, so its
    # softplus and dt_bias ride every mode's epilogue
    jpol, tpol = _policies(mode, min_block=2)
    js = jmamba.MambaSpec.make(jpol, MD, 2, seed_salt=5)
    ts = tmamba.MambaSpec.make(tpol, MD, 2, seed_salt=5)
    jp = jax.tree.map(np.asarray, jax.jit(js.init)(jax.random.PRNGKey(6)))
    jp = _randomized(jp, ("conv_b", "D", "dt_bias"), 7)
    want = tree_lib.map_leaves(lambda t: tuple(t.shape),
                               ts.init(None, device="meta"))
    assert want == tree_lib.map_leaves(lambda t: tuple(t.shape),
                                       _torch_tree(jp))
    return js, ts, jp


def _mamba_inputs(case, seed=0):
    rng = np.random.default_rng(seed)
    t = 3 if case == "carried" else T
    x = rng.standard_normal((B, t, MD)).astype(np.float32)
    state = None
    if case == "carried":
        state = {"conv": rng.standard_normal((B, 3, 2 * MD)).astype(
                     np.float32),
                 "h": rng.standard_normal((B, 2 * MD, 16)).astype(np.float32)}
    valid = (np.arange(t)[None] < LENGTHS[:, None]) if case == "valid" \
        else None
    return x, state, valid


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_mamba_apply_matches_reference(mode, case):
    js, ts, jp = _mamba(mode)
    x, state, valid = _mamba_inputs(case)
    jy, jst = js.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                       None if state is None else jax.tree.map(jnp.asarray,
                                                               state),
                       valid=None if valid is None else jnp.asarray(valid))
    with torch.no_grad():
        ty, tst = ts.apply(_torch_tree(jp), torch.from_numpy(x),
                           None if state is None else _torch_tree(state),
                           valid=None if valid is None
                           else torch.from_numpy(valid))
    _close(ty, jy)
    for k in ("conv", "h"):
        _close(tst[k], jst[k])
    assert tst["h"].dtype == torch.float32
    assert (ts.w_dt.spec.mask is not None) == (mode != "dense")


@pytest.mark.parametrize("mode", MODES)
def test_mamba_grads_match_jax_grad(mode):
    js, ts, jp = _mamba(mode)
    x, state, _ = _mamba_inputs("carried", seed=1)
    rng = np.random.default_rng(3)
    cy = rng.standard_normal((B, 3, MD)).astype(np.float32)
    ch = rng.standard_normal(state["h"].shape).astype(np.float32)

    def jloss(p, xx):
        y, st = js.apply(p, xx, jax.tree.map(jnp.asarray, state))
        return jnp.sum(y * cy) + jnp.sum(st["h"] * ch)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                              jnp.asarray(x))
    tp = _torch_tree(jp, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, st = ts.apply(tp, tx, _torch_tree(state))
    (torch.sum(y * torch.from_numpy(cy))
     + torch.sum(st["h"] * torch.from_numpy(ch))).backward()
    _close(tx.grad, jgx)
    got = tree_lib.map_leaves(lambda t: t.grad.numpy(), tp)
    for (path, g), w in zip(tree_lib.leaves_with_paths(got),
                            jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=path)


# --------------------------------------------------------------- epilogues
ACTS = list(jref.ACTIVATIONS)


@pytest.mark.parametrize("act", ACTS)
def test_activation_through_ref_and_ops_matches_reference(act):
    """The registry (softplus in jax.nn's logaddexp form, exact where
    torch's threshold form is not), bdmm fp and int8 and the masked matmul
    with bias and ``act``, plain and through ``ops``."""
    assert set(tref.ACTIVATIONS) == set(jref.ACTIVATIONS)
    from repro_torch.kernels import bdmm as tbdmm
    from repro_torch.kernels import masked_matmul as tmm
    assert set(tbdmm.ACT_CODES) == set(tmm.ACT_CODES) == set(jref.ACTIVATIONS)
    rng = np.random.default_rng(ACTS.index(act))
    v = np.concatenate([np.linspace(-40, 40, 161),
                        rng.standard_normal(64) * 3]).astype(np.float32)
    _close(tref.ACTIVATIONS[act](torch.from_numpy(v)),
           jref.ACTIVATIONS[act](jnp.asarray(v)))
    nb, bi, bo = 4, 8, 12
    x = rng.standard_normal((3, nb * bi)).astype(np.float32)
    wp = (rng.standard_normal((nb, bi, bo)) * 2).astype(np.float32)
    b = rng.standard_normal(nb * bo).astype(np.float32)
    tx, twp, tb = (torch.from_numpy(a) for a in (x, wp, b))
    want = jref.bdmm_ref(jnp.asarray(x), jnp.asarray(wp), jnp.asarray(b), act)
    _close(tref.bdmm_ref(tx, twp, tb, act), want)
    _close(tops.bdmm(tx, twp, tb, activation=act), want)
    wq, s = jquantize_blocks(jnp.asarray(wp))
    want = jref.bdmm_quant_ref(jnp.asarray(x), wq, s, jnp.asarray(b), act)
    twq, ts_ = torch.from_numpy(np.array(wq)), torch.from_numpy(np.array(s))
    _close(tref.bdmm_quant_ref(tx, twq, ts_, tb, act), want)
    _close(tops.bdmm_quant(tx, twq, ts_, tb, activation=act), want)
    w = rng.standard_normal((nb * bi, nb * bo)).astype(np.float32)
    mask = (rng.random(w.shape) < 0.5).astype(np.uint8)
    want = jref.masked_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(mask), jnp.asarray(b), act)
    tw, tm = torch.from_numpy(w), torch.from_numpy(mask)
    _close(tref.masked_matmul_ref(tx, tw, tm, tb, act), want)
    _close(tops.masked_matmul(tx, tw, tm, tb, activation=act), want)


@pytest.mark.parametrize("use_bias", [False, True], ids=["extra", "own+extra"])
@pytest.mark.parametrize("mode", MODES)
def test_extra_bias_in_every_mode(mode, use_bias):
    """``extra_bias`` joins (or stands in for) the layer's bias before the
    packed re-index, under softplus, as Mamba's ``dt_bias`` does."""
    jpol, tpol = _policies(mode)
    mask = jpol.plan(32, 48, "ssm_proj", seed_salt=9)
    assert (mask is None) == (mode == "dense")
    mode_ = mode if mask is not None else "dense"
    jspec = jmpd.MPDLinearSpec(32, 48, mask, mode=mode_, use_bias=use_bias)
    tspec = tmpd.MPDLinearSpec(32, 48, tpol.plan(32, 48, "ssm_proj",
                                                 seed_salt=9),
                               mode=mode_, use_bias=use_bias)
    jp = jax.tree.map(np.asarray, jmpd.init(jax.random.PRNGKey(1), jspec))
    rng = np.random.default_rng(8)
    if use_bias:
        jp["b"] = rng.standard_normal(48).astype(np.float32)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    eb = rng.standard_normal(48).astype(np.float32)
    want = jmpd.apply(jspec, jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                      activation="softplus", extra_bias=jnp.asarray(eb))
    got = tmpd.apply(tspec, _torch_tree(jp), torch.from_numpy(x),
                     activation="softplus", extra_bias=torch.from_numpy(eb))
    _close(got, want)
    # and it is not a no-op
    assert not np.allclose(got.numpy(), tmpd.apply(
        tspec, _torch_tree(jp), torch.from_numpy(x),
        activation="softplus").numpy())


# ---------------------------------------------------- fold and artifacts
RECURRENT = ["rwkv6-3b", "jamba-v0.1-52b"]


@functools.lru_cache(maxsize=None)
def _masked(arch):
    """Both packages' masked-dense smokes on the reference's params, with
    off-mask noise on every stacked matrix put back to the mask by the
    reference's mask projection."""
    over = dict(mpd_mode="masked_dense")
    jm = jbuild(jcommon.get_config(arch, smoke=True, **over))
    tm = tbuild(tcommon.get_config(arch, smoke=True, **over))
    rng = np.random.default_rng(5)
    jp = jax.tree.map(
        lambda a: a if a.ndim < 3 else
        a + (0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.jit(jm.init)(jax.random.PRNGKey(0)))
    jp = jm.mask_projection(jp)
    return jm, jp, tm, params_from_numpy(tm, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _raw(t):
    return t.detach().cpu().numpy()


def _same_tree(t_tree, j_tree):
    got = list(tree_lib.leaves(t_tree))
    want = [np.asarray(w) for w in jax.tree.leaves(j_tree)]
    return len(got) == len(want) and all(
        g.shape == w.shape and _raw(g).tobytes() == w.tobytes()
        for g, w in zip(got, want))


@pytest.mark.parametrize("quantize,fuse", [(None, False), ("int8", False),
                                           ("int8", True)])
@pytest.mark.parametrize("arch", RECURRENT)
def test_fold_model_matches_reference(arch, quantize, fuse):
    """``fuse``: the Fig-3 rewrite, which takes a mamba block's dense FFN
    as an attention block's (the same merged permutations as the
    reference's) and passes rwkv's and the MoE blocks by."""
    jm, jp, tm, tp = _masked(arch)
    # the port's mask projection is the reference's
    assert _same_tree(tm.mask_projection(tp), jp)
    jpk, jpp = jm.to_packed(jp, quantize=quantize, fuse=fuse)
    tpk, tpp = tm.to_packed(tp, quantize=quantize, fuse=fuse)
    assert _same_tree(tpp, jpp)
    for js, ts in zip(jpk.block_specs, tpk.block_specs):
        if ts["ffn"] is None or ts["kind"].endswith("_moe"):
            continue
        for k in ("w_up", "w_gate", "w_down"):
            jl, tl = getattr(js["ffn"], k), getattr(ts["ffn"], k)
            if jl is None:
                continue
            assert (tl.spec.skip_in_perm, tl.spec.skip_out_perm) == (
                jl.spec.skip_in_perm, jl.spec.skip_out_perm), k
            np.testing.assert_array_equal(tl.spec.mask.in_perm,
                                          jl.spec.mask.in_perm)
            np.testing.assert_array_equal(tl.spec.mask.out_perm,
                                          jl.spec.mask.out_perm)
    kind = tpk.block_specs[0]["kind"]
    mixer = tpp["blocks"][0]["mixer"]
    raw = (("mix", "mix_c", "w0", "wA", "wB", "u", "ln_x") if kind == "rwkv"
           else ("conv", "conv_b", "A_log", "D", "dt_bias"))
    proj = trwkv.PROJ if kind == "rwkv" else tmamba.PROJ
    # the raw leaves stay fp, every projection the policy packs is folded
    # (and quantized)
    assert all(mixer[k].dtype == torch.float32 for k in raw)
    spec = tpk.block_specs[0]["mixer"]
    for k in proj:
        packed = getattr(spec, k).spec.mask is not None
        assert ("w_q" in mixer[k]) == (packed and quantize == "int8"), k
    if quantize:
        assert tpk.quant_report["n_layers"] == jpk.quant_report["n_layers"]


def _manifest(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, "packed", f"step_{step:09d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", RECURRENT)
def test_int8_artifact_crosses_both_ways(tmp_path, arch):
    jm, jp, tm, tp = _masked(arch)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.export_packed(jdir, 3, jm, jp, quantize="int8")
    tckpt.export_packed(tdir, 3, tm, tp, quantize="int8")
    jman, tman = _manifest(jdir, 3), _manifest(tdir, 3)
    assert tman["leaves"] == jman["leaves"]
    for key in ("artifact_crc32", "packed_config", "quantize"):
        assert tman["extra"][key] == jman["extra"][key], key
    assert tman["extra"]["packed_config"]["pattern"] == list(
        jm.cfg.pattern)
    # the reference reads the port's artifact, the port the reference's
    _, from_port = jckpt.load_packed(tdir)
    _, from_jax = jckpt.load_packed(jdir)
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(jax.tree.leaves(from_port),
                               jax.tree.leaves(from_jax)))
    model, params = tckpt.load_packed(jdir, device="cpu")
    assert model.cfg == dataclasses.replace(tm.cfg, mpd_mode="packed")
    assert _same_tree(params, jm.to_packed(jp, quantize="int8")[1])
