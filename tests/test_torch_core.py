"""Port parity, core: masks, permutations, policy plans, pack/unpack gathers
and int8 block quantization must be identical to the JAX package's.

Everything here is host-side numpy (plans, permutations) or exact integer
arithmetic (quantization), so the bar is equality, not a tolerance.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.core import fold as jfold
from repro.core import mask as jmask
from repro.core import permute as jpermute
from repro.core import policy as jpolicy
from repro.kernels import quant as jquant
from repro.models import build as jbuild
from repro_torch.configs import common as tcommon
from repro_torch.core import fold as tfold
from repro_torch.core import mask as tmask
from repro_torch.core import permute as tpermute
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import quant as tquant
from repro_torch.models import build as tbuild
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

PROJ = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "unembed")


def _linears(model):
    spec = model.block_specs[0]
    out = {n: getattr(spec["mixer"], n) for n in ("wq", "wk", "wv", "wo")}
    out.update({n: getattr(spec["ffn"], n) for n in ("w_up", "w_gate", "w_down")})
    out["unembed"] = model.unembed
    return out


def _configs(name):
    if name == "smoke":
        return (jcommon.get_config("olmo-1b", smoke=True),
                tcommon.get_config("olmo-1b", smoke=True))
    if name == "smoke_gqa":
        return (jcommon.get_config("olmo-1b", smoke=True, n_kv_heads=2),
                tcommon.get_config("olmo-1b", smoke=True, n_kv_heads=2))
    return jcommon.get_config("olmo-1b"), tcommon.get_config("olmo-1b")


@pytest.mark.parametrize("proj", PROJ)
@pytest.mark.parametrize("cfg_name", ["smoke", "smoke_gqa", "full"])
def test_masks_identical_to_reference(cfg_name, proj):
    """Every projection's mask (nb, seed, both permutations) equals the
    reference's — salts, SeedSequence keys and shared per-period specs."""
    jcfg, tcfg = _configs(cfg_name)
    jm = _linears(jbuild(jcfg))[proj].spec
    tm = _linears(tbuild(tcfg))[proj].spec
    assert (jm.d_in, jm.d_out, jm.mode, jm.use_bias) == \
        (tm.d_in, tm.d_out, tm.mode, tm.use_bias)
    if jm.mask is None:
        assert tm.mask is None
        return
    assert (jm.mask.nb, jm.mask.seed) == (tm.mask.nb, tm.mask.seed)
    np.testing.assert_array_equal(jm.mask.in_perm, tm.mask.in_perm)
    np.testing.assert_array_equal(jm.mask.out_perm, tm.mask.out_perm)
    assert tm.mask.in_perm.dtype == np.int32


def test_full_config_fields_match():
    """The port's olmo-1b config is the reference's, field for field."""
    jcfg, tcfg = _configs("full")
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert (tcfg.n_layers, tcfg.d_model, tcfg.vocab, tcfg.mpd_c) == \
        (16, 2048, 50304, 8)


@pytest.mark.parametrize("case", [
    (2048, 2048, "attn_qkv", 8, 8, 0, 5),
    (2048, 50304, "unembed", 8, 8, 0, 0),
    (96, 40, "mlp", 6, 8, 3, 301),        # nb falls back to a divisor
    (64, 24, "mlp", 4, 8, 1, 7),          # min_block forces nb=3
    (64, 20, "mlp", 4, 8, 0, 2),          # no nb fits -> dense
    (128, 256, "attn_out", 1, 8, 0, 4),   # c=1 -> dense
])
def test_policy_plan_identical(case):
    d_in, d_out, kind, c, min_block, seed, salt = case
    jp = jpolicy.CompressionPolicy(c=c, min_block=min_block, seed=seed)
    tp = tpolicy.CompressionPolicy(c=c, min_block=min_block, seed=seed)
    jm = jp.plan(d_in, d_out, kind, seed_salt=salt)
    tm = tp.plan(d_in, d_out, kind, seed_salt=salt)
    if jm is None:
        assert tm is None
        return
    assert (jm.nb, jm.seed) == (tm.nb, tm.seed)
    np.testing.assert_array_equal(jm.in_perm, tm.in_perm)
    np.testing.assert_array_equal(jm.out_perm, tm.out_perm)


@pytest.mark.parametrize("permuted", [True, False])
def test_mask_dense_and_blocks_identical(permuted):
    js = jmask.make_mask_spec(48, 72, 6, seed=11, permuted=permuted)
    ts = tmask.make_mask_spec(48, 72, 6, seed=11, permuted=permuted)
    np.testing.assert_array_equal(jmask.mask_dense(js), tmask.mask_dense(ts))
    for a, b in zip(jmask.block_id_of(js), tmask.block_id_of(ts)):
        np.testing.assert_array_equal(a, b)


def test_permutation_algebra_identical():
    rng = np.random.default_rng(0)
    p = jpermute.random_permutation(np.random.default_rng(3), 37)
    q = tpermute.random_permutation(np.random.default_rng(3), 37)
    np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(jpermute.invert(p), tpermute.invert(q))
    r = rng.permutation(37).astype(np.int32)
    np.testing.assert_array_equal(jpermute.compose(p, r), tpermute.compose(q, r))
    x = rng.standard_normal((3, 37)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jpermute.apply(p, jnp.asarray(x))),
        tpermute.apply(q, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("skip", [False, True])
def test_pack_unpack_identical(skip):
    js = jmask.make_mask_spec(64, 96, 4, seed=9)
    ts = tmask.make_mask_spec(64, 96, 4, seed=9)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    y = rng.standard_normal((2, 5, 96)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(jfold.pack_inputs(js, jnp.asarray(x), skip=skip)),
        tfold.pack_inputs(ts, torch.from_numpy(x), skip=skip).numpy())
    np.testing.assert_array_equal(
        np.asarray(jfold.unpack_outputs(js, jnp.asarray(y), skip=skip)),
        tfold.unpack_outputs(ts, torch.from_numpy(y), skip=skip).numpy())


def test_identity_permutation_is_no_gather():
    ts = tmask.make_mask_spec(32, 32, 4, seed=0, permuted=False)
    x = torch.randn(3, 32)
    assert tfold.pack_inputs(ts, x) is x
    assert tfold.unpack_outputs(ts, x) is x


@pytest.mark.parametrize("shape", [(4, 16, 24), (2, 4, 32, 8), (8, 1, 5)])
def test_quantize_blocks_identical(shape):
    """Same ints and scales, including an all-zero column (scale 1) and
    exact .5 ties (both round half to even)."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0                                    # zero column
    # a column with amax 127 -> scale 1.0 -> exact .5 ties
    ties = np.array([2.5, -0.5, 3.5, -126.5, 127.0, 0.5, -1.5, 4.5], np.float32)
    col = np.resize(ties, shape[-2])
    col[np.argmax(np.abs(col))] = 127.0
    w[..., -1] = col
    jq, js = jquant.quantize_blocks(jnp.asarray(w))
    tq, ts = tquant.quantize_blocks(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(
        np.asarray(jquant.dequantize_blocks(jq, js)),
        tquant.dequantize_blocks(tq, ts).numpy())
