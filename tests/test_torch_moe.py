"""Port parity, MoE: ``repro_torch.models.moe.MoESpec`` against
``repro.models.moe.MoESpec`` on the same params and inputs (numpy from a
seed), and the MoE model's fold and packed artifact across the packages.

* ``apply`` in the dense, masked-dense and packed modes, with a capacity
  that drops choices (1.0) and one that does not (8.0), padded experts
  (8 physical for 6 routed), a gated shared expert, and a router that the
  policy packs (16 experts): outputs within 1e-5 at float32, the aux term
  within 1e-6 relative, the routing (expert ids, kept choices, buffer
  slots) exactly equal;
* gradients of every param and of the input against ``jax.grad``;
* ``fold_model`` of a masked-dense qwen2-moe smoke model (fp and int8)
  equals the reference's fold leaf for leaf, bit for bit; the routed
  expert stacks stay fp arrays;
* an MoE ``export_packed`` artifact written by either package loads in the
  other, bit for bit, with the same manifest.

Tolerance: atol 1e-5 at float32, as the other parity files: the frameworks
sum the same products in different orders.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import common as jcommon
from repro.core import fold as jfold
from repro.core.policy import CompressionPolicy as JPolicy
from repro.models import build as jbuild
from repro.models import moe as jmoe
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.core.policy import CompressionPolicy as TPolicy
from repro_torch.models import build as tbuild
from repro_torch.models import moe as tmoe
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
D, FF = 32, 32

# (n_experts, padded, top_k, shared): the padded/shared case routes with a
# dense router, the 16-expert one with a packed router (nb 2 at c 4)
LAYOUTS = {"pad_shared": (6, 8, 2, 64), "packed_router": (16, 16, 4, 0)}


def _specs(mode, layout, capacity):
    n, pad, k, shared = LAYOUTS[layout]
    kw = dict(capacity_factor=capacity, d_ff_shared=shared,
              shared_gated=bool(shared), mode=mode, seed_salt=3,
              n_experts_padded=pad)
    jpol, tpol = (JPolicy(c=4, mode="packed" if mode == "dense" else mode),
                  TPolicy(c=4, mode="packed" if mode == "dense" else mode))
    return (jmoe.MoESpec.make(jpol, D, FF, n, k, **kw),
            tmoe.MoESpec.make(tpol, D, FF, n, k, **kw))


def _torch_tree(tree, grad=False):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, grad) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree)).requires_grad_(grad)


def _case(mode, layout, capacity, seed=0):
    js, ts = _specs(mode, layout, capacity)
    jp = jax.tree.map(np.asarray, jax.jit(js.init)(jax.random.PRNGKey(seed)))
    # the port's init makes the reference's structure and shapes
    want = tree_lib.map_leaves(lambda t: tuple(t.shape),
                               ts.init(None, device="meta"))
    assert want == tree_lib.map_leaves(lambda t: tuple(t.shape),
                                       _torch_tree(jp))
    x = np.random.default_rng(seed).standard_normal((2, 8, D)).astype(
        np.float32)
    return js, ts, jp, x


def _jax_routing(js, jp, x):
    """The reference's routing, step for step from its ``apply``."""
    xf = jnp.asarray(x.reshape(-1, D))
    t, K, E = xf.shape[0], js.top_k, js.n_experts_padded
    C = max(1, int(np.ceil(t * K / js.n_experts * js.capacity_factor)))
    probs = jax.nn.softmax(js.router.apply(jp["router"], xf), axis=-1)
    _, ids = jax.lax.top_k(probs, K)
    flat = ids.reshape(-1)
    oh = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1) * oh, axis=-1)
    keep = pos < C
    slot = jnp.where(keep, flat * C + jnp.minimum(pos, C - 1), E * C - 1)
    return [np.asarray(a) for a in (flat, keep, slot)]


MODES = ["dense", "masked_dense", "packed"]
CASES = [(m, "pad_shared", cap) for m in MODES for cap in (1.0, 8.0)] + [
    (m, "packed_router", 1.0) for m in MODES]


@pytest.mark.parametrize("mode,layout,capacity", CASES)
def test_apply_and_routing_match_reference(mode, layout, capacity):
    js, ts, jp, x = _case(mode, layout, capacity)
    jy, jaux = js.apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = _torch_tree(jp)
    with torch.no_grad():
        ty, taux = ts.apply(tp, torch.from_numpy(x))
        _, _, tids, tslot, tkeep, _ = ts.route(tp, torch.from_numpy(
            x.reshape(-1, D)))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    ids, keep, slot = _jax_routing(js, jp, x)
    np.testing.assert_array_equal(tids.numpy(), ids)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    np.testing.assert_array_equal(tslot.numpy(), slot)
    # the capacity does what the case says
    assert keep.all() == (capacity > 1.0)
    assert (ts.router.spec.mask is not None) == (layout == "packed_router")


@pytest.mark.parametrize("mode", MODES)
def test_grads_match_jax_grad(mode):
    js, ts, jp, x = _case(mode, "pad_shared", 1.0, seed=1)
    r = np.random.default_rng(2).standard_normal((2, 8, D)).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = js.apply(p, xx)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = _torch_tree(jp, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = ts.apply(tp, tx)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=ATOL,
                               rtol=RTOL)
    got = tree_lib.map_leaves(lambda t: t.grad.numpy(), tp)
    for (path, g), w in zip(tree_lib.leaves_with_paths(got),
                            jax.tree.leaves(jg)):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=path)


def _masked_qwen():
    over = dict(mpd_mode="masked_dense")
    jm = jbuild(jcommon.get_config("qwen2-moe-a2.7b", smoke=True, **over))
    tm = tbuild(tcommon.get_config("qwen2-moe-a2.7b", smoke=True, **over))
    rng = np.random.default_rng(5)
    # off-mask noise where the reference's mask projection reaches (its
    # projection leaves the shared expert alone, so its init stays masked)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if "shared" in jax.tree_util.keystr(path)
        or a.ndim < 3 else
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


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_fold_model_matches_reference(quantize):
    jm, jp, tm, tp = _masked_qwen()
    # the mask projection leaves the experts masked, as the reference's
    np.testing.assert_array_equal(
        _raw(tm.mask_projection(tp)["blocks"][0]["ffn"]["w_up"]),
        np.asarray(jp["blocks"][0]["ffn"]["w_up"]))
    jpk, jpp = jm.to_packed(jp, quantize=quantize)
    tpk, tpp = tm.to_packed(tp, quantize=quantize)
    assert _same_tree(tpp, jpp)
    ffn = tpp["blocks"][0]["ffn"]
    mask = tpk.block_specs[0]["ffn"].mask_up
    # routed experts: raw fp stacks (periods, E, nb, bi, bo); shared: int8
    assert ffn["w_up"].shape == (2, 8, mask.nb, mask.block_in,
                                 mask.block_out)
    assert ffn["w_up"].dtype == torch.float32
    assert ("w_q" in ffn["shared"]["w_up"]) == (quantize == "int8")
    if quantize:
        assert tpk.quant_report["n_layers"] == jpk.quant_report["n_layers"]
    # the fold of the experts is exact: a jax.vmap of the reference's fold
    w = np.asarray(jp["blocks"][0]["ffn"]["w_down"])
    want = jax.vmap(jax.vmap(lambda a: jfold.fold(
        jpk.block_specs[0]["ffn"].mask_down, a)))(w)
    np.testing.assert_array_equal(_raw(ffn["w_down"]), np.asarray(want))


def _manifest(ckpt_dir, step):
    with open(os.path.join(ckpt_dir, "packed", f"step_{step:09d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_moe_artifact_crosses_both_ways(tmp_path, quantize):
    jm, jp, tm, tp = _masked_qwen()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.export_packed(jdir, 2, jm, jp, quantize=quantize)
    tckpt.export_packed(tdir, 2, tm, tp, quantize=quantize)
    jman, tman = _manifest(jdir, 2), _manifest(tdir, 2)
    assert tman["leaves"] == jman["leaves"]
    for key in ("artifact_crc32", "packed_config", "quantize"):
        assert tman["extra"][key] == jman["extra"][key], key
    assert "params/blocks/0/ffn/w_gate" in tman["leaves"]        # raw array
    # the reference reads the port's artifact, the port the reference's
    _, from_port = jckpt.load_packed(tdir)
    _, from_jax = jckpt.load_packed(jdir)
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(jax.tree.leaves(from_port),
                               jax.tree.leaves(from_jax)))
    model, params = tckpt.load_packed(jdir, device="cpu")
    assert model.cfg == dataclasses.replace(tm.cfg, mpd_mode="packed")
    assert _same_tree(params, jm.to_packed(jp, quantize=quantize)[1])
