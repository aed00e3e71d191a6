"""Port parity, gradient compression, microbatching and the quantization
reports: ``repro_torch.dist.compress``, ``repro_torch.dist.microbatch``,
``core.export.dequantize_packed`` and ``kernels.quant.quant_error``
against the JAX package, and the train step that uses the first two.

* ``quantize_leaf``, ``compress_with_ef`` (over three steps of error
  feedback, at 8, 4 and 1 bits) and ``wire_bytes`` equal the reference's
  exactly at float32: both round half to even and do the same IEEE
  operations in the same order.
* ``cap_microbatches`` equals the reference's over a grid of (B, n, ways).
* Microbatched grads of the smoke model equal full-batch grads within atol
  1e-7, rtol 1e-5 (the mean of per-microbatch means, summed in another
  order).
* Three steps of ``repro_torch.train.run`` with microbatches of 2 rows and
  int8 compression follow ``repro.train.run``'s loss curve within rtol
  2e-5, as tests/test_torch_train.py holds the plain step.
* ``dequantize_packed`` equals the reference's bit for bit; ``quant_error``
  within rtol 1e-6 (its sums run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.core import export as jexport
from repro.data import SyntheticLM as JSyntheticLM
from repro.dist import compress as jcompress
from repro.dist import microbatch as jmicro
from repro.kernels import quant as jquant
from repro.models import build as jbuild
from repro.optim import optimizer as jopt
from repro.train import TrainConfig as JTrainConfig
from repro.train import run as jrun
from repro_torch import tree as tree_lib
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import export as texport
from repro_torch.data import SyntheticLM
from repro_torch.dist import compress as tcompress
from repro_torch.dist import microbatch as tmicro
from repro_torch.kernels import quant as tquant
from repro_torch.models import build as tbuild
from repro_torch.optim import optimizer as topt
from repro_torch.train import TrainConfig, run
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

SEQ, BATCH = 16, 4


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((5, 7)) * 1e-3).astype(np.float32),
            "b": [rng.standard_normal(33).astype(np.float32),
                  np.zeros((2, 2), np.float32)],
            "c": (rng.standard_normal((3, 4, 6)) * 50).astype(np.float32)}


@pytest.mark.parametrize("bits", [8, 4, 1])
def test_compress_with_ef_equals_jax(bits):
    """Three steps of error feedback from zero residuals: the dequantized
    grads and the residuals equal the reference's bit for bit (an all-zero
    leaf takes scale 1)."""
    j_ef = jcompress.init_ef_state(jax.tree.map(jnp.asarray, _grads(0)))
    t_ef = tcompress.init_ef_state(tree_lib.map_leaves(torch.from_numpy,
                                                       _grads(0)))
    for step in range(3):
        g = _grads(step + 1)
        j_out, j_ef = jcompress.compress_with_ef(
            jax.tree.map(jnp.asarray, g), j_ef, bits)
        t_out, t_ef = tcompress.compress_with_ef(
            tree_lib.map_leaves(torch.from_numpy, g), t_ef, bits)
        for got, want in zip(tree_lib.leaves(t_out), jax.tree.leaves(j_out)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(tree_lib.leaves(t_ef), jax.tree.leaves(j_ef)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in (0, 1, 4, 8):
        assert tcompress.wire_bytes(t_out, b) == jcompress.wire_bytes(
            jax.tree.map(jnp.asarray, _grads(1)), b)


def test_quantize_leaf_equals_jax():
    g = _grads(7)["c"]
    q, s = tcompress.quantize_leaf(torch.from_numpy(g), 8)
    jq, js = jcompress.quantize_leaf(jnp.asarray(g), 8)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    with pytest.raises(ValueError):
        tcompress.quantize_leaf(torch.from_numpy(g), 9)


def test_cap_microbatches_equals_jax():
    for B in range(1, 25):
        for n in range(1, 10):
            for ways in (1, 2, 3, 4, 8):
                assert tmicro.cap_microbatches(B, n, ways) == \
                    jmicro.cap_microbatches(B, n, ways)
    assert tmicro.batch_ways(None, None) == jmicro.batch_ways(None, None) == 1


def _pair(**over):
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True, **over))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, **over))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def test_microbatched_grads_match_full_batch():
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = tm.init(0, device="cpu")
    b = JSyntheticLM(96, SEQ, BATCH, seed=1).next()
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    full_l, full_g = tmicro.value_and_grad(tm.train_loss, tp, tb)
    mb_l, mb_g = tmicro.microbatched_value_and_grad(tm.train_loss, tp, tb, 2)
    np.testing.assert_allclose(float(mb_l), float(full_l), rtol=1e-5)
    for got, full in zip(tree_lib.leaves(mb_g), tree_lib.leaves(full_g)):
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-7,
                                   rtol=1e-5)
    with pytest.warns(UserWarning, match="capped 3 -> 2"):
        tmicro.microbatched_value_and_grad(tm.train_loss, tp, tb, 3)


def test_microbatched_compressed_steps_match_jax():
    """``TrainConfig(microbatch=2, grad_compress_bits=8)``: the step
    splits each batch of 5 rows into 2 microbatches of 2 (the remainder
    row dropped, as the reference drops it) and compresses the grads with
    error feedback; 3 steps follow the reference's loss curve."""
    jm, _, tm, tp = _pair(mpd_mode="packed", mpd_fuse=True)
    ocfg = dict(lr=3e-3, clip_norm=1.0, schedule="cosine", warmup_steps=1,
                total_steps=3)
    kw = dict(microbatch=2, grad_compress_bits=8, log_every=0)
    jout = jrun(jm, JTrainConfig(opt=jopt.OptConfig(**ocfg), **kw),
                JSyntheticLM(96, SEQ, 5, seed=0), 3, key=jax.random.PRNGKey(0))
    tout = run(tm, TrainConfig(opt=topt.OptConfig(**ocfg), **kw),
               SyntheticLM(96, SEQ, 5, seed=0), 3, params=tp)
    np.testing.assert_allclose(tout["history"], jout["history"], rtol=2e-5)


def test_dequantize_packed_and_quant_error_equal_jax():
    """A packed model's blocks quantized to int8 by the port, then
    dequantized by both packages from the same quantized tree: equal bit
    for bit; each layer's round-trip error report within rtol 1e-6 of the
    reference's ``quant_error`` on the same arrays."""
    kw = dict(mpd_mode="packed")
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True, **kw))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, **kw))
    tp = tm.init(0, device="cpu")
    tq, trep = texport.quantize_packed(tm, tp, bits=8)
    td = texport.dequantize_packed(tm, tq)
    jd = jexport.dequantize_packed(jm, jax.tree.map(jnp.asarray,
                                                    params_to_numpy(tq)))
    jl = jax.tree.leaves(jd)
    tl = list(tree_lib.leaves(td))
    assert len(jl) == len(tl) == len(list(tree_lib.leaves(tp)))
    for got, want in zip(tl, jl):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert params_to_numpy(td).keys() == params_to_numpy(tp).keys()
    n = 0
    for parent, key, _lin, tag in texport.iter_linear_leaves(tm, tp):
        w = parent[key]["w"]
        q, sc = tquant.quantize_blocks(w)
        want = jquant.quant_error(w.numpy(), q.numpy(), sc.numpy())
        for k in ("max_abs", "rel_rms"):
            np.testing.assert_allclose(trep["layers"][tag][k], want[k],
                                       rtol=1e-6)
        assert trep["layers"][tag]["max_abs"] <= float(sc.max()) / 2 + 1e-7
        n += 1
    assert n == trep["n_layers"] > 0
