"""Port parity, the fused_ffn autograd rule and packed training of a
perm-fused model.

* ``repro_torch.kernels.ops.fused_ffn``'s gradients of all seven inputs
  (x, the three weights, the three biases) against ``jax.grad`` through
  ``repro.kernels.ops.fused_ffn`` (its ``custom_vjp``, jnp backend), gated
  and plain, silu / gelu / relu, with and without biases; and
  ``torch.autograd.gradcheck`` of the rule at float64 on a tiny shape.
* The perm-fused packed olmo smoke model (every FFN one ``fused_ffn``
  call): loss and every leaf's gradient against ``jax.grad``, params
  carried across with ``params_from_numpy``; its 5-step AdamW curve against
  ``repro.train.run``; ``launch.train --mpd-fuse`` trains it packed.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances at float32: the rule's gradients atol 1e-6, rtol 1e-5 (the same
products summed in other orders); the model's loss atol/rtol 1e-5 and
gradients atol 2e-6, rtol 1e-4, its 5-step loss curve rtol 2e-5, as
tests/test_torch_train.py holds the unfused model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.models import build as jbuild
from repro.optim import optimizer as jopt
from repro.train import TrainConfig as JTrainConfig
from repro.train import run as jrun
from repro_torch import tree as tree_lib
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.optim import optimizer as topt
from repro_torch.train import TrainConfig, run
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ARGS = ("x", "w_up", "w_gate", "w_down", "b_up", "b_gate", "b_down")
SEQ, BATCH = 32, 4


def _inputs(seed, m, nb, bi, f, bo, gated, biases, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(dtype)
    return {"x": r(m, nb * bi), "w_up": r(nb, bi, f, sc=0.3),
            "w_gate": r(nb, bi, f, sc=0.3) if gated else None,
            "w_down": r(nb, f, bo, sc=0.3),
            "b_up": r(nb * f, sc=0.1) if biases else None,
            "b_gate": r(nb * f, sc=0.1) if biases and gated else None,
            "b_down": r(nb * bo, sc=0.1) if biases else None,
            "cot": r(m, nb * bo)}


def _call(fn, a, act):
    return fn(a["x"], a["w_up"], a["w_down"], w_gate=a["w_gate"],
              b_up=a["b_up"], b_gate=a["b_gate"], b_down=a["b_down"],
              activation=act)


@pytest.mark.parametrize("biases", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "plain"])
def test_fused_ffn_grads_match_jax(gated, act, biases):
    """Every input's gradient of ``sum(fused_ffn(...) * cot)``: the port's
    rule (plain forward, bdmm recompute and transposes, einsum weight
    grads) against the reference's ``custom_vjp``."""
    a = _inputs(3, 6, 2, 8, 12, 5, gated, biases)
    names = [k for k in ARGS if a[k] is not None]
    assert jops.get_backend() == "jnp"

    def jloss(*vals):
        j = dict(a, **dict(zip(names, vals)))
        return jnp.sum(_call(jops.fused_ffn, j, act) * a["cot"])
    want = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[k]) for k in names))
    live = {k: torch.from_numpy(a[k]).requires_grad_(True) for k in names}
    y = _call(ops.fused_ffn, {k: live.get(k) for k in ARGS}, act)
    got = torch.autograd.grad((y * torch.from_numpy(a["cot"])).sum(),
                              [live[k] for k in names])
    assert len(got) == len(names) == 3 + gated + (2 + gated) * biases
    for k, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("gated,biases", [(True, True), (False, True),
                                          (True, False)])
def test_fused_ffn_gradcheck_f64(gated, biases):
    """Finite differences at float64 on a tiny shape, through the rule."""
    a = _inputs(4, 3, 2, 3, 4, 2, gated, biases, np.float64)
    names = [k for k in ARGS if a[k] is not None]

    def fn(*vals):
        return _call(ops.fused_ffn, dict(a, **dict(zip(names, vals))), "silu")
    assert torch.autograd.gradcheck(
        fn, tuple(torch.from_numpy(a[k]).requires_grad_(True)
                  for k in names))


def test_fused_ffn_grad_honours_needs_input_grad(monkeypatch):
    """Only the gradients asked for are computed: with x alone requiring
    grad, no weight-gradient einsum runs; with the weights alone, no bdmm
    transpose of ``dx`` runs (``dh`` still needs one)."""
    a = {k: None if v is None else torch.from_numpy(v)
         for k, v in _inputs(5, 4, 2, 4, 6, 3, True, True).items()}
    einsums, transposes = [], []
    real_einsum, real_t = torch.einsum, ops.bdmm_t
    monkeypatch.setattr(
        ops.torch, "einsum",
        lambda eq, *t: (eq == "tnk,tno->nko" and einsums.append(1))
        or real_einsum(eq, *t))
    monkeypatch.setattr(ops, "bdmm_t",
                        lambda g, w: transposes.append(1) or real_t(g, w))
    x = a["x"].clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(_call(ops.fused_ffn, dict(a, x=x), "silu")
                                .sum(), [x])
    assert dx.shape == x.shape and not einsums and len(transposes) == 3
    transposes.clear()
    w = a["w_up"].clone().requires_grad_(True)
    torch.autograd.grad(_call(ops.fused_ffn, dict(a, w_up=w), "silu").sum(),
                        [w])
    assert len(einsums) == 1 and len(transposes) == 1


# ------------------------------------------------------------------- model
def _fused_pair():
    kw = dict(mpd_mode="packed", mpd_fuse=True)
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True, **kw))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, **kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    assert all(b["ffn"].fused_packed() for b in tm.block_specs)
    return jm, jp, tm, tp


@pytest.fixture
def count_fused(monkeypatch):
    """Calls of the plain fused MLP (the CPU forward of ``ops.fused_ffn``)."""
    calls = []
    real = tref.fused_ffn_ref
    monkeypatch.setattr(tref, "fused_ffn_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_fused_packed_model_grads_match_jax(count_fused):
    """Loss and every leaf's gradient of the perm-fused packed smoke model
    on one batch; every FFN's forward is one fused call."""
    jm, jp, tm, tp = _fused_pair()
    b = JSyntheticLM(vocab=96, seq_len=SEQ, global_batch=BATCH, seed=0).next()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in b.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.train_loss))(jp, jb)
    live = [p.detach().requires_grad_(True) for p in tree_lib.leaves(tp)]
    loss = tm.train_loss(tree_lib.unflatten(tp, live), tb)
    grads = torch.autograd.grad(loss, live)
    assert len(count_fused) == tm.cfg.n_layers
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5,
                               rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for got, want in zip(grads, jleaves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=1e-4)


def test_five_fused_packed_steps_match_jax():
    """5 AdamW steps of ``repro_torch.train.run`` and ``repro.train.run``
    on the perm-fused packed model from one init and batch stream: the
    same (falling) loss curve. (AdamW moves a weight whose gradient is
    near 0 by ~lr whatever its sign, so single weights may differ by that
    after a few steps; the first step's gradients are held above.)"""
    jm, _, tm, tp = _fused_pair()
    ocfg = dict(lr=3e-3, clip_norm=1.0, schedule="cosine", warmup_steps=1,
                total_steps=5)
    jout = jrun(jm, JTrainConfig(opt=jopt.OptConfig(**ocfg), log_every=0),
                JSyntheticLM(96, SEQ, BATCH, seed=0), 5,
                key=jax.random.PRNGKey(0))
    tout = run(tm, TrainConfig(opt=topt.OptConfig(**ocfg), log_every=0),
               SyntheticLM(96, SEQ, BATCH, seed=0), 5, params=tp)
    np.testing.assert_allclose(tout["history"], jout["history"], rtol=2e-5)
    assert tout["history"][-1] < tout["history"][0]


def test_train_launcher_mpd_fuse_trains_packed(capsys, count_fused):
    """``--mpd-fuse`` without ``--mpd-mode``: the config's packed mode,
    every FFN through the fused rule (2 layers x 2 steps)."""
    out = tlaunch.main(["--arch", "olmo-1b", "--smoke", "--mpd-fuse",
                        "--steps", "2", "--seq-len", "16",
                        "--global-batch", "2", "--device", "cpu"])
    assert len(count_fused) == 2 * 2
    assert np.isfinite(out["history"]).all()
    text = capsys.readouterr().out
    n_packed = tbuild(tcommon.get_config("olmo-1b", smoke=True,
                                         mpd_fuse=True)).param_count()
    assert f"olmo-smoke: {n_packed:,} params" in text
    assert "final loss" in text
