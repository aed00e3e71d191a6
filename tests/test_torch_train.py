"""Port parity, masked-dense training of the olmo smoke config (2 layers,
d 64, vocab 96, ``mpd_c=4``, f32): params carried from a JAX init through
``params_from_numpy``; logits, loss and the gradient of every leaf against
``repro``; ``SyntheticLM`` batches; one AdamW and one SGD step; a 5-step
loss curve of ``repro_torch.train.run`` against ``repro.train.run``; the
fold of the trained model to packed int8 against ``repro``'s
``fold_model``, and its greedy streams on the port's engine. Packed-mode
training (the launcher's default) gets the same logits/loss/grads check
and 5-step curve.

Tolerances at float32: logits and loss atol 1e-5, rtol 1e-5 (the same
products summed in other orders, as tests/test_torch_model.py); gradients
atol 2e-6, rtol 1e-4 (each passes through the whole backward, and many of
them are near zero); optimizer steps atol 1e-7, rtol 1e-6 at f32 and one
bf16 rounding step (rtol 2^-7) for bf16 params and moments; the 5-step loss
curve rtol 2e-5 (AdamW normalises each update, so the tiny gradient
differences above move a weight by at most a few lr·1e-4). Batches, masks,
folds and off-mask zeros are held exactly.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import common as jcommon
from repro.core import export as jexport
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build as jbuild
from repro.optim import optimizer as jopt
from repro.train import TrainConfig as JTrainConfig
from repro.train import run as jrun
from repro_torch import tree as tree_lib
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import fold as tfold
from repro_torch.core.export import iter_linear_leaves
from repro_torch.data import SyntheticLM
from repro_torch.data import pipeline as tpipeline
from repro_torch.launch import train as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.optim import optimizer as topt
from repro_torch.train import TrainConfig, make_train_step, run
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
G_ATOL, G_RTOL = 2e-6, 1e-4
SEQ, BATCH = 32, 4


def _pair(dtype="float32", **over):
    cfg_kw = dict({"mpd_mode": "masked_dense", "dtype": dtype}, **over)
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True, **cfg_kw))
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True, **cfg_kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _batch(seed=0):
    b = JSyntheticLM(vocab=96, seq_len=SEQ, global_batch=BATCH,
                     seed=seed).next()
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _off_mask_zero(model, params):
    for parent, key, lin, _ in iter_linear_leaves(model, params,
                                                  "masked_dense"):
        m = tfold.mask_tensor(lin.spec.mask, "cpu").bool()
        assert torch.all(parent[key]["w"][..., ~m] == 0)


# --------------------------------------------------------------------- model
@pytest.mark.parametrize("chunks", [False, True],
                         ids=["one_chunk", "q_and_loss_chunks"])
def test_logits_loss_and_grads_match_jax(chunks):
    """Logits, loss and the gradient of every param leaf of the
    masked-dense smoke model, from the same init and batch; off-mask
    weight gradients are exact zeros. ``chunks`` runs the query-chunked
    attention and the sequence-chunked CE (8-token chunks of 32)."""
    over = {"q_chunk": 8, "loss_chunk": 8} if chunks else {}
    tm, tp, grads = _check_logits_loss_grads(**over)
    _off_mask_zero(tm, tree_lib.unflatten(tp, grads))


def test_packed_logits_loss_and_grads_match_jax():
    """The same in packed mode (olmo-1b's own mode, the launcher's
    default): every compressed linear runs through the bdmm autograd rule
    (``dx`` a bdmm with transposed blocks, ``dwp`` an einsum)."""
    tm, _, _ = _check_logits_loss_grads(mpd_mode="packed")
    assert tm.cfg.mpd_mode == "packed"


def _check_logits_loss_grads(**over):
    """Logits, loss and every leaf's gradient of the port against JAX on
    one batch; returns the port's model, params and grads."""
    jm, jp, tm, tp = _pair(**over)
    jb, tb = _batch()
    _close(tm.logits(tp, tb["inputs"]), jm.logits(jp, jb["inputs"]))
    jloss, jgrads = jax.value_and_grad(jm.train_loss)(jp, jb)
    live = [p.detach().requires_grad_(True) for p in tree_lib.leaves(tp)]
    loss = tm.train_loss(tree_lib.unflatten(tp, live), tb)
    grads = torch.autograd.grad(loss, live)
    _close(loss, jloss)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads) == 9
    for got, want in zip(grads, jleaves):
        _close(got, want, G_ATOL, G_RTOL)
    return tm, tp, grads


def test_init_is_masked_and_mask_projection_matches_jax():
    """A fresh port init carries no off-mask mass, and the mask projection
    zeroes off-mask entries exactly as the reference's does."""
    jm, jp, tm, tp = _pair()
    _off_mask_zero(tm, tm.init(3, device="cpu"))
    noisy = jax.tree.map(lambda a: a + 0.5, jp)
    want = jm.mask_projection(noisy)
    got = tm.mask_projection(params_from_numpy(
        tm, jax.tree.map(np.asarray, noisy), device="cpu"))
    for g, w in zip(tree_lib.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tm.param_count() == jm.param_count()


# ---------------------------------------------------------------------- data
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_lm_batches_bit_identical(seed):
    a = SyntheticLM(vocab=96, seq_len=24, global_batch=3, seed=seed)
    b = JSyntheticLM(vocab=96, seq_len=24, global_batch=3, seed=seed)
    for _ in range(4):
        x, y = a.next(), b.next()
        for k in ("inputs", "labels"):
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("rows", [1, 7, 1024])
def test_synthetic_lm_chunked_table_equals_one_shot(monkeypatch, rows):
    """The transition table drawn in row chunks (any chunk size, odd ones
    included) and stored narrow equals the reference's one-shot int64
    draw, value for value."""
    monkeypatch.setattr(tpipeline, "TABLE_ROWS_PER_DRAW", rows)
    monkeypatch.setattr(tpipeline, "_tables", collections.OrderedDict())
    for vocab in (96, 301):
        got = SyntheticLM(vocab=vocab, seq_len=4, global_batch=1, seed=1)
        want = JSyntheticLM(vocab=vocab, seq_len=4, global_batch=1, seed=1)
        assert got._trans.dtype == (np.uint8 if vocab <= 256 else np.uint16)
        np.testing.assert_array_equal(got._trans.astype(np.int64),
                                      want._trans)


# ----------------------------------------------------------------- optimizer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_step_matches_jax(kind, dtype):
    """One update with clipping, warm-up, weight decay and the mask
    projection, from the same params and grads: params and state agree
    (bf16 params keep bf16 moments in both packages)."""
    jm, jp, tm, tp = _pair(dtype)
    cfg_kw = dict(kind=kind, lr=1e-2, clip_norm=0.5, weight_decay=0.1,
                  schedule="cosine", warmup_steps=3, total_steps=10)
    rng = np.random.default_rng(1)
    jg = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32), a.dtype), jp)
    tg = params_from_numpy(tm, jax.tree.map(np.asarray, jg), device="cpu")
    jcfg, tcfg = jopt.OptConfig(**cfg_kw), topt.OptConfig(**cfg_kw)
    jst, tst = jopt.init_state(jcfg, jp), topt.init_state(tcfg, tp)
    for _ in range(2):
        jp, jst, jm_ = jopt.apply_updates(jcfg, jp, jg, jst,
                                          mask_fn=jm.mask_projection)
        tp, tst, tm_ = topt.apply_updates(tcfg, tp, tg, tst,
                                          mask_fn=tm.mask_projection)
    atol, rtol = (1e-7, 1e-6) if dtype == "float32" else (1e-7, 2 ** -7)
    assert tst["step"] == int(jst["step"]) == 2
    np.testing.assert_allclose(tm_["lr"], float(jm_["lr"]), rtol=1e-7)
    _close(tm_["grad_norm"], jm_["grad_norm"], 0, 1e-5)
    for key in ("mu", "nu") if kind == "adamw" else ("mom",):
        for g, w in zip(tree_lib.leaves(tst[key]), jax.tree.leaves(jst[key])):
            assert g.dtype == getattr(torch, dtype)
            _close(g, w, atol, rtol)
    for g, w in zip(tree_lib.leaves(tp), jax.tree.leaves(jp)):
        _close(g, w, atol, rtol)
    _off_mask_zero(tm, tp)


def test_schedules_match_jax():
    for kw in (dict(schedule="cosine", warmup_steps=5, total_steps=40),
               dict(schedule="step", step_decay_every=3),
               dict(schedule="constant", warmup_steps=4)):
        jc, tc = jopt.OptConfig(lr=3e-3, **kw), topt.OptConfig(lr=3e-3, **kw)
        for step in (0, 1, 4, 5, 17, 39, 60):
            assert topt.schedule_lr(tc, step) == float(
                jopt.schedule_lr(jc, step))


# --------------------------------------------------------------------- slice
def test_five_masked_dense_steps_match_jax():
    """The slice as a whole: 5 steps of ``repro_torch.train.run`` and
    ``repro.train.run`` from the same init and batches give the same loss
    curve; stepping ``make_train_step`` (what ``run`` drives) leaves no
    off-mask weight after any step."""
    tm, tp, tcfg, tout = _five_steps_match_jax("masked_dense")
    step = make_train_step(tm, tcfg)
    params, state = tp, topt.init_state(tcfg.opt, tp)
    data = SyntheticLM(96, SEQ, BATCH, seed=0)
    losses = []
    for _ in range(5):
        batch = {k: torch.from_numpy(v).long() for k, v in data.next().items()}
        params, state, _, metrics = step(params, state, {}, batch)
        losses.append(float(metrics["loss"]))
        _off_mask_zero(tm, params)
    assert losses == tout["history"]


def test_five_packed_steps_match_jax():
    """Packed-mode training (no mask projection; the blocks are the
    params): 5 steps of both loops from the same init and batches give the
    same loss curve and final params."""
    _five_steps_match_jax("packed")


def _five_steps_match_jax(mode):
    """5 steps of ``repro_torch.train.run`` and ``repro.train.run`` from one
    init and one batch stream: the same loss curve (falling) and final
    params. Returns the port's model, init, train config and result."""
    jm, _, tm, tp = _pair(mpd_mode=mode)
    ocfg = dict(lr=3e-3, clip_norm=1.0, schedule="cosine", warmup_steps=1,
                total_steps=5)
    jout = jrun(jm, JTrainConfig(opt=jopt.OptConfig(**ocfg), log_every=0),
                JSyntheticLM(96, SEQ, BATCH, seed=0), 5,
                key=jax.random.PRNGKey(0))
    tcfg = TrainConfig(opt=topt.OptConfig(**ocfg), log_every=0)
    tout = run(tm, tcfg, SyntheticLM(96, SEQ, BATCH, seed=0), 5, params=tp)
    np.testing.assert_allclose(tout["history"], jout["history"], rtol=2e-5)
    assert tout["history"][-1] < tout["history"][0]
    for g, w in zip(tree_lib.leaves(tout["params"]),
                    jax.tree.leaves(jout["params"])):
        _close(g, w, 1e-5, 1e-3)
    return tm, tp, tcfg, tout


def _trained(steps=3):
    _, _, tm, tp = _pair()
    tcfg = TrainConfig(opt=topt.OptConfig(lr=3e-3, clip_norm=1.0),
                       log_every=0)
    out = run(tm, tcfg, SyntheticLM(96, SEQ, BATCH, seed=0), steps,
              params=tp)
    return tm, out["params"]


def test_fold_of_trained_model_matches_jax_and_serves_same_streams():
    """Port-trained params, handed back with ``params_to_numpy``: the
    port's ``to_packed(quantize="int8")`` equals ``repro``'s
    ``fold_model`` on them; and at f32 without quantization the folded
    model serves the same greedy streams as the masked-dense model on the
    port's paged engine."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import Engine

    tm, tp = _trained()
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True,
                                   mpd_mode="masked_dense"))
    jp = jax.tree.map(jnp.asarray, params_to_numpy(tp))
    jpk_model, jpk = jexport.fold_model(jm, jp, quantize="int8")
    tpk_model, tpk = tm.to_packed(tp, quantize="int8")
    assert tpk_model.cfg.mpd_mode == "packed"
    jl, tl = jax.tree.leaves(jpk), list(tree_lib.leaves(tpk))
    assert len(jl) == len(tl)
    for g, w in zip(tl, jl):
        if g.dtype == torch.int8:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, 0, 1e-7)
    np.testing.assert_allclose(tpk_model.quant_report["max_rel_rms"],
                               jpk_model.quant_report["max_rel_rms"],
                               rtol=1e-5)

    fp_model, fp_params = tm.to_packed(tp)
    streams = []
    for model, params in ((tm, tp), (fp_model, fp_params)):
        reqs = make_requests(tm.cfg, n_requests=3, rate=1e9, prompt_len=20,
                             gen=6, seed=2, shared_prefix=8)
        streams.append(Engine(model, params, n_slots=2, max_len=32,
                              page_size=8, prefill_chunk_tokens=16).run(reqs))
    assert streams[0] == streams[1]
    assert sum(len(v) for v in streams[0].values()) > 0


def test_fold_refuses_off_mask_mass():
    from repro_torch.core.export import FoldResidualError
    _, _, tm, tp = _pair()
    bad = params_from_numpy(tm, jax.tree.map(
        lambda a: np.asarray(a) + 1e-3, params_to_numpy(tp)), device="cpu")
    with pytest.raises(FoldResidualError):
        tm.to_packed(bad)


def test_params_round_trip_through_numpy():
    """``params_to_numpy`` inverts ``params_from_numpy`` bit for bit, bf16
    leaves included."""
    _, _, tm, tp = _pair("bfloat16")
    back = params_from_numpy(tm, params_to_numpy(tp), device="cpu")
    for a, b in zip(tree_lib.leaves(tp), tree_lib.leaves(back)):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)


# ------------------------------------------------------------------ launcher
def test_train_launcher_runs_on_cpu(capsys):
    tlaunch.main(["--arch", "olmo-1b", "--smoke", "--mpd-mode",
                  "masked_dense", "--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "olmo-smoke: 94,208 params" in out
    assert "final loss" in out


def test_train_launcher_default_mode_runs_on_cpu(capsys):
    """Without ``--mpd-mode`` the launcher trains in the config's own
    packed mode."""
    tlaunch.main(["--arch", "olmo-1b", "--smoke", "--steps", "3",
                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out
    assert all(math.isfinite(float(ln.split()[3]))
               for ln in out.splitlines() if ln.startswith("step "))
