"""Port parity, train checkpoints and resume: ``repro_torch.train.run``
checkpoints params, optimizer state and the data stream on a background
thread and resumes from the newest checkpoint, and the train checkpoints
pass between the JAX package and the port in both directions.

* A perm-fused packed smoke run stopped after 3 steps and resumed for 3
  more gives the uninterrupted 6-step run's losses, params and moments bit
  for bit.
* A pending save survives an in-place write to the saved tensors made
  right after ``save`` returns; a failed background write raises from
  ``wait_pending``.
* A port-written train checkpoint restores in ``repro.checkpoint.restore``
  and a JAX-written one in the port (float32: numpy has no bfloat16), the
  optimizer's step as a 0-d int32 leaf.
* ``SyntheticLM.state`` equals the reference's, and a restored stream
  continues the reference's batches.

Everything here is exact.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import common as jcommon
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build as jbuild
from repro.optim import optimizer as jopt
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.optim import optimizer as topt
from repro_torch.train import TrainConfig, run
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

SEQ, BATCH = 16, 2
OPT = dict(lr=3e-3, clip_norm=1.0, schedule="cosine", warmup_steps=1,
           total_steps=6)


def _model(**over):
    return tbuild(tcommon.get_config("olmo-1b", smoke=True, **over))


def _tcfg(ckpt_dir="", every=0):
    return TrainConfig(opt=topt.OptConfig(**OPT), ckpt_dir=str(ckpt_dir),
                       ckpt_every=every, log_every=0)


def _equal_trees(a, b):
    la, lb = list(tree_lib.leaves(a)), list(tree_lib.leaves(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """6 steps of the perm-fused packed smoke model, checkpointed every 3."""
    d = tmp_path_factory.mktemp("run_a")
    model = _model(mpd_fuse=True)
    out = run(model, _tcfg(d, 3), SyntheticLM(96, SEQ, BATCH, seed=0), 6,
              device="cpu")
    return model, out, d


def test_resume_is_bitwise_the_uninterrupted_run(uninterrupted, tmp_path):
    model, full, d_full = uninterrupted
    assert tckpt.latest_step(str(d_full)) == 6
    first = run(model, _tcfg(tmp_path, 3), SyntheticLM(96, SEQ, BATCH, seed=0),
                3, device="cpu")
    assert first["start_step"] == 0 and len(first["history"]) == 3
    assert tckpt.latest_step(str(tmp_path)) == 3
    # a fresh stream and a fresh run: both resume from step 3
    rest = run(model, _tcfg(tmp_path, 3), SyntheticLM(96, SEQ, BATCH, seed=0),
               6, device="cpu")
    assert rest["start_step"] == 3
    assert first["history"] + rest["history"] == full["history"]
    assert _equal_trees(rest["params"], full["params"])
    assert rest["opt_state"]["step"] == full["opt_state"]["step"] == 6
    assert _equal_trees(rest["opt_state"], full["opt_state"])
    assert rest["ckpt_save_s"] >= 0 and rest["ckpt_wait_s"] >= 0


def test_pending_save_survives_an_in_place_write(tmp_path, monkeypatch):
    """The write thread is held until the caller has overwritten every
    saved tensor in place: the checkpoint holds the values at ``save``."""
    release = threading.Event()
    real_write = tckpt._write

    def held_write(*args):
        assert release.wait(30)
        real_write(*args)
    monkeypatch.setattr(tckpt, "_write", held_write)
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": [torch.ones(4, dtype=torch.bfloat16)], "step": 7}
    want = tree_lib.map_leaves(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)
    tckpt.save(str(tmp_path), 1, tree, blocking=False)
    for t in tree_lib.leaves(tree):
        if isinstance(t, torch.Tensor):
            t.mul_(-3).add_(1)
    assert tckpt.latest_step(str(tmp_path)) is None     # not yet published
    release.set()
    tckpt.wait_pending()
    assert tckpt.latest_step(str(tmp_path)) == 1
    got = tckpt.restore(str(tmp_path), 1, want, device="cpu")
    assert _equal_trees(got, want) and got["step"] == 7


def test_failed_background_write_raises_from_wait_pending(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    tckpt.save(str(blocker), 1, {"a": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError):
        tckpt.wait_pending()
    tckpt.wait_pending()                                # nothing left


def test_port_train_checkpoint_restores_in_jax(uninterrupted):
    """The 6-step run's checkpoint (perm-fused packed, f32) read by the
    reference into its own structure: every leaf equal, the step an int32
    0-d leaf."""
    model, full, d = uninterrupted
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True, mpd_fuse=True))
    like = jax.eval_shape(lambda k: (lambda p: {
        "params": p, "opt": jopt.init_state(jopt.OptConfig(**OPT), p)})(
        jm.init(k)), jax.random.PRNGKey(0))             # shapes only
    got = jckpt.restore(str(d), 6, like)
    assert got["opt"]["step"].dtype == np.int32 and int(got["opt"]["step"]) == 6
    want = {"params": full["params"], "opt": full["opt_state"]}
    for (k, w), g in zip(tree_lib.leaves_with_paths(want),
                         jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)
    assert jckpt.load_extra(str(d), 6)["data"] == {"step": 6, "seed": 0}


def test_jax_train_checkpoint_restores_in_the_port(tmp_path):
    """A train state saved by ``repro.checkpoint.save`` as
    ``repro.train.run`` saves it (``{"params", "opt"}`` after 2 AdamW
    steps, the data stream's state beside) restores in the port, the step
    as an int, and the port resumes training from it."""
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    tm = _model()
    jcfg = jopt.OptConfig(**OPT)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    jst = jopt.init_state(jcfg, jp)
    rng = np.random.default_rng(0)
    update = jax.jit(lambda p, g, st: jopt.apply_updates(jcfg, p, g, st))
    for _ in range(2):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), jp)
        jp, jst, _ = update(jp, grads, jst)
    data = JSyntheticLM(96, SEQ, BATCH, seed=0)
    data.next(), data.next()
    jckpt.save(str(tmp_path), 2, {"params": jp, "opt": jst},
               extra={"data": data.state()})
    like_p = tm.init(0, device="cpu")
    like = {"params": like_p, "opt": topt.init_state(topt.OptConfig(**OPT),
                                                     like_p)}
    got = tckpt.restore(str(tmp_path), 2, like, device="cpu")
    assert got["opt"]["step"] == 2 and isinstance(got["opt"]["step"], int)
    want_p = params_from_numpy(tm, jax.tree.map(np.asarray, jp),
                               device="cpu")
    assert _equal_trees(got["params"], want_p)
    for key in ("mu", "nu"):
        for g, w in zip(tree_lib.leaves(got["opt"][key]),
                        jax.tree.leaves(jst[key])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    stream = SyntheticLM(96, SEQ, BATCH, seed=0)
    out = run(tm, _tcfg(tmp_path), stream, 3, device="cpu")
    assert out["start_step"] == 2 and len(out["history"]) == 1
    assert stream.state() == {"step": 3, "seed": 0}
    assert np.isfinite(out["history"][0])
    assert params_to_numpy(out["params"]).keys() == want_p.keys()


def test_synthetic_lm_state_matches_jax():
    a = SyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=3)
    b = JSyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=3)
    assert a.state() == b.state() == {"step": 0, "seed": 3}
    for _ in range(3):
        a.next(), b.next()
    assert a.state() == b.state() == {"step": 3, "seed": 3}
    c = SyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=3)
    c.restore(b.state())
    np.testing.assert_array_equal(c.next()["inputs"], b.next()["inputs"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticLM(vocab=96, seq_len=8, global_batch=2, seed=4).restore(
            a.state())


def test_train_launcher_ckpt_dir_resumes(tmp_path, capsys):
    """``--ckpt-dir`` alone: a checkpoint every 50 steps, and a second
    launch with more steps resumes at the newest one."""
    argv = ["--arch", "olmo-1b", "--smoke", "--seq-len", "8",
            "--global-batch", "1", "--ckpt-dir", str(tmp_path), "--device",
            "cpu"]
    tlaunch.main(argv + ["--steps", "50"])
    assert tckpt.latest_step(str(tmp_path)) == 50
    out = tlaunch.main(argv + ["--steps", "52", "--compress-grads"])
    assert out["start_step"] == 50 and len(out["history"]) == 2
    assert "step     50 loss" in capsys.readouterr().out
    # nothing left to run: resumes at the newest step and says so
    out = tlaunch.main(argv + ["--steps", "50"])
    assert out["start_step"] == 50 and out["history"] == []
    assert "no step left" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="A11"):
        tlaunch.main(argv + ["--steps", "1", "--data-axis", "2"])
