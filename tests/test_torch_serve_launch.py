"""Port parity, the serve launcher: the port's ``repro_torch.launch.serve``
against the JAX package's ``repro.launch.serve`` on the CPU.

Both launchers restore the same weights from one train checkpoint written
by ``repro.checkpoint`` (``{"params": ...}``, the reference's layout), so
their greedy streams can be compared token for token: the slot-dense
default, ``--quantize int4`` and ``--paged --prefill-kernel interpret``
(the reference's ``jnp`` route, the same function) as CI runs them, and
``--static``, whose lockstep tokens are the reference model's own prefill
and greedy decode. Also held: ``--quantize int4`` against the reference's
``quantize_packed(bits=4)`` (values exact, scales within 1e-6), a
masked-dense train checkpoint served with ``--fold-to-packed --ckpt-dir``
against the reference ``_load_model``'s packed params (within 1e-6), the
``--prefill-kernel`` routes and the launcher's refusals. ``--chaos-schedule
storm --chaos-verify`` streams the reference launcher's tokens and injects
its faults (exact), and ``--http`` hands the engine, host, port and queue
limit to the server.
"""

import argparse
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.checkpoint import checkpoint as jckpt
from repro.configs import common as jcommon
from repro.core import export as jexport
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import build as jbuild
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import build as tbuild

TOL = 1e-6
SMOKE = ["--arch", "olmo-1b", "--smoke"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A train checkpoint of the smoke config's packed init, as the JAX
    trainer writes one (params and an optimizer subtree)."""
    d = str(tmp_path_factory.mktemp("train"))
    jm = jbuild(jcommon.get_config("olmo-1b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    jckpt.save(d, 3, {"params": jp, "opt": {"count": jnp.zeros((), jnp.int32)}})
    return d, jm, jp


def _ref_streams(monkeypatch, argv):
    """The reference launcher's greedy streams for ``argv``."""
    seen = {}
    real = jserve.serve_stream

    def capture(engine, requests, **kw):
        seen["reqs"] = requests
        return real(engine, requests, **kw)
    monkeypatch.setattr(jserve, "serve_stream", capture)
    monkeypatch.setattr(jops, "_PREFILL_BACKEND", None)
    jserve.main(argv)
    return {r.id: list(r.generated) for r in seen["reqs"]}


@pytest.mark.parametrize("extra", [
    [],
    ["--quantize", "int4"],
    ["--requests", "4", "--quantize", "int8", "--paged", "--page-size", "8",
     "--prefill-chunk", "8", "--prompt-len", "48", "--shared-prefix", "16",
     "--prefill-kernel", "interpret"],
], ids=["dense", "int4", "paged_prefill_kernel"])
def test_ci_serve_commands_stream_the_reference_tokens(ckpt, monkeypatch,
                                                       extra):
    d = ckpt[0]
    argv = SMOKE + ["--requests", "6", "--ckpt-dir", d] + extra
    got = tserve.main(argv + ["--device", "cpu"])
    assert got["n_done"] == got["n_requests"] == (4 if "--paged" in extra
                                                  else 6)
    assert ops.prefill_backend() == ops.get_backend()   # put back after
    ref = [a if a != "interpret" else "jnp" for a in argv]
    assert got["streams"] == _ref_streams(monkeypatch, ref)


def test_static_batch_is_the_reference_lockstep_greedy(ckpt, caplog):
    """``--static --batch 2 --prompt-len 16 --gen 8``: the lockstep tokens
    are the reference model's prefill and greedy decode of the same
    ``SyntheticLM(seed=0)`` prompts; the log says the decode ran eagerly."""
    d, jm, jp = ckpt
    with caplog.at_level(logging.INFO, logger="repro_torch.serve.launch"):
        out = tserve.main(SMOKE + ["--static", "--batch", "2", "--prompt-len",
                                   "16", "--gen", "8", "--ckpt-dir", d,
                                   "--device", "cpu"])
    assert "decode 7 steps (eager)" in caplog.text
    prompts = jnp.asarray(JSyntheticLM(vocab=96, seq_len=16, global_batch=2,
                                       seed=0).next()["inputs"])
    lg, caches = jm.prefill(jp, prompts, jm.init_caches(2, 24))
    tok = jnp.argmax(lg, -1)
    want = [tok]
    for _ in range(7):
        lg, caches = jm.decode_step(jp, tok, caches)
        tok = jnp.argmax(lg, -1)
        want.append(tok)
    np.testing.assert_array_equal(out["tokens"], np.stack(want, 1))


def _leaves_close(got, want):
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        g, w = np.asarray(flat_g[k]), np.asarray(w)
        assert g.dtype == w.dtype, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL)


def test_quantize_int4_gives_the_reference_values_and_scales(ckpt):
    _, jm, jp = ckpt
    tm = tbuild(tcommon.get_config("olmo-1b", smoke=True))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    got = tserve._quantize_in_memory(tm, tp, "int4")
    want, _ = jexport.quantize_packed(jm, jp, bits=4)
    assert tm.quant_report["bits"] == 4
    _leaves_close(params_to_numpy(got), jax.tree.map(np.asarray, want))
    q = [v for k, v in jax.tree_util.tree_flatten_with_path(
        params_to_numpy(got))[0] if "w_q" in jax.tree_util.keystr(k)]
    assert q and all(np.abs(a).max() <= 7 for a in q)


@pytest.mark.parametrize("fuse,quantize", [(False, ""), (True, "int8")],
                         ids=["plain", "fused_int8"])
def test_fold_to_packed_serves_a_reference_train_checkpoint(tmp_path, fuse,
                                                            quantize):
    """A masked-dense train checkpoint written by ``repro.checkpoint``,
    loaded with ``--fold-to-packed --ckpt-dir``: the port's packed params
    are the reference ``_load_model``'s, and the launcher serves them."""
    over = {"mpd_fuse": True} if fuse else {}
    jmd = jbuild(jcommon.get_config("olmo-1b", smoke=True,
                                    mpd_mode="masked_dense", **over))
    jpm = jmd.mask_projection(jmd.init(jax.random.PRNGKey(5)))
    jckpt.save(str(tmp_path), 7, {"params": jpm})
    args = argparse.Namespace(arch="olmo-1b", smoke=True, mpd_c=0,
                              mpd_fuse=fuse, ckpt_dir=str(tmp_path),
                              fold_to_packed=True, quantize=quantize)
    _, _, want = jserve._load_model(args)
    _, tm, got = tserve.load_model("olmo-1b", smoke=True, mpd_fuse=fuse,
                                   fold_to_packed=True, quantize=quantize,
                                   ckpt_dir=str(tmp_path), device="cpu",
                                   seed=1)
    assert tm.cfg.mpd_mode == "packed" and tm.cfg.mpd_fuse == fuse
    _leaves_close(params_to_numpy(got), jax.tree.map(np.asarray, want))
    flags = ["--mpd-fuse"] if fuse else []
    flags += ["--quantize", quantize] if quantize else []
    s = tserve.main(SMOKE + ["--fold-to-packed", "--ckpt-dir", str(tmp_path),
                             "--requests", "3", "--device", "cpu"] + flags)
    assert s["n_done"] == 3


def test_mpd_c_sets_the_compression():
    cfg, _, params = tserve.load_model("olmo-1b", smoke=True, mpd_c=2,
                                       device="cpu")
    assert cfg.mpd_c == 2
    assert params["blocks"][0]["mixer"]["wq"]["w"].shape[1] == 2


def test_prefill_kernel_routes(monkeypatch, caplog):
    """``--prefill-kernel``: pallas and interpret take the CUDA kernel,
    jnp the plain version; the route is set while the engine serves and
    put back after."""
    assert tserve.PREFILL_ROUTES == {"pallas": "cuda", "interpret": "cuda",
                                     "jnp": "torch"}
    with caplog.at_level(logging.INFO, logger="repro_torch.serve.launch"):
        s = tserve.main(SMOKE + ["--paged", "--prefill-kernel", "jnp",
                                 "--requests", "2", "--device", "cpu"])
    assert s["n_done"] == 2
    assert "[torch prefill route]" in caplog.text
    assert ops.prefill_backend() == "cuda"
    ops.set_prefill_backend("torch")
    try:
        assert ops.prefill_backend() == "torch" and ops.get_backend() == "cuda"
    finally:
        ops.set_prefill_backend(None)
    with pytest.raises(ValueError):
        ops.set_prefill_backend("pallas")


def test_default_engine_is_dense_and_paged_needs_the_flag(monkeypatch):
    """Deliberate difference: the port's ``Engine`` defaults to
    ``paged=True``; the launcher passes ``--paged`` through, so without it
    the CLI builds the slot-dense engine, as the reference's does."""
    built = []
    real = tserve.Engine

    def spy(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]
    monkeypatch.setattr(tserve, "Engine", spy)
    tserve.main(SMOKE + ["--requests", "1", "--device", "cpu"])
    tserve.main(SMOKE + ["--requests", "1", "--paged", "--device", "cpu"])
    assert [e.paged for e in built] == [False, True]
    _, tm, tp = tserve.load_model("olmo-1b", smoke=True, device="cpu")
    assert real(tm, tp).paged


@pytest.mark.parametrize("argv,match", [
    (["--static", "--paged"], "mutually exclusive"),
    (["--spec-draft", "x"], "--paged"),
    (["--prefill-kernel", "jnp"], "combine with --paged"),
    (["--chaos-verify"], "needs --chaos-schedule"),
    (["--replicas", "2"], "queue A item 4"),
    (["--disagg", "--paged"], "queue A item 4"),
    (["--n-prefill", "2"], "queue A item 4"),
    (["--chaos-schedule", "storm", "--chaos-verify", "--http"],
     "cannot combine with --http"),
    (["--tp", "2"], "queue A item 6"),
])
def test_launcher_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        tserve.main(SMOKE + argv + ["--device", "cpu"])


def test_empty_ckpt_dir_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        tserve.main(SMOKE + ["--ckpt-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no checkpoint under"):
        tserve.main(SMOKE + ["--fold-to-packed", "--ckpt-dir", str(tmp_path),
                             "--device", "cpu"])


def test_chaos_verify_streams_the_reference_tokens(ckpt, monkeypatch):
    """``--paged --chaos-schedule storm --chaos-verify``: the chaos run's
    streams, the faults it injected and the verify's verdict are the
    reference launcher's."""
    d = ckpt[0]
    argv = SMOKE + ["--requests", "6", "--ckpt-dir", d, "--paged",
                    "--page-size", "8", "--chaos-schedule", "storm",
                    "--chaos-verify"]
    got = tserve.main(argv + ["--device", "cpu"])
    assert got["chaos_verify"] == {"identical": 6, "aborted": 0,
                                   "requests": 6}
    seen = []
    real = jserve.serve_stream

    def capture(engine, requests, **kw):
        seen.append((engine, requests))
        return real(engine, requests, **kw)
    monkeypatch.setattr(jserve, "serve_stream", capture)
    monkeypatch.setattr(jops, "_PREFILL_BACKEND", None)
    jserve.main(argv)
    engine, reqs = seen[0]
    assert got["streams"] == {r.id: list(r.generated) for r in reqs}
    faults = got["resilience"]["faults_injected"]
    assert faults == engine.resilience.summary()["faults_injected"]
    assert faults["decode_logits"] == 2 and faults["engine_step"] == 1
    assert got["n_step_faults"] == 1 and got["n_quarantines"] >= 1


def test_http_hands_the_engine_to_the_server(monkeypatch):
    """``--http``: the launcher builds the engine (with the degradation
    ladder) and calls the server's ``run`` with the host, port and queue
    limit."""
    from repro_torch.serve import server as server_lib

    seen = {}
    monkeypatch.setattr(server_lib, "run",
                        lambda engine, **kw: seen.update(engine=engine, **kw))
    tserve.main(SMOKE + ["--http", "--paged", "--port", "0",
                         "--queue-limit", "3", "--device", "cpu"])
    assert seen["host"] == "127.0.0.1" and seen["port"] == 0
    assert seen["queue_limit"] == 3
    assert seen["engine"].paged
    assert seen["engine"].resilience.ladder is not None
