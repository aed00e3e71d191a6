"""Port parity, the embed frontends and M-RoPE: hubert-xlarge (an encoder
on frame embeddings) and qwen2-vl-72b (a GQA decoder with M-RoPE on patch
and token embeddings), each against the JAX package at smoke width, from
the reference's params carried over with ``params_from_numpy``, float32.

* ``layers.mrope_cos_sin`` with distinct temporal, height and width rows,
  at sections (4, 2, 2) and qwen2-vl's (16, 24, 24);
* ``attention.apply_train`` of qwen2-vl's first layer on explicit
  three-row positions, and on the default (text: t == h == w);
* ``logits`` and ``train_loss`` of ``tests/test_models.py``'s ``ENCODER``
  config, of the hubert smoke (also at 256 frames: the non-causal
  attention chunked over queries) and of the qwen2-vl smoke;
* qwen2-vl smoke: a dense ``prefill`` of embeds, then ``decode_step`` on
  ``(B, 1, D)`` embeds; two paged ``prefill_chunk`` calls, decode steps
  under a live mask and a ``verify_step`` window, logits, pools and ``pos``
  after each call. The reference's ``verify_step`` embeds token ids
  whatever the frontend, so it is given an embedding table and ids, and
  the port the same rows of that table times sqrt(d_model);
* a packed artifact of the qwen2-vl smoke (no ``embed`` leaf) written by
  either package loads in the other, byte for byte, with the same
  manifest;
* the launchers: ``--arch qwen2-vl-72b --smoke --static`` prefills and
  skips the decode; ``--arch hubert-xlarge`` and an embed frontend without
  ``--static`` exit with the reference launcher's messages; ``Engine``
  refuses an embed model as the reference's does; the train launcher
  refuses one.

Tolerance: atol = rtol = 1e-5 (float32, summation order), ``pos`` and
artifact bytes exact.
"""

import dataclasses
import functools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import common as jcommon
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import build as jbuild
from repro.models import layers as jlayers
from repro.serve import Engine as JEngine
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import common as tcommon
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import ModelConfig as TModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import build as tbuild
from repro_torch.models import layers as tlayers
from repro_torch.serve import Engine
from test_models import ENCODER
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

ATOL = RTOL = 1e-5
PS, N_PAGES, N_SLOTS = 8, 12, 2
VL = "qwen2-vl-72b"


def _port_config(jcfg):
    """The port's config of a reference config (every field but
    ``remat``)."""
    return TModelConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                           if k != "remat"})


@functools.lru_cache(maxsize=None)
def _pair(name):
    """Both packages' models of ``name`` (an arch's smoke config, or
    ``"encoder"``) on the reference's params."""
    jcfg = (ENCODER if name == "encoder"
            else jcommon.get_config(name, smoke=True))
    jm = jbuild(jcfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = tbuild(_port_config(jcfg))
    return jm, jp, tm, params_from_numpy(tm, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _embeds(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close_caches(tc, jc):
    for t, j in zip(tc, jc):
        assert set(t) == set(j)
        for k in j:
            if k == "pos":
                np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
            else:
                _close(t[k], j[k])


@pytest.mark.parametrize("sections,head_dim", [((4, 2, 2), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_cos_sin_matches_jax(sections, head_dim):
    rng = np.random.default_rng(1)
    pos3 = rng.integers(0, 4096, (3, 2, 12)).astype(np.int32)
    assert not (pos3[0] == pos3[1]).all()
    jc, js = jlayers.mrope_cos_sin(jnp.asarray(pos3), head_dim, sections)
    tc, ts = tlayers.mrope_cos_sin(torch.from_numpy(pos3), head_dim,
                                   sections)
    assert tc.shape == (2, 12, head_dim // 2)
    _close(tc, jc)
    _close(ts, js)
    with pytest.raises(AssertionError):
        tlayers.mrope_cos_sin(torch.from_numpy(pos3), head_dim + 2, sections)


@pytest.mark.parametrize("explicit", [True, False])
def test_apply_train_on_mrope_positions(explicit):
    jm, jp, tm, tp = _pair(VL)
    jspec, tspec = jm.block_specs[0]["mixer"], tm.block_specs[0]["mixer"]
    assert tspec.rope == "mrope" and tspec.mrope_sections == (4, 2, 2)
    jpar = jax.tree.map(lambda a: a[0], jp["blocks"][0]["mixer"])
    tpar = tree_lib.map_leaves(lambda t: t[0], tp["blocks"][0]["mixer"])
    x = _embeds((2, 10, jm.cfg.d_model), 3)
    pos3 = (np.random.default_rng(4).integers(0, 50, (3, 2, 10)).astype(
        np.int32) if explicit else None)
    want = jattn.apply_train(jspec, jpar, jnp.asarray(x),
                             None if pos3 is None else jnp.asarray(pos3))
    with torch.no_grad():
        got = tattn.apply_train(tspec, tpar, torch.from_numpy(x),
                                None if pos3 is None
                                else torch.from_numpy(pos3))
    _close(got, want)


@pytest.mark.parametrize("name,T", [("encoder", 16), ("hubert-xlarge", 16),
                                    ("hubert-xlarge", 256), (VL, 16)])
def test_logits_and_train_loss_match_jax(name, T):
    """At T = 256 the non-causal attention runs chunked (two query chunks
    of ``q_chunk`` 128), each chunk seeing every position."""
    jm, jp, tm, tp = _pair(name)
    assert "embed" not in tp
    assert tm.param_count() == jm.param_count()
    assert tm.active_matmul_params() == jm.active_matmul_params()
    assert T <= jm.cfg.q_chunk or T % jm.cfg.q_chunk == 0
    x = _embeds((2, T, jm.cfg.d_model), 5)
    labels = np.random.default_rng(6).integers(
        0, jm.cfg.vocab, (2, T)).astype(np.int32)
    batch = {"inputs": jnp.asarray(x), "labels": jnp.asarray(labels)}
    jl = jax.jit(jm.logits)(jp, batch["inputs"])
    jloss = jax.jit(jm.train_loss)(jp, batch)
    with torch.no_grad():
        tx = torch.from_numpy(x)
        _close(tm.logits(tp, tx), jl)
        tloss = tm.train_loss(tp, {"inputs": tx,
                                   "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


def test_dense_prefill_and_decode_on_embeds_match_jax():
    jm, jp, tm, tp = _pair(VL)
    D = jm.cfg.d_model
    x = _embeds((2, 12, D), 7)
    jl, jc = jax.jit(jm.prefill)(jp, jnp.asarray(x), jm.init_caches(2, 16))
    with torch.no_grad():
        tl, tc = tm.prefill(tp, torch.from_numpy(x),
                            tm.init_caches(2, 16, device="cpu"))
    _close(tl, jl)
    _close_caches(tc, jc)
    decode = jax.jit(jm.decode_step)
    for i in range(3):
        e = _embeds((2, 1, D), 20 + i)
        jl, jc = decode(jp, jnp.asarray(e), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(e), tc)
        _close(tl, jl)
        _close_caches(tc, jc)


def test_paged_chunks_decode_and_verify_on_embeds_match_jax():
    jm, jp, tm, tp = _pair(VL)
    D = jm.cfg.d_model
    chunk_fn = jax.jit(jm.prefill_chunk, static_argnames=("final",))
    jc = jm.init_paged_caches(N_SLOTS, N_PAGES, PS)
    tc = tm.init_paged_caches(N_SLOTS, N_PAGES, PS, device="cpu")
    prompt0, prompt1 = _embeds((27, D), 8), _embeds((9, D), 9)
    bt = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 0, 0, 0]], np.int32)
    for slot, prompt, pos in ((0, prompt0, 0), (0, prompt0, 16),
                              (1, prompt1, 0)):
        n = min(len(prompt) - pos, 16)
        chunk = np.zeros((1, 16, D), np.float32)
        chunk[0, :n] = prompt[pos:pos + n]
        final = pos + n >= len(prompt)
        row = bt[slot, :4]
        jl, jc = chunk_fn(jp, jnp.asarray(chunk), jc, jnp.asarray(row), slot,
                          pos, n, final=final)
        with torch.no_grad():
            tl, tc = tm.prefill_chunk(tp, torch.from_numpy(chunk), tc,
                                      torch.from_numpy(row), slot, pos, n,
                                      final=final)
        if final:
            _close(tl, jl)
        _close_caches(tc, jc)
    decode = jax.jit(jm.decode_step)
    for i, live in enumerate(([True, True], [True, False], [False, True])):
        live = np.array(live)
        e = _embeds((2, 1, D), 30 + i)
        jl, jc = decode(jp, jnp.asarray(e), jc, block_tables=jnp.asarray(bt),
                        live=jnp.asarray(live))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, torch.from_numpy(e), tc,
                                    torch.from_numpy(bt),
                                    live=torch.from_numpy(live))
        _close(tl, jl)
        _close_caches(tc, jc)
    # the reference's verify embeds ids from a table (times sqrt(d_model),
    # exact for d_model 64); the port takes those rows as embeds
    table = _embeds((jm.cfg.vocab, D), 10)
    ids = np.random.default_rng(11).integers(0, jm.cfg.vocab, (2, 3)).astype(
        np.int32)
    pos = np.array([29, 10], np.int32)
    jc = jm.set_paged_pos(jc, jnp.asarray(pos))
    jl, jc = jax.jit(jm.verify_step)(dict(jp, embed={"table": table}),
                                     jnp.asarray(ids), jc, jnp.asarray(bt))
    with torch.no_grad():
        tc = tm.set_paged_pos(tc, torch.from_numpy(pos))
        tl, tc = tm.verify_step(
            tp, torch.from_numpy(table[ids] * np.float32(np.sqrt(D))), tc,
            torch.from_numpy(bt))
    _close(tl, jl)
    _close_caches(tc, jc)


def _manifest(ckpt_dir, step):
    path = os.path.join(ckpt_dir, "packed", f"step_{step:09d}",
                        "manifest.json")
    with open(path) as f:
        return json.load(f)


def test_packed_artifact_without_embed_round_trips_both_ways(tmp_path):
    """A masked-dense qwen2-vl smoke (M-RoPE sections (4, 2, 2), no
    embedding table) exported by each package: the same manifest leaves,
    checksum and packed config; each loads the other's bytes."""
    jcfg = jcommon.get_config(VL, smoke=True, mpd_mode="masked_dense")
    jm, tm = jbuild(jcfg), tbuild(_port_config(jcfg))
    jp = jm.mask_projection(jax.jit(jm.init)(jax.random.PRNGKey(2)))
    tp = params_from_numpy(tm, jax.tree.map(np.asarray, jp), device="cpu")
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.export_packed(jdir, 1, jm, jp, quantize="int8")
    tckpt.export_packed(tdir, 1, tm, tp, quantize="int8")
    jman, tman = _manifest(jdir, 1), _manifest(tdir, 1)
    assert list(tman["leaves"]) == list(jman["leaves"])
    assert not any(name.startswith("params/embed/")
                   for name in jman["leaves"])
    for name, meta in jman["leaves"].items():
        assert tman["leaves"][name] == meta, name
    for key in ("artifact_crc32", "packed_config", "quantize"):
        assert tman["extra"][key] == jman["extra"][key], key
    assert tman["extra"]["packed_config"]["mrope_sections"] == [4, 2, 2]
    for src in (jdir, tdir):
        model, params = tckpt.load_packed(src, device="cpu")
        assert model.cfg.mrope_sections == (4, 2, 2)
        assert model.cfg.frontend == "embed" and "embed" not in params
        _, back = jckpt.load_packed(src)
        got = [t.numpy() for t in tree_lib.leaves(params)]
        assert len(got) == len(jax.tree.leaves(back)) and all(
            g.tobytes() == np.asarray(w).tobytes()
            for g, w in zip(got, jax.tree.leaves(back)))


STATIC = ["--arch", VL, "--smoke", "--static", "--batch", "2",
          "--prompt-len", "16", "--gen", "4"]


def test_static_embed_prefills_and_skips_the_decode(caplog):
    with caplog.at_level(logging.INFO):
        out = tserve.main(STATIC + ["--device", "cpu"])
    assert out["prefill_ms"] > 0
    assert out["logits"].shape == (2, 96)
    assert torch.isfinite(out["logits"]).all()
    text = caplog.text
    assert "prefill 2x16" in text
    assert "decode: skipped (embed frontend" in text
    assert "decode 3 steps" not in text


def _exit_message(main, argv):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return str(e.value)


@pytest.mark.parametrize("argv", [
    ["--arch", "hubert-xlarge", "--smoke", "--static"],
    ["--arch", VL, "--smoke", "--requests", "2"]])
def test_serve_launcher_refuses_what_the_reference_refuses(argv):
    want = _exit_message(jserve.main, argv)
    assert _exit_message(tserve.main, argv + ["--device", "cpu"]) == want
    assert ("encoder-only" in want) == (argv[1] == "hubert-xlarge")


@pytest.mark.parametrize("name", ["hubert-xlarge", VL])
def test_engine_refuses_an_embed_model(name):
    jm, jp, tm, tp = _pair(name)
    with pytest.raises(ValueError) as want:
        JEngine(jm, jp, n_slots=2, max_len=32)
    with pytest.raises(ValueError) as got:
        Engine(tm, tp, n_slots=2, max_len=32)
    assert str(got.value) == str(want.value)


def test_train_launcher_refuses_an_embed_frontend():
    msg = _exit_message(ttrain.main, ["--arch", VL, "--smoke", "--steps", "1",
                                      "--device", "cpu"])
    assert "embedding frontend" in msg


def test_configs_build_at_full_width_on_the_meta_device():
    """Both full configs build; qwen2-vl-72b's packed params are the
    reference's count (8.93 G at ``mpd_c=8``)."""
    for arch in ("hubert-xlarge", VL):
        tm = tbuild(tcommon.get_config(arch))
        assert tm.param_count() == jbuild(jcommon.get_config(arch)).param_count()
    assert tbuild(tcommon.get_config(VL)).param_count() == 8_933_613_568
