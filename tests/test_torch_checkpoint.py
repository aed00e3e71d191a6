"""Port parity, artifact I/O: the packed deployment artifact passes between
the JAX package and the port in both directions.

* fp, int8 and int4 artifacts, with and without the Fig-3 perm fusion,
  and a bfloat16 one, written by ``repro.checkpoint.export_packed`` load in
  ``repro_torch.checkpoint.load_packed`` into the reference's in-memory
  fold, leaf for leaf and bit for bit;
* an artifact written by the port loads in ``repro.checkpoint.load_packed``
  into the same tree, and its manifest's leaf names, ``artifact_crc32`` and
  packed config equal the reference's for the same params;
* a flipped byte in the shard, or two leaf names swapped in the manifest,
  raises ``ArtifactCorruptError``;
* the port's paged engine streams the JAX paged engine's greedy tokens on a
  perm-fused int8 artifact written by JAX (staggered admission, a shared
  prefix);
* the launchers run the deploy chain on the CPU: train masked-dense with
  ``--mpd-fuse``, fold, quantize and export; serve the artifact.

Every artifact is written inside the test; there are no binary fixtures.
Everything here is exact (trees, checksums, token streams).
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.models import ModelConfig as JModelConfig
from repro.models import build as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import ModelConfig as TModelConfig
from repro_torch.models import build as tbuild
from repro_torch.serve import Engine, Request
from test_torch_threads import one_torch_thread  # noqa: F401 - autouse

CFG = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
           vocab=96, mpd_c=4, mpd_mode="masked_dense", use_bias=True)


def _trained(fuse: bool, dtype: str = "float32"):
    """A masked-dense model in both packages with the same params, biases
    random per index (a wrong gate-bias re-index would show)."""
    kw = dict(CFG, mpd_fuse=fuse, dtype=dtype)
    jm, tm = jbuild(JModelConfig(**kw)), tbuild(TModelConfig(**kw))
    rng = np.random.default_rng(5)
    jp = jax.tree.map(
        lambda x: x + (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if x.ndim == 2 else x, jm.init(jax.random.PRNGKey(0)))
    jp = jm.mask_projection(jp)
    return jm, jp, tm, params_from_numpy(tm, jax.tree.map(np.asarray, jp),
                                         device="cpu")


def _raw(t: torch.Tensor) -> np.ndarray:
    """A leaf's bytes as numpy (bfloat16 as its 16-bit words)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _same_tree(t_tree, j_tree) -> bool:
    """Bit-identical leaves in the same order and of the same width."""
    got = list(tree_lib.leaves(t_tree))
    want = [np.asarray(w) for w in jax.tree.leaves(j_tree)]
    return len(got) == len(want) and all(
        g.shape == w.shape and _raw(g).tobytes() == w.tobytes()
        and _raw(g).dtype.itemsize == w.dtype.itemsize
        for g, w in zip(got, want))


def _manifest(ckpt_dir, step):
    path = os.path.join(ckpt_dir, "packed", f"step_{step:09d}",
                        "manifest.json")
    with open(path) as f:
        return json.load(f)


ARTIFACTS = [(False, None, "float32"), (True, None, "float32"),
             (False, "int8", "float32"), (True, "int8", "float32"),
             (False, "int4", "float32"), (True, "int4", "float32"),
             (True, None, "bfloat16")]


@pytest.mark.parametrize("fuse,quantize,dtype", ARTIFACTS)
def test_jax_artifact_loads_into_the_reference_fold(tmp_path, fuse, quantize,
                                                     dtype):
    jm, jp, _, _ = _trained(fuse, dtype)
    jckpt.export_packed(str(tmp_path), 3, jm, jp, fuse=fuse,
                        quantize=quantize)
    model, params = tckpt.load_packed(str(tmp_path), device="cpu")
    # an int4 artifact unpacks to the int8 form of its qmax-7 blocks
    _, jpp = jm.to_packed(jp, fuse=fuse, quantize=quantize)
    assert _same_tree(params, jpp)
    assert model.cfg.mpd_fuse == fuse and model.cfg.dtype == dtype
    assert all(b["ffn"].fused_packed() == fuse for b in model.block_specs)
    if quantize:
        assert model.quant_report["bits"] == (4 if quantize == "int4" else 8)


@pytest.mark.parametrize("fuse,quantize,dtype", ARTIFACTS)
def test_port_artifact_loads_in_jax_with_the_same_manifest(
        tmp_path, fuse, quantize, dtype):
    jm, jp, tm, tp = _trained(fuse, dtype)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.export_packed(jdir, 4, jm, jp, fuse=fuse, quantize=quantize)
    tckpt.export_packed(tdir, 4, tm, tp, fuse=fuse, quantize=quantize)
    jman, tman = _manifest(jdir, 4), _manifest(tdir, 4)
    assert list(tman["leaves"]) == list(jman["leaves"])
    for name, meta in jman["leaves"].items():
        assert tman["leaves"][name] == meta, name
    for key in ("artifact_crc32", "packed_config", "perm_fused", "quantize",
                "source_step"):
        assert tman["extra"][key] == jman["extra"][key], key
    if quantize:
        assert tman["extra"]["quant_report"]["n_layers"] \
            == jman["extra"]["quant_report"]["n_layers"]
    _, from_port = jckpt.load_packed(tdir)
    _, from_jax = jckpt.load_packed(jdir)
    assert all(np.asarray(a).tobytes() == np.asarray(b).tobytes()
               for a, b in zip(jax.tree.leaves(from_port),
                               jax.tree.leaves(from_jax)))


def test_reference_reads_bf16_leaves_as_raw_words(tmp_path):
    """numpy has no bfloat16: the reference's ``load_packed`` returns a
    bf16 artifact's leaves as raw ``|V2`` words (which JAX cannot compute
    with); the port reads the same words as ``torch.bfloat16``."""
    jm, jp, _, _ = _trained(False, "bfloat16")
    jckpt.export_packed(str(tmp_path), 0, jm, jp)
    _, jparams = jckpt.load_packed(str(tmp_path))
    _, tparams = tckpt.load_packed(str(tmp_path), device="cpu")
    jw = np.asarray(jparams["blocks"][0]["mixer"]["wq"]["w"])
    tw = tparams["blocks"][0]["mixer"]["wq"]["w"]
    assert jw.dtype.kind == "V" and tw.dtype == torch.bfloat16
    assert _raw(tw).tobytes() == jw.tobytes()


def _export(tmp_path, quantize="int8"):
    jm, jp, _, _ = _trained(True)
    jckpt.export_packed(str(tmp_path), 0, jm, jp, fuse=True, quantize=quantize)
    return os.path.join(str(tmp_path), "packed", "step_000000000")


def test_flipped_byte_raises(tmp_path):
    d = _export(tmp_path)
    tckpt.load_packed(str(tmp_path), device="cpu")          # clean load
    shard = os.path.join(d, "shard_00000.npz")
    raw = bytearray(open(shard, "rb").read())
    # a byte in the middle of the shard: inside an array's data or header
    raw[len(raw) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(tckpt.ArtifactCorruptError):
        tckpt.load_packed(str(tmp_path), device="cpu")


def test_swapped_leaf_names_raise(tmp_path):
    """Two same-shape leaves swapped in the manifest pass every per-leaf
    crc; the artifact checksum catches them."""
    d = _export(tmp_path, quantize=None)
    path = os.path.join(d, "manifest.json")
    man = json.load(open(path))
    leaves = man["leaves"]
    a, b = "params/blocks/0/mixer/wk/w", "params/blocks/0/mixer/wv/w"
    assert leaves[a]["shape"] == leaves[b]["shape"]
    leaves[a], leaves[b] = leaves[b], leaves[a]
    json.dump(man, open(path, "w"))
    with pytest.raises(tckpt.ArtifactCorruptError, match="checksum"):
        tckpt.load_packed(str(tmp_path), device="cpu")


def test_unreadable_manifest_raises(tmp_path):
    d = _export(tmp_path)
    open(os.path.join(d, "manifest.json"), "w").write("{not json")
    with pytest.raises(tckpt.ArtifactCorruptError, match="manifest"):
        tckpt.load_packed(str(tmp_path), device="cpu")


def test_config_fields_and_foreign_defaults_equal_reference():
    jfields = [(f.name, f.default) for f in dataclasses.fields(JModelConfig)]
    assert tuple(n for n, _ in jfields) == tckpt.CONFIG_FIELDS
    own = {f.name for f in dataclasses.fields(TModelConfig)}
    assert {n: d for n, d in jfields if n not in own} \
        == tckpt.FOREIGN_CONFIG_DEFAULTS
    cfg = TModelConfig(**dict(CFG, mpd_fuse=True))
    d = json.loads(json.dumps(tckpt.config_to_dict(cfg)))
    assert d == json.loads(json.dumps(
        dataclasses.asdict(JModelConfig(**dict(CFG, mpd_fuse=True)))))
    assert tckpt.config_from_dict(d) == cfg
    # the MoE, recurrent and M-RoPE fields are the port's own; a remat the
    # reference does not have still raises
    moe = tckpt.config_from_dict(dict(d, moe_experts=8, moe_top_k=2,
                                      rwkv_head_dim=32, mamba_expand=4,
                                      mrope_sections=[8, 8, 16]))
    assert (moe.moe_experts, moe.moe_top_k, moe.rwkv_head_dim,
            moe.mamba_expand, moe.mrope_sections) == (8, 2, 32, 4, (8, 8, 16))
    assert tckpt.config_to_dict(moe)["mrope_sections"] == (8, 8, 16)
    assert tckpt.config_from_dict(dict(d, remat="none")) == cfg
    with pytest.raises(ValueError, match="remat"):
        tckpt.config_from_dict(dict(d, remat="everything"))
    with pytest.raises(ValueError, match="no_such_field"):
        tckpt.config_from_dict(dict(d, no_such_field=1))


def test_save_restore_publishes_atomically(tmp_path):
    tree = {"b": [torch.arange(6, dtype=torch.int8).reshape(2, 3)],
            "a": {"w": torch.linspace(-1, 1, 5).to(torch.bfloat16),
                  "none": None}}
    d = tckpt.save(str(tmp_path), 12, tree, extra={"k": 1})
    assert os.path.exists(os.path.join(d, ".complete"))
    assert not os.path.exists(d + ".tmp")
    assert tckpt.latest_step(str(tmp_path)) == 12
    assert tckpt.load_extra(str(tmp_path), 12) == {"k": 1}
    names = list(_manifest_of(d)["leaves"])
    assert names == ["a/w", "b/0"]               # sorted keys, None dropped
    back = tckpt.restore(str(tmp_path), 12, tree, device="cpu")
    assert back["a"]["none"] is None
    assert torch.equal(back["a"]["w"], tree["a"]["w"])
    assert torch.equal(back["b"][0], tree["b"][0])
    # the reference reads the same directory
    jtree = jckpt.restore(str(tmp_path), 12, jax.tree.map(np.asarray, {
        "a": {"w": np.zeros(5, np.float32)}, "b": [np.zeros((2, 3))]}))
    assert np.asarray(jtree["b"][0]).tolist() == [[0, 1, 2], [3, 4, 5]]


def _manifest_of(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def test_port_engine_streams_jax_engine_tokens_on_a_jax_artifact(tmp_path):
    """A perm-fused int8 artifact written by JAX, served by both paged
    engines: staggered admission, a 16-token shared prefix, chunked
    prefill. Token streams must be identical."""
    jm, jp, _, _ = _trained(True)
    jckpt.export_packed(str(tmp_path), 1, jm, jp, fuse=True, quantize="int8")
    jmodel, jparams = jckpt.load_packed(str(tmp_path))
    tmodel, tparams = tckpt.load_packed(str(tmp_path), device="cpu")
    assert all(b["ffn"].fused_packed() for b in tmodel.block_specs)
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, 96, size=16)
    prompts = [(np.concatenate([prefix, rng.integers(0, 96, size=n)]), g)
               for n, g in ((3, 6), (11, 4), (20, 7), (1, 5))]
    kw = dict(n_slots=2, max_len=64, page_size=8, prefill_chunk_tokens=16)

    def drive(engine, req_cls):
        reqs = [req_cls(id=i, prompt=p, max_new_tokens=g)
                for i, (p, g) in enumerate(prompts)]
        engine.submit(reqs[0])
        for _ in range(3):
            engine.step()
        engine.submit(reqs[1])
        engine.step()
        for r in reqs[2:]:
            engine.submit(r)
        while engine.has_work():
            engine.step()
        return {r.id: list(r.generated) for r in reqs}

    want = drive(JEngine(jmodel, jparams, paged=True, **kw), JRequest)
    teng = Engine(tmodel, tparams, **kw)
    got = drive(teng, Request)
    assert got == want
    assert teng.n_prefill_tokens_skipped > 0           # the prefix was reused


def test_launchers_run_the_deploy_chain_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "run")
    out = ttrain.main(["--arch", "olmo-1b", "--smoke", "--mpd-mode",
                       "masked_dense", "--mpd-fuse", "--steps", "2",
                       "--seq-len", "32", "--global-batch", "2",
                       "--fold-to-packed", "--quantize", "int8",
                       "--ckpt-dir", ckpt, "--device", "cpu"])
    assert len(out["history"]) == 2
    assert "packed export" in capsys.readouterr().out
    s = tserve.main(["--arch", "olmo-1b", "--smoke", "--paged", "--ckpt-dir",
                     ckpt, "--device", "cpu", "--requests", "4"])
    assert s["n_done"] == s["n_requests"] == 4
    with pytest.raises(SystemExit, match="masked_dense"):
        ttrain.main(["--arch", "olmo-1b", "--smoke", "--mpd-fuse",
                     "--mpd-mode", "packed", "--fold-to-packed",
                     "--ckpt-dir", ckpt, "--steps", "1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="not ported"):
        ttrain.main(["--arch", "olmo-1b", "--smoke", "--steps", "1",
                     "--data-axis", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no packed export"):
        tserve.main(["--arch", "olmo-1b", "--smoke", "--paged", "--ckpt-dir",
                     str(tmp_path / "empty"), "--device", "cpu"])
