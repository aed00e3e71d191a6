"""Integrity-checked checkpoints and the packed deployment artifact (the
port of ``repro.checkpoint.checkpoint``: ``save``, blocking or on a
background thread, ``wait_pending``, ``restore``, ``export_packed`` and
``load_packed``).

The on-disk format is the reference's, byte for byte, so an artifact
passes between the two packages in both directions::

    <dir>/step_000000120/
      manifest.json     # {"step", "leaves": {name: {array, shape, dtype,
                        #  crc32}}, "extra"}
      shard_00000.npz   # one array per leaf, named a00000, a00001, ...
      .complete         # commit marker, written last

* Leaves are walked in the reference's flatten order (dict keys sorted,
  lists by index, ``None`` dropped) and named by their keys joined with
  ``/`` (:func:`repro_torch.tree.leaves_with_paths`); the per-leaf crc32s
  and the chained ``artifact_crc32`` of a packed export follow that order.
* A bfloat16 leaf is stored as the reference stores it: its raw 2-byte
  words as npy descr ``|V2``, with manifest dtype ``"bfloat16"``. The port
  writes and reads those words through ``int16`` (numpy has no bfloat16).
* A directory is written under ``.tmp`` and published with ``os.replace``
  after its ``.complete`` marker: readers only trust marked directories.
* ``save(..., blocking=False)`` copies every leaf to host memory before it
  returns (a device tensor by a synchronous device-to-host copy, a host
  tensor by a copy of its own), so the caller may update the tensors in
  place at once; a daemon thread then only writes. ``wait_pending`` joins
  every pending write and raises the first error one of them met.
  ``save_log`` records each save's bytes, snapshot and write seconds.
* The optimizer's step count, a host integer in the port, is stored as the
  reference stores its step: a 0-d int32 leaf (``opt/step``); ``restore``
  gives an integer back where ``like`` holds one. A train checkpoint thus
  restores in either package.
* An MoE model's routed expert stacks are raw arrays, not ``{"w"}``
  leaves (``params/blocks/0/ffn/w_up``), stored fp in an int8 export as
  the reference stores them; they take their place in the same flatten
  order and crc32 chain.
* A packed export's manifest carries the packed config with the
  reference's full field set (:data:`FOREIGN_CONFIG_DEFAULTS` for the
  one field the port's config lacks, ``remat``), so the reference's
  ``load_packed`` rebuilds the model from the directory alone. An embed
  frontend's export has no ``embed`` leaf, as the reference's has none.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib

PACKED_SUBDIR = "packed"
BF16_DESCR = np.dtype("V2")         # how numpy stores a bfloat16 leaf

# The reference's ModelConfig fields, in its order (``dataclasses.asdict``
# writes them so), and the default of the one the port's config lacks: the
# reference's rematerialization, ``remat``.
CONFIG_FIELDS = (
    "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
    "head_dim", "norm", "ffn_kind", "use_bias", "causal", "rope",
    "rope_theta", "mrope_sections", "pattern", "moe_experts", "moe_top_k",
    "moe_d_ff", "moe_shared_d_ff", "moe_shared_gated", "moe_capacity",
    "moe_experts_pad", "rwkv_head_dim", "mamba_expand", "frontend",
    "q_chunk", "loss_chunk", "dtype", "aux_loss_weight", "remat", "mpd_c",
    "mpd_mode", "mpd_min_block", "mpd_permuted", "mpd_seed", "mpd_per_kind",
    "mpd_fuse")
FOREIGN_CONFIG_DEFAULTS = {"remat": "block"}
# remat changes what the reference's backward recomputes, not the function;
# the port keeps activations, which computes the same values as either
REMAT_VALUES = ("block", "none")


_SAVE_LOCK = threading.Lock()
_PENDING: List[threading.Thread] = []
_ERRORS: List[Exception] = []
# one entry a save: {"step", "dir", "bytes", "snapshot_s", "write_s"}
save_log: List[Dict[str, Any]] = []


class ArtifactCorruptError(RuntimeError):
    """A packed deployment artifact failed integrity verification: an
    unreadable manifest or shard, a leaf that fails its crc32 or shape, or
    an ``artifact_crc32`` that does not match the bytes on disk."""


def _host_array(t) -> np.ndarray:
    """A leaf as the numpy array the reference writes for it, in host
    memory of its own (never a view of the caller's tensor)."""
    if isinstance(t, int):          # the optimizer's host step count
        return np.array(t, np.int32)
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_DESCR)
    return t.numpy()


def _dtype_name(t, arr: np.ndarray) -> str:
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _flatten(tree) -> List[Tuple[str, np.ndarray, str]]:
    """``(name, host array, dtype name)`` per leaf, in flatten order."""
    out = []
    for k, v in tree_lib.leaves_with_paths(tree):
        arr = _host_array(v)
        out.append((k, arr, _dtype_name(v, arr)))
    return out


def _crc(arr: np.ndarray, c: int = 0) -> int:
    # over the array's own bytes: no copy (a background write holding the
    # interpreter through a 1.5 GB copy would stall the train loop)
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8), c)


def _tree_crc32(tree) -> int:
    """crc32 chained over every leaf's bytes in flatten order."""
    c = 0
    for _, arr, _ in _flatten(tree):
        c = _crc(arr, c)
    return c


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def save(ckpt_dir: str, step: int, tree: Dict[str, Any],
         extra: Optional[Dict[str, Any]] = None,
         blocking: bool = True) -> str:
    """Write one checkpoint of ``tree`` (nested dicts and lists of tensors
    and integers) and publish it atomically. Returns the step directory.
    With ``blocking=False`` the leaves are copied to the host before this
    returns and a daemon thread writes them; :func:`wait_pending` waits."""
    t0 = time.perf_counter()
    flat = _flatten(tree)
    entry = {"step": step, "dir": _step_dir(ckpt_dir, step),
             "bytes": sum(arr.nbytes for _, arr, _ in flat),
             "snapshot_s": time.perf_counter() - t0}

    def write():
        t1 = time.perf_counter()
        _write(ckpt_dir, step, flat, extra)
        entry["write_s"] = time.perf_counter() - t1
        with _SAVE_LOCK:
            save_log.append(entry)

    if blocking:
        write()
        return entry["dir"]

    def write_recording_errors():
        try:
            write()
        except Exception as e:              # re-raised by wait_pending
            with _SAVE_LOCK:
                _ERRORS.append(e)

    t = threading.Thread(target=write_recording_errors, daemon=True)
    with _SAVE_LOCK:
        _PENDING.append(t)
    t.start()
    return entry["dir"]


def _write(ckpt_dir: str, step: int, flat, extra) -> None:
    d = _step_dir(ckpt_dir, step)
    tmp = d + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    arrays = {}
    for i, (k, arr, dtype_name) in enumerate(flat):
        name = f"a{i:05d}"
        arrays[name] = arr
        manifest["leaves"][k] = {"array": name, "shape": list(arr.shape),
                                 "dtype": dtype_name, "crc32": _crc(arr)}
    np.savez(os.path.join(tmp, "shard_00000.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, ".complete"), "w") as f:
        f.write("ok")
    os.replace(tmp, d)                                  # atomic publish


def wait_pending() -> None:
    """Join every pending background write; raise the first error any of
    them met (later ones are dropped with it)."""
    with _SAVE_LOCK:
        pend, _PENDING[:] = _PENDING[:], []
    for t in pend:
        t.join()
    with _SAVE_LOCK:
        errors, _ERRORS[:] = _ERRORS[:], []
    if errors:
        raise errors[0]


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step with a ``.complete`` marker, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, d, ".complete"))]
    return max(steps) if steps else None


def _load_manifest(d: str):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(d, "shard_00000.npz"))


def load_extra(ckpt_dir: str, step: int) -> Dict[str, Any]:
    manifest, _ = _load_manifest(_step_dir(ckpt_dir, step))
    return manifest.get("extra", {})


def restore(ckpt_dir: str, step: int, like, device=None):
    """Restore into the structure of ``like`` (any leaves with a ``.shape``,
    meta tensors included, or integers): each leaf is looked up by name,
    checked against its crc32 and ``like``'s shape, and returned as a
    tensor on ``device`` (the CUDA device unless ``"cpu"`` is asked for),
    in its stored dtype; an integer leaf of ``like`` (the optimizer's step
    count) comes back as an integer."""
    dev = device_lib.resolve(device)
    manifest, data = _load_manifest(_step_dir(ckpt_dir, step))
    out = []
    for k, ref in tree_lib.leaves_with_paths(like):
        meta = manifest["leaves"][k]
        arr = data[meta["array"]]
        if _crc(arr) != meta["crc32"]:
            raise IOError(f"checkpoint corruption at leaf {k}")
        want = () if isinstance(ref, int) else tuple(ref.shape)
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch at {k}: {arr.shape} vs {want}")
        out.append(int(arr) if isinstance(ref, int)
                   else _to_tensor(arr, meta["dtype"]).to(dev))
    return tree_lib.unflatten(like, out)


# ------------------------------------------------------------ packed export
def config_to_dict(cfg) -> Dict[str, Any]:
    """The port's config as the reference's ``dataclasses.asdict`` writes
    its own: every reference field, in its order."""
    own = dataclasses.asdict(cfg)
    return {k: own[k] if k in own else FOREIGN_CONFIG_DEFAULTS[k]
            for k in CONFIG_FIELDS}


def config_from_dict(d: Dict[str, Any]):
    """Rebuild the port's config from a manifest's ``packed_config``.
    Raises ``ValueError`` on a ``remat`` value the reference does not
    have or on a field neither package knows."""
    from repro_torch.models import ModelConfig

    own = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {}
    for k, v in d.items():
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        if k in own:
            kw[k] = v
        elif k == "remat":
            if v not in REMAT_VALUES:
                raise ValueError(f"packed_config: remat={v!r} not in "
                                 f"{REMAT_VALUES}")
        else:
            raise ValueError(f"packed_config: unknown field {k!r}")
    return ModelConfig(**kw)


def export_packed(ckpt_dir: str, step: int, model, params, *,
                  fuse: bool = False, quantize: Optional[str] = None) -> str:
    """Fold a trained ``masked_dense`` model (``model.to_packed``) and
    publish the packed params as a deployment artifact under
    ``<ckpt_dir>/packed/``, with the packed config, whether the Fig-3
    rewrite was applied, the quantization and its round-trip report in the
    manifest. ``quantize="int4"`` nibble-packs the stored blocks."""
    from repro_torch.core import export as export_lib
    from repro_torch.kernels import quant as quant_lib

    model_pk, params_pk = model.to_packed(params, fuse=fuse, quantize=quantize)
    extra = {"packed_config": config_to_dict(model_pk.cfg),
             "perm_fused": bool(fuse), "quantize": quantize,
             "quant_report": getattr(model_pk, "quant_report", None),
             "source_step": int(step)}
    if quantize == "int4":
        params_pk = export_lib.map_quantized_leaves(
            model_pk, params_pk, lambda q, lin: quant_lib.pack_int4(q))
    # over the stored leaves (after nibble packing): load_packed checks it
    # before unpacking, which catches what the per-leaf crcs cannot (two
    # leaf names swapped in the manifest)
    extra["artifact_crc32"] = _tree_crc32(params_pk)
    return save(os.path.join(ckpt_dir, PACKED_SUBDIR), step,
                {"params": params_pk}, extra=extra)


def load_packed(ckpt_dir: str, step: Optional[int] = None, device=None):
    """Load a packed export (the port's or the reference's): ``(model,
    params)`` ready for the serving engine, params on ``device`` (the CUDA
    device unless ``"cpu"`` is asked for). The model is rebuilt from the
    stored config; a perm-fused export has its (deterministic) spec rewrite
    re-derived, the stored params carrying any rewritten bias already. An
    int4 export is unpacked to int8 here, once."""
    from repro_torch.core import export as export_lib
    from repro_torch.kernels import quant as quant_lib
    from repro_torch.models import build

    dev = device_lib.resolve(device)
    d = os.path.join(ckpt_dir, PACKED_SUBDIR)
    if step is None:
        step = latest_step(d)
        if step is None:
            raise FileNotFoundError(f"no packed export under {d}")
    try:
        extra = load_extra(d, step)
    except Exception as e:
        raise ArtifactCorruptError(f"packed artifact at {d} step {step}: "
                                   f"unreadable manifest ({e})") from e
    model = build(config_from_dict(extra["packed_config"]))
    if extra.get("perm_fused"):
        export_lib.apply_perm_fusion(model)
    qmode = extra.get("quantize")
    # the stored structure: the same transformations on a shape template
    like = model.init(0, device="meta")
    if qmode:
        like = export_lib.quantize_packed(model, like, bits=quant_lib.BITS[qmode],
                                          compute_report=False)[0]
        if qmode == "int4":
            like = export_lib.map_quantized_leaves(
                model, like, lambda q, lin: quant_lib.pack_int4(q))
    try:
        params = restore(d, step, {"params": like}, device="cpu")["params"]
    except Exception as e:      # bad zip, npy header, leaf crc, missing leaf
        raise ArtifactCorruptError(
            f"packed artifact at {d} step {step}: {e}") from e
    want_crc = extra.get("artifact_crc32")   # absent in older exports
    if want_crc is not None and _tree_crc32(params) != want_crc:
        raise ArtifactCorruptError(
            f"packed artifact at {d} step {step}: artifact checksum "
            f"mismatch (manifest {want_crc})")
    if qmode == "int4":
        params = export_lib.map_quantized_leaves(
            model, params,
            lambda q, lin: quant_lib.unpack_int4(q, lin.spec.mask.block_in))
    if qmode:
        model.quant_report = extra.get("quant_report")
    return model, tree_lib.map_leaves(lambda t: t.to(dev), params)


def has_packed(ckpt_dir: str) -> bool:
    return latest_step(os.path.join(ckpt_dir, PACKED_SUBDIR)) is not None
