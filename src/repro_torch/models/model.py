"""Model assembly for the attention family (the port of
``repro.models.model`` for ``pattern=("attn",)``: config, init, the
full-sequence ``forward``/``logits``/``train_loss``, the mask projection and
fold of masked-dense training, dense caches (``init_caches``,
``init_slot_caches``, ``slot_cache_axes``) and ``prefill``, paged caches,
``decode_step`` on either, ``prefill_chunk`` and the speculative-decoding
hooks ``set_paged_pos`` and ``verify_step``).

Params keep the reference's tree and key names — block params stacked per
pattern period on a leading axis (``params["blocks"][i]["mixer"]["wq"]["w"]``
has shape ``(n_periods, nb, bi, bo)``) — so a JAX param tree converts leaf by
leaf (:mod:`repro_torch.convert`). The reference's ``scan`` over periods is
a Python loop over leading-axis views (``torch.unbind`` on the training
path, so the gradient of a stacked leaf is one stack, not one full-size
scatter per period). Caches are updated in place. The reference's
``remat="block"`` rematerialization is not ported: the training path keeps
its activations.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import device as device_lib
from repro_torch import tree as tree_lib
from repro_torch.core.policy import CompressionPolicy
from . import attention as attn_lib
from . import layers
from .ffn import FFNSpec
from .linear import Linear


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field-for-field the reference config; only ``pattern=("attn",)``
    with token frontends is ported so far."""
    name: str = "model"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    d_ff: int = 256
    vocab: int = 256
    head_dim: int = 0               # 0 -> d_model // n_heads
    norm: str = "rms"               # rms | ln | none (olmo)
    ffn_kind: str = "swiglu"        # swiglu | gelu | relu
    use_bias: bool = False
    causal: bool = True
    rope: str = "rope"              # rope | none
    rope_theta: float = 10000.0
    pattern: Tuple[str, ...] = ("attn",)
    frontend: str = "token"
    q_chunk: int = 128
    loss_chunk: int = 512           # CE sequence chunk
    dtype: str = "float32"
    mpd_c: int = 1
    mpd_mode: str = "packed"
    mpd_min_block: int = 8
    mpd_permuted: bool = True
    mpd_seed: int = 0
    mpd_per_kind: Tuple[Tuple[str, int], ...] = ()
    mpd_fuse: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def policy(self) -> CompressionPolicy:
        return CompressionPolicy(
            c=self.mpd_c, per_kind=dict(self.mpd_per_kind) or None,
            min_block=self.mpd_min_block, permuted=self.mpd_permuted,
            seed=self.mpd_seed, mode=self.mpd_mode)

    @property
    def tdtype(self) -> torch.dtype:
        return device_lib.DTYPES[self.dtype]


def _layer(tree, i: int):
    """Period ``i`` of a stacked param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> List[Any]:
    """The ``n`` periods of a stacked param tree, by ``torch.unbind``."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: List[Any]):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class Model:
    """Static specs here, params as plain dicts of tensors."""

    def __init__(self, cfg: ModelConfig):
        if tuple(cfg.pattern) != ("attn",):
            raise NotImplementedError(
                f"{cfg.name}: pattern {cfg.pattern} — only attention models "
                "are ported (mamba, moe and rwkv are not yet)")
        if cfg.frontend != "token":
            raise NotImplementedError("only token frontends are ported")
        self.cfg = cfg
        self.n_periods = cfg.n_layers // len(cfg.pattern)
        pol = cfg.policy
        self.block_specs = [self._make_block(pol, kind, i)
                            for i, kind in enumerate(cfg.pattern)]
        self.unembed = Linear.make(pol, cfg.d_model, cfg.vocab, "unembed")
        self._sqrt_d = math.sqrt(cfg.d_model)

    def _make_block(self, pol: CompressionPolicy, kind: str, idx: int):
        cfg = self.cfg
        return {
            "kind": kind,
            "mixer": attn_lib.AttentionSpec.make(
                pol, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                causal=cfg.causal, rope=cfg.rope, rope_theta=cfg.rope_theta,
                q_chunk=cfg.q_chunk, use_bias=cfg.use_bias, seed_salt=idx + 1,
                fuse_perms=cfg.mpd_fuse),
            "ffn": FFNSpec.make(pol, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                cfg.use_bias, seed_salt=idx + 100,
                                fuse_perms=cfg.mpd_fuse),
        }

    # ----------------------------------------------------------------- params
    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random init from ``seed`` on ``device`` (the CUDA device unless
        ``device="cpu"``). Draws differ from ``jax.random``; parity tests
        carry the reference's params over with :mod:`repro_torch.convert`.
        ``device="meta"`` builds the shape template only."""
        dev = device_lib.resolve(device)
        cfg = self.cfg
        dtype = cfg.tdtype
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        params: Dict[str, Any] = {
            "embed": layers.init_embedding(gen, cfg.vocab, cfg.d_model, dtype,
                                           dev)}
        params["blocks"] = []
        for spec in self.block_specs:
            periods = [{
                "norm1": layers.init_norm(cfg.norm, cfg.d_model, dev),
                "mixer": spec["mixer"].init(gen, dtype, dev),
                "norm2": layers.init_norm(cfg.norm, cfg.d_model, dev),
                "ffn": spec["ffn"].init(gen, dtype, dev),
            } for _ in range(self.n_periods)]
            params["blocks"].append(_stack(periods))
        params["final_norm"] = layers.init_norm(cfg.norm, cfg.d_model, dev)
        params["unembed"] = self.unembed.init(gen, dtype, dev)
        return params

    def init_caches(self, batch: int, max_len: int, dtype=None,
                    device=None) -> List[Dict[str, Any]]:
        """Per pattern position: dense K/V ``(n_periods, batch, max_len, Kh,
        Dh)`` in the config dtype unless ``dtype`` is given, and a scalar
        ``pos`` per period, ``(n_periods,)`` (lockstep decode)."""
        dev = device_lib.resolve(device)
        dtype = dtype or self.cfg.tdtype
        return [_stack([attn_lib.init_cache(spec["mixer"], batch, max_len,
                                            dtype, dev)
                        for _ in range(self.n_periods)])
                for spec in self.block_specs]

    def init_slot_caches(self, n_slots: int, max_len: int, dtype=None,
                         device=None) -> List[Dict[str, Any]]:
        """:meth:`init_caches` with a per-slot ``pos (n_periods, n_slots)``,
        so every slot decodes at its own depth (the slot-dense engine)."""
        caches = self.init_caches(n_slots, max_len, dtype, device)
        for c in caches:
            c["pos"] = torch.zeros((self.n_periods, n_slots),
                                   dtype=torch.int32, device=c["k"].device)
        return caches

    def slot_cache_axes(self) -> List[Dict[str, Tuple]]:
        """Logical axes of :meth:`init_slot_caches`' leaves, the reference's
        names; the slot axis is ``"batch"``."""
        return [{"k": ("layers", "batch", "kv_seq", "kv_heads", None),
                 "v": ("layers", "batch", "kv_seq", "kv_heads", None),
                 "pos": ("layers", "batch")} for _ in self.block_specs]

    def init_paged_caches(self, n_slots: int, n_pages: int, page_size: int,
                          dtype=None, device=None) -> List[Dict[str, Any]]:
        """Per pattern position: K/V pools ``(n_periods, n_pages, page_size,
        Kh, Dh)`` (page 0 is the null page) and ``pos (n_periods, n_slots)``."""
        dev = device_lib.resolve(device)
        dtype = dtype or self.cfg.tdtype
        caches = []
        for spec in self.block_specs:
            one = [attn_lib.init_paged_cache(spec["mixer"], n_slots, n_pages,
                                             page_size, dtype, dev)
                   for _ in range(self.n_periods)]
            caches.append(_stack(one))
        return caches

    # ---------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        x = layers.embed(params["embed"], tokens)
        # sqrt(d_model) rounded to the config dtype first, as the reference's
        # weak-typed scalar is (host-side: no device copy per step)
        return x * float(torch.tensor(self._sqrt_d, dtype=x.dtype))

    def _ffn_residual(self, spec, p, x):
        h2 = layers.apply_norm(self.cfg.norm, p["norm2"], x)
        return x + spec["ffn"].apply(p["ffn"], h2)

    def _apply_block(self, spec, p, x):
        """One attention block over the full sequence."""
        h = layers.apply_norm(self.cfg.norm, p["norm1"], x)
        x = x + attn_lib.apply_train(spec["mixer"], p["mixer"], h)
        return self._ffn_residual(spec, p, x)

    def forward(self, params, tokens):
        """Full-sequence trunk: ``tokens (B, T)`` -> final-normed hidden
        states ``(B, T, d_model)`` (the reference also returns a MoE aux
        loss, always 0 for the attention family)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        per_spec = [_unstack(pstack, self.n_periods)
                    for pstack in params["blocks"]]
        for i in range(self.n_periods):
            for spec, periods in zip(self.block_specs, per_spec):
                x = self._apply_block(spec, periods[i], x)
        return layers.apply_norm(cfg.norm, params["final_norm"], x)

    def logits(self, params, tokens):
        return self.unembed.apply(params["unembed"],
                                  self.forward(params, tokens))

    def _ce_chunk(self, params, x_chunk, labels_chunk):
        lg = self.unembed.apply(params["unembed"], x_chunk).float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels_chunk[..., None].long())[..., 0]
        return lse - ll

    def train_loss(self, params, batch):
        """Mean next-token cross-entropy, in f32, over ``batch = {"inputs":
        (B, T), "labels": (B, T)}``; the unembed and CE run per sequence
        chunk of ``loss_chunk`` tokens (one chunk when T is no multiple)."""
        x = self.forward(params, batch["inputs"])
        labels = batch["labels"]
        T = labels.shape[1]
        c = min(self.cfg.loss_chunk, T)
        if T % c:
            c = T
        ce = torch.cat([self._ce_chunk(params, x[:, i:i + c],
                                       labels[:, i:i + c])
                        for i in range(0, T, c)], dim=1)
        return ce.mean()

    # --------------------------------------------- masked-dense training
    def mask_projection(self, params):
        """Re-apply every binary mask after an optimizer update (paper
        Algorithm 1 line 14). Returns a new tree; packed and dense leaves
        are shared, masked-dense weights are new tensors."""
        from repro_torch.core import export as export_lib
        from repro_torch.core import mpd

        out = tree_lib.copy_tree(params)
        for parent, key, lin, _ in export_lib.iter_linear_leaves(
                self, out, "masked_dense"):
            parent[key] = mpd.reapply_mask(lin.spec, parent[key])
        return out

    def to_packed(self, params, *, fuse: bool = False, quantize=None):
        """Fold this trained masked-dense model into its packed twin (Eq. 2
        model-wide); ``fuse=True`` also applies the Fig-3 permutation-fusion
        rewrite and ``quantize="int8"`` (or ``"int4"``) quantizes the
        blocks. Returns
        ``(packed_model, packed_params)``; see
        :func:`repro_torch.core.export.fold_model`."""
        from repro_torch.core import export as export_lib
        return export_lib.fold_model(self, params, fuse=fuse,
                                     quantize=quantize)

    # ----------------------------------------------------------------- serve
    def prefill(self, params, tokens, caches, lengths=None):
        """A whole prompt batch ``tokens (B, T)`` through the trunk, its K/V
        written into ``caches`` (from :meth:`init_caches`) at rows ``0..T-1``
        in place. Returns ``(logits (B, vocab), caches)``: the logits at the
        last token, or with ``lengths (B,)`` (right-padded prompts) at each
        row's last real token, and ``pos`` (a new tensor) ``T`` or
        ``lengths`` per row, ``(n_periods, B)``, the state an unpadded
        prefill of each row leaves (padded K/V is written but masked by
        ``pos`` in decode). ``lengths`` may be a host sequence or a tensor
        on the device (read there, without a host sync)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        B, T = tokens.shape
        dev = x.device
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        out = []
        for spec, pstack, cstack in zip(self.block_specs, params["blocks"],
                                        caches):
            mixer = spec["mixer"]
            for i in range(self.n_periods):
                p = _layer(pstack, i)
                c = _layer(cstack, i)
                h = layers.apply_norm(cfg.norm, p["norm1"], x)
                q, k, v = attn_lib._qkv(mixer, p["mixer"], h, positions)
                c["k"][:, :T] = k.to(c["k"].dtype)
                c["v"][:, :T] = v.to(c["v"].dtype)
                o = attn_lib.attend_full(mixer, q, k, v)
                y = mixer.wo.apply(p["mixer"]["wo"], o.reshape(B, T, -1))
                x = self._ffn_residual(spec, p, x + y)
            pos = (torch.full((self.n_periods,), T, dtype=torch.int32,
                              device=dev) if lengths is None
                   else lengths[None].expand(self.n_periods, B).clone())
            out.append(dict(cstack, pos=pos))
        x = layers.apply_norm(cfg.norm, params["final_norm"], x)
        if lengths is None:
            x_last = x[:, -1]
        else:
            idx = (lengths - 1).long()[:, None, None].expand(B, 1, x.shape[-1])
            x_last = torch.gather(x, 1, idx)[:, 0]
        return self.unembed.apply(params["unembed"], x_last), out

    def _decode_block(self, spec, p, x, cache, block_tables=None, live=None):
        """One attention block of a decode step: the paged form with
        ``block_tables``, else the dense one (``cache["pos"]`` scalar or
        per row)."""
        h = layers.apply_norm(self.cfg.norm, p["norm1"], x)
        if block_tables is not None:
            y, _ = attn_lib.apply_decode_paged(
                spec["mixer"], p["mixer"], h, cache, block_tables, live=live)
        else:
            y, _ = attn_lib.apply_decode(spec["mixer"], p["mixer"], h, cache)
        return self._ffn_residual(spec, p, x + y)

    def decode_step(self, params, tokens, caches, block_tables=None,
                    live=None):
        """One token step. ``tokens (B,)``. With ``block_tables (B, P)``
        int32 (the paged engine's page maps, shared by every attention
        layer) the layers run the paged form, and ``live (B,)`` bool marks
        the rows actually decoding (non-live rows compute but write
        nothing). Without, the dense caches of :meth:`init_caches` (every
        row at one depth) or :meth:`init_slot_caches` (each at its own):
        every row writes and advances. Returns ``(logits (B, vocab),
        caches)``; the caches are updated in place."""
        cfg = self.cfg
        x = self._embed(params, tokens[:, None])
        for spec, pstack, cstack in zip(self.block_specs, params["blocks"],
                                        caches):
            for i in range(self.n_periods):
                x = self._decode_block(spec, _layer(pstack, i), x,
                                       _layer(cstack, i), block_tables, live)
        x = layers.apply_norm(cfg.norm, params["final_norm"], x)
        return self.unembed.apply(params["unembed"], x[:, 0]), caches

    @property
    def spec_decode_supported(self) -> bool:
        """Speculative decoding rolls a window back by truncating the block
        table, which only attention blocks allow (recurrent state cannot be
        re-scored). Every block the port builds is attention."""
        return all(s["kind"] in ("attn", "attn_moe") for s in self.block_specs)

    def set_paged_pos(self, caches, pos):
        """Write the host's accepted depth ``pos (B,)`` into every attention
        layer's cache ``pos`` (paged or per-slot dense), **in place** (the
        reference returns new caches); returns the caches. The spec engine
        calls it before each propose and verify, which is what makes
        rollback free: rejected positions are written over under the
        corrected depth next step; the engine's decode calls it before each
        replay, which makes a retried step write what the first try did."""
        for spec, c in zip(self.block_specs, caches):
            if spec["kind"] in ("attn", "attn_moe"):
                c["pos"].copy_(pos.to(c["pos"].dtype)[None].expand_as(c["pos"]))
        return caches

    def verify_step(self, params, tokens, caches, block_tables, live=None):
        """Speculative-verify window: score ``tokens (B, Tq)`` — the pending
        token and the draft's k proposals — against the paged KV pool in one
        pass; ``logits[:, i]`` is the prediction for the token after window
        position ``i``, what :meth:`decode_step` gives when the window is fed
        one token at a time. The caller sets the accepted depth first
        (:meth:`set_paged_pos`); ``pos`` stays there. Returns ``(logits (B,
        Tq, vocab), caches)``, the caches updated in place."""
        assert self.spec_decode_supported, \
            "verify_step: recurrent blocks cannot roll state back"
        cfg = self.cfg
        x = self._embed(params, tokens)
        for spec, pstack, cstack in zip(self.block_specs, params["blocks"],
                                        caches):
            for i in range(self.n_periods):
                p = _layer(pstack, i)
                c = _layer(cstack, i)
                h = layers.apply_norm(cfg.norm, p["norm1"], x)
                y, _ = attn_lib.apply_verify_paged(
                    spec["mixer"], p["mixer"], h, c, block_tables, live=live)
                x = self._ffn_residual(spec, p, x + y)
        x = layers.apply_norm(cfg.norm, params["final_norm"], x)
        return self.unembed.apply(params["unembed"], x), caches

    def prefill_chunk(self, params, tokens, caches, bt_row, slot, start,
                      chunk_len, final: bool = True):
        """One page-aligned chunk of a single request's prefill (batch 1).

        ``tokens (1, Tc)`` with ``Tc`` a page multiple; ``start``
        (page-aligned) is the chunk's global offset; ``chunk_len <= Tc``
        real tokens (the final chunk is right-padded). ``slot``, ``start``
        and ``chunk_len`` are host integers or 0-d integer tensors on the
        device, as the reference's scalars are; from tensors every
        position, page id, the ``pos`` write and the last real token's row
        are computed on the device. ``final`` is static. Returns ``(logits
        (1, vocab) at the last real token, caches)`` on the final chunk and
        ``(None, caches)`` otherwise (no final norm or unembed)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        for spec, pstack, cstack in zip(self.block_specs, params["blocks"],
                                        caches):
            for i in range(self.n_periods):
                p = _layer(pstack, i)
                c = _layer(cstack, i)
                h = layers.apply_norm(cfg.norm, p["norm1"], x)
                y, _ = attn_lib.prefill_chunk_paged(
                    spec["mixer"], p["mixer"], h, c, bt_row, slot, start,
                    chunk_len)
                x = self._ffn_residual(spec, p, x + y)
        if not final:
            return None, caches
        x = layers.apply_norm(cfg.norm, params["final_norm"], x)
        if torch.is_tensor(chunk_len):
            last = (chunk_len.to(x.device) - 1).clamp_min(0).reshape(1).long()
            x_last = x.index_select(1, last)[:, 0]
        else:
            x_last = x[:, max(chunk_len - 1, 0)]
        return self.unembed.apply(params["unembed"], x_last), caches

    # ------------------------------------------------------------- accounting
    def block_linears(self, spec) -> List[Tuple[Tuple[str, str], Linear]]:
        """(param key path, Linear) pairs of one block spec."""
        mixer, ffn = spec["mixer"], spec["ffn"]
        out = [(("mixer", n), getattr(mixer, n)) for n in ("wq", "wk", "wv", "wo")]
        out.append((("ffn", "w_up"), ffn.w_up))
        if ffn.w_gate is not None:
            out.append((("ffn", "w_gate"), ffn.w_gate))
        out.append((("ffn", "w_down"), ffn.w_down))
        return out

    def param_count(self) -> int:
        """Elements of every param leaf (a masked-dense weight counts in
        full), from an init on the meta device."""
        return sum(t.numel()
                   for t in tree_lib.leaves(self.init(0, device="meta")))

    def matmul_params(self, *, dense: bool) -> int:
        """Weights of every projection (unembed included, the embedding
        gather excluded). ``dense=False`` counts each compressed linear at
        its packed size, as the reference's ``active_matmul_params`` does;
        ``dense=True`` counts what a masked-dense kernel multiplies
        (``d_in * d_out``). Model FLOPs per token are six times this."""
        def count(lin):
            s = lin.spec
            if not dense:
                return s.param_count()
            return s.d_in * s.d_out + (s.d_out if s.use_bias else 0)

        n = sum(count(lin) for spec in self.block_specs
                for _, lin in self.block_linears(spec))
        return self.n_periods * n + count(self.unembed)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
