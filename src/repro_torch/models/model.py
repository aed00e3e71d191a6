"""Model assembly (the port of ``repro.models.model`` for every block kind,
``"attn"``, ``"attn_moe"``, ``"mamba"``, ``"mamba_moe"`` and ``"rwkv"``,
and both frontends: token ids, or ``(B, T, d_model)`` embeds for
``frontend="embed"`` (the audio and vision stubs): config, init, the
full-sequence
``forward``/``logits``/``train_loss``, the mask projection and fold of
masked-dense training, dense caches (``init_caches``,
``init_slot_caches``, ``slot_cache_axes``) and ``prefill``, paged caches,
``decode_step`` on either, ``prefill_chunk`` and the speculative-decoding
hooks ``set_paged_pos`` and ``verify_step``).

A recurrent block (mamba, rwkv) keeps O(1) state a row instead of K/V:
``{"conv", "h"}`` or ``{"S", "x_tm", "x_cm"}`` stacked per period, the
paged engine's one pinned row a slot. Every serving path computes a
block's new state as new tensors from the old and then writes it in
place: ``prefill`` from zeros, ``prefill_chunk`` from the slot's row (read
as zeros at ``start == 0``, selected on the device), ``decode_step`` under
``live`` as ``where(live, new, old)`` (a non-live row keeps its state).

Params keep the reference's tree and key names — block params stacked per
pattern period on a leading axis (``params["blocks"][i]["mixer"]["wq"]["w"]``
has shape ``(n_periods, nb, bi, bo)``) — so a JAX param tree converts leaf by
leaf (:mod:`repro_torch.convert`). The reference's ``scan`` over periods is
a Python loop over leading-axis views (``torch.unbind`` on the training
path, so the gradient of a stacked leaf is one stack, not one full-size
scatter per period). Caches are updated in place. The reference's
``remat="block"`` rematerialization is not ported: the training path keeps
its activations.

As in the reference, the full-sequence trunk runs the blocks period by
period (``A0 M0 A1 M1`` for a pattern ``("attn", "attn_moe")``), while
the serving paths (``prefill``, ``decode_step``, ``verify_step``,
``prefill_chunk``) run each pattern position over all its periods before
the next (``A0 A1 M0 M1``): for a multi-position pattern the two orders
are different functions, and the port keeps each where the reference has
it.
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
from . import mamba as mamba_lib
from . import rwkv as rwkv_lib
from .ffn import FFNSpec
from .linear import Linear
from .mamba import MambaSpec
from .moe import MoESpec
from .rwkv import RWKVSpec

BLOCK_KINDS = ("attn", "attn_moe", "mamba", "mamba_moe", "rwkv")
ATTN_KINDS = ("attn", "attn_moe")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Field-for-field the reference config, less ``remat``."""
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
    causal: bool = True             # False -> encoder (hubert)
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    pattern: Tuple[str, ...] = ("attn",)
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_d_ff: int = 0
    moe_shared_gated: bool = False
    moe_capacity: float = 1.25
    moe_experts_pad: int = 0        # physical expert padding
    # SSM families
    rwkv_head_dim: int = 64
    mamba_expand: int = 2
    frontend: str = "token"         # token | embed ((B, T, D) inputs)
    q_chunk: int = 128
    loss_chunk: int = 512           # CE sequence chunk
    dtype: str = "float32"
    aux_loss_weight: float = 0.01
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
        if not set(cfg.pattern) <= set(BLOCK_KINDS):
            raise ValueError(f"{cfg.name}: pattern {cfg.pattern} has a kind "
                             f"not in {BLOCK_KINDS}")
        if cfg.n_layers % len(cfg.pattern):
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is no "
                             f"multiple of the pattern {cfg.pattern}")
        self.cfg = cfg
        self.n_periods = cfg.n_layers // len(cfg.pattern)
        pol = cfg.policy
        self.block_specs = [self._make_block(pol, kind, i)
                            for i, kind in enumerate(cfg.pattern)]
        self.unembed = Linear.make(pol, cfg.d_model, cfg.vocab, "unembed")
        self._sqrt_d = math.sqrt(cfg.d_model)

    def _make_block(self, pol: CompressionPolicy, kind: str, idx: int):
        """The block's mixer (salt ``idx + 1``) and its FFN or MoE (salt
        ``idx + 100``); an rwkv block's channel mix lives in its mixer
        (``ffn`` None)."""
        cfg = self.cfg
        spec: Dict[str, Any] = {"kind": kind}
        if kind in ATTN_KINDS:
            spec["mixer"] = attn_lib.AttentionSpec.make(
                pol, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                causal=cfg.causal, rope=cfg.rope, rope_theta=cfg.rope_theta,
                mrope_sections=cfg.mrope_sections, q_chunk=cfg.q_chunk,
                use_bias=cfg.use_bias, seed_salt=idx + 1,
                fuse_perms=cfg.mpd_fuse)
        elif kind in ("mamba", "mamba_moe"):
            spec["mixer"] = MambaSpec.make(pol, cfg.d_model, cfg.mamba_expand,
                                           seed_salt=idx + 1)
        else:
            spec["mixer"] = RWKVSpec.make(pol, cfg.d_model, cfg.d_ff,
                                          cfg.rwkv_head_dim, seed_salt=idx + 1)
        if kind.endswith("_moe"):
            spec["ffn"] = MoESpec.make(
                pol, cfg.d_model, cfg.moe_d_ff, cfg.moe_experts,
                cfg.moe_top_k, capacity_factor=cfg.moe_capacity,
                d_ff_shared=cfg.moe_shared_d_ff,
                shared_gated=cfg.moe_shared_gated,
                mode=cfg.mpd_mode if cfg.mpd_c > 1 else "dense",
                seed_salt=idx + 100, n_experts_padded=cfg.moe_experts_pad)
        elif kind in ("attn", "mamba"):
            spec["ffn"] = FFNSpec.make(pol, cfg.d_model, cfg.d_ff,
                                       cfg.ffn_kind, cfg.use_bias,
                                       seed_salt=idx + 100,
                                       fuse_perms=cfg.mpd_fuse)
        else:
            spec["ffn"] = None
        return spec

    # ----------------------------------------------------------------- params
    def init(self, seed: int = 0, device=None) -> Dict[str, Any]:
        """Random init from ``seed`` on ``device`` (the CUDA device unless
        ``device="cpu"``). Draws differ from ``jax.random``; parity tests
        carry the reference's params over with :mod:`repro_torch.convert`.
        ``device="meta"`` builds the shape template only. An embed
        frontend has no ``embed`` leaf."""
        dev = device_lib.resolve(device)
        cfg = self.cfg
        dtype = cfg.tdtype
        gen = (None if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        params: Dict[str, Any] = {}
        if cfg.frontend == "token":
            params["embed"] = layers.init_embedding(gen, cfg.vocab,
                                                    cfg.d_model, dtype, dev)
        params["blocks"] = []
        for spec in self.block_specs:
            periods = []
            for _ in range(self.n_periods):
                p = {"norm1": layers.init_norm(cfg.norm, cfg.d_model, dev),
                     "mixer": spec["mixer"].init(gen, dtype, dev),
                     "norm2": layers.init_norm(cfg.norm, cfg.d_model, dev)}
                if spec["ffn"] is not None:
                    p["ffn"] = spec["ffn"].init(gen, dtype, dev)
                periods.append(p)
            params["blocks"].append(_stack(periods))
        params["final_norm"] = layers.init_norm(cfg.norm, cfg.d_model, dev)
        params["unembed"] = self.unembed.init(gen, dtype, dev)
        return params

    def init_caches(self, batch: int, max_len: int, dtype=None,
                    device=None) -> List[Dict[str, Any]]:
        """Per pattern position: dense K/V ``(n_periods, batch, max_len, Kh,
        Dh)`` in the config dtype unless ``dtype`` is given, and a scalar
        ``pos`` per period, ``(n_periods,)`` (lockstep decode); a recurrent
        position's state ``(n_periods, batch, ...)``."""
        dev = device_lib.resolve(device)
        dtype = dtype or self.cfg.tdtype
        out = []
        for spec in self.block_specs:
            if spec["kind"] in ATTN_KINDS:
                one = [attn_lib.init_cache(spec["mixer"], batch, max_len,
                                           dtype, dev)
                       for _ in range(self.n_periods)]
            else:
                one = [spec["mixer"].init_state(batch, dtype, dev)
                       for _ in range(self.n_periods)]
            out.append(_stack(one))
        return out

    def init_slot_caches(self, n_slots: int, max_len: int, dtype=None,
                         device=None) -> List[Dict[str, Any]]:
        """:meth:`init_caches` with a per-slot ``pos (n_periods, n_slots)``,
        so every slot decodes at its own depth (the slot-dense engine)."""
        caches = self.init_caches(n_slots, max_len, dtype, device)
        for spec, c in zip(self.block_specs, caches):
            if spec["kind"] in ATTN_KINDS:
                c["pos"] = torch.zeros((self.n_periods, n_slots),
                                       dtype=torch.int32, device=c["k"].device)
        return caches

    def slot_cache_axes(self) -> List[Dict[str, Tuple]]:
        """Logical axes of :meth:`init_slot_caches`' leaves, the reference's
        names; the slot axis is ``"batch"``."""
        axes = []
        for spec in self.block_specs:
            kind = spec["kind"]
            if kind in ATTN_KINDS:
                axes.append({"k": ("layers", "batch", "kv_seq", "kv_heads",
                                   None),
                             "v": ("layers", "batch", "kv_seq", "kv_heads",
                                   None),
                             "pos": ("layers", "batch")})
            elif kind in ("mamba", "mamba_moe"):
                axes.append({"conv": ("layers", "batch", None, "inner"),
                             "h": ("layers", "batch", "inner", None)})
            else:
                axes.append({"S": ("layers", "batch", "kv_heads", None, None),
                             "x_tm": ("layers", "batch", None, None),
                             "x_cm": ("layers", "batch", None, None)})
        return axes

    def init_paged_caches(self, n_slots: int, n_pages: int, page_size: int,
                          dtype=None, device=None) -> List[Dict[str, Any]]:
        """Per pattern position: K/V pools ``(n_periods, n_pages, page_size,
        Kh, Dh)`` (page 0 is the null page) and ``pos (n_periods, n_slots)``;
        a recurrent position's state is one pinned row a slot, ``(n_periods,
        n_slots, ...)``, as :meth:`init_slot_caches` has it."""
        dev = device_lib.resolve(device)
        dtype = dtype or self.cfg.tdtype
        caches = []
        for spec in self.block_specs:
            if spec["kind"] in ATTN_KINDS:
                one = [attn_lib.init_paged_cache(spec["mixer"], n_slots,
                                                 n_pages, page_size, dtype,
                                                 dev)
                       for _ in range(self.n_periods)]
            else:
                one = [spec["mixer"].init_state(n_slots, dtype, dev)
                       for _ in range(self.n_periods)]
            caches.append(_stack(one))
        return caches

    def recurrent_state(self, caches) -> List[torch.Tensor]:
        """Every leaf of each recurrent position's state: what a decode
        step advances in place with nothing on the host to set it back."""
        return [t for spec, c in zip(self.block_specs, caches)
                if spec["kind"] not in ATTN_KINDS for t in c.values()]

    def step_state(self, caches) -> List[torch.Tensor]:
        """The cache tensors a decode step advances in place: each
        attention position's ``pos`` and ``recurrent_state`` (a capture
        saves and puts them back)."""
        return ([c["pos"] for spec, c in zip(self.block_specs, caches)
                 if spec["kind"] in ATTN_KINDS]
                + self.recurrent_state(caches))

    # ---------------------------------------------------------------- forward
    def _embed_inputs(self, params, inputs):
        """Token ids ``(B, T)`` embedded times sqrt(d_model), or an embed
        frontend's ``(B, T, d_model)`` embeds cast to the config dtype."""
        if self.cfg.frontend != "token":
            return inputs.to(self.cfg.tdtype)
        x = layers.embed(params["embed"], inputs)
        # sqrt(d_model) rounded to the config dtype first, as the reference's
        # weak-typed scalar is (host-side: no device copy per step)
        return x * float(torch.tensor(self._sqrt_d, dtype=x.dtype))

    def _ffn_out(self, spec, p, x, with_aux: bool = True):
        """``x + FFN(norm2(x))`` and the block's MoE aux term (None for a
        dense FFN, or without ``with_aux``)."""
        h2 = layers.apply_norm(self.cfg.norm, p["norm2"], x)
        if spec["kind"].endswith("_moe"):
            y, aux = spec["ffn"].apply(p["ffn"], h2, with_aux=with_aux)
            return x + y, aux
        return x + spec["ffn"].apply(p["ffn"], h2), None

    def _ffn_residual(self, spec, p, x):
        """The serving paths' FFN residual (no aux term)."""
        return self._ffn_out(spec, p, x, with_aux=False)[0]

    def _recurrent(self, spec, p, x, state=None, valid=None,
                   with_aux: bool = True):
        """One recurrent block from ``state`` (None: zeros, a whole
        prompt), its FFN or MoE residual included: ``(x, new state, aux or
        None)``, the state as new tensors (``state`` is only read).
        ``valid (B, T)`` marks a right-padded batch's real tokens; the
        serving paths pass ``with_aux=False``."""
        cfg = self.cfg
        mix = spec["mixer"]
        h = layers.apply_norm(cfg.norm, p["norm1"], x)
        if spec["kind"] != "rwkv":
            y, new = mix.apply(p["mixer"], h, state, valid=valid)
            x, aux = self._ffn_out(spec, p, x + y, with_aux=with_aux)
            return x, new, aux
        if state is None:
            state = mix.init_state(x.shape[0], x.dtype, x.device)
        y, S, x_tm = mix.time_mix(p["mixer"], h, state["S"], state["x_tm"],
                                  valid=valid)
        x = x + y
        h2 = layers.apply_norm(cfg.norm, p["norm2"], x)
        y2, x_cm = mix.channel_mix(p["mixer"], h2, state["x_cm"],
                                   valid=valid)
        return x + y2, {"S": S, "x_tm": x_tm, "x_cm": x_cm}, None

    def _apply_block(self, spec, p, x):
        """One block over the full sequence: ``(x, aux or None)``."""
        if spec["kind"] not in ATTN_KINDS:
            x, _, aux = self._recurrent(spec, p, x)
            return x, aux
        h = layers.apply_norm(self.cfg.norm, p["norm1"], x)
        x = x + attn_lib.apply_train(spec["mixer"], p["mixer"], h)
        return self._ffn_out(spec, p, x)

    def forward(self, params, inputs):
        """Full-sequence trunk: ``inputs`` (token ids ``(B, T)`` or embeds
        ``(B, T, d_model)``) -> ``(final-normed hidden states (B, T,
        d_model), aux)``, ``aux`` the f32 sum of every MoE
        block's load-balance term (0 without MoE blocks). Blocks run period
        by period."""
        cfg = self.cfg
        x = self._embed_inputs(params, inputs)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        per_spec = [_unstack(pstack, self.n_periods)
                    for pstack in params["blocks"]]
        for i in range(self.n_periods):
            for spec, periods in zip(self.block_specs, per_spec):
                x, a = self._apply_block(spec, periods[i], x)
                if a is not None:
                    aux = aux + a
        return layers.apply_norm(cfg.norm, params["final_norm"], x), aux

    def logits(self, params, inputs):
        return self.unembed.apply(params["unembed"],
                                  self.forward(params, inputs)[0])

    def _ce_chunk(self, params, x_chunk, labels_chunk):
        lg = self.unembed.apply(params["unembed"], x_chunk).float()
        lse = torch.logsumexp(lg, dim=-1)
        ll = torch.gather(lg, -1, labels_chunk[..., None].long())[..., 0]
        return lse - ll

    def train_loss(self, params, batch):
        """Mean next-token cross-entropy, in f32, over ``batch = {"inputs":
        (B, T) or (B, T, d_model), "labels": (B, T)}``; the unembed and CE
        run per sequence chunk of ``loss_chunk`` tokens (one chunk when T is
        no multiple).
        A model with MoE blocks adds ``aux_loss_weight * aux /
        len(pattern)``."""
        cfg = self.cfg
        x, aux = self.forward(params, batch["inputs"])
        labels = batch["labels"]
        T = labels.shape[1]
        c = min(cfg.loss_chunk, T)
        if T % c:
            c = T
        ce = torch.cat([self._ce_chunk(params, x[:, i:i + c],
                                       labels[:, i:i + c])
                        for i in range(0, T, c)], dim=1)
        loss = ce.mean()
        if cfg.aux_loss_weight and any(k.endswith("_moe")
                                       for k in cfg.pattern):
            loss = loss + cfg.aux_loss_weight * aux / max(len(cfg.pattern), 1)
        return loss

    # --------------------------------------------- masked-dense training
    def mask_projection(self, params):
        """Re-apply every binary mask after an optimizer update (paper
        Algorithm 1 line 14). Returns a new tree; packed and dense leaves
        are shared, masked-dense weights are new tensors."""
        from repro_torch.core import export as export_lib
        from repro_torch.core import fold as fold_lib
        from repro_torch.core import mpd

        out = tree_lib.copy_tree(params)
        # as the reference: the MoE blocks' attention and the stacked
        # experts, not the shared expert or the router
        for parent, key, lin, _ in export_lib.iter_linear_leaves(
                self, out, "masked_dense", moe_shared=False):
            parent[key] = mpd.reapply_mask(lin.spec, parent[key])
        for spec, pstack in zip(self.block_specs, out["blocks"]):
            ffn = spec["ffn"]
            if not spec["kind"].endswith("_moe") or ffn.mode != "masked_dense":
                continue
            for key, mask in ffn.expert_masks():
                if mask is not None:
                    w = pstack["ffn"][key]
                    pstack["ffn"][key] = w * fold_lib.mask_tensor(mask,
                                                                  w.device)
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
    def prefill(self, params, inputs, caches, lengths=None):
        """A whole prompt batch ``inputs`` (token ids ``(B, T)`` or embeds
        ``(B, T, d_model)``) through the trunk, its K/V
        written into ``caches`` (from :meth:`init_caches`) at rows ``0..T-1``
        in place. Returns ``(logits (B, vocab), caches)``: the logits at the
        last token, or with ``lengths (B,)`` (right-padded prompts) at each
        row's last real token, and ``pos`` (a new tensor) ``T`` or
        ``lengths`` per row, ``(n_periods, B)``, the state an unpadded
        prefill of each row leaves (padded K/V is written but masked by
        ``pos`` in decode). A recurrent block runs from zeros, whatever its
        cache holds, its state frozen at padded steps, and writes the final
        state into its cache. ``lengths`` may be a host sequence or a
        tensor on the device (read there, without a host sync)."""
        cfg = self.cfg
        x = self._embed_inputs(params, inputs)
        B, T = x.shape[:2]
        dev = x.device
        valid = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=dev).to(torch.int32)
            valid = torch.arange(T, device=dev)[None] < lengths[:, None]
        out = []
        for spec, pstack, cstack in zip(self.block_specs, params["blocks"],
                                        caches):
            mixer = spec["mixer"]
            if spec["kind"] not in ATTN_KINDS:
                # recurrent: from zeros, the state written in place
                for i in range(self.n_periods):
                    c = _layer(cstack, i)
                    x, new, _ = self._recurrent(spec, _layer(pstack, i), x,
                                                valid=valid, with_aux=False)
                    for k, t in new.items():
                        c[k].copy_(t)
                out.append(cstack)
                continue
            positions = attn_lib.text_positions(
                mixer, torch.arange(T, device=dev)[None].expand(B, T))
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
        """One block of a decode step. Attention: the paged form with
        ``block_tables``, else the dense one (``cache["pos"]`` scalar or
        per row). Recurrent: the new state computed from the cache, then
        written in place, under ``live`` as ``where(live, new, old)`` (the
        reference's ``freeze``: a non-live row computes but keeps its
        state)."""
        if spec["kind"] not in ATTN_KINDS:
            x, new, _ = self._recurrent(spec, p, x, cache, with_aux=False)
            for k, t in new.items():
                if live is not None:
                    t = torch.where(live.reshape((-1,) + (1,) * (t.dim() - 1)),
                                    t, cache[k])
                cache[k].copy_(t)
            return x
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
        caches)``; the caches are updated in place. An embed frontend
        takes ``(B, 1, d_model)`` embeds for ``tokens``."""
        cfg = self.cfg
        x = self._embed_inputs(
            params, tokens[:, None] if cfg.frontend == "token" else tokens)
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
        re-scored): False for a model with a mamba or rwkv block (the engine
        then decodes one token a step)."""
        return all(s["kind"] in ATTN_KINDS for s in self.block_specs)

    def set_paged_pos(self, caches, pos):
        """Write the host's accepted depth ``pos (B,)`` into every attention
        layer's cache ``pos`` (paged or per-slot dense), **in place** (the
        reference returns new caches); returns the caches. The spec engine
        calls it before each propose and verify, which is what makes
        rollback free: rejected positions are written over under the
        corrected depth next step; the engine's decode calls it before each
        replay, which makes a retried step write what the first try did."""
        for spec, c in zip(self.block_specs, caches):
            if spec["kind"] in ATTN_KINDS:
                c["pos"].copy_(pos.to(c["pos"].dtype)[None].expand_as(c["pos"]))
        return caches

    def verify_step(self, params, tokens, caches, block_tables, live=None):
        """Speculative-verify window: score ``tokens (B, Tq)`` — the pending
        token and the draft's k proposals — against the paged KV pool in one
        pass; ``logits[:, i]`` is the prediction for the token after window
        position ``i``, what :meth:`decode_step` gives when the window is fed
        one token at a time. The caller sets the accepted depth first
        (:meth:`set_paged_pos`); ``pos`` stays there. Returns ``(logits (B,
        Tq, vocab), caches)``, the caches updated in place. An embed
        frontend takes ``(B, Tq, d_model)`` embeds for ``tokens``."""
        assert self.spec_decode_supported, \
            "verify_step: recurrent blocks cannot roll state back"
        cfg = self.cfg
        x = self._embed_inputs(params, tokens)
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

        ``tokens (1, Tc)`` (an embed frontend: embeds ``(1, Tc,
        d_model)``) with ``Tc`` a page multiple; ``start``
        (page-aligned) is the chunk's global offset; ``chunk_len <= Tc``
        real tokens (the final chunk is right-padded). ``slot``, ``start``
        and ``chunk_len`` are host integers or 0-d integer tensors on the
        device, as the reference's scalars are; from tensors every
        position, page id, the ``pos`` write and the last real token's row
        are computed on the device. ``final`` is static. A recurrent block
        carries the slot's state row across chunks: it reads as zeros at
        ``start == 0`` (a ``torch.where`` on the device, so the slot's
        previous occupant never leaks in), the chunk's padded tail leaves
        it frozen, and the new state is written back into the row. Returns
        ``(logits (1, vocab) at the last real token, caches)`` on the final
        chunk and ``(None, caches)`` otherwise (no final norm or
        unembed)."""
        cfg = self.cfg
        x = self._embed_inputs(params, tokens)
        Tc = x.shape[1]
        dev = x.device
        valid = torch.arange(Tc, device=dev)[None] < (
            chunk_len.to(dev) if torch.is_tensor(chunk_len) else chunk_len)
        row = torch.as_tensor(slot, device=dev).reshape(1).long()
        first = start == 0               # a 0-d tensor, or a host bool

        def carried(leaf):
            old = leaf.index_select(0, row)
            if torch.is_tensor(first):
                return torch.where(first.to(dev), torch.zeros_like(old), old)
            return torch.zeros_like(old) if first else old
        for spec, pstack, cstack in zip(self.block_specs, params["blocks"],
                                        caches):
            if spec["kind"] not in ATTN_KINDS:
                for i in range(self.n_periods):
                    c = _layer(cstack, i)
                    state = {k: carried(t) for k, t in c.items()}
                    x, new, _ = self._recurrent(spec, _layer(pstack, i), x,
                                                state, valid, with_aux=False)
                    for k, t in new.items():
                        c[k].index_copy_(0, row, t.to(c[k].dtype))
                continue
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
    def block_linears(self, spec) -> List[Tuple[Tuple[str, ...], Linear]]:
        """(param key path, Linear) pairs of one block spec (the
        reference's ``_block_linears``): the mixer's projections (a mamba
        or rwkv block's raw leaves, its conv, decay LoRA, mixes and gains,
        are not linears), then a dense FFN's; an MoE block's FFN is left
        out (its router stays dense f32 and unfolded; its experts are
        stacked raw weights, see :meth:`moe_shared_linears`)."""
        mixer, ffn, kind = spec["mixer"], spec["ffn"], spec["kind"]
        names = (("wq", "wk", "wv", "wo") if kind in ATTN_KINDS
                 else rwkv_lib.PROJ if kind == "rwkv" else mamba_lib.PROJ)
        out = [(("mixer", n), getattr(mixer, n)) for n in names]
        if ffn is None or kind.endswith("_moe"):
            return out
        out.append((("ffn", "w_up"), ffn.w_up))
        if ffn.w_gate is not None:
            out.append((("ffn", "w_gate"), ffn.w_gate))
        out.append((("ffn", "w_down"), ffn.w_down))
        return out

    @staticmethod
    def moe_shared_linears(spec) -> List[Tuple[Tuple[str, ...], Linear]]:
        """(param key path, Linear) pairs of an MoE block's shared expert
        (none for other blocks): folded and quantized with the block's
        linears, though not in :meth:`block_linears`."""
        shared = (spec["ffn"].shared if spec["kind"].endswith("_moe")
                  else None)
        if shared is None:
            return []
        return [(("ffn", "shared", k), getattr(shared, k))
                for k in ("w_up", "w_gate", "w_down")
                if getattr(shared, k) is not None]

    def param_count(self) -> int:
        """Elements of every param leaf (a masked-dense weight counts in
        full), from an init on the meta device."""
        return sum(t.numel()
                   for t in tree_lib.leaves(self.init(0, device="meta")))

    def matmul_params(self, *, dense: bool) -> int:
        """Weights of every projection a token runs through (unembed
        included, the embedding gather excluded; an MoE block's router,
        shared expert and ``top_k`` routed experts). ``dense=False``
        counts each compressed linear at its packed size, as the
        reference's ``active_matmul_params`` does; ``dense=True`` counts
        what a masked-dense kernel multiplies (``d_in * d_out``). Model
        FLOPs per token are six times this."""
        def count(lin):
            s = lin.spec
            if not dense:
                return s.param_count()
            return s.d_in * s.d_out + (s.d_out if s.use_bias else 0)

        n = 0
        for spec in self.block_specs:
            lins = [lin for _, lin in self.block_linears(spec)]
            ffn = spec["ffn"]
            if spec["kind"].endswith("_moe"):
                # the router, the shared expert and top_k routed experts
                lins += [ffn.router] + [
                    lin for _, lin in self.moe_shared_linears(spec)]
                per_expert = (3 if ffn.gated else 2) * ffn.d_model * ffn.d_ff
                if not dense and ffn.mask_up is not None \
                        and ffn.mode == "packed":
                    per_expert //= ffn.mask_up.nb
                n += per_expert * ffn.top_k
            n += sum(count(lin) for lin in lins)
        return self.n_periods * n + count(self.unembed)

    def active_matmul_params(self) -> int:
        """Matmul weights one token touches (the reference's
        ``active_matmul_params``): the embedding gather excluded, packed
        linears at their packed size, an MoE block's router, ``top_k``
        routed experts and its shared expert."""
        return self.matmul_params(dense=False)


def build(cfg: ModelConfig) -> Model:
    return Model(cfg)
