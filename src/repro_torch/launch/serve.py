"""Serving launcher of the port: the continuous-batching engine on a
synthetic Poisson request stream, or the legacy static lockstep batch.

    python -m repro_torch.launch.serve --arch olmo-1b --quantize int8
    python -m repro_torch.launch.serve --arch olmo-1b --paged --quantize int8
    python -m repro_torch.launch.serve --arch olmo-1b --static --batch 4

builds the config in memory with a random packed init from ``--seed`` on
the CUDA device (``--device cpu`` runs on the CPU), optionally quantizes
every packed projection (``--quantize int8``, or ``int4``: 4-bit values
the kernels read as int8), and serves ``--requests`` synthetic requests on
the slot-dense engine (the default, as the reference's) or the paged one
(``--paged``). ``--static`` prefills one batch of ``--batch`` prompts and
decodes it in lockstep, logging the prefill ms and the decode tok/s.
``--mpd-fuse`` builds the Fig-3 perm-fused model, whose FFNs run as one
fused kernel each; ``--mpd-c`` overrides the compression. ``--ckpt-dir
DIR`` serves the packed artifact in ``DIR/packed`` when there is one
(written by ``launch.train --fold-to-packed`` or by the JAX package's
``export_packed``): its recorded config, fusion and quantization win over
the flags. Otherwise it restores the newest train checkpoint in ``DIR``
(``{"params": ...}``, written by either package) over the init;
``--fold-to-packed`` builds the model in ``masked_dense`` mode, restores
that, and folds it to packed (paper Eq. 2) before serving. Prompt tokens
are the first batch of a ``SyntheticLM`` stream of ``--seed``, and
``np.random.default_rng(seed)`` draws the arrivals, lengths and budgets,
as the JAX launcher does; prompt lengths lie in ``[prompt_len/2,
prompt_len]``, output budgets in ``[gen/2, gen]``, and ``--shared-prefix
N`` makes the first N prompt tokens identical across requests so the
prefix trie gets hits. ``--spec-draft DIR`` (paged) turns on speculative
decoding with the packed artifact in ``DIR/packed`` as the draft
(typically the target's own folded int8 export), proposing ``--spec-k``
tokens a step. ``--prefill-kernel`` routes the paged prefill attention:
``pallas`` and ``interpret`` (the reference's names for its kernel) take
the CUDA kernel, ``jnp`` the plain version; CPU tensors always take the
plain one.

Every engine the launcher builds carries the degradation ladder (the
reference's production posture). ``--chaos-schedule`` (``storm``, a JSON
list of fault specs or ``@file``) adds a seeded fault injector
(``--chaos-seed``); ``--chaos-verify`` then serves the same stream on a
fault-free engine and exits non-zero unless every request the chaos run
completed streamed the same tokens. ``--http`` serves real traffic over
the asyncio HTTP/SSE frontend on ``--host``/``--port`` (``POST
/v1/generate``, ``GET /metrics``, ``GET /healthz``), turning requests away
with 429 beyond ``--queue-limit`` waiting ones.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import logging
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.common import ARCHS, get_config
from repro_torch.core import export as export_lib
from repro_torch.data import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.serve import (DegradationLadder, Engine, FaultInjector,
                               Request, Resilience, SamplingParams,
                               parse_schedule)

log = logging.getLogger("repro_torch.serve.launch")


def make_requests(cfg, *, n_requests, rate, prompt_len, gen, seed=0,
                  shared_prefix=0):
    """Synthetic Poisson request stream: exponential inter-arrivals at
    ``rate`` req/s, prompt lengths in [prompt_len/2, prompt_len], output
    budgets in [gen/2, gen]; the first ``shared_prefix`` prompt tokens are
    identical across requests. Field for field the requests of
    ``repro.launch.serve.make_requests``: the tokens come from the first
    ``SyntheticLM`` batch of ``seed``, ``default_rng(seed)`` draws the rest
    in the reference's order."""
    if rate <= 0:
        raise ValueError(f"arrival rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=prompt_len,
                       global_batch=max(n_requests, 1), seed=seed)
    toks = data.next()["inputs"]
    if shared_prefix:
        toks[:, :shared_prefix] = toks[0, :shared_prefix]
    t = 0.0
    out = []
    for i in range(n_requests):
        t += rng.exponential(1.0 / rate)
        plen = int(rng.integers(max(prompt_len // 2, 1), prompt_len + 1))
        plen = max(plen, min(shared_prefix, prompt_len))
        out.append(Request(
            id=i, prompt=toks[i, :plen],
            max_new_tokens=int(rng.integers(max(gen // 2, 1), gen + 1)),
            sampling=SamplingParams(temperature=0.0, seed=seed * 1000 + i),
            arrival_time=t))
    return out


def serve_stream(engine, requests, *, idle_sleep=0.0005):
    """Wall-clock drive loop: submit each request when its arrival time
    elapses, step the engine whenever it has work. Returns the summary."""
    pending = collections.deque(
        sorted(requests, key=lambda r: r.arrival_time or 0.0))
    t0 = time.perf_counter()
    engine.metrics.clock = lambda: time.perf_counter() - t0
    while pending or engine.has_work():
        now = time.perf_counter() - t0
        while pending and (pending[0].arrival_time or 0.0) <= now:
            engine.submit(pending.popleft())
        if engine.has_work():
            engine.step()
        elif pending:
            time.sleep(min(idle_sleep,
                           max((pending[0].arrival_time or 0.0) - now, 0)))
    return engine.metrics.summary()


def _restore_latest(ckpt_dir, params, tag="", device=None):
    """``params`` restored from the newest train checkpoint in ``ckpt_dir``
    (the reference's ``{"params": ...}`` tree, so a checkpoint of either
    package restores)."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    step = ckpt_lib.latest_step(ckpt_dir)
    if step is None:
        raise SystemExit(f"no packed export under {ckpt_dir}/packed and no "
                         f"checkpoint under {ckpt_dir}")
    params = ckpt_lib.restore(ckpt_dir, step, {"params": params},
                              device=device)["params"]
    log.info("restored %sstep %d from %s", tag, step, ckpt_dir)
    return params


def _quantize_in_memory(model, params, mode):
    """Post-hoc quantization of a packed (model, params) pair to ``mode``
    (``int8``, or ``int4``: values in [-7, 7], still int8 for the
    kernels)."""
    from repro_torch.kernels.quant import BITS

    params, report = export_lib.quantize_packed(model, params,
                                                bits=BITS[mode])
    model.quant_report = report
    log.info("quantized packed weights to %s: %d layers, max rel-rms err "
             "%.2e", mode, report["n_layers"], report["max_rel_rms"])
    return params


def load_model(arch, *, smoke=False, dtype=None, n_layers=None, quantize="",
               seed=0, device=None, mpd_fuse=False, mpd_c=0,
               fold_to_packed=False, ckpt_dir=""):
    """(cfg, model, params), as the reference's ``_load_model`` resolves
    them: the packed artifact under ``ckpt_dir`` when there is one; with
    ``fold_to_packed`` a ``masked_dense`` init from ``seed`` (restored from
    ``ckpt_dir``'s newest train checkpoint when given) folded to packed;
    else the config's init from ``seed``, restored likewise. Quantized when
    asked and not already so."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    over = {}
    if dtype:
        over["dtype"] = dtype
    if n_layers:
        over["n_layers"] = n_layers
    if mpd_fuse:
        over["mpd_fuse"] = True
    if mpd_c:
        over["mpd_c"] = mpd_c
    if ckpt_dir and ckpt_lib.has_packed(ckpt_dir):
        if over or fold_to_packed:
            log.info("note: packed export found; its recorded config wins, "
                     "ignoring %s", sorted(over) + (["fold_to_packed"]
                                                    if fold_to_packed else []))
        model, params = ckpt_lib.load_packed(ckpt_dir, device=device)
        stored = getattr(model, "quant_report", None)
        log.info("loaded packed export from %s/packed%s", ckpt_dir,
                 f" (quantized, {stored['bits']}-bit)" if stored else "")
        if quantize and stored:
            log.info("note: export already quantized (%d-bit); its stored "
                     "form wins, ignoring --quantize %s", stored["bits"],
                     quantize)
        elif quantize:
            params = _quantize_in_memory(model, params, quantize)
        return model.cfg, model, params
    cfg = get_config(arch, smoke=smoke, **over)
    if fold_to_packed:
        model_md = build(dataclasses.replace(cfg, mpd_mode="masked_dense"))
        params = model_md.init(seed, device=device)
        if ckpt_dir:
            params = _restore_latest(ckpt_dir, params, "masked_dense ",
                                     device)
        model, params = model_md.to_packed(params, fuse=cfg.mpd_fuse,
                                           quantize=quantize or None)
        rep = getattr(model, "quant_report", None)
        log.info("folded to packed: %s params (was %s)%s",
                 f"{model.param_count():,}", f"{model_md.param_count():,}",
                 f", quantized {quantize} (max rel-rms err "
                 f"{rep['max_rel_rms']:.2e})" if rep else "")
        return model.cfg, model, params
    model = build(cfg)
    params = model.init(seed, device=device)
    if ckpt_dir:
        params = _restore_latest(ckpt_dir, params, device=device)
    if quantize:
        if cfg.mpd_mode != "packed":
            raise SystemExit("--quantize needs packed params: combine with "
                             "--fold-to-packed for a masked_dense run")
        params = _quantize_in_memory(model, params, quantize)
    return cfg, model, params


def load_spec_draft(spec_dir, *, device=None):
    """(model, params) of the draft for speculative decoding: the packed
    artifact under ``spec_dir``."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    if not ckpt_lib.has_packed(spec_dir):
        raise SystemExit(f"--spec-draft needs a packed export under "
                         f"{spec_dir}/packed (write one with `train "
                         "--fold-to-packed` or export_packed)")
    draft, params = ckpt_lib.load_packed(spec_dir, device=device)
    q = getattr(draft, "quant_report", None)
    log.info("spec draft: packed export from %s/packed%s", spec_dir,
             f" (quantized, {q['bits']}-bit)" if q else "")
    return draft, params


def static_decode(model, params, prompts, gen):
    """The legacy lockstep path: one prefill of ``prompts (B, T)`` into
    dense caches of ``T + gen`` rows, then ``gen - 1`` greedy decode steps
    of the whole batch at one depth, the step captured as one CUDA graph on
    a CUDA device (eager on the CPU). Returns ``{"tokens" (B, gen) int64
    on the host, "prefill_ms", "decode_ms", "decode_tok_s", "route"}``, the
    times on a synchronised clock (the decode's graph capture excluded)."""
    from repro_torch.serve.graphs import StepGraph

    dev = prompts.device
    captured = dev.type == "cuda" and gen > 1
    B, T = prompts.shape

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    with torch.no_grad():
        caches = model.init_caches(B, T + gen, device=dev)
        sync()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, prompts, caches)
        tok = torch.argmax(logits, dim=-1)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        out = [tok.clone()]
        step = lambda: model.decode_step(params, tok, caches)[0]  # noqa: E731
        if captured:
            # the capture's warm runs write K/V at and past the depth (each
            # written again before it is read) and advance pos: put it back
            saved = [c["pos"].clone() for c in caches]
            graph = StepGraph("static_decode", B, step, dev)
            for c, p in zip(caches, saved):
                c["pos"].copy_(p)
            step = graph.replay
        sync()
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            tok.copy_(torch.argmax(step(), dim=-1))
            out.append(tok.clone())
        sync()
        decode_ms = (time.perf_counter() - t0) * 1e3
    return {"tokens": torch.stack(out, dim=1).cpu().numpy(),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "decode_tok_s": B * (gen - 1) / max(decode_ms / 1e3, 1e-9),
            "route": "captured" if captured else "eager"}


def _static_main(args, cfg, model, params, device):
    """``--static``: prompts from ``SyntheticLM(seed=0)``, one prefill, a
    lockstep greedy decode."""
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.prompt_len,
                       global_batch=args.batch, seed=0)
    prompts = torch.as_tensor(data.next()["inputs"], device=device)
    out = static_decode(model, params, prompts, args.gen)
    log.info("prefill %dx%d: %.1f ms", args.batch, args.prompt_len,
             out["prefill_ms"])
    log.info("decode %d steps (%s): %.1f ms (%.0f tok/s)", args.gen - 1,
             out["route"], out["decode_ms"], out["decode_tok_s"])
    return out


def _build_resilience(args, *, chaos=True):
    """The launcher's engines always get the degradation ladder; a fault
    injector rides along only with ``--chaos-schedule`` (and never in the
    ``chaos=False`` baseline of ``--chaos-verify``)."""
    injector = None
    if chaos and args.chaos_schedule:
        schedule = parse_schedule(args.chaos_schedule)
        injector = FaultInjector(schedule, seed=args.chaos_seed)
        log.info("chaos: %d fault specs from %r (seed %d)", len(schedule),
                 args.chaos_schedule, args.chaos_seed)
    return Resilience(injector=injector, ladder=DegradationLadder(),
                      seed=args.chaos_seed)


def _build_engine(args, model, params, device, spec_draft=None, *,
                  chaos=True):
    """The engine the flags describe, every program captured
    (``warmup()``; eager on the CPU). Returns ``(engine, mode label)``."""
    engine = Engine(model, params, n_slots=args.slots,
                    max_len=args.prompt_len + args.gen, paged=args.paged,
                    page_size=args.page_size, n_pages=args.pages or None,
                    prefill_chunk_tokens=args.prefill_chunk or None,
                    spec_draft=spec_draft, spec_k=args.spec_k,
                    resilience=_build_resilience(args, chaos=chaos))
    mode = "paged" if args.paged else "continuous"
    t0 = time.perf_counter()
    engine.warmup()
    if engine.use_graphs:
        log.info("captured %d CUDA graphs (every program at every width "
                 "rung or bucket) in %.1f s", engine.n_captures,
                 time.perf_counter() - t0)
    return engine, mode


def _requests(args, cfg):
    return make_requests(cfg, n_requests=args.requests, rate=args.rate,
                         prompt_len=args.prompt_len, gen=args.gen,
                         seed=args.seed, shared_prefix=args.shared_prefix)


def _continuous_main(args, cfg, model, params, device):
    spec_draft = (load_spec_draft(args.spec_draft, device=device)
                  if args.spec_draft else None)
    engine, mode = _build_engine(args, model, params, device, spec_draft)
    requests = _requests(args, cfg)
    s = serve_stream(engine, requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info("%s: %d/%d requests, %d tokens in %.2f s (%.0f tok/s)", mode,
             s["n_done"], s["n_requests"], s["total_tokens"], s["elapsed_s"],
             s["agg_tok_s"])
    log.info("ttft mean/p50/p95: %.0f/%.0f/%.0f ms; e2e p50/p95: %.0f/%.0f ms; "
             "slot occupancy %.0f%%", s["ttft_mean_s"] * 1e3,
             s["ttft_p50_s"] * 1e3, s["ttft_p95_s"] * 1e3, s["e2e_p50_s"] * 1e3,
             s["e2e_p95_s"] * 1e3, s["occupancy_mean"] * 100)
    if args.paged:
        c = engine.cache
        log.info("paged kv: page_size=%d, pool=%d pages; allocated peak "
                 "%.2f MB vs dense reservation %.2f MB; prefill tokens "
                 "computed %d (+%d reused via prefix cache) [%s prefill "
                 "route]", c.page_size, c.n_pages,
                 s["kv_bytes_allocated_peak"] / 1e6,
                 s["kv_bytes_reserved"] / 1e6, engine.n_prefill_tokens,
                 engine.n_prefill_tokens_skipped, ops.prefill_backend())
    else:
        log.info("dense kv: %d slots x %d rows reserved, %.2f MB",
                 engine.n_slots, engine.max_len,
                 s["kv_bytes_reserved"] / 1e6)
    if engine.spec_active:
        log.info("spec decode: k=%d, %.2f tokens/step, %.0f%% draft "
                 "acceptance", engine.spec_k, s["tokens_per_step_mean"],
                 s["draft_acceptance_rate"] * 100)
    res = engine.resilience
    if res.injector is not None or s["degradation_transitions"]:
        log.info("resilience: %s", res.summary())
    s["streams"] = {r.id: list(r.generated) for r in requests}
    s["resilience"] = res.summary()
    if args.chaos_verify:
        del engine
        s["chaos_verify"] = _chaos_verify(args, cfg, model, params, device,
                                          spec_draft, requests)
    return s


def _chaos_verify(args, cfg, model, params, device, spec_draft,
                  chaos_requests):
    """Serve the same request stream on a fault-free engine and demand that
    every request the chaos run completed normally streamed the same
    tokens; exits non-zero on any divergence (quarantine and retry must
    never perturb the surviving traffic). Returns the counts."""
    engine, _ = _build_engine(args, model, params, device, spec_draft,
                              chaos=False)
    baseline = _requests(args, cfg)
    serve_stream(engine, baseline)
    base = {r.id: list(r.generated) for r in baseline}
    aborted = [r.id for r in chaos_requests
               if r.finish_reason in ("fault", "deadline")]
    mismatched = [r.id for r in chaos_requests
                  if r.id not in aborted and list(r.generated) != base[r.id]]
    if mismatched:
        raise SystemExit(
            f"chaos-verify FAILED: requests {mismatched} diverged from the "
            "fault-free baseline")
    log.info("chaos-verify OK: %d/%d requests token-identical to fault-free "
             "baseline (%d aborted by injected faults)",
             len(chaos_requests) - len(aborted), len(chaos_requests),
             len(aborted))
    return {"identical": len(chaos_requests) - len(aborted),
            "aborted": len(aborted), "requests": len(chaos_requests)}


def _http_main(args, cfg, model, params, device):
    """``--http``: serve real traffic over the asyncio SSE frontend until
    interrupted."""
    from repro_torch.serve import server as server_lib

    spec_draft = (load_spec_draft(args.spec_draft, device=device)
                  if args.spec_draft else None)
    engine, mode = _build_engine(args, model, params, device, spec_draft)
    engine.metrics.clock = time.perf_counter
    log.info("http frontend over %s engine: %d slots, max_len %d", mode,
             engine.n_slots, engine.max_len)
    server_lib.run(engine, host=args.host, port=args.port,
                   queue_limit=args.queue_limit)


# --prefill-kernel: the reference's names for its kernel (pallas on the TPU,
# interpret its CPU mode) take the CUDA kernel, its dense oracle (jnp) the
# plain version
PREFILL_ROUTES = {"pallas": "cuda", "interpret": "cuda", "jnp": "torch"}
# the reference launcher's flags not ported yet: flag -> (its default, the
# ROADMAP queue A item that ports it)
NOT_PORTED = {"--replicas": (1, 4), "--disagg": (False, 4),
              "--n-prefill": (1, 4), "--tp": (1, 6)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", choices=ARCHS, required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--static", action="store_true",
                   help="legacy fixed-batch lockstep path")
    p.add_argument("--batch", type=int, default=4, help="static-mode batch")
    p.add_argument("--paged", action="store_true",
                   help="paged KV engine (page pool, block tables, prefix "
                   "reuse, chunked prefill) instead of the slot-dense one")
    p.add_argument("--quantize", choices=("int8", "int4"), default="",
                   help="quantize the packed weights (int4: 4-bit values, "
                   "still int8 for the kernels; scales f32)")
    p.add_argument("--mpd-c", type=int, default=0,
                   help="0 = the config's compression")
    p.add_argument("--mpd-fuse", action="store_true",
                   help="Fig-3 perm-fused FFNs (one fused kernel each)")
    p.add_argument("--ckpt-dir", default="",
                   help="serve the packed artifact in <ckpt-dir>/packed, "
                   "else restore its newest train checkpoint")
    p.add_argument("--fold-to-packed", action="store_true",
                   help="build masked_dense (restored from --ckpt-dir when "
                   "given) and fold it to packed before serving (Eq. 2)")
    p.add_argument("--device", default=None,
                   help="torch device; default the CUDA device (cpu runs "
                   "on the host)")
    p.add_argument("--dtype", choices=tuple(device_lib.DTYPES), default=None,
                   help="override the config dtype")
    p.add_argument("--n-layers", type=int, default=0,
                   help="cut the depth (0 = the config's)")
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=16.0,
                   help="Poisson arrival rate (req/s)")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--pages", type=int, default=0,
                   help="pool size; 0 = dense-equivalent")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help="prefill chunk tokens (page multiple); 0 = 4 pages")
    p.add_argument("--prefill-kernel", default="",
                   choices=("",) + tuple(PREFILL_ROUTES),
                   help="paged prefill attention: pallas or interpret = the "
                   "CUDA kernel, jnp = the plain version; empty = follow "
                   "the global route")
    p.add_argument("--shared-prefix", type=int, default=0)
    p.add_argument("--spec-draft", default="",
                   help="speculative decoding (requires --paged): directory "
                   "with a packed export to deploy as the draft model")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens proposed per verify window")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--http", action="store_true",
                   help="serve over the HTTP/SSE frontend instead of a "
                   "synthetic request stream")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--queue-limit", type=int, default=64,
                   help="waiting requests before --http answers 429")
    p.add_argument("--chaos-schedule", default="",
                   help="fault-injection schedule: 'storm', a JSON list of "
                   "fault specs, or @path to a JSON file")
    p.add_argument("--chaos-seed", type=int, default=0)
    p.add_argument("--chaos-verify", action="store_true",
                   help="re-serve the stream fault-free and fail unless "
                   "every completed request is token-identical")
    for flag, (default, _) in NOT_PORTED.items():
        if isinstance(default, bool):
            p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        else:
            p.add_argument(flag, type=type(default), default=default,
                           help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    for flag, (default, item) in NOT_PORTED.items():
        if getattr(args, flag[2:].replace("-", "_")) != default:
            raise SystemExit(f"{flag} is not ported (ROADMAP queue A item "
                             f"{item})")
    if args.static and args.paged:
        raise SystemExit("--static and --paged are mutually exclusive "
                         "(paged is a continuous-engine memory model)")
    if args.spec_draft and not args.paged:
        raise SystemExit("--spec-draft requires --paged (the verify window "
                         "scatters into paged KV)")
    if args.prefill_kernel and not args.paged:
        raise SystemExit("--prefill-kernel routes paged chunked prefill; "
                         "combine with --paged")
    if args.chaos_verify and not args.chaos_schedule:
        raise SystemExit("--chaos-verify needs --chaos-schedule")
    if args.chaos_verify and args.http:
        raise SystemExit("--chaos-verify drives the synthetic stream; it "
                         "cannot combine with --http")
    try:
        device = device_lib.resolve(args.device)
    except device_lib.NoCudaDevice as e:
        raise SystemExit(str(e))
    try:
        cfg, model, params = load_model(
            args.arch, smoke=args.smoke, dtype=args.dtype,
            n_layers=args.n_layers, quantize=args.quantize, seed=args.seed,
            device=device, mpd_fuse=args.mpd_fuse, mpd_c=args.mpd_c,
            fold_to_packed=args.fold_to_packed, ckpt_dir=args.ckpt_dir)
    except SystemExit:
        raise
    except Exception as e:
        # startup fails with one clear line: a corrupt packed artifact lands
        # here as ArtifactCorruptError
        raise SystemExit(f"startup failed: {type(e).__name__}: {e}")
    log.info("serving %s on %s: %s params (%d layers, %s, mode=%s)",
             cfg.name, device, f"{model.param_count():,}", cfg.n_layers,
             cfg.dtype, cfg.mpd_mode)
    if args.static:
        return _static_main(args, cfg, model, params, device)
    # set before the engine captures its programs: a graph keeps the route
    # it was captured under
    ops.set_prefill_backend(PREFILL_ROUTES.get(args.prefill_kernel))
    try:
        if args.http:
            return _http_main(args, cfg, model, params, device)
        return _continuous_main(args, cfg, model, params, device)
    finally:
        ops.set_prefill_backend(None)


if __name__ == "__main__":
    main()
