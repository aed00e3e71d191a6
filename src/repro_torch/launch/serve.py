"""Serving launcher of the port: the paged continuous-batching engine on a
synthetic Poisson request stream.

    python -m repro_torch.launch.serve --arch olmo-1b --paged --quantize int8

builds the config in memory with a random packed init from ``--seed`` on
the CUDA device (``--device cpu`` runs on the CPU), optionally quantizes
every packed projection to int8, and serves ``--requests`` synthetic
requests. ``--mpd-fuse`` builds the Fig-3 perm-fused model, whose FFNs run
as one fused kernel each. ``--ckpt-dir DIR`` serves the packed artifact in
``DIR/packed`` instead (written by ``launch.train --fold-to-packed`` or by
the JAX package's ``export_packed``): its recorded config, fusion and
quantization win over the flags. Prompt tokens are the first batch of a
``SyntheticLM`` stream of ``--seed``, and ``np.random.default_rng(seed)``
draws the arrivals, lengths and budgets, as the JAX launcher does; prompt
lengths lie in ``[prompt_len/2, prompt_len]``, output budgets in
``[gen/2, gen]``, and ``--shared-prefix N`` makes the first N prompt tokens
identical across requests so the prefix trie gets hits. ``--spec-draft DIR``
turns on speculative decoding with the packed artifact in ``DIR/packed`` as
the draft (typically the target's own folded int8 export), proposing
``--spec-k`` tokens a step.
"""

from __future__ import annotations

import argparse
import collections
import logging
import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.configs.common import ARCHS, get_config
from repro_torch.core import export as export_lib
from repro_torch.data import SyntheticLM
from repro_torch.models import build
from repro_torch.serve import Engine, Request, SamplingParams

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


def load_model(arch, *, smoke=False, dtype=None, n_layers=None, quantize="",
               seed=0, device=None, mpd_fuse=False, ckpt_dir=""):
    """(cfg, model, params): the packed artifact under ``ckpt_dir`` when
    there is one, else the config with its overrides and a random packed
    init from ``seed`` on ``device``; quantized when asked and not already
    so."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.kernels.quant import BITS

    over = {}
    if dtype:
        over["dtype"] = dtype
    if n_layers:
        over["n_layers"] = n_layers
    if mpd_fuse:
        over["mpd_fuse"] = True
    if ckpt_dir:
        if not ckpt_lib.has_packed(ckpt_dir):
            raise SystemExit(f"no packed export under {ckpt_dir}/packed "
                             "(restoring train checkpoints is not ported)")
        if over:
            log.info("note: packed export found; its recorded config wins, "
                     "ignoring %s", sorted(over))
        model, params = ckpt_lib.load_packed(ckpt_dir, device=device)
        stored = getattr(model, "quant_report", None)
        log.info("loaded packed export from %s/packed%s", ckpt_dir,
                 f" (quantized, {stored['bits']}-bit)" if stored else "")
        if quantize and stored:
            log.info("note: export already quantized (%d-bit); its stored "
                     "form wins, ignoring --quantize %s", stored["bits"],
                     quantize)
            quantize = ""
        cfg = model.cfg
    else:
        cfg = get_config(arch, smoke=smoke, **over)
        model = build(cfg)
        params = model.init(seed, device=device)
    if quantize:
        params, report = export_lib.quantize_packed(model, params,
                                                    bits=BITS[quantize])
        model.quant_report = report
        log.info("quantized packed weights to %s: %d layers, max rel-rms "
                 "err %.2e", quantize, report["n_layers"],
                 report["max_rel_rms"])
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", choices=ARCHS, required=True)
    p.add_argument("--paged", action="store_true",
                   help="paged KV engine (the only engine ported so far)")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--quantize", choices=("int8",), default="")
    p.add_argument("--mpd-fuse", action="store_true",
                   help="Fig-3 perm-fused FFNs (one fused kernel each)")
    p.add_argument("--ckpt-dir", default="",
                   help="serve the packed artifact in <ckpt-dir>/packed")
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
    p.add_argument("--shared-prefix", type=int, default=0)
    p.add_argument("--spec-draft", default="",
                   help="speculative decoding (requires --paged): directory "
                   "with a packed export to deploy as the draft model")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens proposed per verify window")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.spec_draft and not args.paged:
        raise SystemExit("--spec-draft requires --paged (the verify window "
                         "scatters into paged KV)")
    if not args.paged:
        raise SystemExit("only the paged engine is ported: pass --paged")
    try:
        device = device_lib.resolve(args.device)
    except device_lib.NoCudaDevice as e:
        raise SystemExit(str(e))
    cfg, model, params = load_model(
        args.arch, smoke=args.smoke, dtype=args.dtype, n_layers=args.n_layers,
        quantize=args.quantize, seed=args.seed, device=device,
        mpd_fuse=args.mpd_fuse, ckpt_dir=args.ckpt_dir)
    log.info("serving %s on %s: %s params (%d layers, %s)", cfg.name, device,
             f"{model.param_count():,}", cfg.n_layers, cfg.dtype)
    spec_draft = (load_spec_draft(args.spec_draft, device=device)
                  if args.spec_draft else None)
    engine = Engine(model, params, n_slots=args.slots,
                    max_len=args.prompt_len + args.gen, page_size=args.page_size,
                    n_pages=args.pages or None,
                    prefill_chunk_tokens=args.prefill_chunk or None,
                    spec_draft=spec_draft, spec_k=args.spec_k)
    t0 = time.perf_counter()
    engine.warmup()
    if engine.use_graphs:
        log.info("captured %d CUDA graphs (every program at every width "
                 "rung) in %.1f s", engine.n_captures,
                 time.perf_counter() - t0)
    requests = make_requests(cfg, n_requests=args.requests, rate=args.rate,
                             prompt_len=args.prompt_len, gen=args.gen,
                             seed=args.seed, shared_prefix=args.shared_prefix)
    s = serve_stream(engine, requests)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log.info("paged: %d/%d requests, %d tokens in %.2f s (%.0f tok/s)",
             s["n_done"], s["n_requests"], s["total_tokens"], s["elapsed_s"],
             s["agg_tok_s"])
    log.info("ttft mean/p50/p95: %.0f/%.0f/%.0f ms; e2e p50/p95: %.0f/%.0f ms; "
             "slot occupancy %.0f%%", s["ttft_mean_s"] * 1e3,
             s["ttft_p50_s"] * 1e3, s["ttft_p95_s"] * 1e3, s["e2e_p50_s"] * 1e3,
             s["e2e_p95_s"] * 1e3, s["occupancy_mean"] * 100)
    c = engine.cache
    log.info("paged kv: page_size=%d, pool=%d pages; allocated peak %.2f MB vs "
             "dense reservation %.2f MB; prefill tokens computed %d (+%d "
             "reused via prefix cache)", c.page_size, c.n_pages,
             s["kv_bytes_allocated_peak"] / 1e6, s["kv_bytes_reserved"] / 1e6,
             engine.n_prefill_tokens, engine.n_prefill_tokens_skipped)
    if engine.spec_active:
        log.info("spec decode: k=%d, %.2f tokens/step, %.0f%% draft "
                 "acceptance", engine.spec_k, s["tokens_per_step_mean"],
                 s["draft_acceptance_rate"] * 100)
    return s


if __name__ == "__main__":
    main()
