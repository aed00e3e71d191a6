#!/usr/bin/env python3
"""The paged engine's steady decode step on the card, eager or captured.

    python benchmarks/torch_engine_step.py [--eager] [--steps 32]

olmo-1b at its published widths, every projection packed (mpd_c=8) and
quantized to int8, bf16, random weights from seed 0; the engine of
``chip_smoke.py``'s ``serve`` phase (4 slots, page 16, prefill chunk 64).
Four requests of 448 prompt tokens (numpy draws from ``--seed``) are
prefilled, then ``--steps`` decode steps of 4 live slots are timed one by
one on the host clock, each ended by the engine's own token read. With
``--eager`` the engine runs every program eagerly (``graphs=False``); an
engine without that argument runs eagerly anyway, so the script times
older commits too: put their ``src`` first on ``PYTHONPATH``. Prints one
JSON line with the step's p50 and mean, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_engine_step: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs.common import get_config
    from repro_torch.core import export
    from repro_torch.models import build
    from repro_torch.serve import Engine, Request

    dev = torch.device("cuda", 0)
    cfg = get_config("olmo-1b", dtype="bfloat16")
    model = build(cfg)
    params, _ = export.quantize_packed(model, model.init(0, device=dev))
    kw = dict(n_slots=4, max_len=512 + 32, page_size=16,
              prefill_chunk_tokens=64)
    try:
        engine = Engine(model, params, graphs=False if args.eager else None,
                        **kw)
    except TypeError:                   # an engine that only runs eagerly
        if not args.eager:
            raise
        engine = Engine(model, params, **kw)
    if hasattr(engine, "warmup"):
        engine.warmup()
    rng = np.random.default_rng(args.seed)
    for i in range(4):
        engine.submit(Request(id=i, prompt=rng.integers(0, cfg.vocab, 448),
                              max_new_tokens=96))
    while engine._prefill_queue or engine.scheduler.waiting:
        engine.step()
    for _ in range(4):                  # first-call costs of the decode width
        engine.step()
    torch.cuda.synchronize()
    ms = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        engine.step()
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(json.dumps({
        "route": "eager" if args.eager else "default",
        "captured": bool(getattr(engine, "use_graphs", False)),
        "steps": args.steps, "step_ms_p50": statistics.median(ms),
        "step_ms_mean": statistics.fmean(ms),
        "device": torch.cuda.get_device_name(0)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
