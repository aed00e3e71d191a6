"""Streaming client for the port's HTTP/SSE frontend
(``repro_torch.serve.server``; the port's copy of
``examples/serve_http_client.py``).

Start a server first, e.g. on the CPU::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --smoke --paged --http --port 8077 --device cpu

(drop ``--smoke`` and ``--device cpu`` to serve the full model from the
CUDA card), then stream two concurrent requests (one per priority
class)::

    PYTHONPATH=src python examples/torch_serve_http_client.py --port 8077

Stdlib-only (asyncio streams — the same dependency budget as the server).
Flags used by the CI smoke job:

* ``--wait N``      poll ``/healthz`` for up to N seconds before starting
  (on the card the server builds its kernels and captures its graphs
  before it listens, so give it headroom);
* ``--verify --ckpt-dir D [--device cpu]``  load the same packed export
  the server is serving and check every streamed token against a
  direct-engine greedy run on the port — the frontend must be an exact
  window onto the engine;
* ``--check-metrics``  fetch ``/metrics`` afterwards and assert the
  per-class SLO-attainment series is present;
* ``--check-chaos-metrics``  (chaos smoke: the server was launched with
  ``--chaos-schedule``) additionally assert the fault-injection and
  quarantine counters are non-zero and the degradation-stage gauge is
  exported.
"""

import argparse
import asyncio
import json
import sys
import time


async def _healthz(host, port):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET /healthz HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
    await writer.drain()
    data = await reader.read(65536)
    writer.close()
    return json.loads(data.split(b"\r\n\r\n", 1)[1])


async def wait_ready(host, port, timeout_s):
    t0 = time.monotonic()
    while True:
        try:
            return await _healthz(host, port)
        except (ConnectionError, OSError, json.JSONDecodeError):
            if time.monotonic() - t0 > timeout_s:
                raise SystemExit(f"server at {host}:{port} not ready "
                                 f"after {timeout_s}s")
            await asyncio.sleep(0.5)


async def generate(host, port, spec, label):
    """POST one generate call and stream its SSE events; returns the
    token list and the final ``done`` payload."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(spec).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()

    toks, done, buf = [], None, b""
    head = await reader.readuntil(b"\r\n\r\n")
    status = head.split(b"\r\n", 1)[0].decode()
    if "200" not in status:
        raise SystemExit(f"[{label}] {status}: {await reader.read(4096)}")
    while done is None:
        chunk = await reader.read(4096)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf:
            block, buf = buf.split(b"\n\n", 1)
            lines = block.split(b"\n")
            ev = next((l[7:].decode() for l in lines
                       if l.startswith(b"event: ")), None)
            data = next((json.loads(l[6:]) for l in lines
                         if l.startswith(b"data: ")), None)
            if ev == "token":
                toks.append(data["token"])
                print(f"[{label}] token {data['index']}: {data['token']}")
            elif ev == "done":
                done = data
    writer.close()
    print(f"[{label}] done: {done}")
    return toks, done


async def fetch_metrics(host, port):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET /metrics HTTP/1.1\r\nHost: {host}\r\n\r\n".encode())
    await writer.drain()
    data = b""
    while True:
        chunk = await reader.read(65536)
        if not chunk:
            break
        data += chunk
    writer.close()
    return data.split(b"\r\n\r\n", 1)[1].decode()


def reference_tokens(ckpt_dir, prompts, max_new, device=None):
    """Direct-engine greedy run of the same prompts on the same packed
    export — the ground truth the SSE streams must reproduce."""
    import numpy as np
    from repro_torch import device as device_lib
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.serve import Engine, Request

    model, params = ckpt_lib.load_packed(ckpt_dir,
                                         device=device_lib.resolve(device))
    max_len = max(len(p) for p in prompts) + max_new
    engine = Engine(model, params, n_slots=len(prompts), max_len=max_len,
                    paged=True, page_size=8)
    reqs = [Request(id=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]
    return engine.run(reqs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--wait", type=float, default=0,
                    help="poll /healthz up to this many seconds first")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--verify", action="store_true",
                    help="check streams against a direct-engine greedy run")
    ap.add_argument("--ckpt-dir", default="",
                    help="--verify: packed export the server is serving")
    ap.add_argument("--device", default=None,
                    help="--verify: torch device of the direct engine "
                    "(default the CUDA card)")
    ap.add_argument("--check-metrics", action="store_true",
                    help="assert /metrics carries the SLO series")
    ap.add_argument("--check-chaos-metrics", action="store_true",
                    help="assert /metrics shows injected faults + "
                    "quarantines (server running with --chaos-schedule)")
    args = ap.parse_args(argv)

    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8, 2, 8]]

    async def run():
        if args.wait:
            info = await wait_ready(args.host, args.port, args.wait)
            print(f"server ready: {info}")
        return await asyncio.gather(
            generate(args.host, args.port,
                     {"prompt": prompts[0],
                      "max_new_tokens": args.max_new_tokens,
                      "priority": "interactive", "ttft_slo_ms": 120_000,
                      "e2e_slo_ms": 300_000}, "interactive"),
            generate(args.host, args.port,
                     {"prompt": prompts[1],
                      "max_new_tokens": args.max_new_tokens,
                      "priority": "batch", "e2e_slo_ms": 300_000}, "batch"))

    results = asyncio.run(run())

    if args.verify:
        if not args.ckpt_dir:
            raise SystemExit("--verify needs --ckpt-dir")
        ref = reference_tokens(args.ckpt_dir, prompts, args.max_new_tokens,
                               args.device)
        for i, (toks, _) in enumerate(results):
            if toks != ref[i]:
                raise SystemExit(f"stream {i} diverged from direct engine: "
                                 f"{toks} vs {ref[i]}")
        print(f"verify: {len(results)} streams token-identical to the "
              f"direct engine")

    if args.check_metrics:
        text = asyncio.run(fetch_metrics(args.host, args.port))

        def has_series(name, *labels):
            # label-order and extra-label tolerant
            for line in text.splitlines():
                if line.startswith(name) and all(l in line for l in labels):
                    return True
            return False

        needed = [("repro_serve_slo_attainment",
                   'priority="interactive"', 'slo="ttft"'),
                  ("repro_serve_slo_attainment",
                   'priority="batch"', 'slo="e2e"'),
                  ("repro_serve_requests_done_total",)]
        for series in needed:
            if not has_series(*series):
                raise SystemExit(f"/metrics missing series: {series}")
        print("check-metrics: SLO attainment series present")

    if args.check_chaos_metrics:
        text = asyncio.run(fetch_metrics(args.host, args.port))

        def series_total(name):
            return sum(float(line.rsplit(" ", 1)[1])
                       for line in text.splitlines()
                       if line.startswith(name))

        injected = series_total("repro_serve_faults_injected_total")
        quarantines = series_total("repro_serve_quarantines_total")
        if injected <= 0:
            raise SystemExit("chaos run but repro_serve_faults_injected_"
                             f"total == {injected}")
        if quarantines <= 0:
            raise SystemExit("chaos run but repro_serve_quarantines_total "
                             f"== {quarantines}")
        if "repro_serve_degradation_stage" not in text:
            raise SystemExit("/metrics missing repro_serve_degradation_stage")
        print(f"check-chaos-metrics: faults_injected={injected:.0f} "
              f"quarantines={quarantines:.0f}, degradation gauge present")

    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
