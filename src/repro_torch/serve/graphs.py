"""CUDA graphs of the engine's serving steps (the port of the reference
engine's compiled programs: XLA compiles one program per (program, width
rung); the port captures one CUDA graph each and replays it).

A :class:`StepGraph` is one captured program: a function of no arguments
that reads only static input buffers the engine owns (pending tokens,
block tables, the live mask, accepted depths, the chunk's tokens and
scalars) and updates the page pools in place. It holds

* the program's static outputs (its logits, or None), rewritten in place
  by every replay;
* its own memory pool (``torch.cuda.graph`` without ``pool``), so no
  program's output or scratch is shared with another's: the draft's
  logits survive a verify replay;
* the launch tally its capture added to the counters behind
  :func:`repro_torch.kernels.ops.launch_counts` and the kernels' route
  tallies. Those count Python calls, which a replay does not make, so
  every replay adds the tally again: the counts read the same under replay
  as under eager calls.

Capture follows PyTorch's recipe: eager runs on a side stream first (lazy
initialisation, each gather index's device copy, every kernel's first
launch with its shared-memory attributes), then ``torch.cuda.graph``. The
warm-up runs and the capture add nothing to the counts. A capture or
replay that fails raises :class:`GraphError` naming the program and the
rung; nothing falls back to an eager call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from repro_torch.kernels import ops

WARMUP_RUNS = 2         # eager runs on the side stream before a capture

_side_streams: Dict[int, Any] = {}


class GraphError(RuntimeError):
    """A program could not be captured or replayed."""


def _snapshot() -> List[Dict[str, int]]:
    return [dict(d) for d in ops.counters()]


def _restore(snap: List[Dict[str, int]]) -> None:
    for d, s in zip(ops.counters(), snap):
        for k in d:
            d[k] = s[k]


def _warm(fn: Callable[[], Any], device: torch.device, runs: int) -> None:
    """``runs`` eager calls of ``fn`` on a side stream of ``device``,
    joined back to the current stream."""
    side = _side_streams.get(device.index)
    if side is None:
        side = _side_streams[device.index] = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        for _ in range(runs):
            fn()
    cur.wait_stream(side)


def _record(fn: Callable[[], Any], device: torch.device):
    """``(graph, outputs)``: ``fn`` captured into a new CUDA graph with a
    memory pool of its own."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        out = fn()
    return graph, out


class StepGraph:
    """One program captured at one rung: ``replay()`` runs it and returns
    its static outputs. ``fn`` is dropped after the capture (a replay never
    calls it), so the graph holds no reference to its engine."""

    def __init__(self, name: str, rung: int, fn: Callable[[], Any],
                 device: torch.device):
        self.name, self.rung = name, rung
        before = _snapshot()
        try:
            _warm(fn, device, WARMUP_RUNS)
            mid = _snapshot()
            self._graph, self.output = _record(fn, device)
            after = _snapshot()
        except Exception as e:
            raise GraphError(f"capture of {name} at width {rung} failed: "
                             f"{e}") from e
        finally:
            _restore(before)
        self.tally = [{k: a[k] - m[k] for k in a if a[k] != m[k]}
                      for a, m in zip(after, mid)]

    def replay(self):
        """Run the captured program once; returns its static outputs."""
        try:
            self._graph.replay()
        except Exception as e:
            raise GraphError(f"replay of {self.name} at width {self.rung} "
                             f"failed: {e}") from e
        for d, t in zip(ops.counters(), self.tally):
            for k, n in t.items():
                d[k] += n
        return self.output
