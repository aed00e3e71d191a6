"""repro_torch.serve — the continuous-batching engine of the port.

A fixed decode batch of ``n_slots`` rows, over slot-dense caches
(bucket-padded admission, one prefill a request) or a global KV page pool
with block tables, ref-counted prefix reuse and chunked prefill;
priority-class admission (interactive ahead of batch, FCFS within a class,
preemption by page eviction); per-request sampling and stop conditions;
speculative decoding with a draft model (paged). ``resilience`` is the
fault-tolerance layer (a seeded ``FaultInjector``, the per-slot watchdog's
quarantine and retry, the ``DegradationLadder``, deadlines), passed as
``Engine(..., resilience=...)``; ``server.GenerateServer`` puts an HTTP/SSE
frontend in front of the engine.
"""

from .cache import (NULL_PAGE, PagedCache, PagePool, PrefixTrie, SlotCache,
                    publish_prefix_shared, share_trie)
from .engine import Engine
from .metrics import (RequestMetrics, ServeMetrics, merge_request_metrics,
                      render_prometheus)
from .resilience import (STAGE_NAMES, DegradationLadder, FaultInjector,
                         FaultSpec, InjectedFault, Resilience, parse_schedule,
                         storm_schedule)
from .sampling import SamplingParams, sample, spec_accept
from .scheduler import (PRIORITIES, Request, RequestState, Scheduler,
                        make_buckets)
from .server import GenerateServer

__all__ = [
    "Engine", "SlotCache", "PagedCache", "PagePool", "PrefixTrie", "NULL_PAGE",
    "share_trie", "publish_prefix_shared",
    "ServeMetrics", "RequestMetrics", "GenerateServer", "render_prometheus",
    "merge_request_metrics",
    "SamplingParams", "sample", "spec_accept", "Request", "RequestState",
    "Scheduler", "make_buckets", "PRIORITIES",
    "FaultInjector", "FaultSpec", "InjectedFault", "DegradationLadder",
    "Resilience", "parse_schedule", "storm_schedule", "STAGE_NAMES",
]
