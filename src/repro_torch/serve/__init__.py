"""repro_torch.serve — the continuous-batching engine of the port.

A fixed decode batch of ``n_slots`` rows, over slot-dense caches
(bucket-padded admission, one prefill a request) or a global KV page pool
with block tables, ref-counted prefix reuse and chunked prefill; FCFS
admission gated by free slots (and page-pool pressure); per-request
sampling and stop conditions; speculative decoding with a draft model
(paged).
"""

from .cache import (NULL_PAGE, PagedCache, PagePool, PrefixTrie, SlotCache,
                    publish_prefix_shared, share_trie)
from .engine import Engine
from .metrics import RequestMetrics, ServeMetrics
from .sampling import SamplingParams, sample
from .scheduler import Request, RequestState, Scheduler

__all__ = [
    "Engine", "SlotCache", "PagedCache", "PagePool", "PrefixTrie", "NULL_PAGE",
    "ServeMetrics", "RequestMetrics", "SamplingParams", "sample", "Request",
    "RequestState", "Scheduler", "share_trie", "publish_prefix_shared",
]
