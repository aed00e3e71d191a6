"""Deterministic synthetic token stream (copy of ``repro.data.SyntheticLM``;
numpy only).

Tokens follow a hidden order-2 Markov chain drawn from a seeded
``vocab x vocab`` transition table, with 10 % uniform noise, so a model can
lower its loss. Batches are a stateless function of ``(seed, step, shard)``
and bit-identical to the reference's.

One difference in how the table is held, not in its values: the reference
draws it in one call as int64, which at vocab 50304 is 20.2 GB (40 GB while
``astype`` copies it). Here it is drawn in row chunks and stored in the
narrowest unsigned type that holds ``vocab - 1`` (uint16 at 50304: 5.1 GB).
numpy's bounded int64 draw for a range below 2^32 takes one 32-bit draw per
value, and the bit generator carries any buffered half-word across calls,
so the chunked draw is the same stream as the one-shot draw (a CPU test
holds the two equal).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

TABLE_ROWS_PER_DRAW = 1024


def _table_dtype(vocab: int):
    for dt in (np.uint8, np.uint16, np.uint32):
        if vocab - 1 <= np.iinfo(dt).max:
            return dt
    return np.int64


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    step: int = 0

    def __post_init__(self):
        if self.global_batch % self.shard_count:
            raise ValueError(f"global_batch {self.global_batch} is not a "
                             f"multiple of shard_count {self.shard_count}")
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 17]))
        # hidden order-2 Markov structure (shared across shards)
        v = self.vocab
        self._trans = np.empty((v, v), _table_dtype(v))
        for r in range(0, v, TABLE_ROWS_PER_DRAW):
            n = min(TABLE_ROWS_PER_DRAW, v - r)
            self._trans[r:r + n] = rng.integers(0, v, size=(n, v))
        self._noise_p = 0.1

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.shard_count

    @property
    def table_bytes(self) -> int:
        return self._trans.nbytes

    def _rows(self, step: int) -> np.ndarray:
        b = self.local_batch
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 101, step, self.shard_index]))
        toks = np.empty((b, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        toks[:, 1] = rng.integers(0, self.vocab, b)
        for t in range(2, self.seq_len + 1):
            nxt = self._trans[toks[:, t - 2], toks[:, t - 1]]
            noise = rng.random(b) < self._noise_p
            nxt = np.where(noise, rng.integers(0, self.vocab, b), nxt)
            toks[:, t] = nxt
        return toks

    def next(self) -> Dict[str, np.ndarray]:
        toks = self._rows(self.step)
        self.step += 1
        return {"inputs": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next()
