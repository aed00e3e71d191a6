"""Deterministic synthetic token stream (copy of ``repro.data.SyntheticLM``;
numpy only).

Tokens follow a hidden order-2 Markov chain drawn from a seeded
``vocab x vocab`` transition table, with 10 % uniform noise, so a model can
lower its loss. Batches are a stateless function of ``(seed, step, shard)``
and bit-identical to the reference's; ``state()`` / ``restore()`` carry
the stream across a checkpoint (a stream of another seed raises
``ValueError`` where the reference asserts).

One difference in how the table is held, not in its values: the reference
draws it in one call as int64, which at vocab 50304 is 20.2 GB (40 GB while
``astype`` copies it). Here it is drawn in row chunks and stored in the
narrowest unsigned type that holds ``vocab - 1`` (uint16 at 50304: 5.1 GB).
numpy's bounded int64 draw for a range below 2^32 takes one 32-bit draw per
value, and the bit generator carries any buffered half-word across calls,
so the chunked draw is the same stream as the one-shot draw (a CPU test
holds the two equal).

The table depends on ``(vocab, seed)`` alone, so the drawn tables are kept
(the last ``TABLES_KEPT``) and shared, read-only, by every stream with the
same pair: a serving run that makes request streams and a training stream
from one seed draws its 5 GB table once. ``TABLE_DRAWS`` records each draw
and the seconds it took.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np

TABLE_ROWS_PER_DRAW = 1024
TABLES_KEPT = 2              # drawn tables kept for reuse, newest last

_tables: "collections.OrderedDict[Tuple[int, int], np.ndarray]" = \
    collections.OrderedDict()
TABLE_DRAWS: List[Dict[str, float]] = []   # {"vocab", "seed", "seconds"}


def _table_dtype(vocab: int):
    for dt in (np.uint8, np.uint16, np.uint32):
        if vocab - 1 <= np.iinfo(dt).max:
            return dt
    return np.int64


def draw_table(vocab: int, seed: int) -> np.ndarray:
    """The ``vocab x vocab`` transition table of ``(vocab, seed)``, drawn
    afresh in row chunks (the reference's values, stored narrow)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 17]))
    table = np.empty((vocab, vocab), _table_dtype(vocab))
    for r in range(0, vocab, TABLE_ROWS_PER_DRAW):
        n = min(TABLE_ROWS_PER_DRAW, vocab - r)
        table[r:r + n] = rng.integers(0, vocab, size=(n, vocab))
    return table


def transition_table(vocab: int, seed: int) -> np.ndarray:
    """The kept table of ``(vocab, seed)``, drawn on first use (read-only,
    shared by every stream that asks for it)."""
    key = (vocab, seed)
    if key in _tables:
        _tables.move_to_end(key)
        return _tables[key]
    t0 = time.perf_counter()
    table = draw_table(vocab, seed)
    table.flags.writeable = False
    TABLE_DRAWS.append({"vocab": vocab, "seed": seed,
                        "seconds": time.perf_counter() - t0})
    _tables[key] = table
    while len(_tables) > TABLES_KEPT:
        _tables.popitem(last=False)
    return table


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
        # hidden order-2 Markov structure (shared across shards)
        self._trans = transition_table(self.vocab, self.seed)
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

    # checkpointable: batches are a function of (seed, step), so the step
    # alone resumes the stream exactly
    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def restore(self, st: Dict[str, int]) -> None:
        if st["seed"] != self.seed:
            raise ValueError("restoring a SyntheticLM stream with another "
                             f"seed: {st['seed']} != {self.seed}")
        self.step = int(st["step"])


@dataclasses.dataclass
class TeacherStudent:
    """Frozen-teacher classification batches, the MNIST stand-in of the
    paper-figure benchmarks (copy of ``repro.data.TeacherStudent``; numpy
    only, bit-identical batches).

    ``kind="clusters"`` (default): draws from ``n_classes`` well-separated
    Gaussian clusters pushed through a fixed random nonlinear lift, learnable
    to high accuracy as MNIST is. ``kind="argmax"``: the argmax of a random
    tanh MLP on Gaussian inputs. ``d_in`` is 800 (MNIST's 784 padded) so that
    c = 10 divides every FC layer of LeNet-300-100. Batch ``step`` is a
    stateless function of ``(seed, step)``; the eval set is step ``-1``.
    """

    d_in: int = 800
    n_classes: int = 10
    batch: int = 50
    seed: int = 0
    step: int = 0
    teacher_hidden: int = 64
    kind: str = "clusters"
    cluster_noise: float = 1.45

    def __post_init__(self):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 31]))
        self._w1 = rng.normal(size=(self.d_in, self.teacher_hidden)).astype(np.float32)
        self._w1 /= np.sqrt(self.d_in)
        self._w2 = rng.normal(size=(self.teacher_hidden, self.n_classes)).astype(np.float32)
        self._w2 /= np.sqrt(self.teacher_hidden)
        self._centers = rng.normal(size=(self.n_classes, 32)).astype(np.float32)
        self._lift = rng.normal(size=(32, self.d_in)).astype(np.float32) / np.sqrt(32)

    def _make(self, step: int, batch: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 57, step + 2**31]))
        if self.kind == "clusters":
            y = rng.integers(0, self.n_classes, batch).astype(np.int32)
            z = self._centers[y] + self.cluster_noise * rng.normal(
                size=(batch, 32)).astype(np.float32)
            x = np.tanh(z @ self._lift) + 0.20 * rng.normal(
                size=(batch, self.d_in)).astype(np.float32)
            return x.astype(np.float32), y
        x = rng.normal(size=(batch, self.d_in)).astype(np.float32)
        h = np.tanh(x @ self._w1)
        y = np.argmax(h @ self._w2, axis=-1).astype(np.int32)
        return x, y

    def next(self) -> Dict[str, np.ndarray]:
        x, y = self._make(self.step, self.batch)
        self.step += 1
        return {"inputs": x, "labels": y}

    def eval_set(self, n: int = 2048) -> Dict[str, np.ndarray]:
        x, y = self._make(-1, n)
        return {"inputs": x, "labels": y}

    def state(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def restore(self, st: Dict[str, int]) -> None:
        if st["seed"] != self.seed:
            raise ValueError("restoring a TeacherStudent stream with another "
                             f"seed: {st['seed']} != {self.seed}")
        self.step = int(st["step"])
