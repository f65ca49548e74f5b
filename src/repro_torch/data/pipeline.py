"""Log-backed training data pipeline.

Documents (token sequences) are ingested into an AgileLog topic; training jobs
consume fixed-shape ``(batch, seq_len)`` batches. Because the log is totally
ordered and append-only, the pair ``(log position, intra-record offset)`` is an
exact resume cursor: checkpoint it and a restarted (or re-sharded, for elastic
scaling) job reproduces the identical batch sequence.

Host sharding: host ``h`` of ``H`` reads records ``pos % H == h`` — disjoint,
deterministic, no coordination. Data-quality / synthetic-data agents operate on
cForks of the same topic and `promote` validated mixtures (DESIGN.md §2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..streams.topics import Topic


class TokenStreamWriter:
    """Ingests token documents into the log (one record per document)."""

    def __init__(self, topic: Topic, batch_docs: int = 64) -> None:
        self.topic = topic
        self.batch_docs = batch_docs
        self._buf: List[bytes] = []

    def write_doc(self, tokens: np.ndarray) -> None:
        self._buf.append(np.asarray(tokens, dtype=np.int32).tobytes())
        if len(self._buf) >= self.batch_docs:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self.topic.log.append_batch(self._buf)
            self._buf.clear()


@dataclass
class PipelineCursor:
    position: int = 0        # next log position to read
    carry_tokens: int = 0    # tokens already consumed from the carry buffer


class LogDataPipeline:
    """Packs documents from the log into fixed (batch, seq_len+1) token blocks
    (inputs = [:, :-1], labels = [:, 1:]). Deterministic and exactly resumable
    via `cursor()` / `restore()`."""

    def __init__(self, topic: Topic, batch_size: int, seq_len: int,
                 host_id: int = 0, num_hosts: int = 1,
                 bos_token: int = 1) -> None:
        assert 0 <= host_id < num_hosts
        self.topic = topic
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.bos = bos_token
        self._cursor = PipelineCursor()
        self._carry = np.zeros((0,), dtype=np.int32)

    # -- resume support ------------------------------------------------------------
    def cursor(self) -> Tuple[int, int]:
        return (self._cursor.position, self._cursor.carry_tokens)

    def restore(self, cursor: Tuple[int, int]) -> None:
        """Re-derive state deterministically: re-read the record the carry came
        from (the previous host-owned record) and drop the consumed prefix."""
        pos, carry_consumed = cursor
        self._cursor = PipelineCursor(pos, carry_consumed)
        self._carry = np.zeros((0,), dtype=np.int32)
        if carry_consumed > 0:
            prev = self._prev_owned(pos)
            if prev is not None:
                doc = self._with_bos(self.topic.log.read(prev, prev + 1)[0])
                self._carry = doc[carry_consumed:]

    def _prev_owned(self, pos: int) -> Optional[int]:
        p = pos - 1
        while p >= 0:
            if p % self.num_hosts == self.host_id:
                return p
            p -= 1
        return None

    def _with_bos(self, raw: bytes) -> np.ndarray:
        return np.concatenate([np.array([self.bos], np.int32),
                               np.frombuffer(raw, dtype=np.int32)])

    # -- batch iterator ---------------------------------------------------------------
    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        need = self.batch_size * (self.seq_len + 1)
        parts: List[np.ndarray] = []
        have = 0
        if len(self._carry):
            parts.append(self._carry)
            have += len(self._carry)
        pos = self._cursor.position
        consumed = self._cursor.carry_tokens   # consumed prefix of prev owned record
        tail = self.topic.log.visible_tail
        last_len = None
        while have < need:
            while pos < tail and pos % self.num_hosts != self.host_id:
                pos += 1
            if pos >= tail:
                raise StopIteration  # live stream exhausted; caller retries later
            doc = self._with_bos(self.topic.log.read(pos, pos + 1)[0])
            parts.append(doc)
            have += len(doc)
            last_len = len(doc)
            pos += 1
        flat = np.concatenate(parts)
        block = flat[:need].reshape(self.batch_size, self.seq_len + 1)
        leftover = flat[need:]
        if last_len is None:
            consumed += need                      # batch served purely from carry
        elif len(leftover):
            consumed = last_len - len(leftover)   # carry = suffix of last record
        else:
            consumed = 0                          # no carry at all
        self._carry = leftover
        self._cursor = PipelineCursor(pos, consumed if len(leftover) else 0)
        return block


def synthetic_token_docs(n_docs: int, vocab: int, min_len: int = 32,
                         max_len: int = 512, seed: int = 0,
                         structured: bool = True) -> List[np.ndarray]:
    """Synthetic documents. `structured` makes them a noisy linear-congruential
    walk (a learnable bigram process), so e2e training shows a real loss curve
    instead of flat ln(vocab)."""
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(min_len, max_len + 1))
        if not structured:
            docs.append(rng.integers(2, vocab, size=n, dtype=np.int32))
            continue
        a = int(rng.choice([1, 3, 5, 7]))
        b = int(rng.integers(1, 97))
        t = int(rng.integers(2, vocab))
        out = np.empty(n, np.int32)
        for i in range(n):
            out[i] = t
            noise = int(rng.integers(0, 3)) if rng.random() < 0.1 else 0
            t = (a * t + b + noise) % (vocab - 2) + 2
        docs.append(out)
    return docs
