"""Topics, producers, consumer groups, schemas, and stream processors.

A Topic wraps one AgileLog. Consumers are built on the session layer's
tailing subscriptions (DESIGN.md §12) — the log's Subscription owns the
cursor; `commit` persists it through the object store so restarts resume
exactly. A StreamProcessor is the classic stateful consumer: tumbling-window
aggregation, which the stream-processor-testing agent (§6.8) exercises on
cForks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ..core.api import AgileLog, AppendReceipt, BoltSystem, Speculation
from .records import decode_record, encode_record


class SchemaError(Exception):
    pass


@dataclass
class Schema:
    """Field name -> python type. `strict` rejects unknown fields."""
    fields: Dict[str, type]
    required: Tuple[str, ...] = ()
    strict: bool = False

    def validate(self, rec: Dict[str, Any]) -> None:
        for f in self.required:
            if f not in rec:
                raise SchemaError(f"missing required field {f!r}")
        for k, v in rec.items():
            if k in self.fields:
                if not isinstance(v, self.fields[k]):
                    raise SchemaError(
                        f"field {k!r}: expected {self.fields[k].__name__}, "
                        f"got {type(v).__name__}")
            elif self.strict:
                raise SchemaError(f"unknown field {k!r}")


class SchemaRegistry:
    def __init__(self) -> None:
        self._schemas: Dict[str, Schema] = {}

    def register(self, topic: str, schema: Schema) -> None:
        self._schemas[topic] = schema

    def get(self, topic: str) -> Optional[Schema]:
        return self._schemas.get(topic)


class Topic:
    """A named stream backed by one AgileLog (root or fork)."""

    def __init__(self, name: str, log: AgileLog,
                 registry: Optional[SchemaRegistry] = None) -> None:
        self.name = name
        self.log = log
        self.registry = registry

    @classmethod
    def create(cls, system: BoltSystem, name: str,
               registry: Optional[SchemaRegistry] = None) -> "Topic":
        return cls(name, system.create_log(name), registry)

    # forks of a topic are topics over forks of the log
    def cfork(self, promotable: bool = False, dedicated: bool = False) -> "Topic":
        return Topic(f"{self.name}/cfork", self.log.cfork(promotable, dedicated),
                     self.registry)

    def sfork(self, past: Optional[int] = None, dedicated: bool = False) -> "Topic":
        return Topic(f"{self.name}/sfork", self.log.sfork(past, dedicated),
                     self.registry)

    def speculate(self, **kwargs) -> Speculation:
        """Open a speculative fork transaction on this topic's log
        (DESIGN.md §12); wrap ``spec.log`` in a Topic to run consumers on it."""
        return self.log.speculate(**kwargs)

    @property
    def tail(self) -> int:
        return self.log.tail


class Producer:
    """Validating (optionally) record producer with client-side batching."""

    def __init__(self, topic: Topic, validate: bool = False,
                 linger_records: int = 1) -> None:
        self.topic = topic
        self.validate = validate
        self.linger = max(1, linger_records)
        self._buf: List[bytes] = []
        self.produced = 0

    def produce(self, rec: Dict[str, Any]) -> Optional[AppendReceipt]:
        """Buffer one record; returns the batch's AppendReceipt when this
        record triggered a flush, else None."""
        if self.validate and self.topic.registry:
            schema = self.topic.registry.get(self.topic.name.split("/")[0])
            if schema:
                schema.validate(rec)
        self._buf.append(encode_record(rec))
        self.produced += 1
        if len(self._buf) >= self.linger:
            return self.flush()
        return None

    def flush(self) -> Optional[AppendReceipt]:
        if not self._buf:
            return None
        receipt = self.topic.log.append_batch(self._buf)
        self._buf.clear()
        return receipt


class Consumer:
    """Offset-tracking consumer, built on a tailing Subscription
    (DESIGN.md §12): the subscription owns the cursor, `poll` is one
    cooperative non-blocking step, `stream` iterates decoded batches
    push-style, and `commit` persists the cursor so a restarted consumer
    resumes exactly (the log position IS the resume cursor)."""

    def __init__(self, topic: Topic, group: str = "default",
                 start: int = 0) -> None:
        self.topic = topic
        self.group = group
        self._sub = topic.log.subscribe(from_pos=start, batch=256)
        self.committed = start

    @property
    def offset(self) -> int:
        return self._sub.position

    def poll(self, max_records: int = 256) -> List[Dict[str, Any]]:
        return [decode_record(b) for b in self._sub.poll(max_records)]

    def stream(self, follow: bool = False, max_idle: Optional[int] = None
               ) -> Iterator[List[Dict[str, Any]]]:
        """Iterate decoded batches: drain to the visible tail
        (``follow=False``) or keep tailing with backoff (``follow=True``)."""
        self._sub.follow = follow
        self._sub.max_idle = max_idle
        for batch in self._sub:
            yield [decode_record(b) for b in batch]

    def commit(self) -> None:
        key = f"__offsets/{self.topic.log.log_id}/{self.group}"
        self.topic.log.system.store.put(key, str(self.offset).encode())
        self.committed = self.offset

    @classmethod
    def restore(cls, topic: Topic, group: str = "default") -> "Consumer":
        key = f"__offsets/{topic.log.log_id}/{group}"
        start = 0
        if topic.log.system.store.exists(key):
            start = int(topic.log.system.store.get(key))
        return cls(topic, group, start=start)


@dataclass
class WindowResult:
    window_start: float
    count: int
    aggregate: float


class StreamProcessor:
    """Tumbling-window aggregator (§6.8's processor-under-test).

    Consumes records with (`ts`, `value`) fields, aggregates per window of
    `window_ms`, and appends results to an output topic. Deliberately strict:
    malformed records raise (that is what the Kafka-mode supply-chain
    experiment demonstrates), unless `guard=True`.
    """

    def __init__(self, input_topic: Topic, output_topic: Optional[Topic] = None,
                 window_ms: float = 5.0, agg: Callable[[List[float]], float] = sum,
                 guard: bool = False) -> None:
        self.consumer = Consumer(input_topic, group="proc")
        self.output = Producer(output_topic) if output_topic else None
        self.window_ms = window_ms
        self.agg = agg
        self.guard = guard
        self.windows: Dict[int, List[float]] = {}
        self.results: List[WindowResult] = []
        self.errors: List[str] = []
        self.seen_keys: set = set()

    def _ingest(self, recs: List[Dict[str, Any]]) -> None:
        for rec in recs:
            try:
                ts = rec["ts"]
                value = float(rec["value"])
                if not isinstance(ts, (int, float)):
                    raise TypeError(f"bad ts type {type(ts).__name__}")
                key = rec.get("key")
                if key is not None:
                    if key in self.seen_keys:
                        continue  # dedup (exactly-once-ish semantics)
                    self.seen_keys.add(key)
                w = int(ts // self.window_ms)
                self.windows.setdefault(w, []).append(value)
            except Exception as e:
                if not self.guard:
                    raise
                self.errors.append(f"{type(e).__name__}: {e}")

    def step(self, max_records: int = 256) -> int:
        recs = self.consumer.poll(max_records)
        self._ingest(recs)
        return len(recs)

    def close_windows(self, watermark_ts: float) -> List[WindowResult]:
        """Emit windows fully below the watermark."""
        done = [w for w in self.windows if (w + 1) * self.window_ms <= watermark_ts]
        out = []
        for w in sorted(done):
            vals = self.windows.pop(w)
            res = WindowResult(w * self.window_ms, len(vals), self.agg(vals))
            self.results.append(res)
            out.append(res)
            if self.output:
                self.output.produce({"ts": res.window_start, "count": res.count,
                                     "value": res.aggregate})
        if self.output:
            self.output.flush()
        return out

    def run_to_tail(self) -> None:
        """Drain the input subscription to the visible tail, then close all
        windows (push-shaped: batches arrive from the consumer's stream)."""
        for recs in self.consumer.stream(follow=False):
            self._ingest(recs)
        self.close_windows(float("inf"))
