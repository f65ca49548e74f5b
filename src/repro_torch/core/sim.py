"""Deterministic discrete-event simulation of contended resources.

The paper's isolation experiments (Figs 6-8, 12-14) measure queueing delay when
agentic load shares (or does not share) broker/disk resources with a
latency-critical workload. This container has one CPU core, so wall-clock
contention cannot be reproduced honestly; instead we model each broker (and the
Kafka-like baseline's shared broker+disk) as an M/D/c-style service queue under
a simulated clock. Metadata-layer costs (the paper's novel part) are measured
as *real* CPU time elsewhere; only data-plane contention is modeled here, and
EXPERIMENTS.md labels the two sources explicitly.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


class SimClock:
    def __init__(self) -> None:
        self.now = 0.0


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    fn: Callable[[], None] = field(compare=False)


class Simulator:
    """Minimal event loop."""

    def __init__(self) -> None:
        self.clock = SimClock()
        self._queue: List[_Event] = []
        self._seq = 0

    def at(self, time: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._queue, _Event(time, self._seq, fn))
        self._seq += 1

    def after(self, delay: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.now + delay, fn)

    def run(self, until: Optional[float] = None) -> None:
        while self._queue:
            if until is not None and self._queue[0].time > until:
                break
            ev = heapq.heappop(self._queue)
            self.clock.now = ev.time
            ev.fn()
        if until is not None:
            self.clock.now = max(self.clock.now, until)


class Resource:
    """A FIFO server with `servers` parallel units and deterministic service times.

    `submit(arrival, service_time)` returns the completion time; latency is
    completion - arrival. This is what models a broker NIC/CPU or a disk: when
    an analytics agent floods the same Resource the lc-workload queues behind
    it; on a separate Resource it does not.
    """

    def __init__(self, servers: int = 1) -> None:
        self.servers = servers
        self._free_at: List[float] = [0.0] * servers  # heap of next-free times
        heapq.heapify(self._free_at)
        self.busy_time = 0.0
        self.jobs = 0

    def submit(self, arrival: float, service_time: float) -> float:
        start = max(arrival, heapq.heappop(self._free_at))
        done = start + service_time
        heapq.heappush(self._free_at, done)
        self.busy_time += service_time
        self.jobs += 1
        return done

    def utilization(self, window: float) -> float:
        """Fraction of server-time busy over a `window` of simulated seconds."""
        if window <= 0:
            return float("nan")
        return self.busy_time / (window * self.servers)


@dataclass
class SpecStats:
    """Speculation-session counters (DESIGN.md §12), one instance per
    BoltSystem. The session layer bumps these as it runs; ``OpTally.capture``
    snapshots them alongside the data-/metadata-plane counters so benchmarks
    can report commit/conflict/rebase rates and replay amortization (a rebase
    replays its suffix as metadata-only re-appends — zero object PUTs)."""

    sessions: int = 0          # Speculation handles opened
    commits: int = 0           # successful commit() calls
    aborts: int = 0            # abort() calls (explicit, implicit, or failed)
    conflicts: int = 0         # promote_if conflicts (incl. lost promote races)
    rebases: int = 0           # auto-rebases performed
    replayed_records: int = 0  # suffix records re-sequenced by rebases


@dataclass
class ServeStats:
    """Serving-on-the-log counters (DESIGN.md §17), one per BoltSystem.
    The serve engine and speculative-decode driver bump these; benchmarks
    read accepted-token throughput and rollout economics out of the same
    ``OpTally.capture`` snapshot that reports PUT/proposal amortization —
    the point being that tokens/s and commits/s are the SAME budget when
    responses ride the log."""

    requests: int = 0          # request records consumed from a request log
    responses: int = 0         # response streams completed (EOS committed)
    model_steps: int = 0       # target-model invocations (prefill/decode/verify)
    draft_steps: int = 0       # draft-model invocations (speculative only)
    tokens_out: int = 0        # tokens durably committed to response streams
    tokens_drafted: int = 0    # draft tokens proposed by rollout sessions
    tokens_accepted: int = 0   # draft tokens verification accepted
    tokens_rejected: int = 0   # draft tokens squashed with their rollout
    rollouts: int = 0          # speculate() rollout sessions opened
    rollouts_rejected: int = 0 # rollouts aborted wholesale (no trace, §12)
    reanchors: int = 0         # rollout commits re-anchored past a moved tail

    @property
    def acceptance(self) -> float:
        """Fraction of drafted tokens the target model accepted."""
        return self.tokens_accepted / max(1, self.tokens_drafted)


def _fault_count(system, key: str) -> int:
    """Read one fault-plane counter off a system (0 without a plane)."""
    plane = getattr(system, "faults", None)
    if plane is None:
        return 0
    return plane.counters.get(key, 0)


@dataclass
class OpTally:
    """Cross-plane operation counters for amortization accounting (DESIGN.md §9).

    Group commit's whole point is fewer metadata proposals and object PUTs
    *per appended record*; this tally snapshots both planes around a workload
    so benchmarks report the ratio directly. The §12 session fields measure
    the speculative-commit path the same way: ``replays`` counts zero-copy
    re-appends (metadata-only — if rebases show up in ``puts`` instead,
    replay stopped being zero-copy)."""

    records: int = 0
    proposals: int = 0
    puts: int = 0
    bytes_put: int = 0
    gets: int = 0        # store GETs (ranged; post-cache, DESIGN.md §10)
    bytes_get: int = 0   # bytes actually fetched from the store
    meta_cached: int = 0  # metadata resolutions served by a flattened view (§11)
    meta_slow: int = 0    # resolutions through the exact chain resolver
    deletes: int = 0          # store object deletes (GC reaper, §13)
    bytes_reclaimed: int = 0  # bytes those deletes freed in shared storage
    replays: int = 0      # zero-copy re-appends (rebase replay, §12)
    spec_conflicts: int = 0   # speculative commit conflicts (§12)
    spec_rebases: int = 0     # auto-rebases (§12)
    spec_replayed: int = 0    # suffix records re-sequenced by rebases (§12)
    cold_gets: int = 0        # GETs served by the cold store class (§14)
    bytes_get_cold: int = 0   # logical bytes those cold GETs returned (§14)
    cold_demotions: int = 0   # hot->cold tier moves (§14)
    bytes_demoted: int = 0    # compressed bytes demotions stored cold (§14)
    retries: int = 0          # client retry attempts after Unavailable (§15)
    faults_injected: int = 0  # fault-plane draws that fired (§15)
    dedup_hits: int = 0       # idempotent re-proposals deduplicated (§15)
    failovers: int = 0        # broker failovers + leader elections (§15)
    msgs_dropped: int = 0     # consensus messages the network lost (§16)
    msgs_delayed: int = 0     # consensus messages held for later delivery (§16)
    msgs_duplicated: int = 0  # consensus messages delivered twice (§16)
    fenced_rejections: int = 0  # stale-term appends/reads fenced (§16)
    serve_steps: int = 0        # target-model invocations (§17)
    serve_draft_steps: int = 0  # draft-model invocations (§17)
    serve_tokens_out: int = 0   # tokens committed to response streams (§17)
    serve_tokens_accepted: int = 0  # draft tokens verification accepted (§17)
    serve_tokens_rejected: int = 0  # draft tokens squashed, no trace (§17)
    serve_reanchors: int = 0    # rollout commits re-anchored over a moved tail
    lease_reads: int = 0        # reads served by the lease fast path (§18)
    lease_fallbacks: int = 0    # lease reads that fell back to the barrier (§18)

    @classmethod
    def capture(cls, system, records: int = 0) -> "OpTally":
        """Snapshot a BoltSystem's counters (records is caller-supplied).
        Store backends without counters (e.g. FileObjectStore) report 0."""
        view_stats = system.metadata.state.stats
        spec = getattr(system, "spec_stats", None) or SpecStats()
        serve = getattr(system, "serve_stats", None) or ServeStats()
        return cls(records=records,
                   proposals=system.metadata.proposals,
                   puts=getattr(system.store, "put_count", 0),
                   bytes_put=getattr(system.store, "bytes_written", 0),
                   gets=getattr(system.store, "get_count", 0),
                   bytes_get=getattr(system.store, "bytes_read", 0),
                   meta_cached=view_stats.cached_reads,
                   meta_slow=view_stats.slow_reads,
                   deletes=getattr(system.store, "delete_count", 0),
                   bytes_reclaimed=getattr(system.store, "bytes_deleted", 0),
                   replays=sum(getattr(b, "replays", 0)
                               for b in getattr(system, "brokers", [])),
                   spec_conflicts=spec.conflicts,
                   spec_rebases=spec.rebases,
                   spec_replayed=spec.replayed_records,
                   cold_gets=getattr(system.store, "cold_gets", 0),
                   bytes_get_cold=getattr(system.store, "cold_bytes_read", 0),
                   cold_demotions=getattr(system.store, "cold_puts", 0),
                   bytes_demoted=getattr(system.store, "cold_bytes_written", 0),
                   retries=getattr(getattr(system, "retry_stats", None),
                                   "retries", 0),
                   faults_injected=getattr(getattr(system, "faults", None),
                                           "total_injected", 0) or 0,
                   dedup_hits=getattr(system.metadata.state, "idem_hits", 0),
                   failovers=(getattr(system, "broker_failovers", 0)
                              + getattr(system.metadata, "elections", 0)),
                   msgs_dropped=_fault_count(system, "msgs_dropped"),
                   msgs_delayed=_fault_count(system, "msgs_delayed"),
                   msgs_duplicated=_fault_count(system, "msgs_duplicated"),
                   fenced_rejections=_fault_count(system, "fenced_rejections"),
                   serve_steps=serve.model_steps,
                   serve_draft_steps=serve.draft_steps,
                   serve_tokens_out=serve.tokens_out,
                   serve_tokens_accepted=serve.tokens_accepted,
                   serve_tokens_rejected=serve.tokens_rejected,
                   serve_reanchors=serve.reanchors,
                   lease_reads=getattr(system.metadata, "lease_reads", 0),
                   lease_fallbacks=getattr(system.metadata,
                                           "lease_fallbacks", 0))

    def delta(self, since: "OpTally") -> "OpTally":
        return OpTally(records=self.records - since.records,
                       proposals=self.proposals - since.proposals,
                       puts=self.puts - since.puts,
                       bytes_put=self.bytes_put - since.bytes_put,
                       gets=self.gets - since.gets,
                       bytes_get=self.bytes_get - since.bytes_get,
                       meta_cached=self.meta_cached - since.meta_cached,
                       meta_slow=self.meta_slow - since.meta_slow,
                       deletes=self.deletes - since.deletes,
                       bytes_reclaimed=self.bytes_reclaimed - since.bytes_reclaimed,
                       replays=self.replays - since.replays,
                       spec_conflicts=self.spec_conflicts - since.spec_conflicts,
                       spec_rebases=self.spec_rebases - since.spec_rebases,
                       spec_replayed=self.spec_replayed - since.spec_replayed,
                       cold_gets=self.cold_gets - since.cold_gets,
                       bytes_get_cold=self.bytes_get_cold - since.bytes_get_cold,
                       cold_demotions=self.cold_demotions - since.cold_demotions,
                       bytes_demoted=self.bytes_demoted - since.bytes_demoted,
                       retries=self.retries - since.retries,
                       faults_injected=self.faults_injected - since.faults_injected,
                       dedup_hits=self.dedup_hits - since.dedup_hits,
                       failovers=self.failovers - since.failovers,
                       msgs_dropped=self.msgs_dropped - since.msgs_dropped,
                       msgs_delayed=self.msgs_delayed - since.msgs_delayed,
                       msgs_duplicated=self.msgs_duplicated - since.msgs_duplicated,
                       fenced_rejections=(self.fenced_rejections
                                          - since.fenced_rejections),
                       serve_steps=self.serve_steps - since.serve_steps,
                       serve_draft_steps=(self.serve_draft_steps
                                          - since.serve_draft_steps),
                       serve_tokens_out=(self.serve_tokens_out
                                         - since.serve_tokens_out),
                       serve_tokens_accepted=(self.serve_tokens_accepted
                                              - since.serve_tokens_accepted),
                       serve_tokens_rejected=(self.serve_tokens_rejected
                                              - since.serve_tokens_rejected),
                       serve_reanchors=self.serve_reanchors - since.serve_reanchors,
                       lease_reads=self.lease_reads - since.lease_reads,
                       lease_fallbacks=(self.lease_fallbacks
                                        - since.lease_fallbacks))

    @property
    def proposals_per_record(self) -> float:
        return self.proposals / max(1, self.records)

    @property
    def puts_per_record(self) -> float:
        return self.puts / max(1, self.records)


@dataclass
class ServiceTimes:
    """Per-operation service-time model (seconds). Defaults are loosely sized
    from the paper's CloudLab x1170 numbers (4KB records, ~ms-scale e2e)."""

    broker_cpu_per_req: float = 8e-6       # request handling on a broker
    broker_cpu_per_kb: float = 0.4e-6      # payload touch cost
    store_put_base: float = 1.5e-3         # S3-like object PUT
    store_put_per_kb: float = 2e-6
    store_get_base: float = 0.6e-3         # S3-like ranged GET (charged PER GET:
    store_get_per_kb: float = 1e-6         # Broker._book books each coalesced
                                           # ranged GET, not whole-object fills)
    store_delete_base: float = 0.5e-3      # S3-like object DELETE (GC reaper,
                                           # §13; size-independent like real
                                           # object stores)
    disk_read_per_kb: float = 3e-6         # Kafka-like local disk
    disk_seek: float = 80e-6
    metadata_op: float = 12e-6             # sequencing round at metadata layer
    metadata_op_cached: float = 4e-6       # lookup served by a flattened view
                                           # (§11: bisect + slice, no chain walk)
    metadata_op_lease: float = 1.5e-6      # lease-fenced local read (§18): no
                                           # consensus round, no barrier — a
                                           # clock check + local state apply
    net_rtt: float = 60e-6
    cold_get_base: float = 5e-3            # archive-class ranged GET (§14):
    cold_get_per_kb: float = 8e-6          # slower first byte + decompression
    cold_put_base: float = 3e-3            # demotion PUT into the cold class
    cold_put_per_kb: float = 4e-6
    serve_dispatch: float = 25e-6          # host-side model-step dispatch (§17:
                                           # kernel launch + batch marshaling,
                                           # charged per model invocation on
                                           # top of the roofline step time)


def percentile(sorted_vals: List[float], p: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1, max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def summarize(latencies: List[float]) -> Tuple[float, float, float]:
    """mean, p50, p99 (seconds)."""
    if not latencies:
        return (float("nan"),) * 3
    s = sorted(latencies)
    return (sum(s) / len(s), percentile(s, 50), percentile(s, 99))
