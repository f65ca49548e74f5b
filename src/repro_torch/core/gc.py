"""Lineage-aware segment garbage collection (DESIGN.md §13).

Bolt's cheap forks share immutable segment objects, so nothing at append or
fork time ever owns an object — and nothing ever deleted one. Agentic churn
(speculate → conflict → squash → re-fork, §12) therefore stranded dead
segments in shared storage forever. The subsystem splits reclamation into the
two planes the rest of Bolt already uses:

* **Metadata (consensus) decides.** :class:`~repro.core.metadata.MetadataState`
  maintains per-object *manifests* — a refcount over every index entry in
  every log, frozen stand-ins included. Dead-lineage events (squash, promote,
  frozen-chain GC) decrement them in consensus order; the ``gc`` SMR command
  pops zero-reference candidates into the replicated ``reclaimed`` set. Every
  replica — including a follower restored from a snapshot — converges on the
  identical reclaimed set.

* **A broker-side reaper executes.** :class:`GarbageCollector` proposes ``gc``
  quanta, applies the returned deletes to the shared :class:`ObjectStore`,
  invalidates the affected pages in every broker's
  :class:`~repro.core.objectstore.LRUObjectCache`, and books DES time on its
  own broker (``book_reclaim``) so isolation benchmarks can show reclamation
  does not perturb the latency-critical path.

The **pin registry** closes the one liveness gap refcounts cannot see: a
session rebase (§12) squashes its stale fork — dropping the suffix segments'
refcounts, possibly to zero — *before* replaying them into the fresh fork.
The receipts' durable segment references live outside any index during that
window, so the session pins the object ids; pins ride INTO the ``gc``
proposal as command arguments (hence deterministic across replicas) and
pinned candidates are requeued, not reclaimed.

Crash safety: metadata commits the reclaimed set first, then the reaper
deletes. A reaper that dies mid-reap leaves already-reclaimed objects in the
store; ``resync()`` replays ``reclaimed ∩ store`` (deletes are idempotent),
so a restarted broker converges the store to the consensus decision.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional


@dataclass
class GCConfig:
    """Reaper policy (DESIGN.md §13).

    ``batch`` bounds the objects reclaimed per quantum (one ``gc`` proposal);
    ``auto`` runs a quantum on churn hand-off points — session abort,
    ``AgileLog.close()``, explicit squash/promote — so reclamation keeps pace
    with speculation without a caller ever draining manually. ``broker``
    selects which broker books the reap time (default: the last one, which
    placement never assigns a root log to)."""

    batch: int = 64
    auto: bool = False
    broker: Optional[int] = None


@dataclass
class GCStats:
    """Reclamation counters + a point-in-time backlog snapshot."""

    runs: int = 0                # explicit collect() drains
    quanta: int = 0              # gc proposals issued
    objects_reclaimed: int = 0
    bytes_reclaimed: int = 0
    pages_invalidated: int = 0   # broker cache pages dropped by reaps
    resyncs: int = 0             # crash-recovery store replays
    pending: int = 0             # zero-ref candidates awaiting a quantum (snapshot)
    tracked: int = 0             # objects with live references (snapshot)
    pinned: int = 0              # object ids pinned by in-flight rebases (snapshot)


class GarbageCollector:
    """The broker-side reaper: proposes ``gc`` quanta, applies the deletes."""

    def __init__(self, system, config: Optional[GCConfig] = None) -> None:
        self.system = system
        self.config = config or GCConfig()
        self._pins: Dict[str, int] = {}   # object id -> pin count
        self._orphans: set = set()        # crashed-broker PUT carcasses (§15)
        self._stats = GCStats()

    # -- pins (session rebase protection, §12/§13) --------------------------
    def pin(self, object_ids: Iterable[str]) -> None:
        for obj in object_ids:
            self._pins[obj] = self._pins.get(obj, 0) + 1

    def unpin(self, object_ids: Iterable[str]) -> None:
        for obj in object_ids:
            left = self._pins.get(obj, 0) - 1
            if left <= 0:
                self._pins.pop(obj, None)
            else:
                self._pins[obj] = left

    # -- reclamation --------------------------------------------------------
    def _reaper_broker(self):
        brokers = self.system.brokers
        i = self.config.broker
        return brokers[i if i is not None else len(brokers) - 1]

    def _reap(self, dead: List[str], arrival: Optional[float]) -> int:
        """Apply consensus-decided deletes to the store + broker caches."""
        store = self.system.store
        freed = 0
        pages = 0
        for obj in dead:
            size = store.size(obj)
            freed += size or 0
            store.delete(obj)
            for b in self.system.brokers:
                pages += b.cache.invalidate_object(obj)
        self._stats.objects_reclaimed += len(dead)
        self._stats.bytes_reclaimed += freed
        self._stats.pages_invalidated += pages
        self._reaper_broker().book_reclaim(arrival, len(dead))
        return freed

    def _propose_and_reap(self, limit: Optional[int],
                          arrival: Optional[float]) -> List[str]:
        dead = self.system.metadata.propose(
            ("gc", limit, tuple(sorted(self._pins))))
        self._stats.quanta += 1
        self._reap(dead, arrival)
        return dead

    def quantum(self, limit: Optional[int] = None,
                arrival: Optional[float] = None) -> List[str]:
        """One incremental GC step: propose a ``gc`` command reclaiming up to
        ``limit`` (default ``config.batch``) objects, then reap them. Returns
        the reclaimed object ids (possibly empty)."""
        return self._propose_and_reap(
            self.config.batch if limit is None else limit, arrival)

    def collect(self, arrival: Optional[float] = None) -> GCStats:
        """Drain: reclaim every currently-dead object in one UNBOUNDED
        quantum — ``config.batch`` only paces incremental ``quantum()``
        steps, never a drain (pinned candidates stay queued either way)."""
        self._stats.runs += 1
        self._propose_and_reap(None, arrival)
        return self.stats()

    def note_orphans(self, object_ids: Iterable[str]) -> None:
        """Record PUT carcasses from a crashed broker (DESIGN.md §15): keys
        written (possibly torn) to the store whose metadata proposal never
        committed. ``resync`` deletes the ones consensus never registered."""
        self._orphans.update(object_ids)

    def resync(self, arrival: Optional[float] = None) -> List[str]:
        """Crash recovery for a reaper that died between the ``gc`` commit
        and the store deletes: re-apply the replicated reclaimed set to the
        store (idempotent), and sweep crashed-broker orphan PUTs (§15) —
        noted keys that consensus never registered (not in ``object_refs``,
        not already reclaimed) are garbage by definition: no index entry can
        ever reference them. Run this when a broker restarts."""
        state = self.system.metadata.state
        stale = [obj for obj in sorted(state.reclaimed)
                 if self.system.store.exists(obj)]
        for b in self.system.brokers:   # live brokers note torn PUTs too
            self._orphans.update(b.take_orphans())
        swept = [obj for obj in sorted(self._orphans)
                 if obj not in state.object_refs
                 and obj not in state.reclaimed
                 and self.system.store.exists(obj)]
        self._orphans.clear()
        self._stats.resyncs += 1
        self._reap(stale + swept, arrival)
        return stale + swept

    def stats(self) -> GCStats:
        s = self._stats
        state = self.system.metadata.state
        return GCStats(runs=s.runs, quanta=s.quanta,
                       objects_reclaimed=s.objects_reclaimed,
                       bytes_reclaimed=s.bytes_reclaimed,
                       pages_invalidated=s.pages_invalidated,
                       resyncs=s.resyncs,
                       pending=state.gc_pending(),
                       tracked=state.gc_tracked(),
                       pinned=len(self._pins))
