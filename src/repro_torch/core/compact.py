"""Segment compaction + cold tiering, broker side (DESIGN.md §14).

PR 5's GC reclaims whole dead objects, but group commit (§9) makes *partial*
liveness the steady state: one ``seg-*`` object packs records for several
logs, and it stays fully resident while any one log references a slice. The
post-churn amplification the benchmarks measure (~2.33x) is exactly those
dead bytes inside shared segments.

Like §13, the work splits across the two planes:

* **Metadata (consensus) decides.** The SMR's §14 manifests track per-object
  total bytes and referenced bytes; the ``compact`` command atomically swaps
  every referencing index entry (every log, frozen stand-ins included) from
  the sparsely-live sources onto a compacted object the broker already PUT —
  or mutates nothing and reports ``stale`` if liveness moved underneath the
  broker, leaving the new object as a zero-ref orphan for the §13 path.

* **A broker-side compactor executes.** :class:`Compactor` selects candidates
  below a live-byte-ratio threshold, ranged-reads ONLY the live spans, writes
  the compacted object, proposes the swap, and hands the (now zero-ref)
  sources to the §13 reaper. Crashing at any step is safe: before the PUT,
  nothing happened; after the PUT but before the swap, ``resync()`` sweeps
  the unknown ``cmp-*`` key; after the swap but before the reap, the sources
  sit in the reclaim queue and any later ``gc`` quantum (or reaper resync)
  finishes the job.

Safety interactions with in-flight work mirror the ``gc`` pin machinery: the
compactor's candidate selection EXCLUDES the reaper's pinned ids and every
open speculation session's durable receipt segments — a rebase replay
re-proposes those ``(object, offsets)`` tuples verbatim, so rewriting the
object underneath the receipt would replay against reclaimed storage.
Mid-scan readers are safe without exclusion: scans re-resolve spans per
batch, and sources stay physically present until the reaper (which *does*
honor pins) deletes them after the swap committed.

:class:`TierManager` adds the age-based cold tier on top: consensus-ordered
demotion of cold (by default compacted) objects into the compressed store
class of :class:`~repro.core.objectstore.TieredObjectStore`, and
scan-triggered promotion back. Placement routing is by physical presence, so
every crash window between the copy/drop halves of a move reads correctly;
``resync()`` converges placement to the replicated ``cold_objects`` set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .broker import _obj_counter
from .objectstore import TieredObjectStore


@dataclass
class CompactionConfig:
    """Compactor policy (DESIGN.md §14).

    An object is a candidate when ``referenced_bytes / total_bytes <=
    max_live_ratio`` (and at least ``min_bytes`` big). 0.85 bounds the
    steady-state residual amplification at ~1/0.85 = 1.18x, under the 1.2x
    CI gate. ``batch`` caps source objects per ``compact`` proposal;
    ``auto`` runs a quantum at the same churn hand-off points as GC
    (session abort, close, explicit squash/promote)."""

    max_live_ratio: float = 0.85
    min_bytes: int = 1
    batch: int = 8
    auto: bool = False
    reap: bool = True           # run a gc quantum right after a swap commits
    broker: Optional[int] = None


@dataclass
class CompactStats:
    """Compaction counters + point-in-time snapshots."""

    runs: int = 0               # explicit compact() drains
    quanta: int = 0             # compact proposals issued
    compacted_objects: int = 0  # cmp-* objects written and swapped in
    sources_retired: int = 0    # source objects whose entries were swapped out
    stale: int = 0              # proposals rejected (liveness moved)
    bytes_read: int = 0         # live bytes ranged-read from sources
    bytes_written: int = 0      # compacted payload bytes PUT
    orphans_swept: int = 0      # unknown cmp-* keys deleted by resync
    resyncs: int = 0
    candidates: int = 0         # snapshot: objects under the ratio threshold


@dataclass
class TieringConfig:
    """Tier policy (DESIGN.md §14): objects whose age (SMR command ticks
    since first sight) reaches ``min_age`` — restricted to ``prefixes``,
    by default compacted objects only — demote to the cold class, at most
    ``batch`` per quantum. A read of ``promote_scan_records`` or more
    records that touches cold objects is scan-shaped: those objects promote
    back to hot (the §10 readahead heuristic, applied to tiers)."""

    min_age: int = 64
    prefixes: Tuple[str, ...] = ("cmp-",)
    batch: int = 8
    promote_scan_records: int = 4
    auto: bool = False
    broker: Optional[int] = None


@dataclass
class TierStats:
    demotions: int = 0          # objects moved hot -> cold
    rehydrations: int = 0       # objects moved cold -> hot
    bytes_demoted: int = 0      # compressed bytes stored cold
    bytes_rehydrated: int = 0   # logical bytes restored hot
    resyncs: int = 0
    cold_objects: int = 0       # snapshot: consensus cold set size
    cold_stored_bytes: int = 0  # snapshot: compressed bytes resident cold


class Compactor:
    """The broker-side rewriter: plans, PUTs, proposes ``compact``, reaps."""

    def __init__(self, system, config: Optional[CompactionConfig] = None) -> None:
        self.system = system
        self.config = config or CompactionConfig()
        self._stats = CompactStats()

    def _broker(self):
        brokers = self.system.brokers
        i = self.config.broker
        return brokers[i if i is not None else len(brokers) - 1]

    def _excluded(self) -> Set[str]:
        """Objects the compactor must not rewrite: ids pinned by in-flight
        session rebases (§13) plus every open speculation's durable receipt
        segments — either way, ``(object, offsets)`` tuples held outside any
        index that a replay will re-propose verbatim."""
        out: Set[str] = set()
        collector = getattr(self.system, "collector", None)
        if collector is not None:
            out.update(collector._pins)
        session_segments = getattr(self.system, "_session_segments", None)
        if session_segments is not None:
            out.update(session_segments())
        return out

    def candidates(self) -> List[str]:
        cfg = self.config
        return self.system.metadata.state.compaction_candidates(
            cfg.max_live_ratio, cfg.min_bytes, exclude=self._excluded())

    def _plan(self, sources: Optional[List[str]] = None):
        """Select sources and build (new_object_id, payload, mapping) from
        ranged reads of exactly the live spans. Returns None when there is
        nothing to compact. Split from ``quantum`` so crash tests can stop
        between the PUT and the proposal."""
        if sources is None:
            sources = self.candidates()[:self.config.batch]
        if not sources:
            return None
        state = self.system.metadata.state
        live = state.object_live_spans(sources)
        store = self.system.store
        chunks: List[bytes] = []
        mapping: List[Tuple[str, Tuple]] = []
        dst = 0
        n_gets = 0
        for src in sources:
            spans = live.get(src, [])
            if not spans:
                continue   # died since selection; gc will take it whole
            ranges = []
            for off, ln in spans:
                if ln:
                    chunks.append(store.get(src, off, ln))
                    n_gets += 1
                ranges.append((off, ln, dst))
                dst += ln
            mapping.append((src, tuple(ranges)))
        if not mapping:
            return None
        new_object_id = f"cmp-{self._broker().broker_id}-{next(_obj_counter)}"
        return new_object_id, b"".join(chunks), tuple(mapping), n_gets

    def quantum(self, arrival: Optional[float] = None) -> List[str]:
        """One incremental compaction step: plan, PUT the compacted object,
        propose the swap, then (by default) run a gc quantum so the retired
        sources reach the reaper. Returns the retired source ids ([] when
        idle or when the proposal came back stale)."""
        plan = self._plan()
        if plan is None:
            return []
        new_object_id, payload, mapping, n_gets = plan
        store = self.system.store
        store.put(new_object_id, payload)
        outcome = self.system.metadata.propose(
            ("compact", new_object_id, len(payload), mapping))
        self._stats.quanta += 1
        self._stats.bytes_read += len(payload)
        self._stats.bytes_written += len(payload)
        self._broker().book_compact(arrival, read_bytes=len(payload),
                                    write_bytes=len(payload), n_gets=n_gets)
        if outcome[0] != "ok":
            # liveness moved under us: the swap did not happen and the PUT
            # is an orphan, already queued on the §13 zero-ref path
            self._stats.stale += 1
            if self.config.reap:
                self.system.collector.quantum(arrival=arrival)
            return []
        retired = list(outcome[1]["sources"])
        self._stats.compacted_objects += 1
        self._stats.sources_retired += len(retired)
        if self.config.reap:
            self.system.collector.quantum(arrival=arrival)
        return retired

    def compact(self, arrival: Optional[float] = None) -> CompactStats:
        """Drain: run quanta until no candidate remains (or the only ones
        left keep coming back stale)."""
        self._stats.runs += 1
        while self.quantum(arrival):
            pass
        return self.stats()

    def resync(self, arrival: Optional[float] = None) -> List[str]:
        """Crash recovery for a compactor that died between the PUT and the
        ``compact`` proposal: a ``cmp-*`` key the consensus manifests have
        never seen (not referenced, not reclaimed) is unreachable garbage —
        delete it. Idempotent; run when the compactor's broker restarts."""
        state = self.system.metadata.state
        store = self.system.store
        swept = [key for key in store.list("cmp-")
                 if key not in state.object_refs and key not in state.reclaimed]
        for key in swept:
            store.delete(key)
            for b in self.system.brokers:
                b.cache.invalidate_object(key)
        self._stats.orphans_swept += len(swept)
        self._stats.resyncs += 1
        if swept:
            self._broker().book_reclaim(arrival, len(swept))
        return swept

    def stats(self) -> CompactStats:
        s = self._stats
        return CompactStats(runs=s.runs, quanta=s.quanta,
                            compacted_objects=s.compacted_objects,
                            sources_retired=s.sources_retired,
                            stale=s.stale,
                            bytes_read=s.bytes_read,
                            bytes_written=s.bytes_written,
                            orphans_swept=s.orphans_swept,
                            resyncs=s.resyncs,
                            candidates=len(self.candidates()))


class TierManager:
    """Executes consensus tier decisions against a tiered store."""

    def __init__(self, system, config: Optional[TieringConfig] = None) -> None:
        self.system = system
        self.config = config or TieringConfig()
        self._stats = TierStats()

    def _broker(self):
        brokers = self.system.brokers
        i = self.config.broker
        return brokers[i if i is not None else len(brokers) - 1]

    def _store(self) -> Optional[TieredObjectStore]:
        store = self.system.store
        return store if isinstance(store, TieredObjectStore) else None

    def demote_quantum(self, arrival: Optional[float] = None) -> List[str]:
        """One demotion step. Order is crash-safe: compress a cold copy
        FIRST (hot copy still serving reads), then propose ``demote_cold``,
        then drop the hot copies of exactly the accepted ids — a crash
        anywhere leaves at worst a double-resident key for ``resync``."""
        store = self._store()
        if store is None:
            return []
        cfg = self.config
        state = self.system.metadata.state
        cands = state.demotion_candidates(cfg.min_age, cfg.prefixes)[:cfg.batch]
        cands = [obj for obj in cands if store.exists(obj) and not store.is_cold(obj)]
        if not cands:
            return []
        packed = 0
        for obj in cands:
            packed += store.copy_to_cold(obj)
        accepted = self.system.metadata.propose(("demote_cold", tuple(cands)))
        for obj in accepted:
            store.drop_hot(obj)
        for obj in set(cands) - set(accepted):
            store.drop_cold(obj)   # consensus said no (died/raced): undo
        self._stats.demotions += len(accepted)
        self._stats.bytes_demoted += packed
        self._broker().book_tier(arrival, cold_put_bytes=packed,
                                 n_objects=len(cands))
        return list(accepted)

    def demote(self, arrival: Optional[float] = None) -> TierStats:
        """Drain every currently-eligible demotion."""
        while self.demote_quantum(arrival):
            pass
        return self.stats()

    def note_scan(self, cold_keys: Iterable[str], n_records: int,
                  arrival: Optional[float] = None) -> List[str]:
        """Broker read-path hook: a read of ``n_records`` touched physically
        cold objects. Scan-shaped reads promote them back to hot — propose
        first (the consensus record moves), then rehydrate and drop the cold
        copies. Keys consensus no longer considers cold (placement drift)
        are rehydrated anyway: routing is by presence, so this only
        converges placement."""
        store = self._store()
        if store is None or n_records < self.config.promote_scan_records:
            return []
        keys = sorted(set(cold_keys))
        accepted = self.system.metadata.propose(("promote_hot", tuple(keys)))
        restored = 0
        moved: List[str] = []
        for obj in keys:
            if store.is_cold(obj):
                restored += store.rehydrate(obj)
                store.drop_cold(obj)
                moved.append(obj)
        self._stats.rehydrations += len(moved)
        self._stats.bytes_rehydrated += restored
        if moved:
            self._broker().book_tier(arrival, cold_get_bytes=restored,
                                     n_objects=len(moved))
        return list(accepted)

    def resync(self, arrival: Optional[float] = None) -> int:
        """Converge physical placement to the replicated ``cold_objects``
        set after a crash mid-move (idempotent): consensus-cold keys lose
        their hot copy (compressing one first if the drop never happened);
        physically-cold keys consensus thinks are hot rehydrate."""
        store = self._store()
        if store is None:
            return 0
        state = self.system.metadata.state
        fixed = 0
        for obj in sorted(state.cold_objects):
            if store.exists(obj) and not store.is_cold(obj):
                store.copy_to_cold(obj)
                store.drop_hot(obj)
                fixed += 1
        for obj in store.list():
            if (store.is_cold(obj) and obj not in state.cold_objects
                    and obj in state.object_refs):
                store.rehydrate(obj)
                store.drop_cold(obj)
                fixed += 1
        self._stats.resyncs += 1
        return fixed

    def stats(self) -> TierStats:
        s = self._stats
        store = self._store()
        state = self.system.metadata.state
        return TierStats(demotions=s.demotions, rehydrations=s.rehydrations,
                         bytes_demoted=s.bytes_demoted,
                         bytes_rehydrated=s.bytes_rehydrated,
                         resyncs=s.resyncs,
                         cold_objects=len(state.cold_objects),
                         cold_stored_bytes=(store.cold_stored_bytes
                                            if store is not None else 0))
