"""Bolt metadata layer: the SMR state machine (§5.3-5.6).

This is the deterministic state machine replicated by the Raft-like layer
(:mod:`repro.core.raft`). It owns, per log: the HLI index, the HLI parent
pointer, and membership in the Lazy Tail Tree. Commands (appends, forks,
promote, squash) are applied in consensus order — which is exactly what makes
cFork interleaving *linearizable*: the sequencing order of the single
metadata log is the order every fork observes.

Variant knobs reproduce the paper's ablations:

* ``cf_mode``:   'ltt'   — Bolt   (tail-only updates, lazy via LazyTailTree)
                 'eager' — Bolt-ET (tail-only updates, eager per-descendant)
                 'naive' — BoltNaiveCF (copy index entries into every
                           descendant on each parent append)
* ``fork_mode``: 'zerocopy' — Bolt (HLI; child index starts empty)
                 'metacopy' — BoltMetaCpy (materialize parent's view into the
                              child index at fork time)
* ``promote_mode``: 'copy'   — paper-faithful §5.6 (copy post-fp entries)
                    'splice' — beyond-paper O(1) identity-splice (parent adopts
                               the child's index; old parent index is frozen as
                               an internal HLI ancestor)

Blocking semantics for promotable cForks (§4.1/§5.6) are enforced with a
lazily range-added integer *blocked* counter: while log ``P`` has >=1 active
promotable cFork, +1 is applied over ``subtree(P)`` and -1 over each promotable
child's subtree, so: the parent may still append (positions withheld), the
promotable children operate freely (they must read beyond the fork point to
validate), and every other descendant's appends/deep reads are blocked.
"""

from __future__ import annotations

import bisect
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterable, List, Optional, Set, Tuple

import numpy as np

from . import errors as _errors
from .errors import AgileLogError, ForkBlocked, InvalidOperation, UnknownLog
from .index import NaiveIndex, RunIndex, Span
from .ltt import EagerTailMap, LazyTailTree


def _merge_byte_spans(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of (offset, length) byte spans: sorted, overlapping/adjacent
    spans merged. Zero-length spans (empty records) survive as degenerate
    points unless covered, so the compaction mapping can still translate
    their offsets."""
    if not spans:
        return []
    spans = sorted(spans)
    out: List[List[int]] = [list(spans[0])]
    for off, ln in spans[1:]:
        last = out[-1]
        if off <= last[0] + last[1]:
            last[1] = max(last[1], off + ln - last[0])
        else:
            out.append([off, ln])
    return [(o, ln) for o, ln in out]


def _translate_offset(ranges: Tuple, starts: List[int],
                      off: int, ln: int) -> Optional[int]:
    """Map one source byte span into compacted-object coordinates via the
    ``compact`` command's ``(src_off, length, dst_off)`` ranges (sorted by
    ``src_off``; ``starts`` is the precomputed sort key list). Returns None
    if the span is not fully inside one mapped range — the staleness signal."""
    j = bisect.bisect_right(starts, off) - 1
    if j < 0:
        return None
    s, length, d = ranges[j]
    if off + ln > s + length:
        return None
    return d + (off - s)


@dataclass
class LogMeta:
    log_id: int
    name: str
    kind: str                    # 'root' | 'cfork' | 'sfork' | 'frozen'
    parent: Optional[int]        # HLI parent (metadata-lookup chain)
    fork_point: int = 0          # parent position at fork (tail at creation)
    promotable: bool = False
    index: object = None         # RunIndex | NaiveIndex
    hli_children: Set[int] = field(default_factory=set)
    promotable_forks: Dict[int, int] = field(default_factory=dict)  # child -> fp
    ltt_parent: Optional[int] = None   # inheritance-tree parent (None = tree root)
    broker: Optional[int] = None       # broker assignment (set by the system layer)
    stands_for: Optional[int] = None   # frozen splice stand-in: carries the
                                       # original log's promotable-edge exemption

    @property
    def alive(self) -> bool:
        return self.kind != "frozen"


@dataclass(frozen=True)
class ForkInfo:
    """Fork-point diagnostics for one log (DESIGN.md §12).

    The client session layer uses this to decide whether a speculation's
    parent advanced (``advanced > 0``) and to stamp :class:`ConflictError`
    diagnostics. ``holds_epoch`` is the metadata layer's ``holds_version``
    at query time — the same epoch counter that memoizes §11 visibility
    caps — so two observations with equal epochs saw identical hold state.
    """

    log_id: int
    kind: str                    # 'root' | 'cfork' | 'sfork'
    parent: Optional[int]        # promote target (LTT parent for cForks)
    fork_point: int
    promotable: bool
    tail: int
    parent_tail: Optional[int]   # None for roots / severed-from-dead parents
    advanced: int                # parent records sequenced past the fork point
    holds_epoch: int


class _FlatView:
    """Memoized flattened resolution of one log's view (DESIGN.md §10-§11).

    ``entries`` is a position-contiguous list of ``(c_lo, c_hi, run, rel0)``:
    positions ``[c_lo, c_hi)`` of the viewing log resolve into ancestor index
    run ``run`` at run-relative record ``rel0 + (pos - c_lo)``. A lookup is a
    bisect over ``los`` plus a numpy slice of the run — O(log runs), never a
    chain walk. Views build lazily (extended to the highest position read so
    far, ``hi``).

    ``lineage`` is the view's resolution footprint: the set of log ids on the
    owner's HLI parent chain at build time (owner included). It drives the
    two §11 mechanisms: *scoped invalidation* (promote/squash drop only views
    whose lineage intersects the restructured logs, via the reverse map
    ``MetadataState._view_deps``) and *hold awareness* (a view is servable
    under active promotable cForks up to ``cap``, the visibility prefix
    derived from the holds on its lineage; ``cap_key`` memoizes which
    holds-epoch the cap was computed for)."""

    __slots__ = ("version", "hi", "los", "entries", "lineage", "cap", "cap_key")

    def __init__(self, version: int, lineage: frozenset) -> None:
        self.version = version
        self.hi = 0
        self.los: List[int] = []
        self.entries: List[Tuple[int, int, object, int]] = []
        self.lineage = lineage
        self.cap: Optional[int] = None   # meaningful only when cap_key is current
        self.cap_key = -1


@dataclass
class ViewStats:
    """Read-path counters (DESIGN.md §11): how often the metadata fast path
    engages, and what holds / restructures cost it. Brokers snapshot these
    around each resolution to book cached vs uncached metadata service time
    in the DES model."""

    hits: int = 0           # reads served from a flattened view, no hold on lineage
    capped_hits: int = 0    # served from a view while a lineage hold was active
    slow_reads: int = 0     # exact blocking-aware resolver (cache off or hold fallback)
    builds: int = 0         # views built
    extends: int = 0        # lazy view extensions
    cap_computes: int = 0   # visibility-cap computations (then memoized per epoch)
    invalidated: int = 0    # views dropped by scoped invalidation
    full_clears: int = 0    # wholesale clears (belt-and-braces fallback)

    @property
    def cached_reads(self) -> int:
        return self.hits + self.capped_hits


class MetadataState:
    """Deterministic state machine. `apply(cmd)` for writes, plain methods for reads."""

    def __init__(self, cf_mode: str = "ltt", fork_mode: str = "zerocopy",
                 promote_mode: str = "copy", view_cache: bool = True) -> None:
        assert cf_mode in ("ltt", "eager", "naive")
        assert fork_mode in ("zerocopy", "metacopy")
        assert promote_mode in ("copy", "splice")
        self.cf_mode = cf_mode
        self.fork_mode = fork_mode
        self.promote_mode = promote_mode
        self.logs: Dict[int, LogMeta] = {}
        self._next_id = 0
        if cf_mode == "ltt":
            self.tails = LazyTailTree(seed=0xB017)
        else:
            self.tails = EagerTailMap()
        # naive/metacopy variants use per-record NaiveIndex
        self._use_naive_index = cf_mode == "naive" or fork_mode == "metacopy"
        # -- read path (DESIGN.md §10-§11) ---------------------------------
        # Flattened-view cache: per-log memoized (ancestor run, shift) tables.
        # Engagement is lineage-scoped (§11): a view serves reads whenever no
        # active promotable cFork lies on ITS OWN resolution lineage; under a
        # lineage hold it still serves the visibility prefix (up to `cap`),
        # with only beyond-cap reads delegated to the exact blocking-aware
        # resolver. Holds elsewhere in the forest never disengage it.
        self.view_cache = view_cache and not self._use_naive_index
        self.structure_version = 0
        self.holds_version = 0            # bumped whenever hold state changes
        self._views: Dict[int, _FlatView] = {}
        self._view_deps: Dict[int, Set[int]] = {}  # log id -> view owners through it
        self._holders: Set[int] = set()   # log ids with >=1 promotable fork
        self.stats = ViewStats()
        # -- segment GC manifests (DESIGN.md §13) --------------------------
        # `object_refs[obj]` counts index entries (RunIndex runs / NaiveIndex
        # entries) referencing `obj` across EVERY log in `self.logs`, frozen
        # stand-ins included — a refcount over lineages, not ownership: group
        # commit makes one object multi-log, `Broker.replay` makes it
        # multi-lineage, and a frozen pre-promote chain keeps it pinned for
        # severed dependents. Objects whose count hits zero join
        # `_reclaimable` (in consensus death order); the `gc` SMR command
        # pops candidates, re-checks them (a replay may have re-attached
        # references), and moves the survivors to `reclaimed` — so every
        # replica, including snapshot-restored followers, converges on the
        # identical reclaimed set. All three structures are part of the
        # pickled snapshot state (NOT dropped in __getstate__).
        self.object_refs: Dict[str, int] = {}
        self._reclaimable: Deque[str] = deque()
        self.reclaimed: Set[str] = set()
        self.gc_epoch = 0            # gc commands applied
        self.reclaimed_total = 0     # objects ever reclaimed
        # -- compaction + tiering manifests (DESIGN.md §14) ----------------
        # `object_bytes[obj]` is the object's total payload size, learned at
        # append time (every append command carries the byte ranges covering
        # the whole PUT payload, single-log or group-commit) and set exactly
        # by the `compact` command for objects it writes. `object_ref_bytes`
        # is the byte-granular twin of `object_refs`: the multiset sum of
        # referenced bytes over every attached index entry. Their ratio is
        # the per-object live-byte ratio the compactor selects on. Shared
        # runs inflate the multiset (counted once per attached index), which
        # only *raises* the apparent live ratio — compaction gets less eager,
        # never unsafe. `cold_objects` is the replicated record of which
        # objects the `demote_cold` command moved to the cold store class;
        # `object_birth` (op-seq at first sight) drives age-based demotion.
        # All of these replicate + snapshot exactly like the §13 manifests.
        self.object_bytes: Dict[str, int] = {}
        self.object_ref_bytes: Dict[str, int] = {}
        self.cold_objects: Set[str] = set()
        self.object_birth: Dict[str, int] = {}
        self.op_seq = 0              # SMR commands applied (age clock)
        self.compact_epoch = 0       # compact commands applied (incl. stale)
        self.compacted_total = 0     # source objects retired by compaction
        # -- idempotency dedup table (DESIGN.md §15) -----------------------
        # `idem_results[token]` caches the outcome — ("ok", result) or
        # ("err", exc_type_name, message) — of the first application of an
        # `idem`-wrapped command. A client retrying an ambiguous
        # (committed-but-unacked) propose re-submits the SAME token; the
        # replay returns the cached outcome instead of applying twice.
        # Insertion order is consensus order on every replica, so the FIFO
        # bound (`idem_cap`) evicts identically everywhere; the table is
        # part of the pickled snapshot state and the convergence digest.
        self.idem_results: Dict[str, Tuple] = {}
        self.idem_cap = 1024
        self.idem_hits = 0           # retried proposals served from the table
        self.idem_evictions = 0

    def __getstate__(self) -> dict:
        # Raft snapshots pickle the whole state machine; the view cache and
        # its reverse-dependency map are derived data (and may be large), so
        # they are dropped and rebuilt lazily.
        d = self.__dict__.copy()
        d["_views"] = {}
        d["_view_deps"] = {}
        d["stats"] = ViewStats()
        return d

    # ------------------------------------------------------------------ utils
    def _new_index(self):
        return NaiveIndex() if self._use_naive_index else RunIndex()

    def _get(self, log_id: int, allow_frozen: bool = False) -> LogMeta:
        meta = self.logs.get(log_id)
        if meta is None or (not allow_frozen and not meta.alive):
            raise UnknownLog(f"log {log_id} does not exist")
        return meta

    def _holds(self, meta: LogMeta) -> int:
        return len(meta.promotable_forks)

    def _earliest_fp(self, meta: LogMeta) -> int:
        return min(meta.promotable_forks.values())

    def _blocked_for_ops(self, meta: LogMeta) -> bool:
        """Is this log blocked by an *ancestor's* promotable fork?"""
        _tail, blocked = self.tails.get(meta.log_id)
        own = 1 if self._holds(meta) else 0
        return blocked - own > 0

    def _sync_holder(self, meta: LogMeta) -> None:
        """Keep the active-holders set consistent after a promotable_forks
        mutation; bumping ``holds_version`` expires every memoized view cap."""
        if meta.promotable_forks:
            self._holders.add(meta.log_id)
        else:
            self._holders.discard(meta.log_id)
        self.holds_version += 1

    # -- segment-GC manifests (DESIGN.md §13) -------------------------------
    def _register_object(self, object_id: str) -> None:
        """First sight of a PUT object: enters the manifests at zero
        references. NOT enqueued as a candidate here — a successful append
        bumps the count immediately, and enqueueing every object would grow
        the candidate queue with one stale entry per append; only the
        deterministic-failure path in `_apply_append` (an orphaned PUT)
        enqueues, keeping the queue proportional to *dead* objects."""
        if object_id not in self.object_refs and object_id not in self.reclaimed:
            self.object_refs[object_id] = 0
            self.object_birth[object_id] = self.op_seq

    def _ref_add(self, object_id: str, n: int = 1, nbytes: int = 0) -> None:
        self.object_refs[object_id] = self.object_refs.get(object_id, 0) + n
        if nbytes:
            self.object_ref_bytes[object_id] = \
                self.object_ref_bytes.get(object_id, 0) + nbytes

    def _ref_drop(self, object_id: str, n: int = 1, nbytes: int = 0) -> None:
        left = self.object_refs.get(object_id, 0) - n
        assert left >= 0, f"negative refcount for {object_id}"
        self.object_refs[object_id] = left
        if nbytes:
            left_b = self.object_ref_bytes.get(object_id, 0) - nbytes
            assert left_b >= 0, f"negative ref-bytes for {object_id}"
            self.object_ref_bytes[object_id] = left_b
        if left == 0:
            self._reclaimable.append(object_id)

    def _attach_index(self, index) -> None:
        """A whole index became (another) live reference holder — a frozen
        pre-promote snapshot, or a parent adopting the child's index."""
        refbytes = index.object_refbytes()
        for obj, n in index.object_refcounts().items():
            self._ref_add(obj, n, refbytes.get(obj, 0))

    def _detach_index(self, index) -> None:
        """A log left `self.logs` (or had its index replaced): every entry of
        its index releases one reference. Runs may still be *shared* with a
        surviving index object — counting is per attached index, so the
        survivor's contribution keeps the objects alive."""
        refbytes = index.object_refbytes()
        for obj, n in index.object_refcounts().items():
            self._ref_drop(obj, n, refbytes.get(obj, 0))

    def _apply_gc(self, limit: Optional[int] = None,
                  pinned: Tuple[str, ...] = ()) -> List[str]:
        """The reclamation linearization point (DESIGN.md §13): pop up to
        ``limit`` zero-reference candidates (in death order) and move them to
        the reclaimed set, returning their object ids for the broker-side
        reaper. Stale candidates — objects a replay or
        promote re-attached since they hit zero, or duplicates of an already
        reclaimed id — are discarded; ``pinned`` ids (in-flight session
        rebases holding durable segment refs outside any index) are requeued
        untouched. Runs as ONE SMR command, so the reclaimed set is identical
        on every replica and on any snapshot-restored follower."""
        pinned_set = set(pinned)
        out: List[str] = []
        requeue: List[str] = []
        scanned = 0
        budget = len(self._reclaimable)
        while self._reclaimable and scanned < budget \
                and (limit is None or len(out) < limit):
            scanned += 1
            obj = self._reclaimable.popleft()
            if obj in self.reclaimed or self.object_refs.get(obj, 0) > 0:
                continue   # stale candidate: duplicate, or live again
            if obj in pinned_set:
                requeue.append(obj)
                continue
            del self.object_refs[obj]
            self.object_ref_bytes.pop(obj, None)
            self.object_bytes.pop(obj, None)
            self.object_birth.pop(obj, None)
            self.cold_objects.discard(obj)
            self.reclaimed.add(obj)
            out.append(obj)
        self._reclaimable.extend(requeue)
        self.gc_epoch += 1
        self.reclaimed_total += len(out)
        return out

    def gc_pending(self) -> int:
        """Distinct zero-reference objects awaiting a `gc` quantum."""
        seen: Set[str] = set()
        for obj in self._reclaimable:
            if (obj not in seen and obj not in self.reclaimed
                    and self.object_refs.get(obj, 0) == 0):
                seen.add(obj)
        return len(seen)

    def gc_tracked(self) -> int:
        """Objects with at least one live index reference."""
        return sum(1 for v in self.object_refs.values() if v > 0)

    # -- compaction + tiering (DESIGN.md §14) -------------------------------
    def _apply_compact(self, new_object_id: str, new_size: int,
                       mapping: Tuple) -> Tuple:
        """The compaction linearization point: atomically swap every index
        entry (every log, frozen stand-ins included) referencing the mapped
        source objects onto ``new_object_id``, a compacted object the broker
        already PUT. ``mapping`` is ``((source_id, ranges), ...)`` with
        ``ranges = ((src_off, length, dst_off), ...)`` sorted by ``src_off``
        — explicit command arguments, so the swap is deterministic on every
        replica and under snapshot replay.

        Validation runs to completion BEFORE any mutation: if any live entry
        falls outside its source's mapped ranges (the liveness set moved
        between the broker's read and this command — e.g. a replay
        re-attached a span the compactor thought dead), the command mutates
        nothing and returns ``("stale", reason)``; the already-durable
        compacted object is enqueued as a zero-ref orphan for the §13 path.

        On success the swap rewrites each unique shared ``Run`` in place
        (object id + translated offsets), so frozen snapshots and memoized
        flattened views — both of which hold direct Run references — stay
        coherent with no invalidation, and the sources' refcounts drop to
        zero, queueing them for the reaper. Readers observe byte-identical
        content: the compacted object carries the exact live spans.
        """
        self._register_object(new_object_id)
        if new_size > self.object_bytes.get(new_object_id, 0):
            self.object_bytes[new_object_id] = new_size

        def stale(reason: str) -> Tuple:
            # mirror _apply_append's orphan path: the PUT is durable, the
            # swap is not happening — reclaim via the zero-ref candidate path
            if (self.object_refs.get(new_object_id, 0) == 0
                    and new_object_id not in self.reclaimed):
                self._reclaimable.append(new_object_id)
            self.compact_epoch += 1
            return ("stale", reason)

        if new_object_id in self.reclaimed:
            return stale(f"compacted object {new_object_id} was already reclaimed")
        if self.object_refs.get(new_object_id, 0) > 0:
            return stale(f"compacted object {new_object_id} is already referenced")
        sources: Dict[str, Tuple] = {}
        for src, ranges in mapping:
            if src == new_object_id or src in self.reclaimed:
                return stale(f"source {src} is not compactable")
            sources[src] = (ranges, [r[0] for r in ranges])
        # ---- validate + plan (no mutation yet) ----------------------------
        seen_runs: Dict[int, Tuple] = {}   # id(run) -> (run, new_offsets)
        run_refs: List[Tuple[str, int]] = []      # per (index, run) attachment
        naive_moves: List[Tuple] = []             # (index, pos, src, new_off, ln)
        for lid in sorted(self.logs):
            index = self.logs[lid].index
            if isinstance(index, NaiveIndex):
                for pos in sorted(index.entries):
                    obj, off, ln = index.entries[pos]
                    if obj not in sources:
                        continue
                    ranges, starts = sources[obj]
                    new_off = _translate_offset(ranges, starts, off, ln)
                    if new_off is None:
                        return stale(f"entry {lid}:{pos} of {obj} is outside the live map")
                    naive_moves.append((index, pos, obj, new_off, ln))
            else:
                for run in index.runs():
                    obj = run.object_id
                    if obj not in sources:
                        continue
                    if id(run) not in seen_runs:
                        ranges, starts = sources[obj]
                        new_offs = np.empty_like(run.offsets)
                        for i, (off, ln) in enumerate(zip(run.offsets.tolist(),
                                                          run.lengths.tolist())):
                            new_off = _translate_offset(ranges, starts, off, ln)
                            if new_off is None:
                                return stale(f"run at {lid}:{run.start} of {obj} "
                                             "is outside the live map")
                            new_offs[i] = new_off
                        seen_runs[id(run)] = (run, new_offs)
                    run_refs.append((obj, int(run.lengths.sum())))
        if not run_refs and not naive_moves:
            return stale("no live index entries reference the sources")
        # ---- swap (all-or-nothing from here: no failures possible) --------
        for obj, nbytes in run_refs:
            self._ref_drop(obj, 1, nbytes)
            self._ref_add(new_object_id, 1, nbytes)
        for index, pos, obj, new_off, ln in naive_moves:
            index.entries[pos] = (new_object_id, new_off, ln)
            self._ref_drop(obj, 1, ln)
            self._ref_add(new_object_id, 1, ln)
        for run, new_offs in seen_runs.values():
            run.object_id = new_object_id
            run.offsets = new_offs
        retired = sorted({obj for obj, _ in run_refs}
                         | {mv[2] for mv in naive_moves})
        self.compact_epoch += 1
        self.compacted_total += len(retired)
        return ("ok", {"object": new_object_id, "sources": tuple(retired),
                       "entries": len(run_refs) + len(naive_moves),
                       "live_bytes": self.object_ref_bytes.get(new_object_id, 0)})

    def _apply_demote_cold(self, object_ids: Tuple[str, ...]) -> List[str]:
        """Consensus-ordered demotion to the cold store class (§14): record
        which objects belong cold. Objects that died, were reclaimed, or are
        already cold are skipped deterministically; the accepted ids are
        returned so the broker-side tier manager moves exactly those."""
        done: List[str] = []
        for obj in object_ids:
            if (obj in self.reclaimed or obj in self.cold_objects
                    or self.object_refs.get(obj, 0) <= 0):
                continue
            self.cold_objects.add(obj)
            done.append(obj)
        return done

    def _apply_promote_hot(self, object_ids: Tuple[str, ...]) -> List[str]:
        """Promotion back to the hot tier (scan-triggered rehydration)."""
        done: List[str] = []
        for obj in object_ids:
            if obj in self.cold_objects:
                self.cold_objects.discard(obj)
                done.append(obj)
        return done

    def live_byte_ratio(self, object_id: str) -> float:
        """Referenced bytes / total bytes for one object (multiset-inflated
        ratios clamp at 1.0 — shared runs only make objects look MORE live)."""
        total = self.object_bytes.get(object_id, 0)
        if total <= 0:
            return 1.0
        return min(1.0, self.object_ref_bytes.get(object_id, 0) / total)

    def compaction_candidates(self, max_live_ratio: float, min_bytes: int = 1,
                              exclude: Iterable[str] = ()) -> List[str]:
        """Referenced objects whose live-byte ratio is at or below the
        threshold — the compactor's selection input. ``exclude`` carries the
        broker-side pin/session exclusions (same role as ``gc`` pins)."""
        skip = set(exclude)
        out: List[str] = []
        for obj, n in self.object_refs.items():
            if n <= 0 or obj in skip:
                continue
            total = self.object_bytes.get(obj, 0)
            if total < min_bytes:
                continue
            live = self.object_ref_bytes.get(obj, 0)
            if live < total and live / total <= max_live_ratio:
                out.append(obj)
        return out

    def demotion_candidates(self, min_age: int,
                            prefixes: Tuple[str, ...] = ("cmp-",),
                            exclude: Iterable[str] = ()) -> List[str]:
        """Referenced hot objects old enough (in SMR command ticks since
        first sight) to demote to the cold class."""
        skip = set(exclude)
        pfx = tuple(prefixes)
        out: List[str] = []
        for obj, n in self.object_refs.items():
            if n <= 0 or obj in self.cold_objects or obj in skip:
                continue
            if pfx and not obj.startswith(pfx):
                continue
            if self.op_seq - self.object_birth.get(obj, self.op_seq) >= min_age:
                out.append(obj)
        return out

    def object_live_spans(self, object_ids: Iterable[str]
                          ) -> Dict[str, List[Tuple[int, int]]]:
        """Exact per-object union of referenced byte spans over every log's
        index (frozen stand-ins included), merged and sorted — what the
        compactor ranged-reads and what the mapping ranges are built from."""
        want = set(object_ids)
        raw: Dict[str, List[Tuple[int, int]]] = {obj: [] for obj in want}
        for lid in sorted(self.logs):
            index = self.logs[lid].index
            if isinstance(index, NaiveIndex):
                for obj, off, ln in index.entries.values():
                    if obj in want:
                        raw[obj].append((off, ln))
            else:
                for run in index.runs():
                    if run.object_id in want:
                        raw[run.object_id].extend(
                            zip(run.offsets.tolist(), run.lengths.tolist()))
        return {obj: _merge_byte_spans(sp) for obj, sp in raw.items()}

    # -- invalidation (DESIGN.md §11) ---------------------------------------
    def _drop_view(self, owner: int) -> None:
        view = self._views.pop(owner, None)
        if view is None:
            return
        for lid in view.lineage:
            deps = self._view_deps.get(lid)
            if deps is not None:
                deps.discard(owner)
                if not deps:
                    del self._view_deps[lid]
        self.stats.invalidated += 1

    def _invalidate_through(self, log_ids: Iterable[int]) -> None:
        """Scoped invalidation: drop only the views whose lineage resolves
        through any of ``log_ids`` (the restructured subtree). Views on
        unrelated logs — other topics, other branches — survive, which is
        what keeps promote/squash latency independent of how many flattened
        views are live elsewhere."""
        owners: Set[int] = set()
        for lid in log_ids:
            deps = self._view_deps.get(lid)
            if deps:
                owners.update(deps)
        for owner in owners:
            self._drop_view(owner)

    def _invalidate_views(self) -> None:
        """Belt-and-braces fallback: drop EVERY flattened view and expire any
        view object still referenced elsewhere via the version bump. The §11
        scoped path (`_invalidate_through`) supersedes this on the
        promote/squash hot path; this remains for wholesale resets."""
        self.structure_version += 1
        self.holds_version += 1
        if self._views:
            self._views.clear()
        self._view_deps.clear()
        self.stats.full_clears += 1

    # --------------------------------------------------------------- commands
    def apply(self, cmd: Tuple) -> object:
        op = cmd[0]
        # the age clock ticks on every command (success or deterministic
        # failure — both apply identically on every replica)
        self.op_seq += 1
        return getattr(self, "_apply_" + op)(*cmd[1:])

    def _apply_idem(self, token: str, cmd: Tuple) -> object:
        """Exactly-once wrapper (DESIGN.md §15): apply ``cmd`` and cache its
        outcome under ``token``; a token seen before replays the cached
        outcome WITHOUT re-applying. Deterministic command errors are cached
        as values and re-raised equivalently on replay, so a retried
        ambiguous propose observes the identical result either way."""
        hit = self.idem_results.get(token)
        if hit is not None:
            self.idem_hits += 1
            if hit[0] == "err":
                exc_cls = getattr(_errors, hit[1], AgileLogError)
                raise exc_cls(hit[2])
            return hit[1]
        try:
            result = self.apply(cmd)
        except AgileLogError as e:
            self._idem_remember(token, ("err", type(e).__name__, str(e)))
            raise
        self._idem_remember(token, ("ok", result))
        return result

    def _idem_remember(self, token: str, outcome: Tuple) -> None:
        self.idem_results[token] = outcome
        while len(self.idem_results) > self.idem_cap:
            self.idem_results.pop(next(iter(self.idem_results)))
            self.idem_evictions += 1

    def _apply_noop(self) -> None:
        """Current-term barrier entry (DESIGN.md §16): a new leader proposes
        one of these to commit any lingering prior-term suffix under raft's
        commit rule (prior-term entries commit only beneath a current-term
        majority ack). State-machine-wise it only ticks the age clock — which
        ``apply`` already did."""
        return None

    def _apply_create_root(self, name: str) -> int:
        log_id = self._next_id
        self._next_id += 1
        self.logs[log_id] = LogMeta(log_id, name, "root", parent=None,
                                    index=self._new_index())
        self.tails.add_root(log_id, tail0=0, blocked0=0)
        return log_id

    def _apply_append(self, log_id: int, object_id: str,
                      offsets: Tuple[int, ...], lengths: Tuple[int, ...]) -> Optional[List[int]]:
        # register BEFORE any deterministic failure: the broker already PUT
        # the object, so a blocked/unknown-log append leaves an orphan in
        # shared storage that only the zero-ref candidate path can reclaim
        self._register_object(object_id)
        # learn the object's size (§14): every append command covers a suffix
        # of the PUT payload, so the max byte-end over all appends naming the
        # object — group-commit batches issue one per packed log — is exact
        if lengths:
            end = max(o + ln for o, ln in zip(offsets, lengths))
            if end > self.object_bytes.get(object_id, 0):
                self.object_bytes[object_id] = end
        try:
            if object_id in self.reclaimed:
                raise InvalidOperation(
                    f"object {object_id} was already reclaimed by GC; "
                    "sequencing it would index deleted storage")
            meta = self._get(log_id)
            if self._blocked_for_ops(meta):
                raise ForkBlocked(
                    f"appends to log {log_id} are blocked by an ancestor's promotable cFork")
        except Exception:
            # deterministic failure with the PUT already durable: an orphan —
            # enqueue it (still zero-ref unless a batch-mate entry succeeded)
            if (self.object_refs.get(object_id, 0) == 0
                    and object_id not in self.reclaimed):
                self._reclaimable.append(object_id)
            raise
        tail, _blk = self.tails.get(log_id)
        k = len(offsets)
        run_bytes = int(sum(lengths))
        if self._use_naive_index:
            for i in range(k):
                meta.index.add_local(tail + i, (object_id, offsets[i], lengths[i]))
            self._ref_add(object_id, k, run_bytes)
        else:
            meta.index.append_run(tail, object_id,
                                  np.asarray(offsets, dtype=np.int64),
                                  np.asarray(lengths, dtype=np.int64))
            self._ref_add(object_id, 1, run_bytes)
        if self.cf_mode == "naive":
            # BoltNaiveCF: duplicate the new entries into EVERY descendant's
            # index at that descendant's own tail (Fig. 4a), eagerly.
            for d in self.tails.subtree_ids(log_id):
                if d == log_id:
                    continue
                d_tail, _ = self.tails.get(d)
                d_index = self.logs[d].index
                for i in range(k):
                    d_index.add_copy(d_tail + i, (object_id, offsets[i], lengths[i]))
                self._ref_add(object_id, k, run_bytes)
        self.tails.range_add(log_id, d_tail=k)
        if self._holds(meta):
            return None  # §4.1: positions beyond a promotable fork point are withheld
        return list(range(tail, tail + k))

    def _apply_append_batch_multi(self, entries: Tuple) -> List[Tuple]:
        """One SMR command sequencing appends for several logs (group commit,
        DESIGN.md §9). ``entries`` is a tuple of ``(log_id, object_id,
        offsets, lengths)`` — typically all referencing one segment object.

        Entries are applied in order; each commits or fails *independently but
        deterministically* (a blocked log must not veto its batch-mates, and
        every replica reaches the identical state either way). Failures are
        therefore returned as values, not raised: the per-entry outcomes are
        ``("ok", positions)`` | ``("hidden", None)`` (positions withheld by a
        promotable cFork) | ``("error", exc_type_name, message)``.
        """
        outcomes: List[Tuple] = []
        for log_id, object_id, offsets, lengths in entries:
            try:
                positions = self._apply_append(log_id, object_id, offsets, lengths)
            except AgileLogError as e:
                outcomes.append(("error", type(e).__name__, str(e)))
            else:
                if positions is None:
                    outcomes.append(("hidden", None))
                else:
                    outcomes.append(("ok", positions))
        return outcomes

    def _check_forkable(self, meta: LogMeta) -> int:
        if self._blocked_for_ops(meta):
            raise ForkBlocked(f"log {meta.log_id} is blocked by an ancestor's promotable cFork")
        tail, _ = self.tails.get(meta.log_id)
        if self._holds(meta) and tail > self._earliest_fp(meta):
            raise ForkBlocked(
                "cannot fork beyond an active promotable cFork's fork point")
        return tail

    def _materialize_into(self, child_index: NaiveIndex, log_id: int, upto: int) -> None:
        """BoltMetaCpy: copy the parent's fully-resolved view [0, upto) into the
        child's index (this is the expensive O(n) path the paper measures)."""
        for pos in range(upto):
            span = self._lookup_one(log_id, pos)
            child_index.add_copy(pos, span)
            self._ref_add(span[0], 1, span[2])  # the copy is a live reference (§13)

    def _apply_cfork(self, parent_id: int, promotable: bool) -> int:
        parent = self._get(parent_id)
        fp = self._check_forkable(parent)
        child_id = self._next_id
        self._next_id += 1
        child = LogMeta(child_id, f"{parent.name}/cf{child_id}", "cfork",
                        parent=parent_id, fork_point=fp, promotable=promotable,
                        index=self._new_index(), ltt_parent=parent_id)
        self.logs[child_id] = child
        parent.hli_children.add(child_id)
        _t, parent_blocked = self.tails.get(parent_id)
        self.tails.add_child(parent_id, child_id, tail0=fp, blocked0=parent_blocked)
        if self.fork_mode == "metacopy":
            self._materialize_into(child.index, parent_id, fp)
        if promotable:
            if not self._holds(parent):
                self.tails.range_add(parent_id, d_blocked=+1)  # now incl. child
            self.tails.range_add(child_id, d_blocked=-1)       # child exempt
            parent.promotable_forks[child_id] = fp
            self._sync_holder(parent)
        return child_id

    def _apply_sfork(self, parent_id: int, past: Optional[int]) -> int:
        parent = self._get(parent_id)
        tail = self._check_forkable(parent)
        if past is not None:
            if not (0 <= past < tail):
                raise InvalidOperation(f"past offset {past} out of range (tail {tail})")
            fp = past + 1
        else:
            fp = tail
        child_id = self._next_id
        self._next_id += 1
        child = LogMeta(child_id, f"{parent.name}/sf{child_id}", "sfork",
                        parent=parent_id, fork_point=fp, promotable=False,
                        index=self._new_index(), ltt_parent=None)
        self.logs[child_id] = child
        parent.hli_children.add(child_id)
        # severed: its own LTT *tree* — no continuous inheritance (§5.3)
        self.tails.add_root(child_id, tail0=fp, blocked0=0)
        if self.fork_mode == "metacopy":
            self._materialize_into(child.index, parent_id, fp)
        return child_id

    # -- squash ---------------------------------------------------------------
    def _delete_or_freeze(self, removed: List[int]) -> None:
        """Delete removed logs, but *freeze* (keep index of) any removed log
        that an external log (e.g. an sFork in another tree) — or another kept
        frozen log — still depends on through the HLI chain."""
        removed_set = set(removed)
        keep: Set[int] = set()
        changed = True
        while changed:   # fixpoint: freezing a child forces its ancestors frozen
            changed = False
            for d in removed:
                if d in keep:
                    continue
                deps = self.logs[d].hli_children
                if (deps - removed_set) or (deps & keep):
                    keep.add(d)
                    changed = True
        for d in removed:
            meta = self.logs[d]
            if d in self._holders:
                self._holders.discard(d)
                self.holds_version += 1
            if d in keep:
                meta.kind = "frozen"   # index kept alive for dependents
                meta.promotable_forks.clear()
                meta.hli_children = (meta.hli_children - removed_set) | (meta.hli_children & keep)
            else:
                del self.logs[d]
                # dead-lineage event (§13): the log's index entries release
                # their segment references; zero-ref objects queue for gc
                self._detach_index(meta.index)
                if meta.parent is not None and meta.parent in self.logs:
                    self.logs[meta.parent].hli_children.discard(d)
        self._gc_frozen()

    def _gc_frozen(self) -> None:
        """Delete frozen logs whose last HLI dependent vanished (chain GC)."""
        progressed = True
        while progressed:
            progressed = False
            for lid in [k for k, v in self.logs.items()
                        if v.kind == "frozen" and not v.hli_children]:
                meta = self.logs.pop(lid)
                self._holders.discard(lid)
                self._invalidate_through((lid,))
                self._detach_index(meta.index)   # chain-GC dead-lineage event (§13)
                if meta.parent is not None and meta.parent in self.logs:
                    self.logs[meta.parent].hli_children.discard(lid)
                progressed = True

    def _apply_squash(self, log_id: int) -> List[int]:
        meta = self._get(log_id)
        if meta.kind == "root":
            raise InvalidOperation("cannot squash the root log (§4.1)")
        parent = self.logs.get(meta.ltt_parent) if meta.ltt_parent is not None else None
        was_promotable = (parent is not None and log_id in parent.promotable_forks)
        removed = self.tails.remove_subtree(log_id)
        # scoped invalidation (§11): only views resolving through the removed
        # subtree can go stale — the surviving logs' indexes, tails, and HLI
        # edges are untouched by a squash, so their views stay live (releasing
        # a hold is a visibility change, handled by the holds_version bump)
        self._invalidate_through(removed)
        if was_promotable:
            del parent.promotable_forks[log_id]
            self._sync_holder(parent)
            if not parent.promotable_forks:
                self.tails.range_add(parent.log_id, d_blocked=-1)
        self._delete_or_freeze(removed)
        return removed

    # -- promote ----------------------------------------------------------------
    def _apply_promote(self, child_id: int, mode: Optional[str] = None) -> bool:
        mode = mode or self.promote_mode
        child = self._get(child_id)
        if not child.promotable or child.kind != "cfork":
            raise InvalidOperation("only promotable cForks can be promoted (§4.1)")
        parent = self._get(child.ltt_parent)
        if self._blocked_for_ops(parent):
            # the parent is capped by an ancestor's promotable cFork; promoting
            # into it would mutate content beyond that outer fork point, which
            # the outer hold forbids until it resolves (DESIGN.md §4)
            raise ForkBlocked(
                "cannot promote into a log blocked by an ancestor's promotable cFork")
        assert child_id in parent.promotable_forks
        # scoped invalidation (§11): a promote rewrites the parent's index
        # (copy) or replaces it behind a frozen stand-in (splice), deletes the
        # child, and re-binds the child's HLI dependents — every affected view
        # resolves through `parent` or `child`, so only their dependents drop
        # (sibling squashes below invalidate their own subtrees)
        self._invalidate_through((parent.log_id, child_id))
        # 1. first promote wins: squash other promotable siblings (§4.1)
        for sib in [c for c in parent.promotable_forks if c != child_id]:
            self._apply_squash(sib)
        # 2. tails: parent's lineage absorbs the child's local appends.
        # Inheritance invariant: child_tail = parent_tail + child-lineage locals
        # (the lineage may span frozen splice stand-ins, so count via tails).
        lc = self.tails.get(child_id)[0] - self.tails.get(parent.log_id)[0]
        self.tails.range_add(parent.log_id, d_tail=+lc)
        self.tails.range_add(child_id, d_tail=-lc)
        # 3. blocking. Two cases:
        #    (a) child has its own promotable forks: they TRANSFER to the
        #        parent (the grandchild's promise now applies to the promoted
        #        lineage; child positions == new parent positions). The
        #        counters are already correct: the child's hold-bit (+1 over
        #        its subtree) and its exemption (-1 over its subtree) cancel,
        #        and the parent's bit stays because it still holds forks.
        #    (b) no transfer: reverse the child's exemption, then drop the
        #        parent's hold bit.
        del parent.promotable_forks[child_id]
        assert not parent.promotable_forks
        if child.promotable_forks:
            parent.promotable_forks.update(child.promotable_forks)
        else:
            self.tails.range_add(child_id, d_blocked=+1)
            self.tails.range_add(parent.log_id, d_blocked=-1)
        self._sync_holder(parent)
        # 4. index restructure
        if mode == "splice":
            self._promote_splice(parent, child)
        else:
            self._promote_copy(parent, child)
        # 5. child's HLI dependents re-bind to the parent (same positions)
        for dep in child.hli_children:
            self.logs[dep].parent = parent.log_id
            parent.hli_children.add(dep)
        # 6. child's LTT children re-parent to parent; child's markers vanish
        # (direct_children, not an O(subtree) tour: only the immediate
        # children carry an ltt_parent pointer at the promoted node)
        for d in self.tails.direct_children(child_id):
            if self.logs[d].ltt_parent == child_id:
                self.logs[d].ltt_parent = parent.log_id
        self.tails.remove_node_keep_children(child_id)
        if child.parent is not None and child.parent in self.logs:
            self.logs[child.parent].hli_children.discard(child_id)
        parent.hli_children.discard(child_id)
        del self.logs[child_id]
        # release the child's manifest contribution (§13). Splice mode
        # attached one extra reference when the parent adopted the child's
        # index object, so its entries stay counted exactly once; copy mode
        # re-referenced the child-lineage runs inside the parent's new index.
        self._detach_index(child.index)
        self._holders.discard(child_id)
        self._gc_frozen()
        return True

    def _apply_promote_if(self, child_id: int, expected_parent_tail: int,
                          mode: Optional[str] = None) -> Tuple:
        """Conditional promote — the linearization point of a speculative
        commit (DESIGN.md §12). Promotes ``child_id`` only if its parent's
        tail is still ``<= expected_parent_tail`` (i.e. nothing was sequenced
        into the parent past what the speculation validated); otherwise it
        mutates NOTHING and returns the conflict diagnostics as a value.

        Because this runs as one SMR command, check and promote are atomic in
        consensus order — the hand-rolled tail-check-then-promote loop cannot
        close this race (records sequenced between its two proposals are
        merged unvalidated). Outcomes, deterministic on every replica:

        * ``("ok", (base, count))`` — promoted; the speculative suffix landed
          at parent positions ``[base, base + count)``.
        * ``("conflict", {..})``    — parent advanced; diagnostics carry the
          fork point, observed/expected tails, and the holds epoch.

        Ineligible children (non-promotable, unknown — e.g. squashed by a
        sibling's winning promote) raise the usual deterministic errors.
        """
        child = self._get(child_id)
        if not child.promotable or child.kind != "cfork":
            raise InvalidOperation("only promotable cForks can be committed (§4.1)")
        parent = self._get(child.ltt_parent)
        p_tail = self.tails.get(parent.log_id)[0]
        if p_tail > expected_parent_tail:
            return ("conflict", {
                "log_id": parent.log_id, "fork_id": child_id,
                "fork_point": child.fork_point, "parent_tail": p_tail,
                "expected": expected_parent_tail,
                "advanced": p_tail - expected_parent_tail,
                "holds_epoch": self.holds_version,
            })
        count = self.tails.get(child_id)[0] - p_tail
        self._apply_promote(child_id, mode)
        return ("ok", (p_tail, count))

    def _promote_splice(self, parent: LogMeta, child: LogMeta) -> None:
        """O(1)-metadata: parent adopts child's index; the old parent index is
        frozen as an internal HLI stand-in (beyond-paper; DESIGN.md §4.2).

        Existing forks of the parent keep pointing at the (live) parent: every
        other fork's fork point is <= fp, and the parent's new index only has
        entries >= fp, so their sub-fp lookups fall through into the frozen
        stand-in transparently (local counts below fp are zero in the adopted
        index). Only the bottom of the promoted child's own frozen chain —
        which references *old-parent positions >= fp* — re-binds to F.
        """
        frozen_id = self._next_id
        self._next_id += 1
        frozen = LogMeta(frozen_id, f"{parent.name}@pre-promote", "frozen",
                         parent=parent.parent, index=parent.index,
                         stands_for=parent.log_id)
        self.logs[frozen_id] = frozen
        if parent.parent is not None:
            gp = self.logs[parent.parent]
            gp.hli_children.discard(parent.log_id)
            gp.hli_children.add(frozen_id)
        self._rebind_snapshot_deps(parent, frozen, child)
        # splice: parent continues the child's lineage. Manifests (§13): the
        # old parent index merely moves (parent -> frozen stand-in), but the
        # child's index is now held TWICE (child until its deletion below,
        # plus the parent) — attach the parent's adoption; _apply_promote
        # releases the child's own contribution when it deletes the log.
        self._attach_index(child.index)
        parent.index = child.index
        if child.parent == parent.log_id:
            parent.parent = frozen_id
            frozen.hli_children.add(parent.log_id)
        else:
            # the child had its own frozen chain; its bottom link (a frozen
            # stand-in whose parent was this log) was already re-bound to
            # `frozen` by _rebind_snapshot_deps above
            parent.parent = child.parent
            self.logs[child.parent].hli_children.discard(child.log_id)
            self.logs[child.parent].hli_children.add(parent.log_id)

    def _snapshot_movable_deps(self, parent: LogMeta, child: LogMeta) -> List[int]:
        """Dependents of `parent` that must re-bind to a frozen pre-promote
        copy: severed forks and frozen chains holding *positional* snapshots
        of the old parent content, which a promote rewrites beyond the fork
        point. A frozen splice stand-in that is the chain bottom of a live
        cFork OTHER than the promoted child must NOT move: that fork inherits
        continuously, so its future positions resolve through the live
        parent's post-promote index (its sub-fp lookups are position-stable
        either way). Only the promoted child's own chain bottom — which
        references old-parent positions >= fp, exactly the ones being
        re-sequenced — carries the old order."""
        out = []
        for d in parent.hli_children:
            dm = self.logs[d]
            if dm.kind == "sfork":
                out.append(d)
            elif dm.kind == "frozen":
                sf = dm.stands_for
                live_other = (sf is not None and sf != child.log_id
                              and sf in self.logs and self.logs[sf].alive)
                if not live_other:
                    out.append(d)
        return out

    def _rebind_snapshot_deps(self, parent: LogMeta, frozen: LogMeta,
                              child: LogMeta) -> None:
        for dep in self._snapshot_movable_deps(parent, child):
            self.logs[dep].parent = frozen.log_id
            frozen.hli_children.add(dep)
            parent.hli_children.discard(dep)

    def _collect_lineage_runs(self, child: LogMeta, stop_id: int,
                              lo: int, hi: int):
        """All index runs contributing to child positions [lo, hi) that are NOT
        derived from log `stop_id`'s own index (i.e. the child lineage's local
        records, possibly spread over a frozen splice chain), re-keyed into
        child positions. Returns [(child_start, object_id, offsets, lengths)]
        sorted by child_start."""
        out = []

        def rec(meta: LogMeta, a: int, b: int, shift: int) -> None:
            for seg in meta.index.segments(a, b):
                if seg[0] == "local":
                    _, s_lo, s_hi, run = seg
                    i, j = s_lo - run.start, s_hi - run.start
                    out.append((s_lo + shift, run.object_id,
                                run.offsets[i:j], run.lengths[i:j]))
                else:
                    _, g_lo, g_hi, lcount = seg
                    parent = self.logs[meta.parent]
                    if parent.log_id == stop_id:
                        continue  # stop-log-derived: handled by the merge
                    rec(parent, g_lo - lcount, g_hi - lcount, shift + lcount)

        rec(child, lo, hi, 0)
        out.sort(key=lambda t: t[0])
        return out

    def _promote_copy(self, parent: LogMeta, child: LogMeta) -> None:
        """Paper-faithful §5.6: copy the child's post-fp entries into the
        parent's index; the parent's own post-fp entries are re-sequenced to
        their positions in the child's (= the new) order. O(entries after fp)."""
        fp = child.fork_point
        if self._use_naive_index:
            raise InvalidOperation("promote not supported for naive-index variants")
        child_tail = self.tails.get(child.log_id)[0]
        # collect the child lineage's local runs FIRST (the walk must still see
        # the pre-rebind chain ending at this parent)
        c_runs = self._collect_lineage_runs(child, parent.log_id, fp, child_tail)
        # severed/frozen dependents keep the old positional content: freeze a
        # zero-copy snapshot of the old index for them (copy mode rewrites
        # positions beyond fp in place); live forks' chain bottoms stay on
        # the live parent (continuous inheritance, see _snapshot_movable_deps)
        snapshot_deps = self._snapshot_movable_deps(parent, child)
        if snapshot_deps:
            frozen_id = self._next_id
            self._next_id += 1
            frozen = LogMeta(frozen_id, f"{parent.name}@pre-promote", "frozen",
                             parent=parent.parent, index=parent.index.snapshot(),
                             stands_for=parent.log_id)
            self.logs[frozen_id] = frozen
            # the snapshot shares Run objects but is a second attached index:
            # its entries hold their segments for the severed dependents (§13)
            self._attach_index(frozen.index)
            if parent.parent is not None:
                self.logs[parent.parent].hli_children.add(frozen_id)
            self._rebind_snapshot_deps(parent, frozen, child)
        old_runs = parent.index.runs()
        new_index = RunIndex()
        for r in old_runs:
            if r.end <= fp:
                new_index.append_run(r.start, r.object_id, r.offsets, r.lengths)
        p_runs = [r for r in old_runs if r.start >= fp]
        ci = pi = 0
        c_cum = 0  # child-lineage records emitted so far
        while ci < len(c_runs) or pi < len(p_runs):
            c_start = c_runs[ci][0] if ci < len(c_runs) else None
            # a parent run at parent-position s lands at child-position s + c_cum
            p_start = (p_runs[pi].start + c_cum) if pi < len(p_runs) else None
            if p_start is None or (c_start is not None and c_start <= p_start):
                start, obj, offs, lens = c_runs[ci]
                new_index.append_run(start, obj, offs, lens)
                c_cum += len(offs)
                ci += 1
            else:
                r = p_runs[pi]
                new_index.append_run(p_start, r.object_id, r.offsets, r.lengths)
                pi += 1
        # manifest swap (§13): the rebuilt index re-references the surviving
        # segments (child-lineage runs included), the replaced one releases —
        # only segments that appear in NEITHER can drop toward zero here
        self._attach_index(new_index)
        self._detach_index(parent.index)
        parent.index = new_index

    # ---------------------------------------------------------------- queries
    def tail(self, log_id: int) -> int:
        self._get(log_id)
        return self.tails.get(log_id)[0]

    def visible_tail(self, log_id: int) -> int:
        """Tail capped at the earliest promotable fork point (readable range)."""
        meta = self._get(log_id)
        tail = self.tails.get(log_id)[0]
        if self._holds(meta):
            return min(tail, self._earliest_fp(meta))
        return tail

    def fork_info(self, log_id: int) -> ForkInfo:
        """Fork-point epoch exposure (DESIGN.md §12): where this log forked,
        how far its promote target has run ahead, and the holds epoch."""
        meta = self._get(log_id)
        tail = self.tails.get(log_id)[0]
        target = meta.ltt_parent if meta.kind == "cfork" else meta.parent
        p_tail: Optional[int] = None
        advanced = 0
        if target is not None:
            pm = self.logs.get(target)
            if pm is not None and pm.alive:
                p_tail = self.tails.get(target)[0]
                advanced = max(0, p_tail - meta.fork_point)
        return ForkInfo(log_id=log_id, kind=meta.kind, parent=target,
                        fork_point=meta.fork_point, promotable=meta.promotable,
                        tail=tail, parent_tail=p_tail, advanced=advanced,
                        holds_epoch=self.holds_version)

    def _lookup_one(self, log_id: int, pos: int) -> Span:
        spans = self.read_spans(log_id, pos, pos + 1, _skip_checks=True)
        assert len(spans) == 1
        return spans[0]

    def read_record_spans(self, log_id: int, lo: int, hi: int) -> List[Span]:
        """One span per record (no coalescing) — for record-oriented reads."""
        return self.read_spans(log_id, lo, hi, per_record=True)

    def read_spans(self, log_id: int, lo: int, hi: int,
                   _skip_checks: bool = False, per_record: bool = False) -> List[Span]:
        """Resolve [lo, hi) to byte spans through the HLI chain.
        Contiguous byte ranges are coalesced unless ``per_record``.

        Fast path (DESIGN.md §10-§11): positions resolve through the
        memoized flattened view — O(log runs) per lookup regardless of fork
        depth — whenever no active promotable cFork lies on THIS log's
        resolution lineage. Under a lineage hold, the view still serves the
        §4.1-visible prefix (up to the memoized visibility ``cap``); only a
        read crossing the cap is delegated to the exact blocking-aware chain
        resolver, which raises the precise error in DFS order.

        Raises ForkBlocked if the range crosses an active promotable fork point
        that the reader is not entitled to see (§4.1).
        """
        meta = self._get(log_id)
        tail = self.tails.get(log_id)[0]
        if not (0 <= lo <= hi <= tail):
            # explicit even when a view already covers `hi`: a restructure
            # that shrank this log's range must never serve stale spans
            raise InvalidOperation(f"read [{lo},{hi}) out of range (tail {tail})")
        if lo >= hi:
            return []   # empty reads never resolve, block, or extend a view
        if self.view_cache:
            view = self._views.get(log_id)
            if view is not None and view.version != self.structure_version:
                self._drop_view(log_id)   # belt-and-braces vs wholesale clears
                view = None
            if view is None:
                view = self._build_view(meta)   # one chain walk; cap memoizes on it
            # note: sfork origin exempts only *ancestor* holds (_view_cap
            # breaks its walk at the severed edge); the log's OWN promotable
            # forks still cap it, exactly like the uncached viewing-log check
            if (self._holders and not _skip_checks
                    and not self._holders.isdisjoint(view.lineage)):
                cap = self._view_cap(meta, view)
                if cap is not None and hi > cap:
                    # beyond the visible prefix: the exact resolver owns
                    # the §4.1 error (or the rare allowed corner)
                    return self._slow_spans(meta, lo, hi, _skip_checks,
                                            per_record)
                self.stats.capped_hits += 1
            else:
                self.stats.hits += 1
            if hi > view.hi:
                self._extend_view(meta, view, hi)
            return self._view_spans(view, lo, hi, per_record)
        return self._slow_spans(meta, lo, hi, _skip_checks, per_record)

    def _slow_spans(self, meta: LogMeta, lo: int, hi: int,
                    _skip_checks: bool, per_record: bool) -> List[Span]:
        """The exact blocking-aware resolution (bounds already validated)."""
        self.stats.slow_reads += 1
        if (not _skip_checks and hi > lo and self._holds(meta)
                and hi > self._earliest_fp(meta)):
            raise ForkBlocked(
                f"reads on log {meta.log_id} beyond position {self._earliest_fp(meta)} "
                "are blocked while a promotable cFork exists")
        out: List[Span] = []
        # reads originating on a severed fork reference positionally-committed
        # content (their view was fixed at fork time), so the beyond-fp block —
        # which protects *provisional* positions a promote may rewrite — does
        # not apply to them (the oracle materializes their content at creation)
        origin_snapshot = meta.kind == "sfork"
        self._resolve(meta, lo, hi, out, via_promotable=_skip_checks or origin_snapshot,
                      per_record=per_record)
        return out

    # -- flattened-view fast path (DESIGN.md §10-§11) -----------------------
    def _lineage(self, meta: LogMeta) -> frozenset:
        """The HLI parent chain of `meta` (inclusive): every log its reads can
        resolve through. Stable for a view's lifetime — appends and new forks
        never rebind existing parent pointers; promote/squash do, and they
        drop the dependent views."""
        chain = []
        m: Optional[LogMeta] = meta
        while m is not None:
            chain.append(m.log_id)
            m = self.logs.get(m.parent) if m.parent is not None else None
        return frozenset(chain)

    def _view_cap(self, meta: LogMeta, view: Optional[_FlatView]) -> Optional[int]:
        """Largest ``hi`` this log may read without tripping a §4.1 check,
        given the active holds on its lineage; ``None`` = unbounded (every
        hold on the lineage is exempt for this reader — e.g. the promotable
        child itself, which must read beyond the fork point to validate).

        O(chain) metadata hops plus O(log n) tail queries, and *exact*: while
        a hold on ancestor ``H`` (fork point ``fp``) is active, no log on a
        non-exempt inheritance path below ``H`` can append, so the forbidden
        positions of this log are precisely its top ``H.tail - fp`` ones —
        ``cap = tail - (H.tail - fp)`` — an invariant under any ancestor's
        concurrent appends (they advance both tails equally). Memoized on the
        view per holds-epoch."""
        if view is not None and view.cap_key == self.holds_version:
            return view.cap
        self.stats.cap_computes += 1
        cap: Optional[int] = None
        if self._holds(meta):
            cap = self._earliest_fp(meta)
        m = meta
        while m.parent is not None:
            if m.kind == "sfork":
                if m is meta:
                    # origin snapshot: the exact resolver exempts every edge
                    # of a severed-fork-origin read (`via`), so ancestor
                    # holds never apply — only the own-hold cap above does
                    break
                # severed edge mid-chain: the log above appends freely, so
                # the tail-difference invariant breaks; and a hold whose fork
                # point was transferred down by a promote CAN sit below this
                # fork's inherited reach. If any live holder remains above,
                # be conservative: delegate every non-empty read
                a = m
                holder_above = False
                while a.parent is not None:
                    pa = self.logs.get(a.parent)
                    if pa is None:
                        break
                    if pa.alive and self._holds(pa):
                        holder_above = True
                        break
                    a = pa
                if holder_above:
                    cap = 0
                break
            parent = self.logs.get(m.parent)
            if parent is None:
                break
            exempt = (m.log_id in parent.promotable_forks
                      or (m.stands_for is not None
                          and m.stands_for in parent.promotable_forks))
            if not exempt and parent.alive and self._holds(parent):
                # meta is on a continuous-inheritance path below `parent`
                # (severed edges are handled above): while the hold is
                # active nothing on the path can append, so meta's forbidden
                # positions are exactly its top `parent_tail - fp` ones —
                # and concurrent appends by higher ancestors advance both
                # tails equally, keeping `t` invariant
                p_tail = self.tails.get(parent.log_id)[0]
                t = (self.tails.get(meta.log_id)[0]
                     - (p_tail - self._earliest_fp(parent)))
                cap = t if cap is None else min(cap, t)
            m = parent
        if view is not None:
            view.cap = cap
            view.cap_key = self.holds_version
        return cap

    def _build_view(self, meta: LogMeta) -> _FlatView:
        lineage = self._lineage(meta)
        view = _FlatView(self.structure_version, lineage)
        self._views[meta.log_id] = view
        for lid in lineage:
            self._view_deps.setdefault(lid, set()).add(meta.log_id)
        self.stats.builds += 1
        return view

    def _extend_view(self, meta: LogMeta, view: _FlatView, hi: int) -> None:
        """Lazily extend the flattened view to cover [0, hi)."""
        if hi > view.hi:
            self.stats.extends += 1
            new = self._flatten_range(meta, view.hi, hi)
            # extension seam: if the first new entry continues the last
            # entry's run, merge them so span coalescing granularity is
            # identical to a from-scratch resolution
            if new and view.entries:
                c_lo, c_hi, run, rel0 = new[0]
                p_lo, p_hi, p_run, p_rel0 = view.entries[-1]
                if p_run is run and p_hi == c_lo and p_rel0 + (p_hi - p_lo) == rel0:
                    view.entries[-1] = (p_lo, c_hi, run, p_rel0)
                    new = new[1:]
            for entry in new:
                view.los.append(entry[0])
                view.entries.append(entry)
            view.hi = hi

    def _flatten_range(self, meta: LogMeta, lo: int, hi: int
                       ) -> List[Tuple[int, int, object, int]]:
        """Resolve [lo, hi) of `meta` (viewer coordinates) into position-
        contiguous ``(c_lo, c_hi, run, rel0)`` entries, iteratively. `shift`
        is viewer_pos - current_log_pos along the chain walk."""
        out: List[Tuple[int, int, object, int]] = []
        stack: List[Tuple] = [("log", meta, lo, hi, 0)]
        while stack:
            item = stack.pop()
            if item[0] == "emit":
                out.append(item[1])
                continue
            _, m, a, b, shift = item
            if a >= b:
                continue
            pushes: List[Tuple] = []
            for seg in m.index.segments(a, b):
                if seg[0] == "local":
                    _, s_lo, s_hi, run = seg
                    c_lo = s_lo + shift
                    pushes.append(("emit", (c_lo, c_lo + (s_hi - s_lo), run,
                                            s_lo - run.start)))
                else:
                    _, g_lo, g_hi, lcount = seg
                    parent = self.logs.get(m.parent, None)
                    if parent is None:
                        raise UnknownLog(
                            f"positions [{g_lo},{g_hi}) unresolvable in log {m.log_id}")
                    pushes.append(("log", parent, g_lo - lcount, g_hi - lcount,
                                   shift + lcount))
            # LIFO stack + reversed pushes = emits arrive in position order
            stack.extend(reversed(pushes))
        return out

    def _view_spans(self, view: _FlatView, lo: int, hi: int,
                    per_record: bool) -> List[Span]:
        if lo >= hi:
            return []
        out: List[Span] = []
        entries = view.entries
        i = bisect.bisect_right(view.los, lo) - 1
        pos = lo
        while pos < hi:
            c_lo, c_hi, run, rel0 = entries[i]
            a = rel0 + (pos - c_lo)
            b = rel0 + (min(hi, c_hi) - c_lo)
            if per_record:
                out.extend(run.record_spans(a, b))
            else:
                out.extend(run.span(a, b))
            pos = c_hi
            i += 1
        return out

    # -- exact (blocking-aware) chain resolver ------------------------------
    def _resolve(self, meta: LogMeta, lo: int, hi: int, out: List[Span],
                 via_promotable: bool, per_record: bool = False) -> None:
        """Iterative HLI resolution (explicit work stack, no Python recursion)
        with the §4.1 per-edge blocking checks, in exact DFS order: blocking
        and unresolvable-position errors are raised when their work item is
        *reached*, matching the recursive formulation's error order."""
        # work items: ("log", meta, lo, hi, via, blocked)  expand a chain level
        #             ("run", run, a, b)                   emit run records
        #             ("span", span)                       emit one naive span
        #             ("missing", log_id, a, b)            deferred UnknownLog
        stack: List[Tuple] = [("log", meta, lo, hi, via_promotable, False)]
        while stack:
            item = stack.pop()
            kind = item[0]
            if kind == "run":
                _, run, a, b = item
                if per_record:
                    out.extend(run.record_spans(a, b))
                else:
                    out.extend(run.span(a, b))
                continue
            if kind == "span":
                out.append(item[1])
                continue
            if kind == "missing":
                _, mid, a, b = item
                raise UnknownLog(f"positions [{a},{b}) unresolvable in log {mid}")
            _, m, a, b, via, blocked = item
            if blocked:
                raise ForkBlocked(
                    f"reads resolving into log {m.log_id} beyond its "
                    "promotable fork point are blocked")
            if a >= b:
                continue
            pushes: List[Tuple] = []
            if isinstance(m.index, NaiveIndex):
                for pos in range(a, b):
                    span = m.index.get(pos)
                    if span is not None:
                        pushes.append(("span", span))
                    else:
                        parent = self.logs.get(m.parent, None)
                        if parent is None:
                            pushes.append(("missing", m.log_id, pos, pos + 1))
                        else:
                            pushes.append(("log", parent, pos, pos + 1, True, False))
                stack.extend(reversed(pushes))
                continue
            for seg in m.index.segments(a, b):
                if seg[0] == "local":
                    _, s_lo, s_hi, run = seg
                    pushes.append(("run", run, s_lo - run.start, s_hi - run.start))
                else:
                    _, g_lo, g_hi, lcount = seg
                    parent = self.logs.get(m.parent, None)
                    if parent is None:
                        pushes.append(("missing", m.log_id, g_lo, g_hi))
                        continue
                    # per-edge exemption: the promotable child itself (or a
                    # frozen stand-in for it) may see the parent beyond the
                    # fork point — it must, to validate. (`via` also carries
                    # the snapshot-origin exemption set in read_spans.)
                    edge_exempt = (via
                                   or m.log_id in parent.promotable_forks
                                   or (m.stands_for is not None
                                       and m.stands_for in parent.promotable_forks))
                    edge_blocked = (not edge_exempt and parent.alive
                                    and self._holds(parent)
                                    and (g_hi - lcount) > self._earliest_fp(parent))
                    pushes.append(("log", parent, g_lo - lcount, g_hi - lcount,
                                   via, edge_blocked))
            stack.extend(reversed(pushes))

    # -------------------------------------------------------------- accounting
    def metadata_bytes(self) -> int:
        return sum(m.index.nbytes() for m in self.logs.values())

    def live_log_ids(self) -> List[int]:
        return sorted(k for k, v in self.logs.items() if v.alive)
