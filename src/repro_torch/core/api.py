"""The agent-session client API (DESIGN.md §12) over the Bolt system.

``BoltSystem`` owns the shared object store, a broker pool, and the replicated
metadata service. ``AgileLog`` is the client handle; it keeps the paper's
Fig. 1 surface (append / read / cFork / sFork / promote / squash) but layers
the three session primitives agents actually program against:

* **Unified receipts** — ``append``/``append_batch`` ALWAYS return an
  :class:`AppendReceipt`: resolved immediately in per-call mode, at flush in
  group-commit mode, with ``position()``/``positions()``/``wait()`` and the
  §4.1 ``withheld`` state. The old mode-dependent
  ``Union[Optional[int], PendingAppend]`` is gone; ``PendingAppend`` is a
  broker-internal detail. A thin legacy shim (``result()``, ``==``/indexing
  against raw positions) keeps pre-§12 callers running, with a
  ``DeprecationWarning`` so CI can ban it in-tree.

* **Speculation sessions** — ``log.speculate()`` wraps the paper's agentic
  validate-then-commit loop (cFork → validate → promote-or-squash) into one
  context-managed transaction: ``commit()`` promotes atomically via the
  metadata layer's conditional ``promote_if`` and auto-rebases onto a fresh
  cFork when the parent advanced, replaying the speculative suffix zero-copy
  (the bytes are already durable — only metadata is re-sequenced); bounded
  retries raise :class:`~repro.core.errors.ConflictError` with fork-point
  diagnostics. ``abort()`` squashes (implicit on exception or unclosed exit).

* **Tailing subscriptions** — ``log.subscribe(from_pos=...)`` yields record
  batches as the visible tail advances: a cooperative poll-with-backoff
  inside, push-shaped iteration outside. The streams layer's consumers are
  built on it.

Fork placement policy (§5.7): a fork is served by a broker *different from its
parent's* (performance isolation) but forks of the same parent are co-located
(cache reuse, less metadata-layer load) unless ``dedicated=True``.

Group commit (DESIGN.md §9) is opt-in via ``BoltSystem(group_commit=...)``:
``True`` for defaults, an int for a record-count flush threshold, or a full
:class:`~repro.core.broker.GroupCommitConfig`. ``BoltSystem.flush()`` (or
leaving the system's ``with`` block) commits all staged records;
``AgileLog.flush()`` commits only this log's staged records; reads of a staged
log flush first, so read-your-writes is preserved.
"""

from __future__ import annotations

import tempfile
import time
import warnings
from dataclasses import dataclass
from typing import (Callable, Dict, Iterator, List, Optional, Sequence, Set,
                    Union)

from .broker import Broker, GroupCommitConfig, PendingAppend
from .compact import (Compactor, CompactionConfig, CompactStats, TierManager,
                      TieringConfig, TierStats)
from .errors import (AgileLogError, BrokerCrashed, ConflictError,
                     InvalidOperation, NoLiveBrokers, UnknownLog)
from .faults import (FaultConfig, FaultPlane, RetryPolicy, RetryStats,
                     run_with_retries)
from .gc import GarbageCollector, GCConfig, GCStats
from .objectstore import (FileObjectStore, MemoryObjectStore, ObjectStore,
                          RangedStore, TieredObjectStore)
from .raft import MetadataService
from .sim import ServeStats, SpecStats


def _legacy(old: str, new: str) -> None:
    warnings.warn(
        f"AppendReceipt.{old} is a pre-§12 compatibility shim; use {new} "
        "instead (DESIGN.md §12, README migration table)",
        DeprecationWarning, stacklevel=3)


class AppendReceipt:
    """Unified ack for one ``append``/``append_batch`` call (DESIGN.md §12).

    One type for both append modes: in per-call mode the receipt is born
    resolved; in group-commit mode it resolves when the owning broker's
    staging buffer flushes. ``wait()`` forces resolution (flushing if
    needed) and raises the append's deterministic error, if any — in
    per-call mode that error already raised at the append call site.

    ``positions()`` is ``None`` when the records committed but an active
    promotable cFork withholds their positions (§4.1) — ``withheld`` spells
    that state out.
    """

    __slots__ = ("_pending",)

    def __init__(self, pending: PendingAppend) -> None:
        self._pending = pending

    # -- the new surface -----------------------------------------------------
    @property
    def count(self) -> int:
        """How many records this receipt acknowledges."""
        return self._pending.n

    @property
    def done(self) -> bool:
        """Resolved yet? (Never forces a flush.)"""
        return self._pending.done

    def wait(self) -> "AppendReceipt":
        """Force resolution: flush the owning broker if still staged, raise
        the deterministic append error if there was one, return self."""
        p = self._pending
        if not p.done:
            fleet = p.broker.fleet
            if fleet is not None:
                # route through the fleet's retry layer (§15): if the owning
                # broker crashes mid-flush, failover re-points p.broker at
                # the adopter and the retry flushes THERE — the receipt
                # resolves with the surviving positions
                fleet._retrying(
                    lambda _a: None if p.done else p.broker.flush())
            else:
                p.broker.flush()
        if p._error is not None:
            raise p._error
        return self

    def positions(self) -> Optional[List[int]]:
        """All assigned positions (waits), or ``None`` when withheld (§4.1)."""
        self.wait()
        p = self._pending._positions
        return None if p is None else list(p)

    def position(self) -> Optional[int]:
        """Position of the first record (waits); ``None`` when withheld."""
        p = self.positions()
        return None if p is None else p[0]

    @property
    def withheld(self) -> bool:
        """True iff committed but positions are hidden by an active
        promotable cFork on the appended log (§4.1). Waits."""
        self.wait()
        return self._pending._positions is None

    def __repr__(self) -> str:
        p = self._pending
        state = ("staged" if not p.done
                 else "failed" if p._error is not None
                 else "withheld" if p._positions is None
                 else f"positions={p._positions}")
        return f"AppendReceipt(log={p.log_id}, n={p.n}, {state})"

    # -- legacy shim (pre-§12 call sites; DeprecationWarning) ----------------
    def result(self) -> Optional[List[int]]:
        _legacy("result()", "wait()/positions()")
        return self.positions()

    def __eq__(self, other: object):
        if isinstance(other, AppendReceipt):
            return self is other
        _legacy("== <raw positions>", "position()/positions()")
        if other is None or isinstance(other, (list, tuple)):
            p = self.positions()
            return (p is None) if other is None else p == list(other)
        if isinstance(other, int):
            return self.position() == other
        return NotImplemented

    __hash__ = object.__hash__

    def __getitem__(self, i: int) -> int:
        _legacy("[...] indexing", "positions()")
        p = self.positions()
        if p is None:
            raise TypeError("positions withheld by a promotable cFork (§4.1)")
        return p[i]

    def __iter__(self) -> Iterator[int]:
        _legacy("iteration", "positions()")
        p = self.positions()
        return iter(p if p is not None else ())


class Subscription:
    """Tailing subscription over one log (DESIGN.md §12).

    Push-shaped on the outside — ``for batch in log.subscribe(...)`` yields
    lists of records in position order as the visible tail advances — and a
    cooperative poll with exponential backoff on the inside. ``poll()`` is
    the non-blocking single step (the streams-layer ``Consumer`` builds on
    it); iteration wraps it:

    * ``follow=False`` — drain mode: stop at the first poll that finds the
      subscription caught up with the visible tail.
    * ``follow=True``  — tail mode: on an idle poll call ``backoff(n_idle)``
      (default: bounded exponential ``time.sleep``) and retry; an optional
      ``max_idle`` bounds consecutive idle polls before stopping.

    The cursor (``position``) only moves on delivery, so a subscription is
    also an exact resume token; reads beyond a promotable hold surface the
    usual §4.1 ``ForkBlocked`` rather than silently stalling.
    """

    def __init__(self, log: "AgileLog", from_pos: int = 0, batch: int = 1024,
                 follow: bool = True, max_idle: Optional[int] = None,
                 backoff: Optional[Callable[[int], None]] = None) -> None:
        if batch <= 0:
            raise InvalidOperation(f"subscribe batch must be positive, got {batch}")
        if from_pos < 0:
            raise InvalidOperation(f"subscribe from_pos must be >= 0, got {from_pos}")
        self.log = log
        self.position = from_pos
        self.batch = batch
        self.follow = follow
        self.max_idle = max_idle
        self._backoff = backoff if backoff is not None else self._default_backoff
        self._idle = 0
        self.polls = 0
        self.idle_polls = 0
        self.delivered = 0

    @staticmethod
    def _default_backoff(idle: int) -> None:
        time.sleep(min(0.0005 * (1 << min(idle, 7)), 0.05))

    def poll(self, max_records: Optional[int] = None) -> List[bytes]:
        """One cooperative poll: up to ``max_records`` (default: ``batch``)
        records at/after the cursor, ``[]`` when caught up. Never blocks."""
        limit = self.batch if max_records is None else max_records
        self.polls += 1
        hi = min(self.log.visible_tail, self.position + limit)
        if hi <= self.position:
            self.idle_polls += 1
            return []
        records = self.log.read(self.position, hi)
        self.position = hi
        self.delivered += len(records)
        return records

    def __iter__(self) -> "Subscription":
        self._idle = 0      # each iteration round gets a fresh idle budget
        return self

    def __next__(self) -> List[bytes]:
        while True:
            records = self.poll()
            if records:
                self._idle = 0
                return records
            if not self.follow:
                raise StopIteration
            self._idle += 1
            if self.max_idle is not None and self._idle >= self.max_idle:
                # reset so a resumed round (the cursor is a resume token)
                # polls max_idle times again instead of stopping instantly
                self._idle = 0
                raise StopIteration
            self._backoff(self._idle)


@dataclass(frozen=True)
class CommitResult:
    """Outcome of a successful ``Speculation.commit()`` (DESIGN.md §12)."""

    log_id: int          # the parent the suffix was committed into
    base: int            # parent position the suffix starts at
    count: int           # suffix records committed
    attempts: int        # promote_if proposals issued (1 + rebases survived)
    rebases: int         # auto-rebases performed over the session's lifetime
    replayed: int        # records re-sequenced by those rebases (zero-copy)

    @property
    def positions(self) -> range:
        """Final positions of the speculative suffix in the parent."""
        return range(self.base, self.base + self.count)


class Speculation:
    """A speculative fork transaction (DESIGN.md §12) — the paper's agentic
    validate-then-commit loop as one primitive.

    Opening a speculation cForks the parent (promotable by default, which
    holds the parent per §4.1: producers keep appending but positions are
    withheld and non-exempt readers cap at the fork point). The handle
    proxies ``append``/``append_batch`` (recording the speculative suffix),
    ``read``/``scan``/``subscribe``/tails onto the fork, then:

    * ``commit()`` proposes the metadata layer's atomic ``promote_if``. If
      the parent advanced past what this session validated, the commit
      **auto-rebases**: squash the stale fork, cFork afresh (the new fork
      point now covers the parent's new records), replay the suffix
      zero-copy (metadata-only re-appends of the already-durable bytes), and
      re-propose — at most ``max_rebases`` times before raising
      :class:`ConflictError` with the metadata layer's fork-point/tail
      diagnostics. An optional ``on_rebase(spec, lo, hi)`` hook sees each
      rebase with the parent's delta at fork positions ``[lo, hi)`` — return
      ``False`` to veto (abort + ``ConflictError``). Losing a promote race
      to a sibling speculation (the first promote squashes us) is handled
      as a conflict too.
    * ``abort()`` squashes the fork. Exiting the ``with`` block on an
      exception — or without having committed — aborts implicitly: an
      uncommitted speculation must not keep holding its parent.

    Non-promotable speculations (``promotable=False``) are read/what-if
    sandboxes: they never hold the parent and cannot ``commit()``.
    """

    def __init__(self, parent: "AgileLog", promotable: bool = True,
                 dedicated: bool = False, max_rebases: int = 3,
                 on_rebase: Optional[Callable[["Speculation", int, int],
                                              Optional[bool]]] = None,
                 mode: Optional[str] = None) -> None:
        self.parent = parent
        self.promotable = promotable
        self.max_rebases = max_rebases
        self.on_rebase = on_rebase
        self._dedicated = dedicated
        self._mode = mode
        self._stats: SpecStats = parent.system.spec_stats
        self._stats.sessions += 1
        self.log: AgileLog = parent.cfork(promotable=promotable,
                                          dedicated=dedicated)
        self._base = self._info().fork_point
        self._suffix: List[AppendReceipt] = []
        self._state = "open"          # open | committed | aborted
        self.rebases = 0
        self.replayed = 0
        # registered while open so the §14 compactor can exclude this
        # session's durable receipt segments from rewrite candidates: a
        # rebase replays those (object, offsets) tuples verbatim
        parent.system._live_specs.add(self)

    # -- proxied log surface -------------------------------------------------
    def _info(self):
        return self.parent.system.metadata.read_state().fork_info(
            self.log.log_id)

    def _require_open(self) -> None:
        if self._state != "open":
            raise InvalidOperation(f"speculation already {self._state}")

    def append(self, record: bytes) -> AppendReceipt:
        self._require_open()
        receipt = self.log.append(record)
        self._suffix.append(receipt)
        return receipt

    def append_batch(self, records: Sequence[bytes]) -> AppendReceipt:
        self._require_open()
        receipt = self.log.append_batch(records)
        self._suffix.append(receipt)
        return receipt

    def read(self, lo: int, hi: int) -> List[bytes]:
        return self.log.read(lo, hi)

    def scan(self, lo: int = 0, hi: Optional[int] = None,
             batch: int = 1024) -> Iterator[bytes]:
        return self.log.scan(lo, hi, batch)

    def subscribe(self, **kwargs) -> Subscription:
        return self.log.subscribe(**kwargs)

    @property
    def tail(self) -> int:
        return self.log.tail

    @property
    def fork_point(self) -> int:
        """Parent position the CURRENT fork branched at (moves on rebase)."""
        return self._base

    @property
    def parent_advanced(self) -> int:
        """Parent records sequenced since the current fork point — what a
        ``commit()`` right now would have to rebase over."""
        self.parent._sync()
        return self._info().advanced

    @property
    def suffix_len(self) -> int:
        return sum(r.count for r in self._suffix)

    # -- transaction ---------------------------------------------------------
    def commit(self, mode: Optional[str] = None) -> CommitResult:
        """Promote the speculation atomically; auto-rebase on conflict."""
        self._require_open()
        mode = mode if mode is not None else self._mode
        system = self.parent.system
        for receipt in self._suffix:
            receipt.wait()           # surface deferred append errors first
        attempts = 0
        while True:
            attempts += 1
            self.log._sync()         # sequence any still-staged suffix records
            try:
                outcome = system.metadata.propose(
                    ("promote_if", self.log.log_id, self._base, mode))
            except UnknownLog:
                # a sibling speculation promoted first and squashed us (§4.1
                # first-promote-wins): same client-visible story as a
                # parent-advanced conflict — rebase onto the merged parent
                outcome = ("conflict", None)
            if outcome[0] == "ok":
                base, count = outcome[1]
                self._state = "committed"
                system._live_specs.discard(self)
                self._stats.commits += 1
                system._gc_nudge()   # promote may have squashed rivals (§13)
                return CommitResult(log_id=self.parent.log_id, base=base,
                                    count=count, attempts=attempts,
                                    rebases=self.rebases,
                                    replayed=self.replayed)
            diag = outcome[1] or {}
            self._stats.conflicts += 1
            if attempts > self.max_rebases:
                self._abort(squash=True)
                why = (f"parent {diag['log_id']} advanced {diag['advanced']} "
                       f"records past the validated tail {self._base}"
                       if diag else
                       f"a sibling speculation promoted first into parent "
                       f"{self.parent.log_id}")
                raise ConflictError(
                    f"speculative commit lost to {attempts} conflict(s) "
                    f"(max_rebases={self.max_rebases}): {why}",
                    log_id=diag.get("log_id", self.parent.log_id),
                    fork_id=diag.get("fork_id"),
                    fork_point=diag.get("fork_point", self._base),
                    parent_tail=diag.get("parent_tail"),
                    expected=diag.get("expected", self._base),
                    advanced=diag.get("advanced", 0),
                    attempts=attempts,
                    holds_epoch=diag.get("holds_epoch"))
            old_base = self._base
            self._rebase()
            if self.on_rebase is not None:
                if self.on_rebase(self, old_base, self._base) is False:
                    self._abort(squash=True)
                    raise ConflictError(
                        "on_rebase validation rejected the parent's delta "
                        f"[{old_base},{self._base})",
                        log_id=self.parent.log_id, fork_point=self._base,
                        expected=old_base, advanced=self._base - old_base,
                        attempts=attempts)

    def _rebase(self) -> None:
        """Squash the stale fork, cFork at the parent's new tail, and replay
        the speculative suffix ZERO-COPY: the records are already durable in
        shared storage (each receipt carries its segment reference), so the
        replay is one metadata proposal per original append — no object PUT,
        no payload bytes moved (DESIGN.md §12)."""
        segments = [r._pending.segment for r in self._suffix
                    if r._pending.segment is not None and r.count > 0]
        # pin the suffix segments for the squash -> replay window (§13): the
        # squash drops their manifest refcounts — possibly to zero when this
        # fork was their only lineage — and a GC quantum sequenced between
        # the squash and the replay would otherwise reclaim bytes the replay
        # is about to re-index. Pins ride into the `gc` command, so the skip
        # is consensus-ordered too.
        collector = self.parent.system.collector
        pin_ids = {object_id for object_id, _offs, _lens in segments}
        collector.pin(pin_ids)
        try:
            try:
                self.log.squash()
            except AgileLogError:
                pass                  # already squashed by the winning sibling
            self.log = self.parent.cfork(promotable=self.promotable,
                                         dedicated=self._dedicated)
            self._base = self._info().fork_point
            replayed: List[AppendReceipt] = []
            n = 0
            for object_id, offsets, lengths in segments:
                pending = self.log._b().replay(self.log.log_id, object_id,
                                               offsets, lengths)
                replayed.append(AppendReceipt(pending))
                n += len(offsets)
        finally:
            collector.unpin(pin_ids)
        self._suffix = replayed
        self.rebases += 1
        self.replayed += n
        self._stats.rebases += 1
        self._stats.replayed_records += n

    def abort(self) -> None:
        """Squash the speculation; idempotent once the session is closed."""
        if self._state == "open":
            self._abort(squash=True)

    def _abort(self, squash: bool) -> None:
        self._state = "aborted"
        self.parent.system._live_specs.discard(self)
        self._stats.aborts += 1
        if squash:
            try:
                self.log.squash()
            except AgileLogError:
                pass                  # fork already gone (lost promote race)
        # eager hand-off (§13): the squash just released this session's
        # private suffix segments — don't leave them for a later sweep
        self.parent.system._gc_nudge()

    # -- context manager -----------------------------------------------------
    def __enter__(self) -> "Speculation":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # an uncommitted speculation must not outlive its block: it would
        # keep holding the parent (§4.1) with nobody left to resolve it
        if self._state == "open":
            self.abort()

    def __repr__(self) -> str:
        return (f"Speculation(parent={self.parent.log_id}, "
                f"fork={self.log.log_id}, base={self._base}, "
                f"suffix={self.suffix_len}, state={self._state})")


class BoltSystem:
    def __init__(self, n_brokers: int = 4, store: Optional[ObjectStore] = None,
                 n_meta_replicas: int = 3, snapshot_every: int = 0,
                 cf_mode: str = "ltt", fork_mode: str = "zerocopy",
                 promote_mode: str = "copy",
                 group_commit: Union[None, bool, int, GroupCommitConfig] = None,
                 cache_bytes: int = 64 << 20,
                 cache_page_bytes: int = 64 << 10,
                 readahead_bytes: int = 256 << 10,
                 view_cache: bool = True,
                 pipeline_apply: bool = True,
                 gc: Union[None, bool, int, GCConfig] = None,
                 compaction: Union[None, bool, int, CompactionConfig] = None,
                 tiering: Union[None, bool, int, TieringConfig] = None,
                 faults: Union[None, bool, FaultConfig, FaultPlane] = None,
                 retry: Optional[RetryPolicy] = None,
                 store_backend: Optional[str] = None,
                 store_root: Optional[str] = None,
                 pipelined_io: bool = False) -> None:
        if group_commit is True:
            group_commit = GroupCommitConfig()
        elif group_commit is False or group_commit == 0:
            group_commit = None   # falsy: group commit off
        elif isinstance(group_commit, int):
            if group_commit < 0:
                raise ValueError(f"group_commit batch size must be >= 0, got {group_commit}")
            group_commit = GroupCommitConfig(max_records=group_commit)
        elif group_commit is not None and not isinstance(group_commit, GroupCommitConfig):
            raise TypeError(f"group_commit must be None, bool, int, or "
                            f"GroupCommitConfig, got {type(group_commit).__name__}")
        self.group_commit: Optional[GroupCommitConfig] = group_commit
        # -- cold tiering (DESIGN.md §14). Same shape as `gc`: None/False ->
        # tiering off (plain store, TierManager quanta are no-ops), True ->
        # tiered store + background demotion quanta, int -> auto with that
        # min demotion age, TieringConfig -> as given (store is tiered even
        # when auto is off, for explicit demote()/resync() driving).
        if tiering is True:
            tiering = TieringConfig(auto=True)
        elif isinstance(tiering, bool) or tiering is None:   # False or None
            tiering = None
        elif isinstance(tiering, int):
            if tiering <= 0:
                raise ValueError(f"tiering min_age must be positive, got {tiering}")
            tiering = TieringConfig(min_age=tiering, auto=True)
        elif not isinstance(tiering, TieringConfig):
            raise TypeError(f"tiering must be None, bool, int, or TieringConfig, "
                            f"got {type(tiering).__name__}")
        # -- store backend selection (DESIGN.md §18). `store_backend` names
        # one of the protocol backends; `store=` passes an instance directly
        # (mutually exclusive). "file" roots at `store_root` (a fresh
        # tempdir when omitted); "tiered" composes with `tiering=`.
        if store_backend is not None:
            if store is not None:
                raise TypeError("pass store= or store_backend=, not both")
            if store_backend == "memory":
                store = MemoryObjectStore()
            elif store_backend == "file":
                if store_root is None:
                    store_root = tempfile.mkdtemp(prefix="agilelog-store-")
                store = FileObjectStore(store_root)
            elif store_backend == "ranged":
                store = RangedStore()
            elif store_backend == "tiered":
                store = TieredObjectStore()
            else:
                raise ValueError(
                    f"unknown store_backend {store_backend!r}: expected "
                    f"'memory', 'file', 'ranged', or 'tiered'")
        if store is None:
            store = TieredObjectStore() if tiering is not None else MemoryObjectStore()
        elif tiering is not None and not isinstance(store, TieredObjectStore):
            raise TypeError(
                f"tiering requires a TieredObjectStore (two store classes, "
                f"§14), got {type(store).__name__}")
        self.store = store
        self.metadata = MetadataService(
            n_replicas=n_meta_replicas, snapshot_every=snapshot_every,
            pipeline_apply=pipeline_apply,
            cf_mode=cf_mode, fork_mode=fork_mode, promote_mode=promote_mode,
            view_cache=view_cache)
        self.brokers = [Broker(i, self.store, self.metadata,
                               cache_bytes=cache_bytes,
                               cache_page_bytes=cache_page_bytes,
                               readahead_bytes=readahead_bytes,
                               group_commit=group_commit)
                        for i in range(max(2, n_brokers))]
        for b in self.brokers:
            b.pipelined_io = pipelined_io   # PUT ∥ propose ack overlap (§18)
        self._fork_broker: Dict[int, int] = {}   # parent log -> broker for its forks
        self._next_broker = 1
        self._dead: Set[int] = set()             # failed broker ids
        self.spec_stats = SpecStats()            # session counters (§12)
        self.serve_stats = ServeStats()          # serving counters (§17)
        # -- segment GC (DESIGN.md §13). Manifest accounting in the metadata
        # layer is always on; `gc` only shapes the reaper: None -> manual
        # (explicit system.gc()/gc_quantum()), True -> background quanta on
        # churn hand-off points (abort/close/squash/promote), int -> auto
        # with that per-quantum batch, or a full GCConfig.
        if gc is True:
            gc = GCConfig(auto=True)
        elif gc is False or gc is None:
            gc = GCConfig()
        elif isinstance(gc, int):
            if gc <= 0:
                raise ValueError(f"gc batch size must be positive, got {gc}")
            gc = GCConfig(batch=gc, auto=True)
        elif not isinstance(gc, GCConfig):
            raise TypeError(f"gc must be None, bool, int, or GCConfig, "
                            f"got {type(gc).__name__}")
        self.collector = GarbageCollector(self, gc)
        # -- segment compaction (DESIGN.md §14). Same shape as `gc`: None ->
        # manual (explicit system.compact()/compact_quantum()), True -> auto
        # quanta on churn hand-off points, int -> auto with that per-quantum
        # source batch, or a full CompactionConfig.
        if compaction is True:
            compaction = CompactionConfig(auto=True)
        elif compaction is False or compaction is None:
            compaction = CompactionConfig()
        elif isinstance(compaction, int):
            if compaction <= 0:
                raise ValueError(
                    f"compaction batch size must be positive, got {compaction}")
            compaction = CompactionConfig(batch=compaction, auto=True)
        elif not isinstance(compaction, CompactionConfig):
            raise TypeError(f"compaction must be None, bool, int, or "
                            f"CompactionConfig, got {type(compaction).__name__}")
        self.compactor = Compactor(self, compaction)
        self.tiers = TierManager(self, tiering or TieringConfig())
        self._tiering_auto = tiering is not None and tiering.auto
        self._live_specs: Set[Speculation] = set()   # open sessions (§14 exclusion)
        if isinstance(self.store, TieredObjectStore):
            for b in self.brokers:
                b.tiering = self.tiers   # read-path promotion hook (§14)
        # -- fault plane + retry policy (DESIGN.md §15). Same config shape:
        # None/False -> no plane (every path below is byte-identical to the
        # pre-§15 system: no retries, no token wrapping, no fault draws),
        # True -> a plane with the default seed and all probabilities zero
        # (deterministic schedules can still be driven via plane.advance()),
        # FaultConfig -> a fresh plane over it, FaultPlane -> as given.
        if faults is True:
            faults = FaultPlane(FaultConfig())
        elif faults is False or faults is None:
            faults = None
        elif isinstance(faults, FaultConfig):
            faults = FaultPlane(faults)
        elif not isinstance(faults, FaultPlane):
            raise TypeError(f"faults must be None, bool, FaultConfig, or "
                            f"FaultPlane, got {type(faults).__name__}")
        self.faults: Optional[FaultPlane] = faults
        self.retry = retry if retry is not None else RetryPolicy()
        self.retry_stats = RetryStats()   # shared with the metadata layer
        self.broker_failovers = 0
        if faults is not None:
            faults.bind(self)
            self.store.attach_faults(faults)
            self.metadata.faults = faults
            self.metadata.retry = self.retry
            self.metadata.retry_stats = self.retry_stats
            for b in self.brokers:
                b.faults = faults
        for b in self.brokers:
            b.fleet = self   # receipts route flush through retry/failover

    # -- group commit (DESIGN.md §9) ------------------------------------------------
    def flush(self) -> None:
        """Commit every broker's staging buffer (no-op when group commit is
        off). With a fault plane active, each flush runs under the retry
        policy: a broker that crashes mid-flush fails over and the re-routed
        staging commits through its survivor."""
        for b in self.brokers:
            if b.broker_id in self._dead:
                continue
            self._retrying(lambda _a, b=b: self.live_broker(b).flush())

    # -- segment GC (DESIGN.md §13) -------------------------------------------------
    def gc(self, arrival: Optional[float] = None) -> GCStats:
        """Drain reclamation: one unbounded consensus-ordered ``gc`` command
        reclaims every currently-dead segment object, the reaper deletes them
        from shared storage and invalidates broker cache pages. Returns
        :class:`GCStats` (``pending`` > 0 afterwards only for pinned ids)."""
        return self.collector.collect(arrival=arrival)

    def gc_quantum(self, limit: Optional[int] = None,
                   arrival: Optional[float] = None) -> List[str]:
        """One incremental background GC step (up to the configured batch);
        returns the object ids reclaimed this quantum."""
        return self.collector.quantum(limit=limit, arrival=arrival)

    @property
    def gc_stats(self) -> GCStats:
        return self.collector.stats()

    def _gc_nudge(self) -> None:
        """Churn hand-off point (abort/close/squash/promote): in auto mode,
        run a quantum so dead suffixes are reclaimed as they die rather than
        at the next explicit drain. The pending check keeps no-op nudges from
        spending a consensus round. Auto compaction and tier demotion ride
        the same hand-off points (§14)."""
        if (self.collector.config.auto
                and self.metadata.state.gc_pending() > 0):
            self.collector.quantum()
        if self.compactor.config.auto and self.compactor.candidates():
            self.compactor.quantum()
        if self._tiering_auto:
            self.tiers.demote_quantum()

    # -- segment compaction + cold tiering (DESIGN.md §14) --------------------------
    def compact(self, arrival: Optional[float] = None) -> CompactStats:
        """Drain compaction: rewrite every object under the live-byte-ratio
        threshold onto fresh compacted objects (one consensus-ordered
        ``compact`` swap per batch) and hand the retired sources to the §13
        reaper. Returns :class:`CompactStats`."""
        return self.compactor.compact(arrival=arrival)

    def compact_quantum(self, arrival: Optional[float] = None) -> List[str]:
        """One incremental compaction step; returns the source object ids
        retired by this quantum's swap ([] when idle or stale)."""
        return self.compactor.quantum(arrival=arrival)

    @property
    def compact_stats(self) -> CompactStats:
        return self.compactor.stats()

    def demote(self, arrival: Optional[float] = None) -> TierStats:
        """Drain tier demotion: move every age-eligible compacted object to
        the cold store class (consensus-ordered). No-op on untiered stores."""
        return self.tiers.demote(arrival=arrival)

    def demote_quantum(self, arrival: Optional[float] = None) -> List[str]:
        """One incremental demotion step; returns the object ids demoted."""
        return self.tiers.demote_quantum(arrival=arrival)

    @property
    def tier_stats(self) -> TierStats:
        return self.tiers.stats()

    def _session_segments(self) -> Set[str]:
        """Durable segment objects referenced by open speculation sessions'
        receipts (§14): a rebase replay re-proposes these verbatim, so the
        compactor must not rewrite them out from under the receipts."""
        out: Set[str] = set()
        for spec in self._live_specs:
            for receipt in spec._suffix:
                segment = receipt._pending.segment
                if segment is not None:
                    out.add(segment[0])
        return out

    def __enter__(self) -> "BoltSystem":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # only flush on clean exit: a failing flush must not mask the body's
        # in-flight exception (staged records were never acked; the caller can
        # still flush() manually after handling the error)
        if exc_type is None:
            self.flush()

    # -- placement ----------------------------------------------------------------
    def _broker_for_root(self) -> Broker:
        return self.brokers[0]

    def _pick_fork_broker(self, parent_broker: int) -> int:
        """Next round-robin broker that is NOT the parent's and is live.

        The seed's re-map ``(b % (len-1)) + 1`` could land back on
        ``parent_broker`` (e.g. 2 brokers, parent on broker 1), silently
        violating the isolation placement rule — so after the round-robin
        pass, fall back to an explicit search over every other live broker
        (including broker 0) before giving up and co-locating."""
        n = len(self.brokers)
        for _ in range(max(1, n - 1)):
            b = self._next_broker
            self._next_broker = (self._next_broker % (n - 1)) + 1
            if b != parent_broker and b not in self._dead:
                return b
        for b in range(n):
            if b != parent_broker and b not in self._dead:
                return b
        return parent_broker   # degenerate: no other live broker exists

    def _broker_for_fork(self, parent_log: int, parent_broker: int,
                         dedicated: bool) -> Broker:
        if dedicated:
            return self.brokers[self._pick_fork_broker(parent_broker)]
        b = self._fork_broker.get(parent_log)
        if b is None or b == parent_broker:
            b = self._pick_fork_broker(parent_broker)
            self._fork_broker[parent_log] = b
        return self.brokers[b]

    # -- entry point ----------------------------------------------------------------
    def create_log(self, name: str) -> "AgileLog":
        log_id = self.metadata.propose(("create_root", name))
        return AgileLog(self, log_id, self._broker_for_root())

    def open_log(self, log_id: int) -> "AgileLog":
        """Fresh client handle for an EXISTING log id — the re-attach path
        (DESIGN.md §17): checkpoint manifests and serving catalogs record
        fork ids durably, and a restarted process opens them by id. Brokers
        are stateless, so the handle routes through the normal placement
        map (forks keep their isolation broker, roots stay on broker 0)."""
        meta = self.metadata.read_state().logs.get(log_id)
        if meta is None or not meta.alive:
            raise UnknownLog(f"log {log_id} does not exist or is dead")
        if meta.kind == "root" or meta.parent is None:
            return AgileLog(self, log_id, self._broker_for_root())
        broker = self._broker_for_fork(
            meta.parent, self._broker_for_root().broker_id, dedicated=False)
        return AgileLog(self, log_id, broker)

    def find_log(self, name: str) -> Optional["AgileLog"]:
        """Root log by exact name, or None — the lookup half of the
        re-attach path (``create_log`` is not idempotent: calling it twice
        makes two roots). Newest wins if names were reused."""
        state = self.metadata.read_state()
        for log_id in sorted(state.logs, reverse=True):
            meta = state.logs[log_id]
            if meta.kind == "root" and meta.name == name and meta.alive:
                return AgileLog(self, log_id, self._broker_for_root())
        return None

    # -- broker failover (straggler mitigation §6; crash recovery §15) --------------
    def fail_broker(self, broker_id: int) -> None:
        """Mark a broker dead and fail its staged group-commit records OVER
        to a surviving broker (DESIGN.md §15): brokers are stateless (§5.2),
        so the only broker-private state is the object cache (rebuildable)
        and the unflushed staging buffer. The staged records were never
        acked, so re-routing them preserves exactly-once: the survivor's
        next flush commits them under a fresh segment id, and the receipts
        resolve with the surviving positions. Orphaned PUTs the crashed
        broker noted (torn or unproposed segments) go to the §13 reaper's
        resync path. Only with NO survivor do the pendings fail."""
        if broker_id in self._dead:
            return
        self._dead.add(broker_id)
        dead = self.brokers[broker_id]
        for parent, b in list(self._fork_broker.items()):
            if b == broker_id:
                del self._fork_broker[parent]
        self.collector.note_orphans(dead.take_orphans())
        staged = dead.take_staging()
        if not staged:
            return
        survivor = next((b for b in self.brokers
                         if b.broker_id not in self._dead), None)
        if survivor is None:
            for pending, _records in staged:
                pending._fail(NoLiveBrokers(
                    f"broker {broker_id} failed with no live peer; "
                    f"append not committed"), 0.0)
            return
        survivor.adopt_staging(staged)
        self.broker_failovers += 1

    def recover_broker(self, broker_id: int) -> None:
        """Restart a dead broker (DESIGN.md §15). Brokers are stateless
        (§5.2), so recovery is just rejoining the fleet: the cache refills
        on demand and staging starts empty. Any orphan PUT notes it carried
        were already handed to the §13 reaper at failure time."""
        self._dead.discard(broker_id)

    # -- network partitions (DESIGN.md §16) --------------------------------
    def partition(self, *groups) -> None:
        """Partition the metadata replica network into ``groups`` (iterables
        of replica ids): traffic crosses group boundaries in neither
        direction until :meth:`heal_network`. Convenience front for
        ``faults.net.partition`` — requires a fault plane."""
        assert self.faults is not None, "partition() needs a fault plane"
        self.faults.net.partition(*groups)

    def heal_network(self) -> None:
        """Lift every partition (symmetric and one-way) and deliver delayed
        in-flight messages; replica reconciliation then happens through
        normal AppendEntries traffic (``sync_followers`` / the next
        ``check_convergence``)."""
        assert self.faults is not None, "heal_network() needs a fault plane"
        self.faults.net.heal()
        self.faults.net.flush()

    def live_broker(self, preferred: Broker) -> Broker:
        if preferred.broker_id not in self._dead:
            return preferred
        for b in self.brokers:
            if b.broker_id not in self._dead:
                return b
        raise NoLiveBrokers("no live brokers")

    # -- data-plane retry (DESIGN.md §15) -------------------------------------------
    def _retrying(self, fn):
        """Run a data-plane operation under the client retry policy when a
        fault plane is active (plain synchronous call otherwise). On a
        :class:`BrokerCrashed` the crashed broker is failed over BEFORE the
        backoff, so the retry routes through a survivor via ``live_broker``.
        Metadata-level transients never reach here with budget left — the
        metadata layer retries them internally with the SAME idempotency
        token — and its ``RetryBudgetExhausted`` is not re-retried (the
        helper re-raises it immediately), so budgets never multiply."""
        plane = self.faults
        if plane is None or not plane.enabled:
            return fn(1)

        def attempt(i):
            try:
                return fn(i)
            except BrokerCrashed as e:
                if e.broker_id is not None:
                    self.fail_broker(e.broker_id)
                raise

        return run_with_retries(attempt, self.retry, plane.rng,
                                stats=self.retry_stats)


class AgileLog:
    """Client handle for one log (root or fork): Figure 1's interface plus
    the §12 session primitives (receipts, speculate, subscribe)."""

    def __init__(self, system: BoltSystem, log_id: int, broker: Broker) -> None:
        self.system = system
        self.log_id = log_id
        self.broker = broker

    # -- traditional shared-log API --------------------------------------------------
    def _b(self) -> Broker:
        """Current broker, re-routed if ours failed (stateless brokers)."""
        b = self.system.live_broker(self.broker)
        if b is not self.broker:
            self.broker = b
        return b

    def _sync(self) -> Broker:
        """Broker handle with this log's staged records committed: metadata
        operations (tails, forks, promote, squash) must observe the caller's
        own prior appends (read-your-writes, DESIGN.md §9), so they flush a
        staging buffer holding records of this log first."""
        self.system._retrying(
            lambda _a: self._b()._flush_if_staged(self.log_id))
        return self._b()

    def append(self, record: bytes) -> AppendReceipt:
        """Append one record; always returns an :class:`AppendReceipt` —
        resolved immediately in per-call mode (deterministic errors raise
        here), at flush in group-commit mode (errors raise at ``wait()``).
        With a fault plane active (§15) transient failures retry under the
        client policy, failing over to a surviving broker if ours crashes."""
        return AppendReceipt(self.system._retrying(
            lambda _a: self._b().submit(self.log_id, [record])))

    def append_batch(self, records: Sequence[bytes]) -> AppendReceipt:
        """Append a batch atomically; one receipt covering every record."""
        recs = list(records)
        return AppendReceipt(self.system._retrying(
            lambda _a: self._b().submit(self.log_id, recs)))

    def flush(self) -> None:
        """Commit this log's staged records (group commit, DESIGN.md §9).
        Only flushes the broker staging buffer if records of THIS log are in
        it — other logs' staged batches keep accumulating. Use
        ``BoltSystem.flush()`` for the global flush."""
        self.system._retrying(
            lambda _a: self._b()._flush_if_staged(self.log_id))

    def read(self, lo: int, hi: int) -> List[bytes]:
        records, _ = self.system._retrying(
            lambda _a: self._b().read_records(self.log_id, lo, hi))
        return records

    def scan(self, lo: int = 0, hi: Optional[int] = None,
             batch: int = 1024) -> Iterator[bytes]:
        """Stream records [lo, hi) in position order (DESIGN.md §10).

        The agent catch-up pattern: one metadata resolution + one
        scatter-gather ranged-GET round per ``batch`` positions, with the
        broker cache's sequential readahead prefetching ahead of the cursor —
        instead of a chain walk and a GET per record. ``hi=None`` snapshots
        the visible tail when ``scan`` is called; records appended afterwards
        are not included. Validation is eager (this returns a generator, but
        bad ``batch``/bounds raise here, at the call site, exactly as
        ``read`` would)."""
        if batch <= 0:
            raise InvalidOperation(f"scan batch must be positive, got {batch}")
        self._sync()
        state = self.system.metadata.read_state()
        if hi is None:
            hi = state.visible_tail(self.log_id)
        tail = state.tail(self.log_id)
        if not (0 <= lo <= hi <= tail):
            raise InvalidOperation(f"scan [{lo},{hi}) out of range (tail {tail})")
        return self._scan_iter(lo, hi, batch)

    def _scan_iter(self, lo: int, hi: int, batch: int) -> Iterator[bytes]:
        # each chunk re-resolves the broker AND runs under the retry policy:
        # a scan survives its broker dying mid-iteration (§15) — the next
        # chunk (or the retried current one) reads through a survivor
        pos = lo
        while pos < hi:
            chunk_hi = min(pos + batch, hi)
            records, _ = self.system._retrying(
                lambda _a, lo_=pos, hi_=chunk_hi:
                    self._b().read_records(self.log_id, lo_, hi_))
            yield from records
            pos = chunk_hi

    def subscribe(self, from_pos: int = 0, batch: int = 1024,
                  follow: bool = True, max_idle: Optional[int] = None,
                  backoff: Optional[Callable[[int], None]] = None
                  ) -> Subscription:
        """Tailing subscription from ``from_pos`` (DESIGN.md §12): iterate
        for batches as the visible tail advances, or drive it one
        ``poll()`` at a time."""
        return Subscription(self, from_pos=from_pos, batch=batch,
                            follow=follow, max_idle=max_idle, backoff=backoff)

    @property
    def tail(self) -> int:
        self._sync()
        return self.system.metadata.read_state().tail(self.log_id)

    @property
    def visible_tail(self) -> int:
        self._sync()
        return self.system.metadata.read_state().visible_tail(self.log_id)

    # -- forking -----------------------------------------------------------------------
    def cfork(self, promotable: bool = False, dedicated: bool = False) -> "AgileLog":
        self._sync()
        child_id = self.system.metadata.propose(("cfork", self.log_id, promotable))
        broker = self.system._broker_for_fork(self.log_id, self.broker.broker_id,
                                              dedicated)
        return AgileLog(self.system, child_id, broker)

    def sfork(self, past: Optional[int] = None, dedicated: bool = False) -> "AgileLog":
        self._sync()
        child_id = self.system.metadata.propose(("sfork", self.log_id, past))
        broker = self.system._broker_for_fork(self.log_id, self.broker.broker_id,
                                              dedicated)
        return AgileLog(self.system, child_id, broker)

    def speculate(self, promotable: bool = True, dedicated: bool = False,
                  max_rebases: int = 3,
                  on_rebase: Optional[Callable[[Speculation, int, int],
                                               Optional[bool]]] = None,
                  mode: Optional[str] = None) -> Speculation:
        """Open a speculative fork transaction against this log
        (DESIGN.md §12): ``with log.speculate() as s: ... s.commit()``."""
        if promotable is False and on_rebase is not None:
            raise InvalidOperation(
                "on_rebase only applies to promotable speculations")
        return Speculation(self, promotable=promotable, dedicated=dedicated,
                           max_rebases=max_rebases, on_rebase=on_rebase,
                           mode=mode)

    def promote(self, mode: Optional[str] = None) -> bool:
        self._sync()
        result = self.system.metadata.propose(("promote", self.log_id, mode))
        self.system._gc_nudge()   # restructure may have freed segments (§13)
        return result

    def squash(self) -> None:
        self._sync()
        self.system.metadata.propose(("squash", self.log_id))
        self.system._gc_nudge()   # dead-lineage hand-off (§13)

    def close(self) -> None:
        """Release this handle's log (DESIGN.md §13): flush any staged
        records, and — for a FORK — squash it, eagerly handing its private
        suffix segments to GC (the next quantum reclaims whatever no other
        lineage references). A root log only flushes: closing a handle must
        not destroy the shared stream. Idempotent: closing a handle whose
        fork is already gone (squashed, or promoted away) is a no-op."""
        b = self._b()
        b._flush_if_staged(self.log_id)
        meta = self.system.metadata.state.logs.get(self.log_id)
        if meta is not None and meta.alive and meta.kind != "root":
            try:
                self.system.metadata.propose(("squash", self.log_id))
            except AgileLogError:
                pass              # blocked/raced away: nothing to hand over
        self.system._gc_nudge()

    def __repr__(self) -> str:
        return f"AgileLog(id={self.log_id}, broker={self.broker.broker_id})"
