"""Stateless brokers (§5.2-5.3, DESIGN.md §6): the diskless data plane.

A broker owns no durable state: appends batch client records into a single
object, PUT it to shared storage, then sequence the per-record metadata through
the metadata layer (steps a1-a7 of Fig. 3). Reads resolve byte spans at the
metadata layer and ranged-GET them from shared storage through a local object
cache (r1-r7).

With *group commit* enabled (DESIGN.md §9) the broker additionally amortizes
the data- and metadata-plane round trips across concurrent appenders: records
are staged into a per-broker buffer and flushed — by record-count, byte, or
DES-time policy — as ONE segment object PUT plus ONE batched metadata proposal
covering every staged log. Appenders get a :class:`PendingAppend` that
resolves to their assigned positions when the flush commits.

Brokers double as DES resources for the isolation benchmarks: when a
:class:`~repro.core.sim.Simulator` is attached, each operation also books
simulated service time on this broker's queue (and the shared store's), which
is how contention (or its absence) is measured without real hardware.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from . import errors as _errors
from .errors import AgileLogError, BrokerCrashed, Unavailable
from .objectstore import LRUObjectCache, ObjectStore, SegmentWriter
from .sim import Resource, ServiceTimes, Simulator

_obj_counter = itertools.count()


@dataclass
class GroupCommitConfig:
    """Flush policy for the group-commit staging buffer (DESIGN.md §9).

    A flush is triggered by whichever bound is hit first: staged record count,
    staged payload bytes, or — when appends carry DES arrival times — a record
    arriving more than ``max_delay`` simulated seconds after the oldest staged
    one. Explicit ``flush()`` and reads of a staged log also flush.
    """

    max_records: int = 64
    max_bytes: int = 1 << 20
    max_delay: float = 500e-6


class PendingAppend:
    """Deferred ack for a staged append: resolves at flush commit.

    ``result()`` forces a flush of the owning broker if the batch has not
    committed yet, then returns the assigned positions (or ``None`` when an
    active promotable cFork withholds them, §4.1) or raises the deterministic
    error the metadata layer produced for this log.

    ``segment`` is set when the records become durable: the
    ``(object_id, offsets, lengths)`` triple locating this append's bytes in
    shared storage. The session layer's rebase replay (DESIGN.md §12) re-
    sequences those already-durable records through :meth:`Broker.replay`
    without ever re-PUTting them. This is a broker-internal type — clients
    see :class:`~repro.core.api.AppendReceipt`.
    """

    __slots__ = ("broker", "log_id", "n", "done", "done_time", "segment",
                 "_positions", "_error")

    def __init__(self, broker: "Broker", log_id: int, n: int) -> None:
        self.broker = broker
        self.log_id = log_id
        self.n = n
        self.done = False
        self.done_time = 0.0
        self.segment: Optional[Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = None
        self._positions: Optional[List[int]] = None
        self._error: Optional[Exception] = None

    def _resolve(self, positions: Optional[List[int]], done_time: float) -> None:
        self._positions = positions
        self.done = True
        self.done_time = done_time

    def _fail(self, error: Exception, done_time: float) -> None:
        self._error = error
        self.done = True
        self.done_time = done_time

    def result(self) -> Optional[List[int]]:
        if not self.done:
            self.broker.flush()
        if self._error is not None:
            raise self._error
        return self._positions


class Broker:
    def __init__(self, broker_id: int, store: ObjectStore, metadata,
                 cache_bytes: int = 64 << 20,
                 cache_page_bytes: int = 64 << 10,
                 readahead_bytes: int = 256 << 10,
                 sim: Optional[Simulator] = None,
                 service: Optional[ServiceTimes] = None,
                 store_resource: Optional[Resource] = None,
                 group_commit: Optional[GroupCommitConfig] = None) -> None:
        self.broker_id = broker_id
        self.store = store
        self.metadata = metadata
        self.cache = LRUObjectCache(store, cache_bytes,
                                    page_bytes=cache_page_bytes,
                                    readahead_bytes=readahead_bytes)
        # group-commit staging (DESIGN.md §9)
        self.group_commit = group_commit
        self._staged: List[Tuple[PendingAppend, List[bytes]]] = []
        self._staged_bytes = 0
        self._staged_records = 0
        self._staged_first_arrival: Optional[float] = None
        self.flushes = 0
        # DES hooks
        self.sim = sim
        self.service = service or ServiceTimes()
        self.cpu = Resource(servers=1)
        self.store_resource = store_resource
        self.appends = 0
        self.replays = 0
        self.reads = 0
        # cold-tier hook (DESIGN.md §14): set by the system layer when the
        # store is tiered; scan-shaped reads that touched cold objects are
        # reported so the TierManager can promote them back to hot
        self.tiering = None
        # fault plane + fleet hooks (DESIGN.md §15): `faults` is consulted at
        # the crash windows (between an object PUT and its proposal);
        # `fleet` is the owning BoltSystem, so receipts can route their
        # flush through the retry/failover layer. `_orphan_puts` notes keys
        # this broker PUT but may never have proposed — the §13 reaper's
        # resync() sweeps the ones consensus indeed never saw.
        self.faults = None
        self.fleet = None
        self._orphan_puts: set = set()
        # §18: overlap the segment PUT with the metadata propose in the DES
        # ack model (execution order stays PUT-then-propose — never sequence
        # an object that has not landed; ack = both landed). Set by the
        # system layer; sequential booking is the pre-§18 model.
        self.pipelined_io = False
        # §18: stage-epoch guard for clock-driven deadline flushes — a
        # registered deadline only fires against the batch it was armed for
        self._stage_epoch = 0

    # -- data path ----------------------------------------------------------------
    def append(self, log_id: int, records: Sequence[bytes],
               arrival: Optional[float] = None) -> Tuple[Optional[List[int]], float]:
        """Returns (positions-or-None, completion_time). positions is None when
        an active promotable cFork hides them (§4.1)."""
        positions, done, _segment = self._append_now(log_id, records, arrival)
        return positions, done

    def _append_now(self, log_id: int, records: Sequence[bytes],
                    arrival: Optional[float]):
        """One PUT + one metadata proposal; also returns the durable segment
        reference so receipts can support zero-copy replay (DESIGN.md §12)."""
        object_id = f"obj-{self.broker_id}-{next(_obj_counter)}"
        payload = b"".join(records)
        offsets, lengths, off = [], [], 0
        for r in records:
            offsets.append(off)
            lengths.append(len(r))
            off += len(r)
        segment = (object_id, tuple(offsets), tuple(lengths))
        try:
            self.store.put(object_id, payload)
        except Unavailable:
            # a torn PUT may have landed a prefix under this key; the retry
            # uses a fresh id, so note the carcass for the resync sweep
            self._orphan_puts.add(object_id)
            raise
        if self.faults is not None and self.faults.fire("broker_crash_append"):
            # crash in the PUT->proposal window: the object is durable but
            # never sequenced — an orphan. The fleet layer fails this broker
            # over; the client retries through a survivor (fresh object id).
            self._orphan_puts.add(object_id)
            raise BrokerCrashed(
                f"broker {self.broker_id} crashed after PUT {object_id}, "
                "before its proposal (injected)", broker_id=self.broker_id)
        try:
            positions = self.metadata.propose(("append", log_id) + segment)
        except Unavailable:
            # proposal outcome unknown/failed with the PUT already durable:
            # if consensus never saw the object, resync reclaims it
            self._orphan_puts.add(object_id)
            raise
        self.appends += 1
        done = self._book(arrival, write_bytes=len(payload))
        return positions, done, segment

    def submit(self, log_id: int, records: Sequence[bytes],
               arrival: Optional[float] = None) -> PendingAppend:
        """The ONE staging-aware append entry point (DESIGN.md §12): stages
        under group commit, appends immediately otherwise — either way the
        caller gets a :class:`PendingAppend` (already resolved on the
        immediate path). Deterministic errors on the immediate path raise
        here, at the call site, exactly as the pre-§12 ``append`` did."""
        if self.group_commit is not None:
            return self.stage(log_id, records, arrival)
        positions, done, segment = self._append_now(log_id, records, arrival)
        pending = PendingAppend(self, log_id, len(records))
        pending.segment = segment
        pending._resolve(positions, done)
        return pending

    def replay(self, log_id: int, object_id: str, offsets: Sequence[int],
               lengths: Sequence[int],
               arrival: Optional[float] = None) -> PendingAppend:
        """Zero-copy re-append (DESIGN.md §12): sequence records that are
        ALREADY durable in shared storage — a rebase replays a speculative
        suffix as one metadata proposal per original append, with no object
        PUT and no payload bytes touched. Bypasses the group-commit staging
        deliberately: there is no payload to stage, and replay happens on a
        commit path that needs the positions sequenced now."""
        segment = (object_id, tuple(offsets), tuple(lengths))
        positions = self.metadata.propose(("append", log_id) + segment)
        self.appends += 1
        self.replays += 1
        done = self._book(arrival)
        pending = PendingAppend(self, log_id, len(segment[1]))
        pending.segment = segment
        pending._resolve(positions, done)
        return pending

    # -- group-commit staging (DESIGN.md §9) ---------------------------------------
    def stage(self, log_id: int, records: Sequence[bytes],
              arrival: Optional[float] = None) -> PendingAppend:
        """Stage an append into the group-commit buffer; returns a
        :class:`PendingAppend` acked at flush commit. Requires ``group_commit``."""
        cfg = self.group_commit
        assert cfg is not None, "stage() requires a group_commit config"
        if (arrival is not None and self._staged
                and self._staged_first_arrival is not None
                and arrival - self._staged_first_arrival >= cfg.max_delay):
            # DES-time deadline: the old batch must not wait for this record
            self._auto_flush(arrival)
        fleet = self.fleet
        if fleet is not None and self.broker_id in fleet._dead:
            # THIS broker died during the deadline flush (§15): its staging
            # already failed over — stage the new record on a survivor so it
            # rides live flush paths, not a dead broker's buffer
            return fleet.live_broker(self).stage(log_id, records, arrival)
        pending = PendingAppend(self, log_id, len(records))
        self._staged.append((pending, list(records)))
        self._staged_bytes += sum(len(r) for r in records)
        self._staged_records += len(records)
        if arrival is not None and self._staged_first_arrival is None:
            self._staged_first_arrival = arrival
            self._arm_deadline(arrival)
        self.appends += 1
        if (self._staged_records >= cfg.max_records
                or self._staged_bytes >= cfg.max_bytes):
            self._auto_flush(arrival)
        return pending

    def _arm_deadline(self, first_arrival: float) -> None:
        """Register a clock-driven ``max_delay`` flush (§9 bugfix). The seed
        deadline check lived inside ``stage()``, so it only fired when the
        NEXT record arrived — an idle staged batch could sit past its
        deadline indefinitely. With a fault plane attached, its DES-time
        callback queue fires the flush from ``advance()`` instead; the
        stage-epoch guard makes a callback for an already-flushed (or
        failed-over) batch a no-op."""
        plane = self.faults
        cfg = self.group_commit
        if plane is None or cfg is None:
            return
        epoch = self._stage_epoch
        deadline = first_arrival + cfg.max_delay
        plane.call_at(deadline, lambda: self._deadline_flush(epoch, deadline))

    def _deadline_flush(self, epoch: int, deadline: float) -> None:
        if epoch != self._stage_epoch or not self._staged:
            return
        self._auto_flush(deadline)

    def _auto_flush(self, arrival: Optional[float]) -> None:
        """A threshold/deadline flush from inside ``stage()``. The record is
        already safely staged EXACTLY ONCE by this point (or about to be),
        so a transient flush failure must NOT propagate out of ``submit`` —
        the caller's retry layer would re-submit and commit the record
        twice. With a fleet retry layer attached, transients retry here
        (broker failover included); an exhausted budget leaves the batch
        staged — possibly on a survivor — and the error surfaces at
        ``wait()``/``flush()``, where retrying is duplicate-safe. Without a
        plane, failures propagate exactly as pre-§15."""
        fleet = self.fleet
        if (fleet is None or fleet.faults is None
                or not fleet.faults.enabled):
            self.flush(arrival=arrival)
            return
        try:
            fleet._retrying(
                lambda _a: fleet.live_broker(self).flush(arrival=arrival))
        except Unavailable:
            pass   # batch still staged (here or failed-over); ack deferred

    def flush(self, arrival: Optional[float] = None) -> float:
        """Commit the staging buffer: ONE segment-object PUT + ONE batched
        metadata proposal for all staged logs, then ack every PendingAppend."""
        if not self._staged:
            return arrival if arrival is not None else 0.0
        staged, self._staged = self._staged, []
        self._staged_bytes = 0
        self._staged_records = 0
        self._staged_first_arrival = None
        self._stage_epoch += 1
        writer = SegmentWriter()
        slices = []   # (pending, entry_index, start slot within the entry)
        for pending, records in staged:
            entry_index, start = writer.add(pending.log_id, records)
            slices.append((pending, entry_index, start))
        payload, entries = writer.finish()
        object_id = f"seg-{self.broker_id}-{next(_obj_counter)}"
        try:
            try:
                self.store.put(object_id, payload)
            except Unavailable:
                self._orphan_puts.add(object_id)   # torn prefix, maybe
                raise
            if (self.faults is not None
                    and self.faults.fire("broker_crash_flush")):
                # crash between the segment PUT and the batched proposal
                # (DESIGN.md §15): the segment is an orphan, and the staged
                # records were never acked — put them BACK so the fleet
                # layer's failover re-routes them to a surviving broker
                # (fresh segment, fresh PUT) and the receipts still resolve.
                self._orphan_puts.add(object_id)
                self._restage(staged)
                raise BrokerCrashed(
                    f"broker {self.broker_id} crashed after segment PUT "
                    f"{object_id}, before its proposal (injected)",
                    broker_id=self.broker_id)
            try:
                outcomes = self.metadata.propose(
                    ("append_batch_multi",
                     tuple((lid, object_id, offs, lens)
                           for lid, offs, lens in entries)))
            except Unavailable:
                self._orphan_puts.add(object_id)
                raise
        except Unavailable as e:
            if self.faults is not None and self.faults.enabled:
                # transient under an active fault plane: nothing was acked
                # and nothing failed permanently — re-stage so the retry
                # layer (or a broker failover) can commit the batch on the
                # next attempt with a fresh segment id
                if not isinstance(e, BrokerCrashed):
                    self._restage(staged)
                raise
            # no retry layer attached: surface the loss exactly as pre-§15 —
            # every pending FAILS (None would masquerade as §4.1 "withheld")
            for pending, _entry_index, _start in slices:
                pending._fail(AgileLogError(f"group-commit flush failed: {e}"), 0.0)
            raise
        except Exception as e:
            # a failed flush (store error, lost metadata quorum) must not
            # strand the batch: nothing was acked, so every pending FAILS —
            # result() returning None here would masquerade as the §4.1
            # "committed, positions withheld" success case
            for pending, _entry_index, _start in slices:
                pending._fail(AgileLogError(f"group-commit flush failed: {e}"), 0.0)
            raise
        self.flushes += 1
        done = self._book(arrival, write_bytes=len(payload))
        for pending, entry_index, start in slices:
            _lid, e_offs, e_lens = entries[entry_index]
            pending.segment = (object_id,
                               tuple(e_offs[start:start + pending.n]),
                               tuple(e_lens[start:start + pending.n]))
            outcome = outcomes[entry_index]
            if outcome[0] == "ok":
                pending._resolve(outcome[1][start:start + pending.n], done)
            elif outcome[0] == "hidden":
                pending._resolve(None, done)
            else:
                _, exc_name, msg = outcome
                exc_cls = getattr(_errors, exc_name, AgileLogError)
                pending._fail(exc_cls(msg), done)
        return done

    def _restage(self, staged) -> None:
        """Put a popped staging batch back (front of the buffer, original
        order) after a transient flush failure: nothing was acked, so the
        records are still pending — the next flush attempt recommits them."""
        self._staged = list(staged) + self._staged
        self._staged_bytes += sum(len(r) for _p, recs in staged for r in recs)
        self._staged_records += sum(len(recs) for _p, recs in staged)

    def take_staging(self):
        """Broker failover (DESIGN.md §15): surrender the staging buffer to
        the fleet layer so a surviving broker can adopt it. The pendings stay
        unresolved — they will be acked by the adopter's flush."""
        staged, self._staged = self._staged, []
        self._staged_bytes = 0
        self._staged_records = 0
        self._staged_first_arrival = None
        self._stage_epoch += 1
        return staged

    def adopt_staging(self, staged) -> None:
        """Adopt staged records from a crashed peer: re-point each pending at
        this broker (receipts route their flush here) and append the batch to
        the local buffer. The peer's PUT (if any) is orphaned garbage — the
        adopter re-PUTs everything under a fresh segment id at flush."""
        for pending, _records in staged:
            pending.broker = self
        self._staged.extend(staged)
        self._staged_bytes += sum(len(r) for _p, recs in staged for r in recs)
        self._staged_records += sum(len(recs) for _p, recs in staged)

    def take_orphans(self) -> set:
        """Hand the noted orphan PUT keys (torn/unproposed segments) to the
        caller — the §13 reaper resync path — and forget them locally."""
        orphans, self._orphan_puts = self._orphan_puts, set()
        return orphans

    def discard_staging(self) -> None:
        """Broker failure: staged records were never acked, so they are LOST,
        not committed — each PendingAppend fails instead of resolving."""
        staged, self._staged = self._staged, []
        self._staged_bytes = 0
        self._staged_records = 0
        self._staged_first_arrival = None
        self._stage_epoch += 1
        for pending, _records in staged:
            pending._fail(AgileLogError(
                f"broker {self.broker_id} failed before flush; append not committed"),
                0.0)

    def _flush_if_staged(self, log_id: int) -> None:
        """Read-your-writes: reads of a log with staged records flush first."""
        if self._staged and any(p.log_id == log_id for p, _ in self._staged):
            self.flush()

    def _cached_read(self, spans, arrival: Optional[float],
                     meta_cached: bool = False,
                     lease_read: bool = False) -> Tuple[List[bytes], float]:
        """Scatter-gather the spans through the page cache; book broker CPU on
        the bytes *returned* but store GETs only on what was actually
        *fetched* (ranged GETs, not whole-object fills — DESIGN.md §10)."""
        g0, b0 = self.cache.ranged_gets, self.cache.bytes_fetched
        cg0 = getattr(self.store, "cold_gets", 0)
        cb0 = getattr(self.store, "cold_bytes_read", 0)
        blobs = self.cache.get_spans(spans)
        self.reads += 1
        done = self._book(arrival,
                          read_bytes=sum(len(b) for b in blobs),
                          fetch_bytes=self.cache.bytes_fetched - b0,
                          get_ops=self.cache.ranged_gets - g0,
                          meta_cached=meta_cached,
                          cold_get_ops=getattr(self.store, "cold_gets", 0) - cg0,
                          cold_fetch_bytes=getattr(self.store, "cold_bytes_read", 0) - cb0,
                          lease_read=lease_read)
        return blobs, done

    def _resolve_spans(self, log_id: int, lo: int, hi: int,
                       per_record: bool) -> Tuple[List, bool, bool]:
        """Metadata resolution plus whether the flattened-view fast path
        served it (§11) and whether the lease fast path skipped consensus
        (§18) — the DES model books a cheaper metadata op for each."""
        meta = self.metadata
        l0 = getattr(meta, "lease_reads", 0)
        reader = getattr(meta, "read_state", None)
        state = reader() if reader is not None else meta.state
        lease_read = getattr(meta, "lease_reads", 0) > l0
        c0 = state.stats.cached_reads
        if per_record:
            spans = state.read_record_spans(log_id, lo, hi)
        else:
            spans = state.read_spans(log_id, lo, hi)
        return spans, state.stats.cached_reads > c0, lease_read

    def read(self, log_id: int, lo: int, hi: int,
             arrival: Optional[float] = None) -> Tuple[List[bytes], float]:
        self._flush_if_staged(log_id)
        spans, meta_cached, lease = self._resolve_spans(log_id, lo, hi,
                                                        per_record=False)
        out = self._cached_read(spans, arrival, meta_cached, lease)
        self._note_cold_scan(spans, hi - lo, arrival)
        return out

    def read_records(self, log_id: int, lo: int, hi: int,
                     arrival: Optional[float] = None) -> Tuple[List[bytes], float]:
        """Read and return individual records (one span per record)."""
        self._flush_if_staged(log_id)
        spans, meta_cached, lease = self._resolve_spans(log_id, lo, hi,
                                                        per_record=True)
        out = self._cached_read(spans, arrival, meta_cached, lease)
        self._note_cold_scan(spans, hi - lo, arrival)
        return out

    def _note_cold_scan(self, spans, n_records: int,
                        arrival: Optional[float]) -> None:
        """Readahead-aware promotion trigger (DESIGN.md §14): the read was
        already served (byte-correct through whichever tier held the data);
        if it was scan-shaped and touched cold objects, tell the tier
        manager so the NEXT reads come from the hot class."""
        tiers = self.tiering
        if tiers is None:
            return
        is_cold = getattr(self.store, "is_cold", None)
        if is_cold is None:
            return
        cold = {key for key, _off, _ln in spans if is_cold(key)}
        if cold:
            tiers.note_scan(cold, n_records, arrival)

    # -- DES accounting -----------------------------------------------------------
    def _store_rates(self):
        """Resolve the store cost model (§18): a backend carrying a
        ``StoreProfile`` books its own rates; ``None`` (memory/tiered) means
        the global ``ServiceTimes`` store rates — the pre-§18 model,
        byte-identical for every existing benchmark."""
        prof = getattr(self.store, "profile", None)
        s = self.service
        if prof is None:
            return (s.store_put_base, s.store_put_per_kb,
                    s.store_get_base, s.store_get_per_kb,
                    s.store_delete_base, 0)
        return (prof.put_base, prof.put_per_kb, prof.get_base,
                prof.get_per_kb, prof.delete_base, prof.min_get_bytes)

    def _book(self, arrival: Optional[float], write_bytes: int = 0,
              read_bytes: int = 0, fetch_bytes: Optional[int] = None,
              get_ops: Optional[int] = None,
              meta_cached: bool = False,
              cold_get_ops: int = 0, cold_fetch_bytes: int = 0,
              lease_read: bool = False) -> float:
        """`read_bytes` is what the client receives (broker CPU touches it);
        `fetch_bytes`/`get_ops` are the actual store traffic — cache hits cost
        no store time, and one coalesced ranged GET costs one `store_get_base`,
        however many spans it served. They default to the pre-cache model
        (every read is one whole GET) when not supplied. `meta_cached` books
        the flattened-view lookup cost instead of the chain-walk one (§11);
        `lease_read` books the consensus-free lease-local read (§18), which
        beats both. `cold_get_ops`/`cold_fetch_bytes` split out the GETs the
        cold store class served — those are charged at the archive rates
        (§14). Store rates come from the backend's profile when it has one;
        ``min_get_bytes`` bills every hot ranged GET at least its floor.
        With ``pipelined_io``, a write's metadata propose overlaps the PUT:
        the ack waits for max(PUT completion, propose round) instead of
        their sum (§18 — execution order is still PUT-then-propose)."""
        if self.sim is None or arrival is None:
            return 0.0
        s = self.service
        put_base, put_per_kb, get_base, get_per_kb, _del_base, min_get = \
            self._store_rates()
        t = arrival
        cpu_time = s.broker_cpu_per_req + s.broker_cpu_per_kb * (write_bytes + read_bytes) / 1024
        t = self.cpu.submit(t, cpu_time)
        if fetch_bytes is None:
            fetch_bytes = read_bytes
        if get_ops is None:
            get_ops = 1 if fetch_bytes else 0
        hot_ops = max(0, get_ops - cold_get_ops)
        hot_bytes = max(0, fetch_bytes - cold_fetch_bytes)
        meta_time = (s.metadata_op_lease if lease_read
                     else s.metadata_op_cached if meta_cached
                     else s.metadata_op)
        if self.store_resource is not None:
            if write_bytes:
                put_done = self.store_resource.submit(
                    t, put_base + put_per_kb * write_bytes / 1024)
                if self.pipelined_io:
                    t = max(put_done, t + meta_time)
                    meta_time = 0.0          # propose overlapped the PUT
                else:
                    t = put_done
            if hot_ops:
                billed = max(hot_bytes, hot_ops * min_get)
                t = self.store_resource.submit(
                    t, hot_ops * get_base + get_per_kb * billed / 1024)
            if cold_get_ops:
                t = self.store_resource.submit(
                    t, cold_get_ops * s.cold_get_base + s.cold_get_per_kb * cold_fetch_bytes / 1024)
        t += meta_time + s.net_rtt
        return t

    def book_reclaim(self, arrival: Optional[float], n_deletes: int) -> float:
        """Book one GC reap quantum on THIS broker (DESIGN.md §13): the `gc`
        sequencing round, per-DELETE request handling on this broker's CPU
        (each object is its own store call), and the DELETEs on the store
        pool. The reaper runs on its own broker precisely so a backlog drain
        is a CPU burst the latency-critical workload never queues behind —
        the isolation benchmark places it both ways to show the difference."""
        if self.sim is None or arrival is None:
            return 0.0
        s = self.service
        _pb, _pk, _gb, _gk, delete_base, _mg = self._store_rates()
        t = self.cpu.submit(arrival, s.broker_cpu_per_req * max(1, n_deletes))
        if self.store_resource is not None and n_deletes:
            t = self.store_resource.submit(t, n_deletes * delete_base)
        t += s.metadata_op + s.net_rtt
        return t

    def book_compact(self, arrival: Optional[float], read_bytes: int,
                     write_bytes: int, n_gets: int) -> float:
        """Book one compaction quantum on THIS broker (DESIGN.md §14): the
        ranged reads of the live spans, the compacted-object PUT, and the
        ``compact`` sequencing round. Like the GC reaper, the compactor runs
        on its own broker so rewrite I/O never queues in front of the
        latency-critical workload."""
        if self.sim is None or arrival is None:
            return 0.0
        s = self.service
        put_base, put_per_kb, get_base, get_per_kb, _db, min_get = \
            self._store_rates()
        cpu_time = s.broker_cpu_per_req + s.broker_cpu_per_kb * (read_bytes + write_bytes) / 1024
        t = self.cpu.submit(arrival, cpu_time)
        if self.store_resource is not None:
            if n_gets:
                billed = max(read_bytes, n_gets * min_get)
                t = self.store_resource.submit(
                    t, n_gets * get_base + get_per_kb * billed / 1024)
            if write_bytes:
                t = self.store_resource.submit(
                    t, put_base + put_per_kb * write_bytes / 1024)
        t += s.metadata_op + s.net_rtt
        return t

    def book_tier(self, arrival: Optional[float], cold_put_bytes: int = 0,
                  cold_get_bytes: int = 0, n_objects: int = 1) -> float:
        """Book tier moves (§14): demotions PUT into the cold class at the
        archive rates; rehydrations GET out of it."""
        if self.sim is None or arrival is None:
            return 0.0
        s = self.service
        t = self.cpu.submit(arrival, s.broker_cpu_per_req * max(1, n_objects))
        if self.store_resource is not None:
            if cold_put_bytes:
                t = self.store_resource.submit(
                    t, n_objects * s.cold_put_base + s.cold_put_per_kb * cold_put_bytes / 1024)
            if cold_get_bytes:
                t = self.store_resource.submit(
                    t, n_objects * s.cold_get_base + s.cold_get_per_kb * cold_get_bytes / 1024)
        t += s.metadata_op + s.net_rtt
        return t


class KafkaLikeBroker(Broker):
    """Stateful shared-broker baseline (§6.2): all workloads hit the same broker
    and its local disk, so agentic bulk reads contend with the lc-workload. The
    'disk' is a single DES resource attached to this broker."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.disk = Resource(servers=1)

    def _book(self, arrival: Optional[float], write_bytes: int = 0,
              read_bytes: int = 0, fetch_bytes: Optional[int] = None,
              get_ops: Optional[int] = None,
              meta_cached: bool = False,
              cold_get_ops: int = 0, cold_fetch_bytes: int = 0,
              lease_read: bool = False) -> float:
        # Every read is served from this broker's local disk: the page cache's
        # fetch accounting (fetch_bytes/get_ops) must NOT exempt the baseline
        # — a free RAM cache here would understate the very read contention
        # this baseline exists to measure (§6.2); likewise the metadata op is
        # charged at the uncached rate (the baseline has no §11 fast path),
        # so bytes returned are charged to the disk unconditionally, as in
        # the seed model.
        if self.sim is None or arrival is None:
            return 0.0
        s = self.service
        t = arrival
        cpu_time = s.broker_cpu_per_req + s.broker_cpu_per_kb * (write_bytes + read_bytes) / 1024
        t = self.cpu.submit(t, cpu_time)
        nbytes = write_bytes + read_bytes
        if nbytes:
            t = self.disk.submit(t, s.disk_seek + s.disk_read_per_kb * nbytes / 1024)
        t += s.metadata_op + s.net_rtt
        return t
