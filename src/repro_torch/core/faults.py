"""Deterministic fault-injection plane + client retry policy (DESIGN.md §15).

The paper's availability story — stateless brokers can die without losing
data, the metadata layer is "a fault-tolerant group" (§5.2) — is only real if
the request path has defined behavior when things actually fail. This module
is the single switchboard for making them fail *on purpose, reproducibly*:

* :class:`FaultConfig` — per-site probabilities (store PUT/GET/DELETE errors,
  torn partial PUTs, committed-but-unacked propose ambiguity, leader crash
  mid-operation, broker crash between the segment PUT and its proposal) plus
  a DES-time **schedule** of discrete events (kill/recover a broker, replica,
  or the current leader at simulated time *t*).
* :class:`FaultPlane` — one seeded ``random.Random`` drives every probability
  draw in *consultation order*, so a given (seed, workload) pair replays the
  identical fault sequence; counters record what actually fired.
* :class:`RetryPolicy` / :func:`run_with_retries` — the client-side answer:
  bounded retries with exponential backoff + deterministic jitter. Every
  transient failure surfaces as :class:`~repro.core.errors.Unavailable`; the
  budget's end is a typed :class:`~repro.core.errors.RetryBudgetExhausted`.

Layering contract (who consults what):

* Object stores consult ``on_put``/``on_get``/``on_delete`` (attached via
  ``ObjectStore.attach_faults``). A *torn* PUT durably writes a prefix and
  then raises — the caller must treat the key as garbage until a full re-PUT
  lands (retries use fresh object ids; the torn orphan is swept by the §13
  reaper's ``resync``).
* ``MetadataService`` consults ``leader_crash`` (the leader dies mid-propose,
  before the entry is appended) and ``propose_unacked`` (the entry committed
  and applied, but the ack is lost — the client sees
  :class:`~repro.core.errors.AmbiguousProposal` and may retry **only** with
  the same idempotency token, deduplicated in the replicated state).
* Brokers consult ``broker_crash_flush``/``broker_crash_append`` (death in
  the window after the object PUT, before the metadata proposal: the PUT is
  an orphan, staged records fail over to a surviving broker).
* The metadata group's replication traffic consults the :class:`Network`
  (``plane.net``, DESIGN.md §16): every AppendEntries / vote / snapshot
  message and its ack traverses a directed link with per-link
  drop/delay/duplicate/reorder probabilities and partition blocks, so stale
  leaders, divergent suffixes, and lost-ack ambiguity are injectable and
  replay under one seed.

The plane is inert by default: a ``BoltSystem`` without ``faults=`` never
draws, never retries, replicates by direct call, and behaves byte-identically
to the pre-§15 system.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .errors import RetryBudgetExhausted, StoreFault, Unavailable


#: Schedule event kinds understood by :meth:`FaultPlane.advance`. The
#: ``partition*``/``heal_network`` kinds drive the §16 message network and
#: need no bound system; the kill/recover kinds require :meth:`FaultPlane.bind`.
SCHEDULE_KINDS = ("kill_broker", "kill_leader", "kill_replica",
                  "recover_replica", "partition", "partition_oneway",
                  "heal_network")


@dataclass
class LinkFaults:
    """Per-link override of the §16 network probabilities. ``None`` fields
    inherit the global ``net_*`` value; a link named in
    ``FaultConfig.link_faults`` can therefore be made lossier (a flapping
    link) or cleaner than the fleet default without touching the others."""

    drop: Optional[float] = None
    delay: Optional[float] = None
    duplicate: Optional[float] = None
    reorder: Optional[float] = None


@dataclass
class FaultConfig:
    """Per-site fault probabilities + a DES-time event schedule (§15/§16).

    Probabilities are consulted per operation at the named site; ``0.0``
    disables the site without spending an RNG draw, so adding a site to a
    config never perturbs the fault sequence of the others. ``schedule`` is
    a tuple of ``(time, kind, target)`` events in simulated seconds —
    ``kind`` one of :data:`SCHEDULE_KINDS`, ``target`` the broker/replica id
    (ignored for ``kill_leader``; for ``partition`` a tuple of replica-id
    groups, for ``partition_oneway`` a ``(src_ids, dst_ids)`` pair, ignored
    for ``heal_network``). Events fire when :meth:`FaultPlane.advance` first
    observes a time >= theirs; events sharing a timestamp fire in their
    original schedule order (stable tiebreaker — replay-deterministic even
    when targets are not mutually comparable).

    The ``net_*`` sites are consulted per replication MESSAGE by the §16
    network (AppendEntries / votes / acks each traverse their directed link
    twice — request and reply leg, each drawn independently), so one seed
    replays one message-fault sequence. ``lease_duration`` is the leader
    lease horizon for fenced local reads, against the plane's DES clock."""

    seed: int = 0xFA177
    store_put_error: float = 0.0      # clean PUT failure: nothing written
    store_put_torn: float = 0.0       # torn PUT: a prefix lands, then error
    store_get_error: float = 0.0
    store_delete_error: float = 0.0
    propose_unacked: float = 0.0      # committed, applied, ack lost (§15)
    leader_crash: float = 0.0         # leader dies mid-propose (pre-append)
    broker_crash_flush: float = 0.0   # broker dies between seg PUT + proposal
    broker_crash_append: float = 0.0  # same window on the per-call path
    net_drop: float = 0.0             # message lost on a link leg (§16)
    net_delay: float = 0.0            # message held in flight, delivered late
    net_delay_time: float = 2e-3      # modeled seconds a delayed message waits
    net_duplicate: float = 0.0        # message delivered twice
    net_reorder: float = 0.0          # message overtaken by later traffic
    lease_duration: float = 0.5       # leader lease horizon (modeled seconds)
    link_faults: Optional[Dict[Tuple[int, int], LinkFaults]] = None
    schedule: Tuple[Tuple[float, str, object], ...] = ()


class Network:
    """Deterministic message-level network for the metadata group (§16).

    The raft layer routes every replication message (AppendEntries, vote
    requests, snapshot installs — and their acks) through :meth:`send`. Each
    directed link leg draws drop/delay/duplicate/reorder off the plane's
    seeded RNG (zero-probability sites never draw), and a set of directed
    partition blocks models symmetric and asymmetric partitions. Delayed and
    reordered messages sit in an in-flight queue until the DES clock reaches
    their delivery time (:meth:`pump`, driven by ``FaultPlane.advance``);
    their replies are stale by then and are discarded, which is exactly the
    asymmetric-ack failure the term/prev fencing in ``raft.py`` must absorb.

    With every ``net_*`` probability zero and no partitions armed, ``send``
    is a plain synchronous call — message-mode replication is then
    observationally identical to the pre-§16 direct path."""

    def __init__(self, plane: "FaultPlane") -> None:
        self.plane = plane
        self._blocks: set = set()          # directed (src, dst) blocked pairs
        self._inflight: List[Tuple[float, int, Callable, tuple]] = []
        self._seq = 0
        self.partitions_armed = 0          # partition events applied (stat)
        self.msgs_sent = 0                 # total sends (not an injected fault)

    # -- partitions ----------------------------------------------------------
    def partition(self, *groups) -> None:
        """Symmetric partition: replicas in different ``groups`` cannot
        exchange messages in either direction (ids absent from every group
        keep full connectivity). Cumulative with earlier blocks."""
        for i, ga in enumerate(groups):
            for gb in groups[i + 1:]:
                for a in ga:
                    for b in gb:
                        self._blocks.add((a, b))
                        self._blocks.add((b, a))
        self.partitions_armed += 1

    def partition_oneway(self, srcs, dsts) -> None:
        """Asymmetric partition: messages ``src -> dst`` are blocked, the
        reverse direction still delivers (acks vanish, requests arrive)."""
        for s in srcs:
            for d in dsts:
                self._blocks.add((s, d))
        self.partitions_armed += 1

    def heal(self) -> None:
        """Remove every partition block (in-flight messages stay queued)."""
        self._blocks.clear()

    def blocked(self, src: int, dst: int) -> bool:
        return (src, dst) in self._blocks

    # -- fault draws ---------------------------------------------------------
    def _fire(self, site: str, src: int, dst: int) -> bool:
        """One per-link probability draw; link overrides beat the global
        ``net_<site>``. Zero-probability links never draw, so arming one
        link's faults never perturbs the message-fault sequence of others."""
        plane = self.plane
        if not plane.enabled:
            return False
        p = None
        overrides = plane.config.link_faults
        if overrides:
            lf = overrides.get((src, dst))
            if lf is not None:
                p = getattr(lf, site)
        if p is None:
            p = getattr(plane.config, "net_" + site)
        if p <= 0.0:
            return False
        if plane.rng.random() < p:
            plane.note("msgs_" + {"drop": "dropped", "delay": "delayed",
                                  "duplicate": "duplicated",
                                  "reorder": "reordered"}[site])
            return True
        return False

    # -- transport -----------------------------------------------------------
    def send(self, src: int, dst: int, handler: Callable[[tuple], object],
             payload: tuple):
        """One request/reply exchange over the ``src -> dst`` link. Returns
        the reply payload, or ``None`` when either leg failed: the request
        was blocked/dropped/held in flight, or the reply leg lost the ack
        (the destination then processed the request WITHOUT the source
        learning — the duplicate-suppression case the raft handlers absorb).
        """
        plane = self.plane
        self.msgs_sent += 1
        if self.blocked(src, dst):
            plane.note("msgs_dropped")
            plane.note("msgs_partitioned")
            return None
        if self._fire("drop", src, dst):
            return None
        if self._fire("duplicate", src, dst):
            # the extra copy arrives back-to-back with the original; its
            # reply is redundant and discarded
            handler(payload)
        if self._fire("delay", src, dst):
            jitter = 0.5 + plane.rng.random()
            self._hold(plane.now + plane.config.net_delay_time * jitter,
                       handler, payload)
            return None
        if self._fire("reorder", src, dst):
            # held at the CURRENT clock: delivered at the next pump, after
            # every message sent later in this round already executed —
            # genuine out-of-order arrival without a long delay
            self._hold(plane.now, handler, payload)
            return None
        reply = handler(payload)
        if reply is None:
            return None
        if self.blocked(dst, src):
            plane.note("msgs_dropped")
            plane.note("msgs_partitioned")
            return None
        if self._fire("drop", dst, src):
            return None
        if self._fire("delay", dst, src):
            # a late ack is a dead ack: the round moved on
            return None
        return reply

    def _hold(self, deliver_at: float, handler: Callable, payload: tuple) -> None:
        heapq.heappush(self._inflight, (deliver_at, self._seq, handler, payload))
        self._seq += 1

    def pump(self, now: float) -> int:
        """Deliver every in-flight message whose time has come (their replies
        are stale and discarded). Returns how many were delivered."""
        n = 0
        while self._inflight and self._inflight[0][0] <= now:
            _, _, handler, payload = heapq.heappop(self._inflight)
            handler(payload)
            n += 1
        return n

    def flush(self) -> int:
        """Deliver ALL in-flight messages (heal-time drain): late
        AppendEntries land on healed replicas and are absorbed — or
        truncated — by the term/prev checks."""
        return self.pump(math.inf)

    @property
    def in_flight(self) -> int:
        return len(self._inflight)


class FaultPlane:
    """Seeded switchboard the wired layers consult (DESIGN.md §15/§16).

    ``enabled`` gates every probability site (schedules still fire): the
    test harness heals the system by flipping it off before running the
    final oracles, without losing the counters of what was injected."""

    def __init__(self, config: Optional[FaultConfig] = None) -> None:
        self.config = config or FaultConfig()
        self.rng = random.Random(self.config.seed)
        self.enabled = True
        self.now = 0.0                # DES clock, advanced by advance()
        self.counters: Dict[str, int] = {}
        # stable tiebreaker (ISSUE 8 satellite): events sharing a DES
        # timestamp fire in their original schedule order — sorting the raw
        # (time, kind, target) triples compared kinds/targets, which is both
        # replay-fragile and a TypeError for mixed target types
        self._pending_events = sorted(
            ((t, seq, kind, target)
             for seq, (t, kind, target) in enumerate(self.config.schedule)),
            key=lambda ev: (ev[0], ev[1]))
        self.events_fired: list = []
        self._system = None           # bound BoltSystem (for schedules)
        self.net = Network(self)      # §16 message-level network
        self._timers: list = []       # heap of (time, seq, fn) callbacks
        self._timer_seq = 0

    # -- wiring --------------------------------------------------------------
    def bind(self, system) -> None:
        """Attach the BoltSystem whose brokers/replicas schedules target."""
        self._system = system

    def note(self, site: str, n: int = 1) -> None:
        self.counters[site] = self.counters.get(site, 0) + n

    @property
    def total_injected(self) -> int:
        return sum(self.counters.values())

    def fire(self, site: str) -> bool:
        """One probability draw at ``site``; counts and reports a hit.
        Zero-probability sites never draw, keeping fault sequences stable
        under config extension."""
        if not self.enabled:
            return False
        p = getattr(self.config, site)
        if p <= 0.0:
            return False
        if self.rng.random() < p:
            self.note(site)
            return True
        return False

    def heal(self) -> None:
        """Stop injecting (counters and remaining schedule are preserved).
        Partitions lift and in-flight delayed messages drain: their late
        delivery exercises the term/prev fencing one final time, after which
        the network is quiescent and reconciliation can run."""
        self.enabled = False
        self.net.heal()
        self.net.flush()

    # -- store sites ---------------------------------------------------------
    def on_put(self, key: str, data: bytes):
        """Consulted by the store before a PUT. Returns ``(payload, error)``:
        the bytes to durably write (``None`` for nothing) and the error to
        raise after writing them (``None`` for success)."""
        if self.fire("store_put_torn"):
            cut = self.rng.randrange(0, max(1, len(data)))
            return data[:cut], StoreFault(
                f"injected torn PUT of {key}: {cut}/{len(data)} bytes landed")
        if self.fire("store_put_error"):
            return None, StoreFault(f"injected PUT failure for {key}")
        return data, None

    def on_get(self, key: str) -> None:
        if self.fire("store_get_error"):
            raise StoreFault(f"injected GET failure for {key}")

    def on_delete(self, key: str) -> None:
        if self.fire("store_delete_error"):
            raise StoreFault(f"injected DELETE failure for {key}")

    # -- DES-time schedules --------------------------------------------------
    def call_at(self, time: float, fn) -> None:
        """Register a one-shot callback to fire when the DES clock reaches
        ``time`` (via :meth:`advance`). This is how layers turn *deadlines*
        into clock-driven actions — e.g. the group-commit ``max_delay`` flush
        (§9 bugfix): before this hook, an idle staged record's deadline only
        fired when the NEXT record happened to arrive. Callbacks at the same
        time fire in registration order; a ``time`` already in the past fires
        on the next ``advance()`` call."""
        heapq.heappush(self._timers, (time, self._timer_seq, fn))
        self._timer_seq += 1

    def advance(self, now: float) -> int:
        """Advance the DES clock: deliver due in-flight network messages,
        then fire every scheduled event with time <= ``now`` (kill/recover
        kinds require :meth:`bind`), then due :meth:`call_at` callbacks.
        Deliveries drain before events at the same clock reading (they were
        sent strictly earlier); events sharing a timestamp fire in original
        schedule order. Returns how many SCHEDULE events fired. Kills of
        already-dead targets are no-ops, so schedules compose with
        probabilistic crashes."""
        self.now = max(self.now, now)
        self.net.pump(self.now)
        fired = 0
        while self._pending_events and self._pending_events[0][0] <= now:
            t, _seq, kind, target = self._pending_events.pop(0)
            self._dispatch(kind, target)
            self.events_fired.append((t, kind, target))
            self.note("schedule_" + kind)
            fired += 1
        while self._timers and self._timers[0][0] <= now:
            _t, _seq, fn = heapq.heappop(self._timers)
            fn()
        return fired

    def _dispatch(self, kind: str, target) -> None:
        if kind == "partition":
            self.net.partition(*target)
            return
        if kind == "partition_oneway":
            self.net.partition_oneway(*target)
            return
        if kind == "heal_network":
            self.net.heal()
            return
        system = self._system
        assert system is not None, "FaultPlane.advance requires bind(system)"
        metadata = system.metadata
        if kind == "kill_broker":
            if target not in system._dead:
                system.fail_broker(target)
        elif kind == "kill_leader":
            metadata.fail_replica(metadata.leader_id)
        elif kind == "kill_replica":
            if metadata.replicas[target].alive:
                metadata.fail_replica(target)
        elif kind == "recover_replica":
            if not metadata.replicas[target].alive:
                metadata.recover_replica(target)
        else:
            raise ValueError(f"unknown fault-schedule kind {kind!r}")


# ---------------------------------------------------------------------------
# Client retry policy (DESIGN.md §15)
# ---------------------------------------------------------------------------

@dataclass
class RetryPolicy:
    """Bounded exponential backoff with deterministic jitter.

    ``attempts`` bounds the total tries (first call included); delays follow
    ``base * multiplier**k`` capped at ``max_delay``, each scaled by a jitter
    factor drawn uniformly from ``[1-jitter, 1+jitter]`` off the fault
    plane's seeded RNG — so two retrying clients seeded differently desync
    (the point of jitter) while a fixed seed replays exactly."""

    attempts: int = 6
    base_delay: float = 1e-3          # simulated seconds (DES) per first retry
    multiplier: float = 2.0
    max_delay: float = 64e-3
    jitter: float = 0.5


@dataclass
class RetryStats:
    """What the retry layer actually did (fed into ``OpTally``)."""

    retries: int = 0                  # re-attempts after an Unavailable
    backoff_time: float = 0.0         # total simulated backoff slept
    budget_exhausted: int = 0         # RetryBudgetExhausted raised


def run_with_retries(fn: Callable[[int], object], policy: RetryPolicy,
                     rng: random.Random,
                     stats: Optional[RetryStats] = None,
                     on_backoff: Optional[Callable[[float], None]] = None,
                     on_retry: Optional[Callable[[Exception], None]] = None):
    """Run ``fn(attempt)`` (1-based) until it returns, retrying every
    :class:`Unavailable` except :class:`RetryBudgetExhausted` itself (a
    nested retry loop that already gave up must not be multiplied).
    ``on_backoff`` observes each simulated delay (the DES benchmarks charge
    it to the op's latency); ``on_retry`` observes the error *before* the
    backoff (e.g. to fail over a crashed broker)."""
    delay = policy.base_delay
    last: Optional[Exception] = None
    for attempt in range(1, policy.attempts + 1):
        try:
            return fn(attempt)
        except RetryBudgetExhausted:
            raise
        except Unavailable as e:
            last = e
            if attempt >= policy.attempts:
                break
            if on_retry is not None:
                on_retry(e)
            pause = min(delay, policy.max_delay)
            if policy.jitter > 0.0:
                pause *= 1.0 + policy.jitter * (2.0 * rng.random() - 1.0)
            if stats is not None:
                stats.retries += 1
                stats.backoff_time += pause
            if on_backoff is not None:
                on_backoff(pause)
            delay = min(delay * policy.multiplier, policy.max_delay)
    if stats is not None:
        stats.budget_exhausted += 1
    raise RetryBudgetExhausted(
        f"gave up after {policy.attempts} attempts: {last}",
        attempts=policy.attempts, last_error=last)
