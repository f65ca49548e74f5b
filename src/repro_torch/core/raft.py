"""Fault-tolerant metadata layer: a minimal in-process replicated SMR group.

The paper's metadata layer is "a fault-tolerant group that implements state-
machine replication using Paxos or Raft" (§5.2). We implement the SMR contract
the rest of Bolt depends on — a single totally-ordered command log applied
deterministically on every replica, with majority commit, leader failover, and
snapshot/compaction — without a wire protocol (single-process container).

Two replication paths (DESIGN.md §16):

* **Direct** (``faults=None``): replicas are updated by direct call inside
  ``propose`` — the seed behavior, byte-identical to the pre-§16 system.
* **Message mode** (a :class:`~repro.core.faults.FaultPlane` attached):
  replication is reified as explicit term-tagged messages — AppendEntries
  with prev-index/term consistency checks and conflict truncation, vote
  requests, snapshot installs, and their acks — each routed through the
  plane's deterministic :class:`~repro.core.faults.Network`. Partitions,
  drops, delays, duplicates and reordering therefore hit the consensus
  traffic itself: a stale leader is fenced by term (``NotLeader``), its
  lease-fenced local reads expire (``LeaseExpired``), elections make
  progress on the majority side of a partition, and divergent minority
  suffixes are truncated when reconciliation traffic reaches them on heal.

Properties exercised by tests:
  * a committed command survives any minority of replica failures;
  * killing the leader elects a new one and the state machines converge;
  * snapshots truncate the command log and a replica restarted from a snapshot
    replays the suffix and converges;
  * under partitions the majority side keeps committing, the minority side's
    leader is term-fenced, and heal + ``sync_followers`` reconverges every
    replica (``tests/test_network_faults.py``, ``test_fault_tolerance_e2e``).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .errors import (AmbiguousProposal, LeaseExpired, NoQuorum, NotLeader,
                     Unavailable)
from .faults import RetryPolicy, RetryStats, run_with_retries
from .metadata import MetadataState


@dataclass
class _Entry:
    term: int
    cmd: Tuple


class Replica:
    def __init__(self, rid: int, make_state: Callable[[], MetadataState]) -> None:
        self.rid = rid
        self.make_state = make_state
        self.state = make_state()
        self.log: List[_Entry] = []
        self.commit_index = -1      # highest COMMITTED entry index
        self.applied_index = -1     # highest entry applied to the state machine
        self.snapshot_index = -1    # entries <= this are compacted into `snapshot`
        self.snapshot: Optional[bytes] = None
        self.snapshot_term = 0      # term of the last entry inside `snapshot`
        self.alive = True
        self.lazy_applies = 0       # entries applied via deferred batches
        # -- message-mode raft state (DESIGN.md §16) -----------------------
        self.current_term = 1       # highest term this replica has seen
        self.voted_for: Optional[int] = None   # candidate granted in current_term
        self.is_leader = False      # LOCAL belief — a partitioned deposed
                                    # leader keeps believing until a higher
                                    # term reaches it (that is the fencing
                                    # scenario the §16 tests drive)
        self.lease_until = 0.0      # leader-lease horizon on the DES clock

    def append_entry(self, entry: _Entry) -> bool:
        if not self.alive:
            return False
        self.log.append(entry)
        return True

    @property
    def pending_applies(self) -> int:
        return self.commit_index - self.applied_index

    # -- log coordinates (global index space; entries <= snapshot_index are
    # compacted away but their positions remain occupied) ---------------------
    @property
    def last_index(self) -> int:
        return self.snapshot_index + len(self.log)

    @property
    def last_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_term

    def term_at(self, index: int) -> int:
        """Term of the entry at global ``index`` (snapshot boundary term for
        the compacted prefix — exact at the boundary, which is the only
        compacted position the prev-check ever consults)."""
        if index < 0:
            return 0
        if index <= self.snapshot_index:
            return self.snapshot_term
        return self.log[index - self.snapshot_index - 1].term

    # -- message handlers (DESIGN.md §16) -------------------------------------
    # Each returns a reply payload, or None when the replica is dead (the
    # network reports an unreachable destination as a lost message). Handlers
    # are duplicate- and reorder-safe: a redelivered AppendEntries is a no-op
    # (same term + same entries), a stale one is fenced by term.

    def _observe_term(self, term: int) -> None:
        if term > self.current_term:
            self.current_term = term
            self.voted_for = None
            self.is_leader = False   # a higher term deposes any local belief

    def on_append_entries(self, payload: tuple):
        """AppendEntries: term fence, prev-index/term consistency check with
        conflict truncation, idempotent append, commit piggyback. Replies
        ``("ok", last_index)``, ``("reject_term", higher_term)`` (the fencing
        signal), or ``("reject_log", hint)`` (backtrack ``next_index`` to
        ``hint + 1``)."""
        if not self.alive:
            return None
        term, prev, prev_term, entries, leader_commit = payload
        if term < self.current_term:
            return ("reject_term", self.current_term)
        self._observe_term(term)
        if prev > self.last_index:
            return ("reject_log", self.last_index)       # gap: fast backtrack
        if prev > self.snapshot_index and self.term_at(prev) != prev_term:
            # conflicting entry at prev: drop it and the divergent suffix
            # after it. Committed prefixes never conflict (majority-
            # intersection), so this can only touch uncommitted entries.
            assert prev > self.commit_index, "conflict below commit point"
            del self.log[prev - self.snapshot_index - 1:]
            return ("reject_log", prev - 1)
        for i, e in enumerate(entries):
            g = prev + 1 + i
            if g <= self.snapshot_index:
                continue              # compacted == committed == identical
            local = g - self.snapshot_index - 1
            if local < len(self.log):
                if self.log[local].term == e.term:
                    continue          # duplicate delivery: no-op
                assert g > self.commit_index, "truncation below commit point"
                del self.log[local:]  # divergent suffix: truncate, replace
            self.log.append(e)
        if leader_commit > self.commit_index:
            # piggybacked commit (pipelined, §11: apply stays deferred)
            self.commit_index = min(leader_commit, self.last_index)
        return ("ok", self.last_index)

    def on_pre_vote(self, payload: tuple):
        """PreVote (raft §9.6): answer how RequestVote WOULD go, without
        adopting the term or recording a vote. Keeps a partitioned minority's
        doomed candidacies from perturbing terms — in particular, a deposed
        leader stranded with minority peers keeps believing it leads (the
        fencing scenario) instead of being deposed by a neighbor's hopeless
        campaign."""
        if not self.alive:
            return None
        term, candidate, last_term, last_index = payload
        if term < self.current_term:
            return ("deny", self.current_term)
        if (last_term, last_index) >= (self.last_term, self.last_index):
            return ("grant", self.current_term)
        return ("deny", self.current_term)

    def on_request_vote(self, payload: tuple):
        """RequestVote: grant at most one vote per term, and only to a
        candidate whose log is at least as up-to-date (Raft's election
        restriction — it is what keeps committed entries on every electable
        leader)."""
        if not self.alive:
            return None
        term, candidate, last_term, last_index = payload
        if term < self.current_term:
            return ("deny", self.current_term)
        self._observe_term(term)
        if self.voted_for is not None and self.voted_for != candidate:
            return ("deny", self.current_term)
        if (last_term, last_index) >= (self.last_term, self.last_index):
            self.voted_for = candidate
            return ("grant", self.current_term)
        return ("deny", self.current_term)

    def on_install_snapshot(self, payload: tuple):
        """InstallSnapshot: a follower behind the leader's compaction horizon
        restores the snapshot and resumes AppendEntries from there. A stale
        or duplicated install (snapshot at-or-below our commit) is a no-op."""
        if not self.alive:
            return None
        term, snapshot, sidx, sterm = payload
        if term < self.current_term:
            return ("reject_term", self.current_term)
        self._observe_term(term)
        if sidx <= self.commit_index:
            return ("ok", self.last_index)
        self.state = pickle.loads(snapshot)
        self.snapshot = snapshot
        self.snapshot_index = sidx
        self.snapshot_term = sterm
        self.commit_index = sidx
        self.applied_index = sidx
        self.log = []
        return ("ok", sidx)

    def apply_to(self, index: int) -> None:
        """Apply committed entries up to `index` (0-based global index)."""
        while self.applied_index < index:
            self.applied_index += 1
            local = self.applied_index - self.snapshot_index - 1
            entry = self.log[local]
            try:
                self.state.apply(entry.cmd)
            except Exception:
                # Deterministic command failures (e.g. ForkBlocked) are part
                # of the state machine contract: every replica fails
                # identically, leaving identical state (a failed append still
                # registers its orphaned PUT object for GC, §13, but does so
                # before raising — deterministically); the leader surfaces
                # the error.
                pass
        if self.commit_index < index:
            self.commit_index = index

    def apply_pending(self) -> int:
        """Drain the deferred-apply backlog (pipelined followers, DESIGN.md
        §11): one sequential batch replay instead of per-proposal work."""
        n = self.pending_applies
        if n > 0:
            self.lazy_applies += n
            self.apply_to(self.commit_index)
        return n

    def take_snapshot(self) -> None:
        self.apply_pending()   # a snapshot serializes APPLIED state
        self.snapshot_term = self.term_at(self.commit_index)
        self.snapshot = pickle.dumps(self.state)
        drop = self.commit_index - self.snapshot_index
        self.log = self.log[drop:]
        self.snapshot_index = self.commit_index

    def restore_from(self, other: "Replica") -> None:
        """Crash-recovery: install peer snapshot + replay suffix."""
        assert other.snapshot is not None
        self.state = pickle.loads(other.snapshot)
        self.snapshot = other.snapshot
        self.snapshot_index = other.snapshot_index
        self.snapshot_term = other.snapshot_term
        self.commit_index = other.snapshot_index
        self.applied_index = other.snapshot_index
        self.log = list(other.log)
        self.apply_to(other.commit_index)
        # term/vote are persisted state in raft; leadership belief is not
        self.current_term = max(self.current_term, other.current_term)
        self.voted_for = None
        self.is_leader = False


class MetadataService:
    """Client-facing façade: propose() commands, query the leader's state."""

    def __init__(self, n_replicas: int = 3, snapshot_every: int = 0,
                 pipeline_apply: bool = True, **state_kwargs) -> None:
        make_state = lambda: MetadataState(**state_kwargs)  # noqa: E731
        self.replicas = [Replica(i, make_state) for i in range(n_replicas)]
        self.term = 1
        self.leader_id = 0
        self.snapshot_every = snapshot_every
        self._since_snapshot = 0
        self.proposals = 0
        # Pipelined replica apply (DESIGN.md §11): followers only append the
        # entry and advance their commit index on the propose critical path;
        # the state-machine apply is deferred and batch-replayed on snapshot,
        # failover, recovery, and convergence checks. With it off, every
        # replica applies synchronously inside propose() (the seed behavior).
        self.pipeline_apply = pipeline_apply
        # Fault plane + client retry policy (DESIGN.md §15). With no plane
        # attached, propose() is the plain synchronous path below — no token
        # wrapping, no retry loop, byte-identical to the pre-§15 system.
        self.faults = None
        self.retry = RetryPolicy()
        self.retry_stats = RetryStats()
        self._token_seq = 0
        self.elections = 0
        # message-mode replication bookkeeping (DESIGN.md §16): per
        # (leader, follower) link, the next global index to send — raft's
        # next_index, reset on every election
        self._next_index: Dict[Tuple[int, int], int] = {}
        self._electing = False       # reentrancy guard (election -> noop
                                     # barrier -> NoQuorum -> election ...)
        self.lease_reads = 0         # reads served by the lease fast path (§18)
        self.lease_fallbacks = 0     # reads that took the slow/barrier path
        self.replicas[0].is_leader = True

    # -- leadership ------------------------------------------------------------
    @property
    def leader(self) -> Replica:
        return self.replicas[self.leader_id]

    def fail_replica(self, rid: int) -> None:
        r = self.replicas[rid]
        r.alive = False
        r.is_leader = False      # leadership belief is volatile, not persisted
        if rid == self.leader_id:
            if self.faults is not None:
                self._elect_msg()
            else:
                self._elect()

    def recover_replica(self, rid: int) -> None:
        r = self.replicas[rid]
        r.alive = True
        donor = max((p for p in self.replicas if p.alive and p.rid != rid),
                    key=lambda p: p.commit_index)
        if donor.commit_index > r.commit_index:
            # The donor won on commit_index, which says nothing about its
            # APPLIED state: a pipelined follower (§11) may carry a stale
            # snapshot from an earlier compaction plus a deferred-apply
            # backlog — its log is shorter than its commit point. Drain the
            # backlog and refresh the snapshot so the recovering replica
            # installs fully-applied state and replays only the (empty)
            # suffix, instead of re-running the donor's whole backlog.
            donor.apply_pending()
            if donor.snapshot is None or donor.snapshot_index < donor.commit_index:
                donor.take_snapshot()
            r.restore_from(donor)

    def _elect(self) -> None:
        alive = [r for r in self.replicas if r.alive]
        if len(alive) * 2 <= len(self.replicas):
            raise NoQuorum("no quorum: metadata layer unavailable")
        self.elections += 1
        # most-up-to-date alive replica wins (Raft's log-completeness rule)
        winner = max(alive, key=lambda r: (len(r.log) + r.snapshot_index, -r.rid))
        self.leader_id = winner.rid
        self.term += 1
        # discard uncommitted suffix (never acked to clients)
        for r in alive:
            keep = winner.commit_index - r.snapshot_index
            r.log = r.log[:max(0, keep)]
        # a pipelined follower stepping up must serve linearizable reads:
        # drain its deferred-apply backlog before taking queries
        winner.apply_pending()
        for r in self.replicas:
            r.is_leader = r is winner

    # -- message-mode leadership (DESIGN.md §16) -------------------------------
    def _elect_msg(self) -> None:
        """Message-routed election: candidates stand in up-to-dateness order,
        each soliciting votes through the network at a fresh term; the first
        to assemble a majority of grants wins. Progress is exactly the raft
        condition — some candidate can reach a voting majority — so the
        majority side of a partition elects and the minority side cannot."""
        if self._electing:
            raise NoQuorum("election already in progress")
        plane = self.faults
        net = plane.net
        alive = [r for r in self.replicas if r.alive]
        n = len(self.replicas)
        if len(alive) * 2 <= n:
            raise NoQuorum("no quorum: metadata layer unavailable")
        self._electing = True
        try:
            term_try = max(self.term, max(r.current_term for r in alive)) + 1
            for cand in sorted(alive, reverse=True,
                               key=lambda r: (r.last_term, r.last_index,
                                              -r.rid)):
                # pre-vote round (§9.6): a term-neutral reachability +
                # up-to-dateness probe. A candidate that cannot assemble a
                # pre-vote majority (it is on the minority side) skips the
                # real candidacy, leaving every term untouched.
                pre = 1
                for r in self.replicas:
                    if r is cand or not r.alive:
                        continue
                    reply = net.send(cand.rid, r.rid, r.on_pre_vote,
                                     (term_try, cand.rid, cand.last_term,
                                      cand.last_index))
                    if reply is not None and reply[0] == "grant":
                        pre += 1
                if pre * 2 <= n:
                    continue
                cand.current_term = max(cand.current_term, term_try)
                term_try = cand.current_term
                cand.voted_for = cand.rid
                votes = 1
                for r in self.replicas:
                    if r is cand or not r.alive:
                        continue
                    reply = net.send(cand.rid, r.rid, r.on_request_vote,
                                     (term_try, cand.rid, cand.last_term,
                                      cand.last_index))
                    if reply is None:
                        continue             # unreachable / message lost
                    status, info = reply
                    if status == "grant":
                        votes += 1
                    elif info > term_try:
                        term_try = info      # a higher term is out there
                if votes * 2 > n:
                    self.leader_id = cand.rid
                    self.term = cand.current_term
                    cand.is_leader = True
                    cand.lease_until = plane.now + plane.config.lease_duration
                    self.elections += 1
                    self._next_index = {}
                    # a pipelined winner must serve linearizable reads (§11)
                    cand.apply_pending()
                    # no-op barrier (raft §8): the winner's log holds every
                    # committed entry (vote restriction) but its commit index
                    # may lag an entry the old leader committed whose ack to
                    # this replica was lost. One current-term no-op commits
                    # that prefix so leader-local reads are never stale.
                    # Best-effort: if its messages fail, `_read_barrier`
                    # retries at read time.
                    if cand.last_index > cand.commit_index:
                        try:
                            self._propose_once(("noop",))
                        except Unavailable:
                            pass
                    return
                term_try += 1                # failed candidacy burns the term
            raise NoQuorum(
                "no electable majority: every candidacy failed to gather "
                "votes (network partition?)")
        finally:
            self._electing = False

    def _maybe_elect(self) -> None:
        """Best-effort election after a fencing event: if no majority is
        reachable right now the caller's NotLeader/NoQuorum still propagates
        and the client's retry policy re-drives the election later."""
        try:
            self._elect_msg()
        except Unavailable:
            pass

    # -- the SMR write path ------------------------------------------------------
    def propose(self, cmd: Tuple, replica_hint: Optional[int] = None) -> object:
        """Sequence `cmd`, commit at majority, apply everywhere, return the
        leader's apply result (or raise its deterministic error).

        With a fault plane attached (DESIGN.md §15) this is the full client
        submit path: the command is wrapped with a fresh idempotency token —
        deduplicated in the replicated state, so a retry after an ambiguous
        (committed-but-unacked) outcome applies at most once — and every
        transient :class:`Unavailable` is retried under the bounded backoff
        policy. Without a plane it is the plain synchronous path."""
        if replica_hint is not None and replica_hint != self.leader_id:
            raise NotLeader(f"replica {replica_hint} is not the leader")
        plane = self.faults
        if plane is None or not plane.enabled:
            return self._propose_once(cmd)
        token = f"t{self._token_seq}"
        self._token_seq += 1
        wrapped = ("idem", token, cmd)
        return run_with_retries(lambda _attempt: self._propose_once(wrapped),
                                self.retry, plane.rng, stats=self.retry_stats)

    def _propose_once(self, cmd: Tuple) -> object:
        plane = self.faults
        if plane is not None and plane.fire("leader_crash"):
            # the leader dies before appending the entry anywhere: nothing
            # committed. Failing it triggers the election (which may itself
            # find no quorum); the client retries against the new leader.
            dead = self.leader_id
            self.fail_replica(dead)
            raise Unavailable(
                f"leader replica {dead} crashed mid-operation (injected)")
        entry = _Entry(self.term, cmd)
        if plane is None:
            acked = self._replicate_direct(entry)
        else:
            acked = self._replicate_msg(entry)
        result, error = self._commit_acked(self.leader, entry, acked)
        if plane is not None and plane.fire("propose_unacked"):
            # committed-but-unacked (DESIGN.md §15): the entry is committed
            # and applied, but the ack is lost. The client may retry ONLY
            # because the command rides an idempotency token — the replicated
            # dedup table returns this apply's cached outcome instead of
            # applying twice.
            raise AmbiguousProposal(
                "propose timed out after commit: outcome unacked (injected)")
        if error is not None:
            raise error
        return result

    # -- replication paths (DESIGN.md §16) -------------------------------------
    def _replicate_direct(self, entry: _Entry) -> List[Replica]:
        """Seed path (``faults=None``): append by direct call, roll back on a
        lost majority — byte-identical to the pre-§16 system."""
        acked = []
        for r in self.replicas:
            if r.alive and r.append_entry(entry):
                acked.append(r)
        if len(acked) * 2 <= len(self.replicas):
            # roll back: the entry was never committed (nor applied anywhere),
            # so leaving it in minority logs would skew the global index of
            # every later proposal after recovery
            for r in acked:
                r.log.pop()
            raise NoQuorum("no quorum: append not committed")
        return acked

    def _replicate_msg(self, entry: _Entry,
                       leader: Optional[Replica] = None) -> List[Replica]:
        """Message path: the leader appends locally, then drives each alive
        follower up to its last entry via AppendEntries through the network.
        Unlike the direct path there is NO rollback on a lost majority — a
        minority-acked entry lingers in those logs (raft's behavior) and is
        either committed later under a current-term majority or truncated by
        the conflict check when a new leader's log reaches it; the §15
        idempotency table absorbs the committed-then-retried duplicates.

        ``leader`` overrides the facade leader for the stale-leader client
        path (:meth:`propose_via`): the deposed replica replicates under its
        own stale term and the quorum's higher term fences it (NotLeader)."""
        L = self.leader if leader is None else leader
        facade = leader is None
        if not L.alive:
            if facade:
                self._maybe_elect()
            raise NotLeader(f"replica {L.rid} is dead, cannot lead")
        if facade:
            L.current_term = max(L.current_term, self.term)
        entry.term = L.current_term    # a stale leader stamps its stale term
        L.log.append(entry)
        acked = [L]
        fenced: Optional[int] = None
        for r in self.replicas:
            if r is L or not r.alive:
                continue
            status, _rounds = self._catch_up(L, r)
            if status == "ok":
                acked.append(r)
            elif isinstance(status, tuple):    # ("fenced", higher_term)
                fenced = status[1]
                break
        if fenced is not None:
            # term fence (§16): some replica has seen a higher term, so this
            # leader is deposed. It steps down — adopting the higher term and
            # dropping its leadership belief — and the client fails over.
            L.current_term = max(L.current_term, fenced)
            L.is_leader = False
            if facade:
                # the facade's notion of leadership is stale too (an aborted
                # election left adopted terms behind): re-elect at a term
                # above everything seen
                self._maybe_elect()
            raise NotLeader(
                f"replica {L.rid} deposed: term {entry.term} fenced by "
                f"term {fenced}")
        if len(acked) * 2 <= len(self.replicas):
            if facade:
                # the current leader cannot reach a majority (partitioned
                # away, or the messages died): try to fail leadership over to
                # a side that can — raft's heartbeat-timeout election, driven
                # here by the failed round. The client's retry then lands on
                # the new leader.
                self._maybe_elect()
            raise NoQuorum(
                f"no quorum: append reached {len(acked)}/"
                f"{len(self.replicas)} replicas")
        return acked

    def _catch_up(self, L: Replica, r: Replica):
        """Drive follower ``r`` to ``L``'s last entry with AppendEntries
        rounds (next_index backtracking on log rejects, snapshot install when
        the follower is behind the leader's compaction horizon), all routed
        through the network. Returns ``(status, rounds)`` where status is
        ``"ok"``, ``"unreachable"`` (message lost / partitioned / dead) or
        ``("fenced", higher_term)``."""
        plane = self.faults
        net = plane.net
        key = (L.rid, r.rid)
        last = L.last_index
        next_idx = min(self._next_index.get(key, last + 1), last + 1)
        rounds = 0
        # Bounded: every round either succeeds, loses a message, or moves
        # next_idx strictly down; the +4 covers a snapshot install round-trip.
        for _ in range(2 * (last - L.snapshot_index) + 4):
            rounds += 1
            if next_idx <= L.snapshot_index:
                # follower needs entries the leader has compacted away
                reply = net.send(L.rid, r.rid, r.on_install_snapshot,
                                 (L.current_term, L.snapshot,
                                  L.snapshot_index, L.snapshot_term))
                if reply is None:
                    return "unreachable", rounds
                status, info = reply
                if status == "reject_term":
                    plane.note("fenced_rejections")
                    return ("fenced", info), rounds
                next_idx = info + 1
                continue
            prev = next_idx - 1
            lo = next_idx - L.snapshot_index - 1
            reply = net.send(L.rid, r.rid, r.on_append_entries,
                             (L.current_term, prev, L.term_at(prev),
                              tuple(L.log[lo:]), L.commit_index))
            if reply is None:
                return "unreachable", rounds
            status, info = reply
            if status == "ok":
                self._next_index[key] = info + 1
                # piggybacked commit on the ack leg: the ack proves r holds
                # the leader's prefix through `info`
                if min(L.commit_index, info) > r.commit_index:
                    r.commit_index = min(L.commit_index, info)
                return "ok", rounds
            if status == "reject_term":
                plane.note("fenced_rejections")
                return ("fenced", info), rounds
            next_idx = min(next_idx - 1, info + 1)    # reject_log hint
        return "unreachable", rounds     # pathological flapping: give up,
                                         # treated as a lost ack (no commit)

    def _commit_acked(self, L: Replica, entry: _Entry, acked: List[Replica]):
        """Majority in hand: advance commits, apply on the leader (capturing
        its result/error), run the snapshot cadence, extend the leader lease.
        Shared tail of both replication paths."""
        # global index of the just-appended entry: entries [0..snapshot_index]
        # are compacted, so global = snapshot_index + local_length
        index = L.snapshot_index + len(L.log)
        result: object = None
        error: Optional[Exception] = None
        for r in acked:
            if r is L:
                # capture leader's apply result/error explicitly
                if r.applied_index < index - 1:
                    r.apply_to(index - 1)
                r.commit_index = index
                r.applied_index = index
                try:
                    result = r.state.apply(entry.cmd)
                except Exception as e:  # deterministic command error
                    error = e
            elif self.pipeline_apply:
                # pipelined (DESIGN.md §11): the follower's durable vote is
                # the log append; advancing its commit index is all the
                # critical path needs — the state-machine apply is deferred
                if index > r.commit_index:
                    r.commit_index = index
            else:
                r.apply_to(index)
        if self.faults is not None:
            # a majority ack round is a lease grant (§16): the leader may
            # serve fenced local reads until the DES clock passes the horizon
            L.lease_until = self.faults.now + self.faults.config.lease_duration
        self.proposals += 1
        self._since_snapshot += 1
        if self.snapshot_every and self._since_snapshot >= self.snapshot_every:
            for r in self.replicas:
                if r.alive:
                    r.take_snapshot()
            self._since_snapshot = 0
        return result, error

    def propose_via(self, rid: int, cmd: Tuple) -> object:
        """Submit ``cmd`` through a SPECIFIC replica as if it were the leader
        — the stale-leader client path (§16). A replica that never led (or
        already observed its deposition) rejects locally with ``NotLeader``;
        a partitioned deposed leader that still believes it leads replicates
        under its stale term and is fenced by the quorum's higher term
        (``NotLeader``) or cannot assemble a majority (``NoQuorum``). Either
        way nothing commits through it — that is the §16 safety property."""
        r = self.replicas[rid]
        if rid == self.leader_id and (self.faults is None or r.is_leader):
            return self._propose_once(cmd)
        if self.faults is None or not r.is_leader or not r.alive:
            raise NotLeader(f"replica {rid} is not the leader")
        entry = _Entry(r.current_term, cmd)
        acked = self._replicate_msg(entry, leader=r)
        # Unreachable for a genuinely stale leader (quorum intersection: an
        # elected majority adopted a higher term, so a stale-term append can
        # reach at most a minority). Commit defensively if it ever acks.
        result, error = self._commit_acked(r, entry, acked)
        if error is not None:
            raise error
        return result

    def read_fenced(self, rid: Optional[int] = None) -> MetadataState:
        """Lease-fenced local read (§16): return the replica's state only
        while its leader lease is valid on the plane's DES clock. A deposed
        partitioned leader stops winning ack rounds, its lease stops being
        extended, and once ``plane.now`` passes the horizon its local reads
        raise :class:`LeaseExpired` instead of returning stale state."""
        r = self.replicas[self.leader_id if rid is None else rid]
        plane = self.faults
        if plane is None:
            if r.rid != self.leader_id:
                raise NotLeader(f"replica {r.rid} is not the leader")
            return r.state
        if not r.alive or not r.is_leader:
            raise NotLeader(f"replica {r.rid} is not the leader")
        if plane.now > r.lease_until:
            plane.note("fenced_rejections")
            raise LeaseExpired(
                f"replica {r.rid}'s leader lease expired at "
                f"{r.lease_until:.3f} (now {plane.now:.3f}); "
                f"re-read via the current leader")
        r.apply_pending()
        return r.state

    def sync_followers(self) -> int:
        """Post-heal reconciliation (§16): bring every alive follower up to
        the leader's log, committing any lingering prior-term suffix under
        the CURRENT term (raft's commit rule: prior-term entries commit only
        beneath a current-term entry — one no-op proposal does it). Returns
        the number of message rounds used, the bench's convergence metric.
        Direct mode replicates synchronously and needs none: returns 0."""
        if self.faults is None:
            return 0
        rounds = 0
        if not self.leader.alive:
            self._elect_msg()
        if self.leader.last_index > self.leader.commit_index:
            try:
                self._propose_once(("noop",))
            except Unavailable:
                pass    # still partitioned; callers may sync again later
        fenced = False
        for r in self.replicas:
            if not r.alive or r is self.leader:
                continue
            status, used = self._catch_up(self.leader, r)
            rounds += used
            if isinstance(status, tuple):
                fenced = True
        if fenced:
            # an aborted election left a higher adopted term somewhere:
            # re-elect above it, then reconcile once more
            self._maybe_elect()
            for r in self.replicas:
                if not r.alive or r is self.leader:
                    continue
                _status, used = self._catch_up(self.leader, r)
                rounds += used
        return rounds

    # -- linearizable reads (leader-local) -------------------------------------
    def _read_barrier(self) -> None:
        """Leader with a lingering uncommitted suffix: its commit index may
        lag entries an old leader committed (raft §8), so a leader-local read
        could miss an acked write. The election's no-op barrier normally
        closes the gap; this retries it at read time if those messages
        failed. At most ONE barrier no-op is ever appended per lingering
        suffix — if the tail already is one, the retry is a replication round
        of the existing entry, so reads while partitioned don't grow the log.
        Cheap in the steady state: two int compares."""
        L = self.leader
        if not L.alive or L.last_index <= L.commit_index or self._electing:
            return
        tail = L.log[-1] if L.log else None
        if tail is not None and tail.cmd == ("noop",) \
                and tail.term == L.current_term:
            # barrier entry already in place: one round either commits it
            # (majority holds the tail under the current term) or fails again
            acked = [L]
            for r in self.replicas:
                if r is L or not r.alive:
                    continue
                status, _rounds = self._catch_up(L, r)
                if status == "ok":
                    acked.append(r)
            if len(acked) * 2 > len(self.replicas):
                self._commit_acked(L, tail, acked)
            return
        try:
            self._propose_once(("noop",))
        except Unavailable:
            pass

    @property
    def state(self) -> MetadataState:
        if self.faults is not None:
            self._read_barrier()
        return self.leader.state

    # -- lease-read fast path (DESIGN.md §18) ----------------------------------
    def read_state(self) -> MetadataState:
        """Client-facing read entry point: serve from the leader's local
        state with NO consensus traffic while its lease covers the read.

        The fast path requires all of: the leader is alive and believes it
        leads, the DES clock has not passed its lease horizon, and its log
        has no uncommitted suffix. The last condition is the linearizability
        guard the lease alone cannot give — a freshly elected leader holds a
        lease immediately, but until its no-op barrier commits, its commit
        index may lag entries the OLD leader acked (raft §8); reading then
        could miss an acked write. ``last_index <= commit_index`` is exactly
        "the barrier has landed", so the lease read returns precisely what a
        barrier read would — at two int compares and a clock check instead
        of a replication round.

        Any condition failing falls back to :meth:`_read_state_slow`, which
        re-elects / re-barriers / renews the lease under the client
        ``RetryPolicy`` — the ``LeaseExpired``/``NotLeader`` fallback rule.
        Without a fault plane there is no clock and no lease to fence on;
        reads stay on the plain leader-local path (pre-§18, byte-identical).
        """
        plane = self.faults
        if plane is None:
            return self.leader.state
        L = self.leader
        if (L.alive and L.is_leader and plane.now <= L.lease_until
                and L.last_index <= L.commit_index):
            self.lease_reads += 1
            L.apply_pending()
            return L.state
        self.lease_fallbacks += 1
        return self._read_state_slow()

    def _read_state_slow(self) -> MetadataState:
        """Lease-read fallback: drive whatever the fast path found missing —
        a dead/deposed leader re-elects, a lingering uncommitted suffix
        re-runs the barrier, an expired lease renews through one committed
        no-op ack round (commit extends the lease, §16) — then serve through
        ``read_fenced()``. Runs under the client retry policy: a partitioned
        minority leader keeps failing here until the partition heals or the
        retry budget raises ``RetryBudgetExhausted``."""
        plane = self.faults

        def attempt(_n: int) -> MetadataState:
            if not self.leader.alive or not self.leader.is_leader:
                self._elect_msg()
            self._read_barrier()
            if plane.now > self.leader.lease_until:
                self._propose_once(("noop",))   # committed ack round renews
            return self.read_fenced()

        return run_with_retries(attempt, self.retry, plane.rng,
                                stats=self.retry_stats)

    def check_convergence(self) -> bool:
        """All alive replicas have identical applied state (test hook).

        The digest covers membership, tails, AND per-log index-run content
        (object ids + offsets/lengths, frozen stand-ins included): a replica
        that replayed a promote splice differently but landed on the same
        tails — same positions, different byte mapping — is caught, not just
        one that lost a whole log. With pipelined apply, every replica's
        deferred backlog is drained first: convergence is a statement about
        applied state, not about queued entries.

        In message mode (§16) the followers are reconciled first: replication
        is asynchronous-by-fault there, so a healed system legitimately holds
        stale followers until reconciliation traffic reaches them.
        """
        if self.faults is not None:
            self.sync_followers()

        def digest(state: MetadataState) -> bytes:
            items = []
            for lid, m in sorted(state.logs.items()):
                tails = state.tails.get(lid) if state.tails.contains(lid) else None
                items.append((lid, m.kind, m.parent, m.fork_point, tails,
                              m.stands_for, sorted(m.hli_children),
                              sorted(m.promotable_forks.items()),
                              m.index.content_digest()))
            # segment-GC manifests (§13): replicas must agree not only on the
            # log forest but on refcounts, the candidate queue (order
            # included — it decides future reclaim order), and the reclaimed
            # set, or a failover would reclaim different objects
            gc_items = (sorted(state.object_refs.items()),
                        tuple(state._reclaimable),
                        sorted(state.reclaimed))
            # compaction + tiering manifests (§14): byte-granular refcounts,
            # learned object sizes, birth ticks (they decide future demotion
            # eligibility), and the replicated cold-placement set must match
            # too, or a failover would compact/demote different objects
            compact_items = (sorted(state.object_ref_bytes.items()),
                             sorted(state.object_bytes.items()),
                             sorted(state.object_birth.items()),
                             sorted(state.cold_objects),
                             state.op_seq, state.compact_epoch)
            # idempotency dedup table (§15): content AND order — insertion
            # order is consensus order, and it decides future FIFO evictions,
            # so replicas that agree on entries but not order would diverge
            # at the next eviction. Each outcome is pickled in ISOLATION:
            # cached results are live objects that may share identity with
            # other state on one replica but not another (e.g. after a
            # snapshot round-trip), and pickle's memoization would turn that
            # invisible identity difference into a digest mismatch.
            idem_items = tuple((tok, pickle.dumps(outcome))
                               for tok, outcome in state.idem_results.items())
            # The same isolation applies to the digest as a whole: two logs
            # on one replica may share a tails tuple or index-run object that
            # a snapshot-restored peer reconstructs as distinct (equal)
            # objects, so each component is pickled separately and the digest
            # is built from the independent byte strings.
            return pickle.dumps((tuple(pickle.dumps(it) for it in items),
                                 tuple(pickle.dumps(it) for it in gc_items),
                                 tuple(pickle.dumps(it) for it in compact_items),
                                 idem_items))

        blobs = set()
        for r in self.replicas:
            if not (r.alive and r.commit_index == self.leader.commit_index):
                continue
            r.apply_pending()
            blobs.add(digest(r.state))
        return len(blobs) <= 1
