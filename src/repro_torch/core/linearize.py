"""General linearizability checker over forkable-log histories (DESIGN.md §16).

Porcupine-style (WGL: Wing & Gong with memoization, as used by Jepsen's knossos
and etcd's porcupine): given a concurrent history of client operations —
appends that returned positions, reads that returned records, cForks that
returned a child log id, and operations whose outcome is *unknown* (the client
saw a transient error after the effect may have landed) — search for a total
order that

  * respects real time: if op A's response preceded op B's invocation, A
    linearizes before B;
  * matches the sequential forkable-log spec: an append takes the next
    consecutive positions in its target log AND lands at the tail of every
    live descendant fork (the cFork sharing semantics: `_apply_append` range-
    adds the whole LTT subtree); a cFork snapshots the parent's content; a
    read returns exactly the records below its range bound;
  * places every unknown-outcome operation either at one point (it happened
    once) or nowhere (it never happened) — the §15 at-most-once contract.

The checker replaces the bespoke "acked positions hold, no duplicates"
assertions in ``tests/test_fault_tolerance_e2e.py`` with a strictly stronger
statement: those assertions follow from linearizability of the recorded
history, and the checker additionally rejects reorderings, lost acks that
resurface at the wrong position, and dedup failures (a retried ambiguous
append applying twice shifts every later append's positions — the mutation
test in the e2e suite pins that detection).

Concurrency in a single-threaded trace runner is real, not simulated: a
group-commit ``append_batch`` returns a *receipt* whose positions resolve at
flush time, so the operation's response event happens many client steps after
its invocation — reads in between legitimately miss it. The recorder stamps
invocation/response with a logical clock; receipt resolution is the response.

Squash needs no modeling: it discards a fork subtree without touching the
parent, and a squashed log is never read afterwards — any trailing unknown
append on it simply linearizes before the (unrecorded) squash or nowhere.
Promotable forks (withheld positions, promote splices) are outside the
recorded histories' scope.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

INF = float("inf")


@dataclass
class Op:
    """One client-visible operation in a history.

    ``ret_time`` is +inf until the response resolves; an op whose outcome
    never resolved (``ok is None``) stays concurrent with everything after
    its invocation and may linearize anywhere after ``call`` — or nowhere.
    """
    opid: int
    kind: str                      # "append" | "read" | "cfork"
    log_id: int                    # target log (cfork: the parent)
    payload: tuple                 # append: records; read: (lo, hi); cfork: ()
    call: int                      # invocation timestamp (logical clock)
    ret_time: float = INF          # response timestamp (+inf = unresolved)
    ret: Optional[tuple] = None    # append: positions; read: records;
                                   # cfork: (child_log_id,)
    ok: Optional[bool] = None      # True=resolved, None=unknown, False=no-op


class History:
    """Recorder: ``invoke`` at the call site, then exactly one of ``resolve``
    (outcome known), ``unknown`` (transient error — effect may have landed),
    or ``discard`` (known no-effect, e.g. a deterministic command rejection:
    the op is dropped from the history)."""

    def __init__(self) -> None:
        self.ops: List[Op] = []
        self._clock = 0
        self._next_opid = 0
        self.base: Dict[int, int] = {}     # pre-existing log -> first known pos

    def tick(self) -> int:
        self._clock += 1
        return self._clock

    def register_log(self, log_id: int, base: int = 0) -> None:
        """Declare a log that exists BEFORE the history starts, with content
        below ``base`` unknown (and unchecked). Logs created mid-history are
        declared by their recorded cfork op instead — their full content,
        inherited prefix included, is then checked."""
        self.base[log_id] = base

    def invoke(self, kind: str, log_id: int, payload: tuple) -> Op:
        op = Op(self._next_opid, kind, log_id, payload, self.tick())
        self._next_opid += 1
        self.ops.append(op)
        return op

    def resolve(self, op: Op, ret: tuple) -> None:
        op.ret = tuple(ret)
        op.ok = True
        op.ret_time = self.tick()

    def unknown(self, op: Op) -> None:
        op.ok = None                       # at-most-once: may linearize 0 or 1 times

    def discard(self, op: Op) -> None:
        op.ok = False                      # known no-effect: drop from history

    def settle(self, log_id: int, content: tuple) -> None:
        """Post-trace settlement of unknown-outcome appends to ``log_id``
        against a final full read of ``content`` (the whole log from position
        0). Records are globally unique in the recorded workloads, so an
        unknown append whose records are absent definitely never landed (drop
        it) and one whose records sit at consecutive positions landed exactly
        there (resolve it, response = now). Both decisions are forced by the
        final read — this only prunes the search's branching, it cannot mask
        a violation: a record planted at inconsistent positions still fails
        ``check``."""
        index: Dict[object, int] = {}
        for i, rec in enumerate(content):
            index[rec] = i
        for op in self.ops:
            if op.log_id != log_id or op.kind != "append" or op.ok is not None:
                continue
            positions = [index.get(r) for r in op.payload]
            if all(p is None for p in positions):
                op.ok = False              # never landed
            elif None not in positions and positions == list(
                    range(positions[0], positions[0] + len(positions))):
                self.resolve(op, tuple(positions))

    # -- checking -----------------------------------------------------------
    def check(self) -> "LinearizeResult":
        ops = [op for op in self.ops if op.ok is not False]
        return check_history(ops, dict(self.base))


@dataclass
class LinearizeResult:
    ok: bool
    log_id: Optional[int]
    reason: Optional[str]

    def __bool__(self) -> bool:
        return self.ok


# ---------------------------------------------------------------------------
# the WGL search over the multi-log sequential model
# ---------------------------------------------------------------------------
#
# Model state: log_id -> (parent_id, base, entries) where positions
# [base, base+len(entries)) hold `entries` and [0, base) is unknown (only
# nonzero for pre-registered logs; cfork children inherit the parent's base).

def _is_descendant(logs: dict, y: int, x: int) -> bool:
    """Is y == x or a transitive fork of x (walking parent links)?"""
    seen = 0
    while y is not None:
        if y == x:
            return True
        y = logs[y][0]
        seen += 1
        assert seen <= len(logs), "parent-link cycle"
    return False


def _apply(logs: dict, op: Op) -> Optional[dict]:
    """Run ``op`` against the model. Returns the successor state, or None if
    the op's observed return value is impossible at this point in the order."""
    if op.log_id not in logs:
        return None
    parent, base, entries = logs[op.log_id]
    if op.kind == "append":
        records = tuple(op.payload)
        if op.ok and op.ret is not None:
            # resolved positions pin the linearization point exactly
            nxt = base + len(entries)
            if op.ret != tuple(range(nxt, nxt + len(records))):
                return None
        out = dict(logs)
        for lid, (p, b, e) in logs.items():
            # cFork sharing: the append lands in the target log AND at the
            # current tail of every live descendant fork
            if _is_descendant(logs, lid, op.log_id):
                out[lid] = (p, b, e + records)
        return out
    if op.kind == "read":
        lo, hi = op.payload
        next_pos = base + len(entries)
        if hi > next_pos:
            return None                    # read past the tail cannot succeed
        want = entries[max(lo, base) - base: hi - base]
        got = () if op.ret is None else tuple(op.ret[max(lo, base) - lo:])
        if got != want:
            return None                    # (prefix below a pre-registered
        return logs                        # log's `base` is unchecked)
    if op.kind == "cfork":
        if op.ret is None:
            return None                    # unresolved cforks aren't recorded
        child = op.ret[0]
        if child in logs:
            return None
        out = dict(logs)
        out[child] = (op.log_id, base, entries)   # snapshot the parent
        return out
    raise ValueError(f"unknown op kind {op.kind!r}")


def _freeze(logs: dict) -> tuple:
    return tuple(sorted((lid,) + logs[lid] for lid in logs))


def check_history(ops: List[Op], bases: Dict[int, int]) -> LinearizeResult:
    """WGL search over the whole history. Exponential in the worst case,
    memoized on (remaining-ops, model-state); the histories the e2e suite
    records have few concurrent windows, so the search is effectively linear
    there."""
    if not ops:
        return LinearizeResult(True, None, None)
    ops = sorted(ops, key=lambda o: (o.call, o.opid))
    init = {lid: (None, base, ()) for lid, base in bases.items()}
    seen = set()
    # the search keeps one frame per linearized op, so depth is linear in
    # history length — benchmark-scale traces (§18 lease-read histories run
    # thousands of ops) need headroom past the interpreter default
    limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(limit, 2 * len(ops) + 1000))

    def minimal(remaining: frozenset) -> List[Op]:
        """Ops that may linearize next: nothing still pending responded
        before their invocation."""
        pending = [o for o in ops if o.opid in remaining]
        horizon = min((o.ret_time for o in pending), default=INF)
        return [o for o in pending if o.call <= horizon]

    def search(remaining: frozenset, logs: dict) -> bool:
        if not remaining:
            return True
        key = (remaining, _freeze(logs))
        if key in seen:
            return False
        seen.add(key)
        for op in minimal(remaining):
            nxt = _apply(logs, op)
            if nxt is not None and search(remaining - {op.opid}, nxt):
                return True
            if op.ok is None:
                # unknown outcome: it may also have never happened — decide
                # "skipped" at its minimal point and move on
                if search(remaining - {op.opid}, logs):
                    return True
        return False

    try:
        ok = search(frozenset(o.opid for o in ops), init)
    finally:
        sys.setrecursionlimit(limit)
    if ok:
        return LinearizeResult(True, None, None)
    return LinearizeResult(
        False, None,
        f"no linearization of {len(ops)} ops over logs "
        f"{sorted({o.log_id for o in ops})} matches the sequential "
        "forkable-log spec")


def check_log(ops: List[Op], base: int = 0) -> LinearizeResult:
    """Single-log convenience wrapper (no forks in the op list)."""
    if not ops:
        return LinearizeResult(True, None, None)
    return check_history(ops, {ops[0].log_id: base})


def check_histories(history: History) -> LinearizeResult:
    """Convenience alias used by the tests."""
    return history.check()
