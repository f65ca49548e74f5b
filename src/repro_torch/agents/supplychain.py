"""Supply-chain restocking agent (§6.8, Figure 14) — speculative commit.

The stream carries `order` events from non-agentic producers; the agent
evaluates demand and proactively writes `restock` events. In safe mode it
opens a *speculation session* (DESIGN.md §12) — a promotable cFork under the
hood — validates by running a stateful copy of the downstream inventory
consumer on the speculative fork (which contains previous records AND live
non-agentic orders linearizably interleaved with the agent's writes — the
stateful-validation story of §4.1), then `commit()`s or `abort()`s; a commit
that races a concurrent producer auto-rebases, re-validating the delta via
the session's `on_rebase` hook. In direct mode (the Kafka-style baseline) it
writes straight to the main stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..core.errors import ConflictError
from ..streams.records import decode_record, encode_record
from ..streams.topics import Topic


class InventoryConsumer:
    """Downstream stateful application: tracks per-item inventory.
    Deliberately strict about schema (crashes on malformed events)."""

    def __init__(self, initial: Optional[Dict[str, int]] = None) -> None:
        self.inventory: Dict[str, int] = dict(initial or {})
        self.offset = 0
        self.processed = 0
        self.crashed = False

    def process(self, topic: Topic, upto: Optional[int] = None) -> int:
        hi = topic.log.visible_tail if upto is None else upto
        if hi <= self.offset:
            return 0
        n = 0
        for raw in topic.log.read(self.offset, hi):
            rec = decode_record(raw)
            kind = rec["kind"]              # KeyError on malformed -> crash
            item = rec["item"]
            qty = int(rec["qty"])           # ValueError on bad qty  -> crash
            if kind == "order":
                self.inventory[item] = self.inventory.get(item, 0) - qty
            elif kind == "restock":
                self.inventory[item] = self.inventory.get(item, 0) + qty
            else:
                raise ValueError(f"unknown event kind {kind!r}")
            n += 1
        self.offset = hi
        self.processed += n
        return n

    def snapshot(self) -> "InventoryConsumer":
        c = InventoryConsumer(self.inventory)
        c.offset = self.offset
        return c


@dataclass
class RestockDecision:
    item: str
    qty: int


class SupplyChainAgent:
    def __init__(self, topic: Topic, inject_mistake: bool = False) -> None:
        self.topic = topic
        self.inject_mistake = inject_mistake
        self.promotes = 0
        self.squashes = 0

    # -- the 'LLM' plan: demand heuristic over recent history --------------------
    def decide(self, lookback: int = 256) -> List[RestockDecision]:
        tail = self.topic.log.visible_tail
        lo = max(0, tail - lookback)
        demand: Dict[str, int] = {}
        for raw in self.topic.log.read(lo, tail):
            rec = decode_record(raw)
            if rec.get("kind") == "order":
                demand[rec["item"]] = demand.get(rec["item"], 0) + int(rec["qty"])
        return [RestockDecision(item, qty * 2) for item, qty in
                sorted(demand.items()) if qty > 4]

    def _restock_events(self, decisions: List[RestockDecision]) -> List[bytes]:
        events = []
        for i, d in enumerate(decisions):
            rec = {"kind": "restock", "item": d.item, "qty": d.qty}
            if self.inject_mistake and i == 0:
                rec = {"kind": "restock", "item": d.item, "quantity": d.qty}  # schema error
            events.append(encode_record(rec))
        return events

    # -- safe mode: speculation session (validate -> commit/abort, §12) -----------
    def _validates(self, validator_state: InventoryConsumer,
                   fork_topic: Topic) -> bool:
        """Stateful validation: run a COPY of the downstream consumer on the
        speculative fork — it sees history + live orders + agent writes,
        linearizably interleaved."""
        probe = validator_state.snapshot()
        try:
            probe.process(fork_topic)
            # the replay must not crash AND the restocked inventory must not
            # end negative — the business invariant safe mode exists to hold
            return all(v >= 0 for v in probe.inventory.values())
        except Exception:
            return False

    def run_safe(self, validator_state: InventoryConsumer) -> bool:
        decisions = self.decide()
        if not decisions:
            return False

        def revalidate(spec, lo, hi):
            # a producer raced the commit: the rebase replayed our restocks;
            # re-run the downstream probe over the rebased fork before the
            # retried promote (delta [lo, hi) now sits below the fork point)
            return self._validates(
                validator_state,
                Topic(f"{self.topic.name}/speculate", spec.log,
                      self.topic.registry))

        with self.topic.speculate(on_rebase=revalidate) as s:
            s.append_batch(self._restock_events(decisions))
            valid = self._validates(
                validator_state,
                Topic(f"{self.topic.name}/speculate", s.log, self.topic.registry))
            if valid:
                try:
                    s.commit()
                    self.promotes += 1
                except ConflictError:
                    # rebase budget exhausted or revalidation vetoed the
                    # rebased state: the session already squashed itself
                    self.squashes += 1
                    valid = False
            else:
                s.abort()
                self.squashes += 1
        return valid

    # -- direct mode (Kafka baseline): write straight to the main stream ---------
    def run_direct(self) -> int:
        decisions = self.decide()
        events = self._restock_events(decisions)
        for ev in events:
            self.topic.log.append(ev)
        return len(events)
