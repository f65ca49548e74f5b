"""Stream-processor testing agent (§6.8, Figure 13) — non-promotable cForks.

The agent tests a tumbling-window StreamProcessor under corner cases (late,
malformed, duplicate records) by injecting test events into cForks of the
production stream — so every test sees *real* data with the synthetic events
linearizably interleaved — then running a processor copy on the fork and
collecting failures. Each test case = one cFork, run, squash.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List

from ..streams.topics import StreamProcessor, Topic


@dataclass
class TestReport:
    name: str
    injected: int
    crashed: bool
    error: str = ""
    windows: int = 0
    notes: List[str] = field(default_factory=list)


class StreamTestingAgent:
    def __init__(self, topic: Topic, window_ms: float = 5.0) -> None:
        self.source = topic
        self.window_ms = window_ms
        self.reports: List[TestReport] = []

    # -- the test-case tool (create cFork, inject, run processor, squash) -------
    def _run_case(self, name: str, inject: Callable[[Topic], int]) -> TestReport:
        fork = self.source.cfork(promotable=False)
        injected = inject(fork)
        report = TestReport(name, injected, crashed=False)
        proc = StreamProcessor(fork, window_ms=self.window_ms)
        try:
            proc.run_to_tail()
            report.windows = len(proc.results)
        except Exception as e:
            report.crashed = True
            report.error = f"{type(e).__name__}: {e}"
        finally:
            fork.log.squash()
        self.reports.append(report)
        return report

    # -- recorded test plan ------------------------------------------------------
    def run(self) -> Dict[str, object]:
        from ..streams.records import encode_record

        def inject_late(fork: Topic) -> int:
            # events with timestamps far in the past (straggler window)
            for i in range(8):
                fork.log.append(encode_record({"ts": 0.0 + i * 0.1, "value": 1.0}))
            return 8

        def inject_malformed(fork: Topic) -> int:
            fork.log.append(encode_record({"ts": "not-a-number", "value": 1.0}))
            fork.log.append(encode_record({"value": 2.0}))           # missing ts
            fork.log.append(encode_record({"ts": 1.0, "value": "NaN?"}))
            return 3

        def inject_duplicates(fork: Topic) -> int:
            for _ in range(5):
                fork.log.append(encode_record({"ts": 3.0, "value": 7.0, "key": "dup"}))
            return 5

        def inject_schema_evolution(fork: Topic) -> int:
            fork.log.append(encode_record(
                {"ts": 4.0, "value": 1.0, "new_field": {"nested": True}}))
            return 1

        self._run_case("late-records", inject_late)
        self._run_case("malformed-records", inject_malformed)
        self._run_case("duplicate-records", inject_duplicates)
        self._run_case("schema-evolution", inject_schema_evolution)
        return {
            "cases": len(self.reports),
            "bugs_found": [r.name for r in self.reports if r.crashed],
            "reports": self.reports,
        }
