"""Ad-hoc IoT analytics agent (§6.8, Figure 12) — works on an sFork.

Task: "look for anomalies in the first N records". The replayed plan:
  1. probe: sample records to infer the schema,
  2. fan out parallel investigations (per-metric scans: range stats,
     spike detection, status correlation),
  3. correlate anomalies across metrics and report.

Each investigation issues bulk reads against the fork — the load pattern the
isolation benchmark measures. The agent never touches the root log.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..streams.records import decode_record
from ..streams.topics import Topic


@dataclass
class Investigation:
    name: str
    reads: int = 0
    findings: List[str] = field(default_factory=list)


class AnalyticsAgent:
    def __init__(self, topic: Topic, scan_limit: int = 1_000_000,
                 chunk: int = 4096) -> None:
        self.source = topic
        self.scan_limit = scan_limit
        self.chunk = chunk
        self.fork: Optional[Topic] = None
        self.investigations: List[Investigation] = []
        self.tool_calls: List[str] = []

    # -- tools -------------------------------------------------------------------
    def _tool_read(self, lo: int, hi: int) -> List[dict]:
        self.tool_calls.append(f"read[{lo}:{hi})")
        raw = self.fork.log.read(lo, hi)
        return [decode_record(b) for b in raw]

    # -- the replayed plan ----------------------------------------------------------
    def run(self) -> Dict[str, object]:
        # step 0: isolate on a severed fork (point-in-time task: sFork suffices)
        self.fork = self.source.sfork(dedicated=True)
        self.tool_calls.append("sfork")
        n = min(self.scan_limit, self.fork.tail)

        # step 1: probe schema from a sample
        sample = self._tool_read(0, min(16, n))
        metrics = sorted({k for r in sample for k in r
                          if isinstance(r[k], (int, float)) and k != "ts"})

        # step 2: parallel investigations (one scan per metric + status scan)
        stats: Dict[str, List[float]] = {m: [] for m in metrics}
        spikes: Dict[str, List[int]] = {m: [] for m in metrics}
        running: Dict[str, tuple] = {m: (0.0, 0.0, 0) for m in metrics}  # sum, sumsq, k
        invs = {m: Investigation(f"scan:{m}") for m in metrics}
        status_inv = Investigation("scan:status")
        self.investigations = list(invs.values()) + [status_inv]
        bad_status_at: List[int] = []

        for lo in range(0, n, self.chunk):
            hi = min(lo + self.chunk, n)
            recs = self._tool_read(lo, hi)
            for m in metrics:
                invs[m].reads += 1
                s, s2, k = running[m]
                for i, r in enumerate(recs):
                    v = r.get(m)
                    if v is None:
                        continue
                    if k > 32:
                        mean = s / k
                        var = max(s2 / k - mean * mean, 1e-12)
                        if abs(v - mean) > 6 * var ** 0.5:
                            spikes[m].append(lo + i)
                            invs[m].findings.append(
                                f"spike {m}={v:.3g} at {lo + i} (mean {mean:.3g})")
                    s += v
                    s2 += v * v
                    k += 1
                running[m] = (s, s2, k)
            status_inv.reads += 1
            for i, r in enumerate(recs):
                if r.get("status") not in (None, "ok"):
                    bad_status_at.append(lo + i)

        # step 3: correlate spikes with status anomalies
        correlated = []
        bad = set(bad_status_at)
        for m in metrics:
            for pos in spikes[m]:
                near = [b for b in bad if abs(b - pos) <= 2]
                if near:
                    correlated.append((m, pos, sorted(near)))
        return {
            "metrics": metrics,
            "spikes": {m: v for m, v in spikes.items() if v},
            "bad_status_positions": bad_status_at,
            "correlated": correlated,
            "tool_calls": len(self.tool_calls),
        }

    def cleanup(self) -> None:
        if self.fork is not None:
            self.fork.log.squash()
            self.fork = None
