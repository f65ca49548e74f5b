"""Hierarchical Log Index (HLI, §5.4-5.5) storage: per-log index structures.

Bolt's index maps log positions -> (object, byte-range) for *locally appended*
records only; inherited positions are resolved by recursing into the parent's
index after subtracting the cumulative local-append count (§5.5.1, Fig. 4b).

Two implementations:

* :class:`RunIndex` — Bolt's index, with a beyond-paper compression: one append
  batch (= one SMR command = one contiguous position run) is stored as a single
  *run entry* with numpy offset/length arrays, so memory is O(runs) dict
  entries + packed arrays instead of per-record boxed entries. The cumulative
  local count ("local count" in the paper) is stored per run and derived per
  record inside a run (positions in a run are consecutive, so the count is
  ``run.lcum_start + offset_in_run + 1``).

* :class:`NaiveIndex` — per-record dict entries; used by the BoltNaiveCF /
  BoltMetaCpy ablation variants (§6.4, §6.5) exactly because it duplicates and
  boxes aggressively.
"""

from __future__ import annotations

import bisect
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

Span = Tuple[str, int, int]  # (object_id, offset, length)


class Run:
    __slots__ = ("start", "n", "object_id", "offsets", "lengths", "lcum_start")

    def __init__(self, start: int, object_id: str,
                 offsets: np.ndarray, lengths: np.ndarray, lcum_start: int) -> None:
        self.start = start
        self.n = len(offsets)
        self.object_id = object_id
        self.offsets = offsets
        self.lengths = lengths
        self.lcum_start = lcum_start

    @property
    def end(self) -> int:
        return self.start + self.n

    @property
    def lcum_end(self) -> int:
        return self.lcum_start + self.n

    def span(self, i: int, j: Optional[int] = None) -> List[Span]:
        """Byte spans for records [i, j) within this run (run-relative),
        coalescing contiguous byte ranges into one span (fewer GETs).
        Vectorized: group boundaries come from one numpy comparison instead of
        a per-record Python loop (DESIGN.md §10)."""
        j = self.n if j is None else j
        if j <= i:
            return []
        if j - i == 1:
            return [(self.object_id, int(self.offsets[i]), int(self.lengths[i]))]
        offs = self.offsets[i:j]
        lens = self.lengths[i:j]
        # a new span starts wherever a record is not byte-adjacent to its
        # predecessor: offs[k] != offs[k-1] + lens[k-1]
        breaks = np.flatnonzero(offs[1:] != offs[:-1] + lens[:-1]) + 1
        starts = np.empty(len(breaks) + 1, dtype=np.int64)
        starts[0] = 0
        starts[1:] = breaks
        ends = np.empty_like(starts)
        ends[:-1] = breaks
        ends[-1] = j - i
        cum = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=cum[1:])
        obj = self.object_id
        return [(obj, o, ln) for o, ln in zip(offs[starts].tolist(),
                                              (cum[ends] - cum[starts]).tolist())]

    def record_spans(self, i: int, j: Optional[int] = None) -> List[Span]:
        j = self.n if j is None else j
        obj = self.object_id
        return [(obj, o, ln) for o, ln in zip(self.offsets[i:j].tolist(),
                                              self.lengths[i:j].tolist())]

    def nbytes(self) -> int:
        return (sys.getsizeof(self.start) * 3 + len(self.object_id)
                + self.offsets.nbytes + self.lengths.nbytes)


class RunIndex:
    """Sorted run entries over strictly-increasing position ranges."""

    def __init__(self) -> None:
        self._starts: List[int] = []
        self._runs: List[Run] = []

    # -- writes -------------------------------------------------------------
    def append_run(self, start: int, object_id: str,
                   offsets: np.ndarray, lengths: np.ndarray) -> None:
        assert not self._runs or start >= self._runs[-1].end, "runs must advance"
        lcum = self._runs[-1].lcum_end if self._runs else 0
        self._runs.append(Run(start, object_id,
                              np.asarray(offsets, dtype=np.int64),
                              np.asarray(lengths, dtype=np.int64), lcum))
        self._starts.append(start)

    # -- queries --------------------------------------------------------------
    @property
    def total_local(self) -> int:
        return self._runs[-1].lcum_end if self._runs else 0

    @property
    def num_runs(self) -> int:
        return len(self._runs)

    def runs(self) -> List[Run]:
        return self._runs

    def first_start(self) -> Optional[int]:
        return self._starts[0] if self._starts else None

    def local_count_before(self, pos: int) -> int:
        """Number of local records at positions < pos (the paper's ``l``)."""
        i = bisect.bisect_right(self._starts, pos) - 1
        if i < 0:
            return 0
        r = self._runs[i]
        if pos >= r.end:
            return r.lcum_end
        return r.lcum_start + (pos - r.start)

    def segments(self, lo: int, hi: int) -> Iterator[Tuple[str, int, int, object]]:
        """Decompose [lo, hi) into ('local', a, b, run) and ('gap', a, b, lcount)
        segments in position order; gap segments carry the local count before
        the gap (for translating into the parent)."""
        pos = lo
        i = bisect.bisect_right(self._starts, lo) - 1
        if i < 0:
            i = 0
        while pos < hi:
            # skip runs that end at/before pos
            while i < len(self._runs) and self._runs[i].end <= pos:
                i += 1
            if i >= len(self._runs):
                yield ("gap", pos, hi, self.total_local)
                return
            r = self._runs[i]
            if r.start > pos:
                g_hi = min(r.start, hi)
                yield ("gap", pos, g_hi, r.lcum_start)
                pos = g_hi
                if pos >= hi:
                    return
            seg_hi = min(r.end, hi)
            if seg_hi > pos:
                yield ("local", pos, seg_hi, r)
                pos = seg_hi

    def content_digest(self) -> Tuple:
        """Hashable run-level content identity: positions, object ids, and
        exact byte ranges. Two indexes with equal tails can still differ here
        (e.g. a promote splice replayed differently), which is what the
        replica-convergence check must catch."""
        return tuple((r.start, r.object_id, r.offsets.tobytes(), r.lengths.tobytes())
                     for r in self._runs)

    def object_refcounts(self) -> dict:
        """Per-object reference multiset of this index: object id -> number of
        runs referencing it. This is the unit the segment-GC manifests count
        (DESIGN.md §13): an object is reclaimable only when the sum of these
        over every log (live or frozen) reaches zero."""
        out: dict = {}
        for r in self._runs:
            out[r.object_id] = out.get(r.object_id, 0) + 1
        return out

    def object_refbytes(self) -> dict:
        """Per-object referenced-byte multiset: object id -> total bytes this
        index's runs reference in it (overlaps counted once per run, shared
        runs once per attached index — same multiset semantics as
        ``object_refcounts``). This is what the compaction manifests
        (DESIGN.md §14) aggregate into per-object live-byte ratios."""
        out: dict = {}
        for r in self._runs:
            out[r.object_id] = out.get(r.object_id, 0) + int(r.lengths.sum())
        return out

    def snapshot(self) -> "RunIndex":
        """O(runs) snapshot sharing the (immutable) Run objects — used when a
        promote must preserve the old index for severed/frozen dependents."""
        s = RunIndex()
        s._starts = list(self._starts)
        s._runs = list(self._runs)
        return s

    def nbytes(self) -> int:
        return (sum(r.nbytes() for r in self._runs)
                + sys.getsizeof(self._starts) + sys.getsizeof(self._runs))


class NaiveIndex:
    """Per-record dict index (ablation variants)."""

    def __init__(self) -> None:
        self.entries: dict = {}       # pos -> (object_id, offset, length)
        self._local_positions: List[int] = []  # sorted; positions appended locally
        # For BoltNaiveCF, copied (inherited) entries are in ``entries`` but not
        # in ``_local_positions`` — lookups never need local counts there.

    def add_local(self, pos: int, span: Span) -> None:
        self.entries[pos] = span
        self._local_positions.append(pos)

    def add_copy(self, pos: int, span: Span) -> None:
        self.entries[pos] = span

    @property
    def total_local(self) -> int:
        return len(self._local_positions)

    def get(self, pos: int) -> Optional[Span]:
        return self.entries.get(pos)

    def content_digest(self) -> Tuple:
        return (tuple(sorted(self.entries.items())),
                tuple(sorted(self._local_positions)))

    def object_refcounts(self) -> dict:
        """Per-object reference multiset (DESIGN.md §13): one reference per
        entry, copies included — a BoltNaiveCF descendant's copied entries
        keep their object alive exactly as long as the descendant exists."""
        out: dict = {}
        for obj, _off, _ln in self.entries.values():
            out[obj] = out.get(obj, 0) + 1
        return out

    def object_refbytes(self) -> dict:
        """Per-object referenced-byte multiset (one contribution per entry,
        copies included) — see :meth:`RunIndex.object_refbytes`."""
        out: dict = {}
        for obj, _off, ln in self.entries.values():
            out[obj] = out.get(obj, 0) + ln
        return out

    def nbytes(self) -> int:
        n = sys.getsizeof(self.entries) + sys.getsizeof(self._local_positions)
        for k, v in self.entries.items():
            n += sys.getsizeof(k) + sys.getsizeof(v) + sum(sys.getsizeof(x) for x in v)
        return n
