"""S3-like object store backends (the diskless "shared storage" layer, §5.2).

Bolt brokers are stateless: durability lives here. The backend protocol
(DESIGN.md §18) is the abstract :class:`ObjectStore` plus, per backend:

* a uniform **miss type** — every GET of an absent key raises
  :class:`~repro.core.errors.ObjectMissing`, never the backend's native error;
* the **fault hooks** (`_fault_put`/`_fault_get`/`_fault_delete`) consulted at
  every entry point, so the §15 plane exercises all backends identically;
* the **op counters** ``put_count``/``get_count``/``delete_count`` and
  ``bytes_written``/``bytes_read``/``bytes_deleted`` that ``OpTally`` captures;
* an optional DES cost :class:`StoreProfile` — brokers book store service
  times from it when present, falling back to the global ``ServiceTimes``
  store rates when it is ``None`` (the memory/tiered backends, keeping every
  pre-§18 benchmark byte-identical).

Backends:

* :class:`MemoryObjectStore` — dict-backed; the default for tests/benchmarks.
* :class:`TieredObjectStore` — hot + compressed cold store classes (§14).
* :class:`FileObjectStore`   — one file per object under a root dir, atomic
  tmp+rename PUTs with file *and directory* fsync; shared with checkpoints.
* :class:`RangedStore`       — S3-shaped cost model: high per-op latency, high
  throughput (tiny per-KB cost), and a ranged-GET *minimum billable size* —
  a 1 KB ranged GET costs the same as ``min_get_bytes`` (the
  latency-vs-throughput asymmetry real object stores have).

All support ranged GETs, which is what brokers use to fetch a single record
out of a large multi-record object.
"""

from __future__ import annotations

import os
import threading
import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from .errors import ObjectMissing


@dataclass(frozen=True)
class StoreProfile:
    """Per-backend DES service-time profile (DESIGN.md §18).

    Brokers resolve store costs through ``store.profile`` when one is set;
    ``None`` (memory/tiered) means "use the global ``ServiceTimes`` store
    rates" — the seed cost model, unchanged. ``min_get_bytes`` models the
    ranged-GET minimum of S3-class stores: every GET is billed at least that
    many bytes of transfer time, so tiny ranged reads pay the asymmetry.
    """

    put_base: float = 1.5e-3        # per-PUT latency floor (s)
    put_per_kb: float = 2e-6        # PUT transfer time per KiB
    get_base: float = 0.6e-3        # per-GET latency floor (s)
    get_per_kb: float = 1e-6        # GET transfer time per KiB
    delete_base: float = 0.5e-3     # per-DELETE latency (s)
    min_get_bytes: int = 0          # ranged-GET minimum billable size


#: Local-file backend: fsync dominates the PUT floor (file + parent dir),
#: but there is no network — per-KB transfer is cheap and GETs are page-cache
#: fast. The first *honest* durable-ack cost model in the repo.
FILE_PROFILE = StoreProfile(put_base=120e-6, put_per_kb=0.5e-6,
                            get_base=20e-6, get_per_kb=0.25e-6,
                            delete_base=30e-6, min_get_bytes=0)

#: S3-style backend: milliseconds of per-op latency, near-free marginal
#: bytes (high throughput), and a ranged-GET minimum — the classic object
#: store latency-vs-throughput asymmetry.
RANGED_PROFILE = StoreProfile(put_base=8e-3, put_per_kb=0.05e-6,
                              get_base=12e-3, get_per_kb=0.04e-6,
                              delete_base=4e-3, min_get_bytes=128 << 10)


class ObjectStore:
    """Abstract S3-ish KV-of-bytes interface (backend protocol, §18)."""

    #: Optional DES cost profile; ``None`` = global ServiceTimes store rates.
    profile: Optional[StoreProfile] = None

    #: Optional fault plane (DESIGN.md §15): backends consult it at their
    #: PUT/GET/DELETE entry points so injected store errors and torn partial
    #: PUTs exercise every layer above, deterministically.
    _faults = None

    def attach_faults(self, plane) -> None:
        self._faults = plane

    def _fault_put(self, key: str, data: bytes) -> bytes:
        """Consult the fault plane before a PUT. Returns the payload to
        durably write; raises after the caller-visible prefix of a torn PUT
        has been handed back (the *caller* of put() sees the error, the
        store commits whatever the plane let through)."""
        if self._faults is None:
            return data
        payload, error = self._faults.on_put(key, data)
        if error is not None:
            if payload is not None:
                self._commit_put(key, payload)   # the torn prefix lands
            raise error
        return data

    def _commit_put(self, key: str, data: bytes) -> None:
        """Durably write without re-consulting the fault plane (used only
        for torn-PUT prefixes). Backends that support fault injection
        override this with their raw write."""
        raise NotImplementedError

    def _fault_get(self, key: str) -> None:
        if self._faults is not None:
            self._faults.on_get(key)

    def _fault_delete(self, key: str) -> None:
        if self._faults is not None:
            self._faults.on_delete(key)

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def size(self, key: str) -> Optional[int]:
        """Object size in bytes, or None if absent (used by the GC reaper to
        book bytes_reclaimed without a GET)."""
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError


class MemoryObjectStore(ObjectStore):
    def __init__(self) -> None:
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.put_count = 0
        self.get_count = 0
        self.delete_count = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.bytes_deleted = 0

    def _commit_put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._objects[key] = bytes(data)
            self.put_count += 1
            self.bytes_written += len(data)

    def put(self, key: str, data: bytes) -> None:
        self._commit_put(key, self._fault_put(key, data))

    def get(self, key: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        self._fault_get(key)
        with self._lock:
            obj = self._objects.get(key)
            if obj is None:
                raise ObjectMissing(key)
            self.get_count += 1
            end = len(obj) if length is None else offset + length
            out = obj[offset:end]
            self.bytes_read += len(out)
            return out

    def delete(self, key: str) -> None:
        self._fault_delete(key)
        with self._lock:
            obj = self._objects.pop(key, None)
            if obj is not None:
                self.delete_count += 1
                self.bytes_deleted += len(obj)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._objects

    def size(self, key: str) -> Optional[int]:
        with self._lock:
            obj = self._objects.get(key)
            return None if obj is None else len(obj)

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._objects.values())


class TieredObjectStore(ObjectStore):
    """Two store classes behind one keyspace (DESIGN.md §14): a **hot** tier
    (raw bytes, S3-standard-like) and a **cold** tier (zlib-compressed,
    archive-like — the DES model charges it distinct, slower service times).

    Routing is by *presence*, hot tier first: whichever tier physically holds
    the key serves it, so reads stay byte-correct at every point of a
    demotion/rehydration crash window — the consensus ``cold_objects`` set is
    the durable record of where objects *belong*, and ``TierManager.resync``
    converges physical placement to it. Tier moves are split into copy and
    drop halves (``copy_to_cold``/``drop_hot``, ``rehydrate``/``drop_cold``)
    so the tier manager can order them around the consensus proposal and a
    crash between halves leaves at worst a double-resident key, never a
    missing one.

    The hot-tier counters mirror :class:`MemoryObjectStore` (``OpTally``
    captures them by name); cold traffic additionally bumps the ``cold_*``
    counters so the DES model and benchmarks can split hot vs cold bytes.
    """

    def __init__(self, compression_level: int = 1) -> None:
        self._hot: Dict[str, bytes] = {}
        self._cold: Dict[str, bytes] = {}        # compressed payloads
        self._cold_sizes: Dict[str, int] = {}    # logical (uncompressed) sizes
        self._lock = threading.Lock()
        self.compression_level = compression_level
        self.put_count = 0
        self.get_count = 0
        self.delete_count = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.bytes_deleted = 0
        self.cold_puts = 0           # demotion writes into the cold class
        self.cold_gets = 0           # GETs served by the cold class
        self.cold_bytes_read = 0     # logical bytes those GETs returned
        self.cold_bytes_written = 0  # compressed bytes demotions stored

    # -- S3-ish interface ---------------------------------------------------
    def _commit_put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._hot[key] = bytes(data)
            self.put_count += 1
            self.bytes_written += len(data)

    def put(self, key: str, data: bytes) -> None:
        self._commit_put(key, self._fault_put(key, data))

    def get(self, key: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        self._fault_get(key)
        with self._lock:
            obj = self._hot.get(key)
            cold = obj is None
            if cold:
                packed = self._cold.get(key)
                if packed is None:
                    raise ObjectMissing(key)
                obj = zlib.decompress(packed)
            self.get_count += 1
            end = len(obj) if length is None else offset + length
            out = obj[offset:end]
            self.bytes_read += len(out)
            if cold:
                self.cold_gets += 1
                self.cold_bytes_read += len(out)
            return out

    def delete(self, key: str) -> None:
        self._fault_delete(key)
        with self._lock:
            freed = 0
            obj = self._hot.pop(key, None)
            if obj is not None:
                freed += len(obj)
            if self._cold.pop(key, None) is not None:
                freed += self._cold_sizes.pop(key, 0)
            if freed or obj is not None:
                self.delete_count += 1
                self.bytes_deleted += freed

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._hot or key in self._cold

    def size(self, key: str) -> Optional[int]:
        """Logical size regardless of tier (reclaim accounting stays
        tier-agnostic)."""
        with self._lock:
            obj = self._hot.get(key)
            if obj is not None:
                return len(obj)
            return self._cold_sizes.get(key)

    def list(self, prefix: str = "") -> List[str]:
        with self._lock:
            return sorted(k for k in set(self._hot) | set(self._cold)
                          if k.startswith(prefix))

    # -- tier moves (driven by TierManager, DESIGN.md §14) ------------------
    def is_cold(self, key: str) -> bool:
        """Physically cold: no hot copy, a cold copy exists."""
        with self._lock:
            return key not in self._hot and key in self._cold

    def copy_to_cold(self, key: str) -> int:
        """Compress the hot copy into the cold class (hot copy kept — the
        drop happens after the demotion commits). Returns compressed size."""
        with self._lock:
            data = self._hot.get(key)
            if data is None:
                return len(self._cold.get(key, b""))
            packed = zlib.compress(data, self.compression_level)
            self._cold[key] = packed
            self._cold_sizes[key] = len(data)
            self.cold_puts += 1
            self.cold_bytes_written += len(packed)
            return len(packed)

    def drop_hot(self, key: str) -> None:
        with self._lock:
            assert key in self._cold, f"dropping sole copy of {key}"
            self._hot.pop(key, None)

    def rehydrate(self, key: str) -> int:
        """Decompress the cold copy back into the hot class (cold copy kept
        until the promotion commits). Returns the logical size."""
        with self._lock:
            if key in self._hot:
                return len(self._hot[key])
            data = zlib.decompress(self._cold[key])
            self._hot[key] = data
            return len(data)

    def drop_cold(self, key: str) -> None:
        with self._lock:
            if key in self._hot or key not in self._cold:
                self._cold.pop(key, None)
                self._cold_sizes.pop(key, None)

    # -- accounting ---------------------------------------------------------
    @property
    def total_bytes(self) -> int:
        """Physical footprint: hot logical bytes + cold *compressed* bytes
        (double-resident keys during a move window count both)."""
        with self._lock:
            return (sum(len(v) for v in self._hot.values())
                    + sum(len(v) for v in self._cold.values()))

    @property
    def cold_stored_bytes(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._cold.values())

    @property
    def cold_logical_bytes(self) -> int:
        with self._lock:
            return sum(self._cold_sizes.get(k, 0) for k in self._cold)


class FileObjectStore(ObjectStore):
    """Filesystem-backed store; object keys map to files (slashes allowed).

    Writes are atomic and durable: write to tmp, fsync the file, rename over
    the target, then fsync the *parent directory* — the rename itself is only
    durable once the directory entry is, which is the property the checkpoint
    manifest protocol relies on (a manifest PUT that acked must survive a
    crash). Opening a root sweeps ``*.tmp`` carcasses left by PUTs that
    crashed before their rename, mirroring ``SegmentCollector.resync()``'s
    orphan sweep: a tmp file is by construction un-acked and unreferenced.
    """

    profile = FILE_PROFILE

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.put_count = 0
        self.get_count = 0
        self.delete_count = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.bytes_deleted = 0
        self.tmp_swept = 0          # crash carcasses removed on open
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                if fn.endswith(".tmp"):
                    os.remove(os.path.join(dirpath, fn))
                    self.tmp_swept += 1

    def _path(self, key: str) -> str:
        path = os.path.join(self.root, key)
        if os.path.commonpath([os.path.abspath(path), os.path.abspath(self.root)]) != os.path.abspath(self.root):
            raise ValueError(f"key escapes store root: {key!r}")
        return path

    @staticmethod
    def _fsync_dir(path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _commit_put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        parent = os.path.dirname(path)
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        self._fsync_dir(parent)
        self.put_count += 1
        self.bytes_written += len(data)

    def put(self, key: str, data: bytes) -> None:
        self._commit_put(key, self._fault_put(key, data))

    def get(self, key: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        self._fault_get(key)
        try:
            f = open(self._path(key), "rb")
        except FileNotFoundError:
            raise ObjectMissing(key) from None
        with f:
            f.seek(offset)
            out = f.read(length) if length is not None else f.read()
        self.get_count += 1
        self.bytes_read += len(out)
        return out

    def delete(self, key: str) -> None:
        self._fault_delete(key)
        path = self._path(key)
        try:
            freed = os.path.getsize(path)
            os.remove(path)
        except FileNotFoundError:
            return
        self.delete_count += 1
        self.bytes_deleted += freed

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def size(self, key: str) -> Optional[int]:
        try:
            return os.path.getsize(self._path(key))
        except OSError:
            return None

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    @property
    def total_bytes(self) -> int:
        total = 0
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                if not fn.endswith(".tmp"):
                    total += os.path.getsize(os.path.join(dirpath, fn))
        return total


class RangedStore(MemoryObjectStore):
    """S3-shaped backend: memory-backed semantics with the S3 *cost model*
    (DESIGN.md §18) — milliseconds of per-op latency, near-free marginal
    bytes, and a ranged-GET minimum billable size. ``billed_read_bytes``
    tracks what the DES model charges (each GET at least
    ``profile.min_get_bytes``) next to the logical ``bytes_read``, so
    benchmarks can show the asymmetry a page-granular cache must amortize.
    """

    profile = RANGED_PROFILE

    def __init__(self) -> None:
        super().__init__()
        self.billed_read_bytes = 0

    def get(self, key: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        out = super().get(key, offset, length)
        self.billed_read_bytes += max(len(out), self.profile.min_get_bytes)
        return out


class SegmentWriter:
    """Builder for segment-style multi-log objects (group commit, DESIGN.md §9).

    A group-commit flush packs the records of many staged appends — possibly
    for several different logs — into one object::

        payload = records of append 0 || records of append 1 || ...

    ``add()`` returns where the append landed inside its log's *entry* (all
    appends for one log are merged, in staging order, into a single entry of
    the batched metadata proposal); ``finish()`` returns the payload plus the
    per-log ``(log_id, offsets, lengths)`` table that proposal carries. Byte
    offsets are absolute within the segment object, so readers ranged-GET a
    record without knowing anything about the batch that produced it.
    """

    def __init__(self) -> None:
        self._chunks: List[bytes] = []
        self._size = 0
        self._log_ids: List[int] = []
        self._spans: List[Tuple[List[int], List[int]]] = []  # per-entry (offsets, lengths)
        self._entry_of: Dict[int, int] = {}

    def add(self, log_id: int, records: Iterable[bytes]) -> Tuple[int, int]:
        """Append `records` for `log_id`; returns (entry_index, start) — the
        entry's position in the batch and the records' start slot within it."""
        entry_index = self._entry_of.get(log_id)
        if entry_index is None:
            entry_index = self._entry_of[log_id] = len(self._log_ids)
            self._log_ids.append(log_id)
            self._spans.append(([], []))
        offsets, lengths = self._spans[entry_index]
        start = len(offsets)
        for r in records:
            self._chunks.append(r)
            offsets.append(self._size)
            lengths.append(len(r))
            self._size += len(r)
        return entry_index, start

    @property
    def nbytes(self) -> int:
        return self._size

    @property
    def nrecords(self) -> int:
        return sum(len(offs) for offs, _ in self._spans)

    def finish(self) -> Tuple[bytes, List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]]]:
        payload = b"".join(self._chunks)
        entries = [(log_id, tuple(offs), tuple(lens))
                   for log_id, (offs, lens) in zip(self._log_ids, self._spans)]
        return payload, entries


class LRUObjectCache:
    """Broker-side object cache (§5.7: "we equip brokers with a local object
    cache") — page-granular byte-range caching (DESIGN.md §10).

    The seed version cached *whole objects*: a single-record read of a 1 MB
    group-commit segment faulted in the full megabyte. This cache holds
    fixed-size ``page_bytes`` pages per object instead. A miss fetches only
    the pages a request needs — one coalesced ranged GET per contiguous
    missing stretch (scatter-gather) — and an optional sequential-readahead
    window (``readahead_bytes``) extends the fetch when a request continues
    exactly where the previous one on the same object ended (scan-shaped
    access). Requests larger than ``capacity_bytes`` bypass the cache
    entirely: admitting them would evict everything and then churn.

    Forks of one parent co-located on one broker share this cache (the
    paper's rationale for co-location).

    Stats: ``hits``/``misses`` count *pages*; ``ranged_gets``/``bytes_fetched``
    count actual store traffic (what the DES model books, §8).
    """

    def __init__(self, store: ObjectStore, capacity_bytes: int = 64 << 20,
                 page_bytes: int = 64 << 10, readahead_bytes: int = 0) -> None:
        assert page_bytes > 0
        self.store = store
        self.capacity = capacity_bytes
        self.page_bytes = page_bytes
        self.readahead = readahead_bytes
        self._pages: "OrderedDict[Tuple[str, int], bytes]" = OrderedDict()
        self._size = 0
        self._obj_pages: Dict[str, set] = {}  # key -> resident page numbers
        self._obj_size: Dict[str, int] = {}   # sizes learned from short reads
        self._last_end: Dict[str, int] = {}   # per-object last request end
        # the two hint dicts above must stay bounded too (brokers never reuse
        # object ids, so "one entry per object ever read" is a leak): prune
        # oldest entries past a limit sized like the page population
        self._meta_limit = max(1024, capacity_bytes // page_bytes)
        self.hits = 0
        self.misses = 0
        self.ranged_gets = 0
        self.bytes_fetched = 0
        self.invalidations = 0                # invalidate_object calls

    # -- store traffic ------------------------------------------------------
    def _bypass(self, key: str, offset: int, length: Optional[int]) -> bytes:
        data = self.store.get(key, offset, length)
        self.ranged_gets += 1
        self.bytes_fetched += len(data)
        self.misses += 1
        return data

    def _admit(self, pkey: Tuple[str, int], data: bytes) -> None:
        if not data:
            return
        old = self._pages.pop(pkey, None)
        if old is not None:
            self._size -= len(old)
        self._pages[pkey] = data
        self._size += len(data)
        self._obj_pages.setdefault(pkey[0], set()).add(pkey[1])
        while self._size > self.capacity and self._pages:
            epk, evicted = self._pages.popitem(last=False)
            self._size -= len(evicted)
            self._forget_page(epk)

    def _forget_page(self, pkey: Tuple[str, int]) -> None:
        pages = self._obj_pages.get(pkey[0])
        if pages is not None:
            pages.discard(pkey[1])
            if not pages:
                del self._obj_pages[pkey[0]]

    def invalidate_object(self, key: str) -> int:
        """Drop every resident page and size/readahead hint for ``key``.

        Required before an object key can be deleted or recreated: pages are
        keyed by (object, page#) with no versioning, so a stale page would
        silently serve the OLD bytes to every later read (the pre-§13 gap —
        load-bearing once the GC reaper deletes objects, and for any backend
        caller that overwrites a key in place). Returns pages dropped."""
        self.invalidations += 1
        dropped = 0
        for p in sorted(self._obj_pages.pop(key, ())):
            page = self._pages.pop((key, p), None)
            if page is not None:
                self._size -= len(page)
                dropped += 1
        self._obj_size.pop(key, None)
        self._last_end.pop(key, None)
        return dropped

    def _fetch_pages(self, key: str, p_lo: int, p_hi: int) -> None:
        """ONE ranged GET for pages [p_lo, p_hi); splits the result into pages."""
        B = self.page_bytes
        want = (p_hi - p_lo) * B
        data = self.store.get(key, p_lo * B, want)
        self.ranged_gets += 1
        self.bytes_fetched += len(data)
        if len(data) < want:
            # short read: p_lo*B + len(data) is the object's size when the
            # offset was in range, and an upper bound on it otherwise
            bound = p_lo * B + len(data)
            known = self._obj_size.get(key)
            self._obj_size[key] = bound if known is None else min(known, bound)
        for i in range(0, len(data), B):
            self._admit((key, p_lo + i // B), data[i:i + B])

    def _ensure(self, key: str, pages: List[int], ra_pages: int) -> None:
        """Make the given (sorted) pages resident: coalesce missing stretches
        into one ranged GET each; extend the last stretch by the readahead."""
        size = self._obj_size.get(key)
        B = self.page_bytes
        missing: List[int] = []
        for p in pages:
            if size is not None and p * B >= size:
                continue   # provably beyond the object's end
            pk = (key, p)
            if pk in self._pages:
                self._pages.move_to_end(pk)
                self.hits += 1
            else:
                missing.append(p)
                self.misses += 1
        if not missing:
            return
        stretches: List[List[int]] = []
        for p in missing:
            if stretches and p == stretches[-1][1]:
                stretches[-1][1] = p + 1
            else:
                stretches.append([p, p + 1])
        if ra_pages > 0:
            a, b = stretches[-1]
            max_p = None if size is None else (size + B - 1) // B
            ext = b
            while (ext < b + ra_pages and (max_p is None or ext < max_p)
                   and (key, ext) not in self._pages):
                ext += 1
            stretches[-1][1] = ext
        for a, b in stretches:
            self._fetch_pages(key, a, b)

    def _assemble(self, key: str, offset: int, length: int) -> bytes:
        """Slice [offset, offset+length) out of resident pages; truncates at
        the object's end exactly like ``ObjectStore.get`` does."""
        B = self.page_bytes
        end = offset + length
        parts: List[bytes] = []
        pos = offset
        while pos < end:
            p, a = divmod(pos, B)
            page = self._pages.get((key, p))
            if page is None or a >= len(page):
                size = self._obj_size.get(key)
                if size is not None and pos >= size:
                    break   # provably past the object's end
                # a near-capacity request can evict its own earlier pages
                # between _ensure and assembly — fall back to a direct read
                # of the remainder rather than silently truncating
                parts.append(self._bypass(key, pos, end - pos))
                break
            take = page[a:min(end - p * B, len(page))]
            parts.append(take)
            pos += len(take)
            if len(page) < B:
                break
        return b"".join(parts)

    def _prune_meta(self) -> None:
        while len(self._obj_size) > self._meta_limit:
            self._obj_size.pop(next(iter(self._obj_size)))
        while len(self._last_end) > self._meta_limit:
            self._last_end.pop(next(iter(self._last_end)))

    # -- public API ---------------------------------------------------------
    def get(self, key: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        if length is None:
            size = self._obj_size.get(key)
            if size is None:
                # whole-object fetch of unknown size: one GET; admit pages
                # only if the object fits (oversized objects bypass — they
                # would evict the entire cache and then not even be reusable)
                data = self._bypass(key, 0, None)
                self._obj_size[key] = len(data)
                self._last_end[key] = len(data)
                if len(data) <= self.capacity:
                    B = self.page_bytes
                    for i in range(0, len(data), B):
                        self._admit((key, i // B), data[i:i + B])
                self._prune_meta()
                return data[offset:]
            length = max(0, size - offset)
        return self.get_spans([(key, offset, length)])[0]

    def get_spans(self, spans: Iterable[Tuple[str, int, int]]) -> List[bytes]:
        """Scatter-gather ranged reads: spans are grouped by object, each
        object's missing pages coalesce into minimal ranged GETs, results
        come back in input order."""
        spans = list(spans)
        out: List[Optional[bytes]] = [None] * len(spans)
        by_obj: Dict[str, List[int]] = {}
        for i, (key, _off, _ln) in enumerate(spans):
            by_obj.setdefault(key, []).append(i)
        B = self.page_bytes
        for key, idxs in by_obj.items():
            small: List[int] = []
            for i in idxs:
                _, off, ln = spans[i]
                if ln > self.capacity:
                    out[i] = self._bypass(key, off, ln)   # oversized: bypass
                elif ln <= 0:
                    out[i] = b""
                else:
                    small.append(i)
            if not small:
                continue
            pages: set = set()
            lo = min(spans[i][1] for i in small)
            hi = max(spans[i][1] + spans[i][2] for i in small)
            for i in small:
                _, off, ln = spans[i]
                pages.update(range(off // B, (off + ln + B - 1) // B))
            seq = self.readahead > 0 and self._last_end.get(key) == lo
            self._ensure(key, sorted(pages), (self.readahead // B) if seq else 0)
            self._last_end.pop(key, None)   # re-insert: prune is oldest-first
            self._last_end[key] = hi
            for i in small:
                out[i] = self._assemble(key, spans[i][1], spans[i][2])
        self._prune_meta()
        return out  # type: ignore[return-value]
