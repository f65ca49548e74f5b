"""AgileLog / Bolt — the paper's primary contribution.

Layers (bottom-up):
  objectstore — S3-like shared storage (diskless substrate)
  index       — Hierarchical Log Index (HLI) run entries + naive variants
  ltt         — Lazy Tail Tree (Euler tour in a treap, lazy range updates)
  metadata    — the SMR state machine: forks, promote, squash, reads
  raft        — replicated metadata service (majority commit, failover)
  broker      — stateless brokers (append batching, object cache, DES hooks)
  gc          — lineage-aware segment garbage collection: consensus-ordered
                manifests + broker-side reaper (DESIGN.md §13)
  compact     — segment compaction + cold tiering: live-byte manifests,
                consensus-ordered index swaps, age-based demotion into a
                compressed store class (DESIGN.md §14)
  faults      — deterministic fault-injection plane + client retry policy
                (seeded per-site probabilities, DES-time kill/recover
                schedules, bounded backoff — DESIGN.md §15) + the message-
                level network layer (drop/delay/duplicate/reorder, partitions
                — DESIGN.md §16)
  linearize   — general porcupine-style linearizability checker over
                recorded append/read histories (DESIGN.md §16)
  api         — the agent-session client API (receipts, speculation sessions,
                tailing subscriptions — DESIGN.md §12) + BoltSystem wiring
  sim         — deterministic DES used by isolation benchmarks
"""

from .api import (AgileLog, AppendReceipt, BoltSystem, CommitResult,
                  Speculation, Subscription)
from .broker import GroupCommitConfig
from .compact import (CompactionConfig, Compactor, CompactStats, TieringConfig,
                      TierManager, TierStats)
from .errors import (AgileLogError, AmbiguousProposal, BrokerCrashed,
                     ConflictError, ForkBlocked, InvalidOperation,
                     LeaseExpired, NoLiveBrokers, NoQuorum, NotLeader,
                     ObjectMissing, RetryBudgetExhausted, StoreFault,
                     Unavailable, UnknownLog)
from .faults import FaultConfig, FaultPlane, LinkFaults, RetryPolicy, RetryStats
from .gc import GarbageCollector, GCConfig, GCStats
from .linearize import History, LinearizeResult, check_log
from .objectstore import (FileObjectStore, MemoryObjectStore, ObjectStore,
                          RangedStore, StoreProfile, TieredObjectStore)

__all__ = [
    "AgileLog", "AppendReceipt", "BoltSystem", "CommitResult", "Speculation",
    "Subscription", "GroupCommitConfig", "GarbageCollector", "GCConfig",
    "GCStats", "CompactionConfig", "Compactor", "CompactStats",
    "TieringConfig", "TierManager", "TierStats",
    "ObjectStore", "StoreProfile", "MemoryObjectStore", "FileObjectStore",
    "RangedStore", "TieredObjectStore",
    "FaultConfig", "FaultPlane", "LinkFaults", "RetryPolicy", "RetryStats",
    "History", "LinearizeResult", "check_log",
    "AgileLogError", "ConflictError", "ForkBlocked",
    "InvalidOperation", "UnknownLog", "ObjectMissing",
    "Unavailable", "NoQuorum", "NotLeader", "LeaseExpired", "NoLiveBrokers",
    "StoreFault", "BrokerCrashed", "AmbiguousProposal",
    "RetryBudgetExhausted",
]
