"""The paper's OWN system configuration (§6 Setup) — used by benchmarks.

CloudLab x1170: nine MinIO storage nodes, three metadata replicas, one
broker per node, 4 KB records. Our benchmarks scale record counts for the
1-CPU container but keep the structural ratios; `BoltDeployment.make()`
builds the equivalently-shaped in-process system.
"""

from dataclasses import dataclass

from ..core import BoltSystem


@dataclass(frozen=True)
class BoltDeployment:
    n_storage_nodes: int = 9       # MinIO nodes (store parallelism in DES)
    n_meta_replicas: int = 3       # Raft group size
    n_brokers: int = 4             # broker pool (root + fork brokers)
    record_bytes: int = 4096       # paper's record size
    snapshot_every: int = 1024     # metadata log compaction cadence

    def make(self, **overrides) -> BoltSystem:
        kw = dict(n_brokers=self.n_brokers,
                  n_meta_replicas=self.n_meta_replicas,
                  snapshot_every=self.snapshot_every)
        kw.update(overrides)
        return BoltSystem(**kw)


PAPER = BoltDeployment()
