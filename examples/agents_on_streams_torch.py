"""The paper's three agentic applications (§6.8) end to end, in the PyTorch
port. The twin of ``examples/agents_on_streams.py``; it imports nothing of
JAX. The agents are host code over the log: like every entry point of the
port, the script asks for the card unless ``--device`` names another, and
stops where the device asked for is missing.

    PYTHONPATH=src python examples/agents_on_streams_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.agents import AnalyticsAgent, StreamTestingAgent, SupplyChainAgent
from repro_torch.agents.supplychain import InventoryConsumer
from repro_torch.core import BoltSystem
from repro_torch.models.layers import resolve_device
from repro_torch.streams import Producer, Topic

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
print("device:", resolve_device(args.device))

system = BoltSystem(n_brokers=4)

# ---------------------------------------------------------- analytics (sFork)
iot = Topic.create(system, "iot")
prod = Producer(iot, linger_records=128)
rng = np.random.default_rng(0)
for i in range(5000):
    temp = float(rng.normal(20, 0.5)) + (40.0 if i in (1200, 3900) else 0.0)
    prod.produce({"ts": i / 1000, "temperature": temp, "humidity": 55.0,
                  "status": "ok" if temp < 50 else "sensor-fault"})
prod.flush()

agent = AnalyticsAgent(iot, scan_limit=5000, chunk=512)
report = agent.run()
print("[analytics] anomalies:", report["spikes"])
print("[analytics] correlated with status faults:", report["correlated"])
print("[analytics] root log untouched:", iot.tail == 5000)
agent.cleanup()

# ------------------------------------------------ testing (non-promotable cFork)
events = Topic.create(system, "events")
prod = Producer(events, linger_records=128)
for i in range(2000):
    prod.produce({"ts": i * 0.1, "value": 1.0})
prod.flush()

tester = StreamTestingAgent(events, window_ms=5.0)
res = tester.run()
print("[testing] cases:", [r.name for r in res["reports"]])
print("[testing] bugs found:", res["bugs_found"])
print("[testing] no test event leaked:", events.tail == 2000)

# --------------------------------------------- supply chain (promotable cFork)
orders = Topic.create(system, "orders")
prod = Producer(orders, linger_records=32)
for _ in range(60):
    prod.produce({"kind": "order", "item": "widget", "qty": 1})
prod.flush()
validator = InventoryConsumer()
validator.process(orders)

bad = SupplyChainAgent(orders, inject_mistake=True)
ok = bad.run_safe(validator)
print("[supply-chain] mistake caught before promote:", not ok)

good = SupplyChainAgent(orders)
ok = good.run_safe(validator)
downstream = InventoryConsumer()
downstream.process(orders)
print("[supply-chain] promoted restock; inventory:", downstream.inventory)

# ------------------------------------------- tailing subscription (DESIGN.md §12)
# a downstream job follows the orders stream push-style: the committed
# restock events arrive linearizably interleaved with the orders
from repro_torch.streams import Consumer  # noqa: E402

follower = Consumer(orders, group="follower")
kinds = {}
for batch in follower.stream(follow=False):
    for rec in batch:
        kinds[rec["kind"]] = kinds.get(rec["kind"], 0) + 1
follower.commit()
print("[subscribe] drained", follower.offset, "records by kind:", kinds)

# --------------------------------------------- segment GC (DESIGN.md §13)
# the agents above churned forks constantly (sFork scans, what-if cForks,
# speculation aborts); without reclamation every dead fork's segments
# would sit in shared storage forever. One drain returns storage to the
# live working set — and the safety harness guarantees it never touches a
# byte any surviving log can still read.
before = system.store.total_bytes
stats = system.gc()
print(f"[gc] reclaimed {stats.objects_reclaimed} dead segment objects "
      f"({stats.bytes_reclaimed} B): store {before} -> "
      f"{system.store.total_bytes} B, {stats.tracked} live objects tracked")
