"""Quickstart in the PyTorch port: the AgileLog abstraction + the agent-session
API in 70 lines (paper §4.1 Fig. 2; DESIGN.md §12). The twin of
``examples/quickstart.py``, line for line on ``repro_torch.core``; it imports
nothing of JAX. The log is host code and launches no kernel: like every
entry point of the port, the script asks for the card unless ``--device``
names another, and stops where the device asked for is missing.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.core import BoltSystem, ConflictError
from repro_torch.core.errors import ForkBlocked
from repro_torch.models.layers import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
print("device:", resolve_device(args.device))

system = BoltSystem(n_brokers=4)
log = system.create_log("orders")

# 1. appends return unified receipts (per-call mode: resolved immediately)
receipts = [log.append(f"order-{i}".encode()) for i in range(5)]
print("positions:", [r.position() for r in receipts])
print("root:", log.read(0, log.tail))

# 2. continuous fork (Fig 2a/2b): inherits live appends, private writes
agent_view = log.cfork()
log.append(b"order-5")                      # lands on the parent...
print("cfork sees parent append:", agent_view.read(5, 6))   # ...and the fork
agent_view.append(b"agent-note")            # private to the fork
print("parent tail:", log.tail, "| fork tail:", agent_view.tail)

# 3. severed fork from a past offset (Fig 2c/2d): frozen what-if sandbox
snapshot = log.sfork(past=2)
print("sfork snapshot:", snapshot.read(0, snapshot.tail))

# 4. speculation session: the isolate -> validate -> promote loop (Fig 2e)
#    as ONE primitive — commit() is atomic and auto-rebases if producers
#    appended concurrently (replaying the speculative suffix zero-copy)
with log.speculate() as s:
    s.append(b"restock-widget")
    r = log.append(b"order-6")              # producers keep appending...
    print("producer position withheld during speculation:", r.withheld)
    try:
        log.read(0, log.tail)               # ...but reads beyond fp block
    except ForkBlocked as e:
        print("parent read blocked during validation:", type(e).__name__)
    # validation = read the fork: history + live orders + agent writes
    print("validation view:", s.read(5, s.tail))
    result = s.commit()                     # conflict -> rebase -> retry
    print(f"committed at {list(result.positions)} after "
          f"{result.rebases} rebase(s)")
print("after commit:", log.read(5, log.tail))

# 5. exploration: competing speculations — first commit wins, the loser's
#    commit raises ConflictError with fork-point diagnostics
a = log.speculate(max_rebases=0)
b = log.speculate(max_rebases=0)
a.append(b"path-A")
b.append(b"path-B")
a.commit()
try:
    b.commit()
except ConflictError as e:
    print("losing path rejected:", e)
print("chosen path:", log.read(log.tail - 1, log.tail))

# 6. tailing subscription: follow the stream push-style
sub = log.subscribe(from_pos=0, batch=4, follow=False)
for batch in sub:
    print("subscription batch:", batch)
log.append(b"order-7")
print("next poll sees the new record:", sub.poll())
print("metadata bytes:", system.metadata.state.metadata_bytes())
