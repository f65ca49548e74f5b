"""End-to-end training on the log-backed data plane, with a mid-run crash and
an exact resume, in the PyTorch port. The twin of ``examples/train_e2e.py``;
it imports nothing of JAX and runs on the card unless ``--device`` names
another.

The log is a durable shared SERVICE the training job is a client of:
checkpoints are log forks (DESIGN.md §17), so "crash" kills the client while
the BoltSystem survives, and the restarted job re-attaches by name — finds
its token stream, replays the checkpoint catalog, reaps any fork a crashed
save orphaned, and resumes the identical batch stream.

    PYTHONPATH=src python examples/train_e2e_torch.py [--steps 150] [--device cpu]
"""

import argparse

from repro_torch.core import BoltSystem
from repro_torch.launch.train import run

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=150)
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

# ONE shared-log service outlives both training-client "processes"
system = BoltSystem(n_brokers=4, gc=True)

# phase 1: train, checkpointing every 25 steps — then "crash" at step N
half = args.steps // 2
print(f"=== phase 1: train to step {half}, then crash ===")
losses1, _, _, _ = run(steps=half, d_model=128, n_layers=4, system=system,
                       ckpt_every=25, log_every=25, device=args.device)

# phase 2: a fresh client re-attaches to the same service, restores the
# latest catalog manifest + data cursor, and continues the identical stream
print("=== phase 2: restart from the last checkpoint ===")
losses2, _, _, _ = run(steps=args.steps, d_model=128, n_layers=4, system=system,
                       ckpt_every=25, log_every=25, resume=True, device=args.device)

print(f"phase1 final {losses1[-1]:.4f} -> phase2 final {losses2[-1]:.4f} "
      f"(loss kept falling across the restart: {losses2[-1] < losses1[-1]})")
