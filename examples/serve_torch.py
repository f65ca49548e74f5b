"""Serving ON the log (DESIGN.md §17) in the PyTorch port: requests stream in
through a subscription, a batched engine decodes and appends per-token
response records the subscribers demux, and a speculative decoder runs each
draft rollout as a ``log.speculate()`` session — byte-identical to
sequential greedy decode. The twin of ``examples/serve.py``; it imports
nothing of JAX and runs on the card unless ``--device`` names another.

    PYTHONPATH=src python examples/serve_torch.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core import BoltSystem
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import init_params
from repro_torch.serve import (ModelDraft, ModelTarget, ServeEngine,
                               SpeculativeDecoder, decode_response,
                               sequential_decode)
from repro_torch.streams import Producer, Topic

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
args = ap.parse_args()

cfg = ModelConfig(name="serve-demo", n_layers=2, d_model=64, n_heads=2,
                  n_kv_heads=1, d_ff=128, vocab_size=256,
                  tie_embeddings=True, attn_chunk=32)
params = init_params(cfg, 0, device=args.device)

# ---- request/response topics on the shared log -------------------------------
system = BoltSystem(n_brokers=4)
requests = Topic.create(system, "requests")
responses = Topic.create(system, "responses")
prod = Producer(requests)
rng = np.random.default_rng(0)
BATCH, PROMPT, GEN = 4, 8, 12
for rid in range(BATCH):
    prod.produce({"id": f"req-{rid}",
                  "prompt": [int(t) for t in rng.integers(2, 256, PROMPT)]})
prod.flush()

# ---- batched engine: subscription in, per-token records out ------------------
eng = ServeEngine(cfg, params, requests, responses, batch_size=BATCH)
t0 = time.time()
served = eng.poll_and_serve(gen_tokens=GEN)
dt = time.time() - t0
print(f"engine served {served} requests, {GEN} tokens each in {dt:.2f}s "
      f"({served * GEN / max(dt, 1e-9):.1f} tok/s)")
assert eng.poll_and_serve() == 0      # durable cursor: nothing left to serve

# clients demux the shared response stream by (id, seq)
log = responses.log
out = decode_response(log.read(0, log.visible_tail))
assert set(out) == {f"req-{r}" for r in range(BATCH)}
assert all(len(toks) == GEN for toks in out.values())
print("first response:", out["req-0"][:8], "...")

# ---- speculative decoding: each rollout is a log.speculate() session ---------
dcfg = ModelConfig(name="serve-draft", n_layers=1, d_model=32, n_heads=2,
                   n_kv_heads=1, d_ff=64, vocab_size=256,
                   tie_embeddings=True, attn_chunk=32)
target = ModelTarget(cfg, params, stats=system.serve_stats)
draft = ModelDraft(dcfg, init_params(dcfg, 1, device=args.device),
                   stats=system.serve_stats)
spec_log = system.create_log("spec-responses")
dec = SpeculativeDecoder(target, draft, k=2, stats=system.serve_stats)

prompt = [int(t) for t in rng.integers(2, 256, PROMPT)]
ref = sequential_decode(target, prompt, GEN)
res = dec.decode_request(spec_log, "spec-0", prompt, GEN)
assert res.tokens == ref              # greedy speculative decoding is exact
view = decode_response(spec_log.read(0, spec_log.visible_tail))
assert view == {"spec-0": ref}        # ... and so is the stream itself
rejected = sum(1 for r in res.rollouts if r.rejected)
print(f"speculative: {len(res.tokens)} tokens in {len(res.rollouts)} "
      f"speculate() sessions ({rejected} aborted with no trace, "
      f"acceptance {res.acceptance:.2f}) — byte-identical to sequential")
