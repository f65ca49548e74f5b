"""End-to-end training driver: streaming-log data plane -> PyTorch train loop.

Port of ``src/repro/launch/train.py``. Documents are ingested into a topic of
the port's own log; the job consumes exactly-resumable batches through
``LogDataPipeline``; checkpoints (parameters, optimizer state and the data
cursor in ``extra``) are forks of the same log; a restarted job re-attaches
to the same ``BoltSystem``, restores the latest checkpoint and replays the
identical batch stream. The two packages share the log's format and the
checkpoint record, so a job the JAX launcher started and checkpointed
resumes here, and one this launcher checkpointed resumes in the JAX
launcher (save and restore map the reference's layout with ``cfg``; the JAX
launcher's model is its ``small_config``). Beyond the reference:
``config`` trains a registered config at its full width (``n_layers`` cuts
its depth), ``accum`` splits each batch into microbatches, and the job runs
on the card unless ``device`` names another.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --config smollm-135m --steps 10
"""

from __future__ import annotations

import argparse
import time
from typing import Union

import numpy as np
import torch

from ..configs import get_config
from ..core import BoltSystem
from ..data import LogDataPipeline, TokenStreamWriter, synthetic_token_docs
from ..models.config import ModelConfig
from ..models.layers import resolve_device
from ..models.lm import init_params
from ..streams import Topic
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import AdamWConfig, adamw_init
from ..train.step import make_train_step


def small_config(d_model: int, n_layers: int, vocab: int) -> ModelConfig:
    return ModelConfig(
        name=f"train-e2e-{d_model}", n_layers=n_layers, d_model=d_model,
        n_heads=max(2, d_model // 64), n_kv_heads=max(1, d_model // 128),
        d_ff=d_model * 4, vocab_size=vocab, tie_embeddings=True,
        remat="none", attn_chunk=128)


def run(steps: int = 100, d_model: int = 128, n_layers: int = 4,
        batch: int = 4, seq: int = 128, vocab: int = 2048,
        resume: bool = False, store=None, system=None, log_every: int = 20,
        ckpt_every: int = 50, seed: int = 0,
        config: Union[str, ModelConfig, None] = None, device=None, accum: int = 1):
    """Train ``steps`` steps (counted from the restored step on resume).
    Returns ``(losses, model, system, seconds)``, ``seconds`` each step's
    wall time, ending in the loss's read-back. ``config`` names a registered
    config, or is a ``ModelConfig`` (``n_layers`` then cuts its depth;
    ``d_model`` and ``vocab`` are the config's)."""
    device = resolve_device(device)
    if config is None:
        cfg = small_config(d_model, n_layers, vocab)
    else:
        cfg = get_config(config) if isinstance(config, str) else config
        cfg = cfg.with_(n_layers=n_layers)
    vocab = cfg.vocab_size
    total, _ = cfg.count_params()
    print(f"model: {cfg.name} ({total/1e6:.1f}M params, {cfg.n_layers} layers) "
          f"on {device}")

    # ---- data plane: the forkable shared log --------------------------------
    # The log is a durable shared SERVICE; the training job is a client.
    # Crash/resume means the job re-attaches to the same BoltSystem (pass
    # `system=`), finds its token stream and checkpoint catalog by name, and
    # resumes: checkpoints are log forks (DESIGN.md §17).
    system = system if system is not None else BoltSystem(n_brokers=4,
                                                          store=store)
    existing = system.find_log("train-tokens")
    if existing is None:
        topic = Topic.create(system, "train-tokens")
        writer = TokenStreamWriter(topic, batch_docs=64)
        for doc in synthetic_token_docs(4000, vocab=vocab, min_len=64,
                                        max_len=512, seed=seed):
            writer.write_doc(doc)
        writer.flush()
    else:
        topic = Topic("train-tokens", existing)
    pipe = LogDataPipeline(topic, batch_size=batch, seq_len=seq)

    # ---- model + optimizer ----------------------------------------------------
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    ckpt = CheckpointManager(system, prefix="ckpt")
    start_step = 0
    if resume and ckpt.latest_step() is not None:
        orphans = ckpt.recover()    # reclaim forks a crashed save left behind
        if orphans:
            print(f"recovered {len(orphans)} orphaned checkpoint fork(s)")
        start_step, params, opt_state, extra = ckpt.restore(device=device, cfg=cfg)
        model = init_params(cfg, seed=None, device=device, trainable=True)
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(params[name])
        del params
        pipe.restore(tuple(extra["cursor"]))
        print(f"resumed from step {start_step}, cursor {extra['cursor']}")
    else:
        model = init_params(cfg, seed, device=device, trainable=True)
        opt_state = adamw_init(model, opt_cfg)

    step_fn = make_train_step(cfg, opt_cfg, accum=accum)

    losses, seconds = [], []
    t0 = time.time()
    for step in range(start_step, steps):
        t_step = time.perf_counter()
        block = torch.from_numpy(next(pipe)).long().to(device)
        batch_dict = {"tokens": block[:, :-1], "labels": block[:, 1:]}
        model, opt_state, metrics = step_fn(model, opt_state, batch_dict)
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t_step)
        if (step + 1) % log_every == 0:
            tput = batch * seq * log_every / (time.time() - t0)
            print(f"step {step + 1:5d} loss {np.mean(losses[-log_every:]):.4f} "
                  f"({tput:.0f} tok/s)")
            t0 = time.time()
        if (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, model, opt_state,
                      extra={"cursor": list(pipe.cursor())}, cfg=cfg)
    return losses, model, system, seconds


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth: 4 for the small config, the config's own "
                         "with --config unless given")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--config", default=None,
                    help="a registered config, trained at full width "
                         "(--layers cuts its depth)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    n_layers = args.layers
    if n_layers is None:
        n_layers = get_config(args.config).n_layers if args.config else 4
    losses, _, _, _ = run(steps=args.steps, d_model=args.d_model,
                          n_layers=n_layers, batch=args.batch, seq=args.seq,
                          resume=args.resume, config=args.config,
                          device=args.device)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
