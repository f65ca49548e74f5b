"""Batched serving engine: request topic -> prefill -> decode -> response topic.

Port of ``src/repro/serve/engine.py``. Requests arrive through the durable
``Consumer`` of the port's own log; every response batch is appended with an
``AppendReceipt`` that the engine waits on before it commits its request
cursor, so a crash between the two replays the batch rather than losing it.
Response records are ``(id, seq)``-keyed token records.

One difference from the reference: the prompt batch is prefilled by ONE
full-sequence ``forward(want_caches=True)`` (through the flash-attention
kernel on the card), not by teacher-forcing the prompt through
``decode_step`` one position at a time. For the left-padded batch with no pad
mask the causal pass gives the same logits and the same cache; a Mamba
layer passes the pads through its conv and scan from a zero state as the
reference's decode steps do, and decode continues from the prefill's final
``{ssm, conv}`` state. Decoding then
runs one eager ``decode_step`` a token. ``ModelTarget`` / ``ModelDraft``
adapt the model to the speculative driver (``serve/speculative.py``).

A VLM's text requests serve as any decoder's (no image prefix: a request
carries tokens only). An encoder-decoder (whisper) is refused: a request
carries no audio, so the prefill has no frames to encode, and the JAX engine,
which teacher-forces from ``init_caches``, attends over an all-zero cross
cache and ropes every position where a forward does not, so the two could
not agree (ROADMAP.md Queue 3, quirk 15). Whisper serves through the model's
own entry points: ``forward(batch with frames, want_caches=True)`` and
greedy ``decode_step``.

A model split over 'model' (``distributed/tp.py``) is refused too: its
logits are a rank's vocabulary slice and its caches a rank's kv heads, so
the engine's and the adapters' argmax would give a rank's local ids. The
split model, of any block kind (an encoder-decoder's with frames, a VLM's
with its prefix), serves through ``forward``, ``decode_step`` and
``tp.greedy``; the engine over it is a later part of ROADMAP item 7d.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.sim import ServeStats
from ..distributed import tp
from ..models.config import ModelConfig
from ..models.lm import LM, decode_step, forward
from ..streams.topics import Consumer, Topic
from .speculative import encode_eos, encode_token


def check_servable(cfg: ModelConfig) -> None:
    """Refuse an encoder-decoder config, and any model under a split over
    'model' on the ambient mesh: see the module docstring."""
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: a request on the log carries no "
            "audio frames to encode, so the engine cannot prefill it (ROADMAP.md "
            "Queue 3, quirk 15); serve it through forward(batch with 'frames', "
            "want_caches=True) and decode_step")
    mg = tp.model_group()
    if mg is not None:
        raise NotImplementedError(
            f"{cfg.name}: the engine and the speculative adapters serve a whole model; "
            f"under a split over 'model' ({mg.size} ranks) the logits are a rank's "
            "vocabulary slice, so serve it through forward, decode_step and "
            f"tp.greedy (the engine over a split model is a later part of "
            f"{tp.ROADMAP_ITEM})")


class _Stepper:
    """Greedy decode of one prefix, recomputed from the prefix on each call:
    no per-request cache registry to invalidate when a speculative branch is
    squashed. The prefix is prefilled in one forward pass."""

    def __init__(self, cfg: ModelConfig, model: LM,
                 stats: Optional[ServeStats] = None) -> None:
        check_servable(cfg)
        self.cfg = cfg
        self.model = model
        self.stats = stats
        self.device = model.embed.device

    def _greedy(self, logits: torch.Tensor) -> int:
        return int(torch.argmax(logits[0, -1, :self.cfg.vocab_size]))

    @torch.no_grad()
    def _run(self, tokens: List[int], extra: int) -> tuple:
        """Prefill ``tokens``; returns (logits, caches) with cache room for
        ``extra`` more positions."""
        check_servable(self.cfg)
        arr = torch.tensor([tokens], dtype=torch.long, device=self.device)
        logits, _, caches, _ = forward(self.cfg, self.model, {"tokens": arr},
                                       want_caches=True,
                                       max_len=len(tokens) + extra)
        return logits, caches

    def _step(self, caches, tok: int, pos: int):
        arr = torch.tensor([[tok]], dtype=torch.long, device=self.device)
        return decode_step(self.cfg, self.model, caches, arr, pos)


class ModelTarget(_Stepper):
    """TargetModel adapter: ``verify(prefix, draft)`` returns the k+1 greedy
    tokens (position i conditioned on ``prefix + draft[:i]``)."""

    def verify(self, prefix: List[int], draft: List[int]) -> List[int]:
        logits, caches = self._run(list(prefix), extra=len(draft) + 1)
        if self.stats is not None:
            self.stats.model_steps += 1
        out = [self._greedy(logits)]
        base = len(prefix)
        for i, tok in enumerate(draft):
            logits, caches = self._step(caches, tok, base + i)
            out.append(self._greedy(logits))
        return out


class ModelDraft(_Stepper):
    """DraftModel adapter: k greedy tokens from the (smaller) draft model."""

    def propose(self, prefix: List[int], k: int) -> List[int]:
        logits, caches = self._run(list(prefix), extra=k)
        if self.stats is not None:
            self.stats.draft_steps += k
        out = []
        base = len(prefix)
        for i in range(k):
            tok = self._greedy(logits)
            out.append(tok)
            if i + 1 < k:
                logits, caches = self._step(caches, tok, base + i)
        return out


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: LM, requests: Topic,
                 responses: Topic, batch_size: int = 4,
                 max_len: int = 64, group: str = "serve") -> None:
        check_servable(cfg)
        self.cfg = cfg
        self.model = model
        # restore() makes the request cursor a durable resume token, so a
        # restarted engine re-serves exactly the uncommitted suffix
        self.consumer = Consumer.restore(requests, group=group)
        self.responses = responses
        self.batch_size = batch_size
        self.max_len = max_len
        self.stats: ServeStats = requests.log.system.serve_stats
        self.device = model.embed.device
        self.served = 0

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits[:, -1, :self.cfg.vocab_size], dim=-1)

    @torch.no_grad()
    def poll_and_serve(self, gen_tokens: int = 16) -> int:
        """Serve one batch of requests from the subscription; returns
        #served. Response tokens are appended as ``(id, seq)`` records plus
        an EOS marker per request; the receipt is waited before the request
        cursor commits (at-least-once across a crash, deduped by key)."""
        check_servable(self.cfg)
        reqs = self.consumer.poll(self.batch_size)
        if not reqs:
            return 0
        B = len(reqs)
        self.stats.requests += B
        prompts = [r["prompt"] for r in reqs]
        plen = max(len(p) for p in prompts)
        toks = np.full((B, plen), 1, np.int64)
        for i, p_ in enumerate(prompts):
            toks[i, plen - len(p_):] = p_   # left-pad, no pad mask
        tokens = torch.from_numpy(toks).to(self.device)
        logits, _, caches, _ = forward(self.cfg, self.model, {"tokens": tokens},
                                       want_caches=True,
                                       max_len=plen + gen_tokens)
        self.stats.model_steps += plen      # prompt positions, as the reference
        outs = [self._greedy(logits)]
        for t in range(plen, plen + gen_tokens - 1):
            logits, caches = decode_step(self.cfg, self.model, caches,
                                         outs[-1][:, None], t)
            outs.append(self._greedy(logits))
            self.stats.model_steps += 1
        gen = torch.stack(outs, dim=1).cpu().numpy()
        records: List[bytes] = []
        for i, r in enumerate(reqs):
            records.extend(encode_token(r["id"], j, int(tok))
                           for j, tok in enumerate(gen[i]))
            records.append(encode_eos(r["id"], int(gen.shape[1])))
        receipt = self.responses.log.append_batch(records)
        receipt.wait()          # durable before the request cursor moves
        self.consumer.commit()
        self.stats.tokens_out += int(gen.size)
        self.stats.responses += B
        self.served += B
        return B
