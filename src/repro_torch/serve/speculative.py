"""Speculative decoding as log speculation (DESIGN.md §17).

The paper's claim is that agents acting on model-generated streams want a
forkable log; speculative decoding is the degenerate-but-load-bearing case:

* a k-token draft rollout IS a ``log.speculate()`` session — the fork is the
  sequence branch (draft tokens live on the fork, invisible to response
  subscribers until promoted);
* ``promote_if`` IS the acceptance gate — the rollout commits into the
  shared response stream atomically, or not at all;
* auto-rebase IS re-anchoring — when other decoders (or the request pump)
  advance the response stream's tail between draft and commit, the session
  replays its token suffix zero-copy onto the moved tail. Token records are
  keyed ``(id, seq)``, so interleaving with other requests' records is
  harmless and the ``on_rebase`` hook just counts the re-anchor.

Greedy speculative decoding is exact: the emitted stream is byte-identical
to sequential greedy decoding of the target model (tests/test_serve_on_log.py
proves it record-for-record). A rejected rollout aborts its session — the
squash leaves no trace in the flattened view and hands the draft's segment
bytes to §13 GC.

This module is deliberately JAX-free: the driver works over two small
callables (below) so the DES benchmark can run it with synthetic models and
hlo_cost-derived step costs, while ``serve/engine.py`` provides the real
``decode_step``-backed adapters.

  TargetModel.verify(prefix, draft) -> k+1 greedy tokens: position i is the
      target's argmax conditioned on ``prefix + draft[:i]``. ``verify(p, [])``
      is one sequential decode step.
  DraftModel.propose(prefix, k) -> k greedy draft tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from ..core.api import AgileLog, CommitResult, Speculation
from ..core.sim import ServeStats
from ..streams.records import decode_record, encode_record


def encode_token(req_id: str, seq: int, tok: int) -> bytes:
    """One response-stream token record. ``seq`` orders tokens within a
    request; readers demux the shared stream by ``id``."""
    return encode_record({"id": req_id, "seq": seq, "tok": int(tok)})


def encode_eos(req_id: str, n: int) -> bytes:
    """End-of-response marker: ``n`` tokens were emitted for ``req_id``."""
    return encode_record({"id": req_id, "eos": True, "n": int(n)})


def decode_response(records: Sequence[bytes]) -> Dict[str, List[int]]:
    """Demux a response-stream slice into per-request token lists (in seq
    order; EOS markers dropped). The inverse of the encoders above."""
    out: Dict[str, List[Dict]] = {}
    for raw in records:
        rec = decode_record(raw)
        if rec.get("eos"):
            continue
        out.setdefault(rec["id"], []).append(rec)
    return {rid: [r["tok"] for r in sorted(recs, key=lambda r: r["seq"])]
            for rid, recs in out.items()}


@dataclass
class RolloutResult:
    """One draft-verify-commit round."""
    emitted: List[int]              # tokens durably committed this rollout
    drafted: int                    # draft tokens proposed
    accepted: int                   # draft tokens the target accepted
    rejected: bool                  # True iff the rollout session aborted
    commit: Optional[CommitResult]  # the accepting session's promote result
    rebases: int = 0                # re-anchors over a moved stream tail


@dataclass
class DecodeResult:
    """One request decoded to completion."""
    req_id: str
    tokens: List[int]
    rollouts: List[RolloutResult] = field(default_factory=list)

    @property
    def acceptance(self) -> float:
        drafted = sum(r.drafted for r in self.rollouts)
        return sum(r.accepted for r in self.rollouts) / max(1, drafted)


class SpeculativeDecoder:
    """Drive one target/draft pair over a shared response log.

    ``on_draft(steps)`` / ``on_target(positions)`` are cost hooks: the DES
    benchmark books roofline step times through them (real wall-clock decode
    books nothing — the JAX step itself is the cost).
    """

    def __init__(self, target, draft, k: int = 4,
                 stats: Optional[ServeStats] = None,
                 max_rebases: int = 8,
                 on_draft: Optional[Callable[[int], None]] = None,
                 on_target: Optional[Callable[[int], None]] = None) -> None:
        if k < 1:
            raise ValueError(f"draft depth k must be >= 1, got {k}")
        self.target = target
        self.draft = draft
        self.k = k
        self.stats = stats
        self.max_rebases = max_rebases
        self.on_draft = on_draft
        self.on_target = on_target

    # -- per-phase accounting ------------------------------------------------
    def _draft_steps(self, n: int) -> None:
        if self.stats is not None:
            self.stats.draft_steps += n
        if self.on_draft is not None:
            self.on_draft(n)

    def _target_pass(self, positions: int) -> None:
        if self.stats is not None:
            self.stats.model_steps += 1
        if self.on_target is not None:
            self.on_target(positions)

    def _on_rebase(self, counter: List[int]):
        def hook(spec: Speculation, lo: int, hi: int) -> bool:
            # tokens are (id, seq)-keyed: any interleaving of other writers'
            # records in [lo, hi) is safe to re-anchor over
            counter[0] += 1
            if self.stats is not None:
                self.stats.reanchors += 1
            return True
        return hook

    # -- one rollout ---------------------------------------------------------
    def rollout(self, log: AgileLog, req_id: str, prefix: List[int],
                seq0: int, k: Optional[int] = None) -> RolloutResult:
        """One draft-verify-commit round against ``log``.

        The k draft tokens are appended to the speculation fork FIRST — the
        fork is the sequence branch, and verification validates the fork's
        suffix. Full acceptance appends the bonus token and promotes the
        session; any rejection aborts it (no trace) and commits the accepted
        prefix + correction token through a short second session, so every
        durable token rode a ``promote_if``."""
        k = self.k if k is None else k
        rebases = [0]
        drafted = self.draft.propose(prefix, k)
        self._draft_steps(len(drafted))
        with log.speculate(promotable=True, max_rebases=self.max_rebases,
                           on_rebase=self._on_rebase(rebases)) as spec:
            spec.append_batch([encode_token(req_id, seq0 + i, t)
                               for i, t in enumerate(drafted)])
            truth = self.target.verify(prefix, drafted)
            self._target_pass(len(drafted) + 1)
            n_acc = 0
            while n_acc < len(drafted) and drafted[n_acc] == truth[n_acc]:
                n_acc += 1
            if self.stats is not None:
                self.stats.rollouts += 1
                self.stats.tokens_drafted += len(drafted)
                self.stats.tokens_accepted += n_acc
            if n_acc == len(drafted):
                # full accept: bonus token rides the same session
                bonus = truth[n_acc]
                spec.append(encode_token(req_id, seq0 + n_acc, bonus))
                commit = spec.commit()
                emitted = list(drafted) + [bonus]
                if self.stats is not None:
                    self.stats.tokens_out += len(emitted)
                return RolloutResult(emitted=emitted, drafted=len(drafted),
                                     accepted=n_acc, rejected=False,
                                     commit=commit, rebases=rebases[0])
            # partial/zero accept: the fork holds rejected records — squash
            # the whole session (no trace, §12) ...
            spec.abort()
        if self.stats is not None:
            self.stats.tokens_rejected += len(drafted) - n_acc
            self.stats.rollouts_rejected += 1
        # ... and commit the accepted prefix + the target's correction token
        # through a fresh session (still promote_if-gated, still re-anchors)
        emitted = list(drafted[:n_acc]) + [truth[n_acc]]
        with log.speculate(promotable=True, max_rebases=self.max_rebases,
                           on_rebase=self._on_rebase(rebases)) as spec:
            spec.append_batch([encode_token(req_id, seq0 + i, t)
                               for i, t in enumerate(emitted)])
            commit = spec.commit()
        if self.stats is not None:
            self.stats.tokens_out += len(emitted)
        return RolloutResult(emitted=emitted, drafted=len(drafted),
                             accepted=n_acc, rejected=True,
                             commit=commit, rebases=rebases[0])

    # -- one request ---------------------------------------------------------
    def decode_request(self, log: AgileLog, req_id: str, prompt: List[int],
                       max_new: int, eos: bool = True) -> DecodeResult:
        """Decode ``max_new`` tokens for one request onto the shared
        response log, one speculation session per rollout."""
        result = DecodeResult(req_id=req_id, tokens=[])
        prefix = list(prompt)
        while len(result.tokens) < max_new:
            remaining = max_new - len(result.tokens)
            if remaining == 1:
                # no room for draft + bonus: one plain target step, still
                # committed through a promote_if-gated session
                tok = self.target.verify(prefix, [])[0]
                self._target_pass(1)
                rebases = [0]
                with log.speculate(promotable=True,
                                   max_rebases=self.max_rebases,
                                   on_rebase=self._on_rebase(rebases)) as spec:
                    spec.append(encode_token(req_id, len(result.tokens), tok))
                    commit = spec.commit()
                if self.stats is not None:
                    self.stats.rollouts += 1
                    self.stats.tokens_out += 1
                r = RolloutResult(emitted=[tok], drafted=0, accepted=0,
                                  rejected=False, commit=commit,
                                  rebases=rebases[0])
            else:
                # a rollout emits at most k+1 tokens, so k <= remaining-1
                # guarantees the response never overshoots max_new
                k = min(self.k, remaining - 1)
                r = self.rollout(log, req_id, prefix,
                                 seq0=len(result.tokens), k=k)
            result.rollouts.append(r)
            result.tokens.extend(r.emitted)
            prefix.extend(r.emitted)
        if eos:
            log.append(encode_eos(req_id, len(result.tokens))).wait()
            if self.stats is not None:
                self.stats.responses += 1
        return result


def sequential_decode(target, prompt: List[int], max_new: int,
                      on_target: Optional[Callable[[int], None]] = None,
                      stats: Optional[ServeStats] = None) -> List[int]:
    """Plain greedy decode of the target model — the equivalence reference
    (no log, no draft): ``verify(prefix, [])`` is exactly one decode step."""
    prefix, out = list(prompt), []
    for _ in range(max_new):
        tok = target.verify(prefix, [])[0]
        if stats is not None:
            stats.model_steps += 1
            stats.tokens_out += 1
        if on_target is not None:
            on_target(1)
        out.append(tok)
        prefix.append(tok)
    return out


def sequential_decode_on_log(target, log: AgileLog, req_id: str,
                             prompt: List[int], max_new: int,
                             on_target: Optional[Callable[[int], None]] = None,
                             stats: Optional[ServeStats] = None,
                             eos: bool = True) -> List[int]:
    """The non-speculative serving baseline: one decode step AND one durable
    append per token (each token is acked to subscribers as it is produced —
    the per-token commit cost the rollout sessions amortize away)."""
    prefix, out = list(prompt), []
    for i in range(max_new):
        tok = target.verify(prefix, [])[0]
        if on_target is not None:
            on_target(1)
        log.append(encode_token(req_id, i, tok)).wait()
        if stats is not None:
            stats.model_steps += 1
            stats.tokens_out += 1
        out.append(tok)
        prefix.append(tok)
    if eos:
        log.append(encode_eos(req_id, len(out))).wait()
        if stats is not None:
            stats.responses += 1
    return out
