"""Model-step service times for serving ON the log (DESIGN.md §17), on the
H100 roofline.

Port of ``src/repro/serve/costs.py``. A serving benchmark runs real
AgileLog sessions under the DES clock, so the card's side of a serving
step enters the simulation as a service time. A step is a :class:`Cost`
(dot flops / HBM-traffic bytes / collective link-bytes) built from a
:class:`~repro_torch.models.config.ModelConfig`'s geometry by the analytic
constructors (:func:`decode_cost`, :func:`prefill_cost`,
:func:`verify_cost`): ``2 * active_params`` dot flops per token, parameter
+ KV-cache bytes as the HBM traffic, and the 2x-ring all-reduce link bytes
tensor parallelism adds per block. The formulas are the reference's, term
for term.

:func:`roofline_seconds` applies the per-card roofline
``max(flops/PEAK, bytes/BW, coll/LINK)`` on an H100 SXM's datasheet figures:
989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM and NVLink 4 at 450e9 B/s a
direction for the link term, held once in ``launch/h100.py``, which the dry
run's roofline reads too. Every time this module gives is reckoned from
those figures, not measured: a roofline is a lower bound on what the card
takes. ``chip_smoke.py`` prints them beside the measured
decode step of qwen3-8b.

The reference's second path, ``step_cost_from_hlo`` (a Cost parsed from a
compiled HLO dump), has no twin: torch makes no HLO.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from ..launch.h100 import HBM_BW, NVLINK_BW, PEAK_FLOPS
from ..models.config import ModelConfig

_BF16 = 2  # serving weights/KV are bf16


@dataclass
class Cost:
    """The reference's ``launch/hlo_cost.py`` ``Cost``: dot flops, HBM
    bytes and, by collective kind, ``[count, link_bytes]`` (its ``add``,
    which only the HLO walk calls, is left out)."""

    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, List[float]] = field(default_factory=dict)  # kind -> [count, link_bytes]

    @property
    def collective_bytes(self) -> float:
        return sum(b for _c, b in self.coll.values())


def roofline_seconds(cost: Cost, n_devices: int = 1) -> float:
    """Per-step seconds for a cost under the H100 roofline.

    ``n_devices > 1`` shards a whole-model analytic cost across a tensor-
    parallel group (flops and HBM traffic split evenly; collective link
    bytes in the analytic constructors are already per-device)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return max(cost.flops / n_devices / PEAK_FLOPS,
               cost.bytes / n_devices / HBM_BW,
               cost.collective_bytes / NVLINK_BW)


def _attn_layers(cfg: ModelConfig) -> int:
    """Layers that hold a KV cache (mamba/linear blocks do not)."""
    per_group = sum(1 for b in cfg.pattern_layers if "attn" in b)
    return per_group * cfg.n_groups + (1 if cfg.first_layer_dense else 0)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes one sequence position occupies (bf16, all layers)."""
    if cfg.mla is not None:
        # MLA caches the compressed kv latent + rope key, not full heads
        per_layer = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    else:
        per_layer = 2 * cfg.n_kv_heads * cfg.head_dim_
    return _attn_layers(cfg) * per_layer * _BF16


def decode_cost(cfg: ModelConfig, batch: int, context: int,
                n_devices: int = 1) -> Cost:
    """One greedy decode step: every weight is read once (weights stream,
    batch=O(10) reuses them from registers, not HBM), the whole KV cache is
    read and one position appended, and TP all-reduces the block outputs."""
    total, active = cfg.count_params()
    flops = 2.0 * active * batch
    kv = kv_bytes_per_token(cfg)
    bytes_ = (total * _BF16                   # streamed weights
              + batch * context * kv          # KV read (flash decode)
              + batch * kv                    # KV append
              + batch * cfg.padded_vocab * _BF16)   # logits out
    return Cost(flops=flops, bytes=bytes_,
                coll=_tp_collectives(cfg, batch * 1, n_devices))


def prefill_cost(cfg: ModelConfig, batch: int, prompt_len: int,
                 n_devices: int = 1) -> Cost:
    """Prompt ingestion for a batch: compute-bound (2*active per token) plus
    the O(T^2) attention score flops, writing the prompt's KV cache."""
    total, active = cfg.count_params()
    tokens = batch * prompt_len
    flops = 2.0 * active * tokens
    # causal attention scores/values: 2 matmuls of [T, Dh] @ [Dh, T] per head
    attn = (2.0 * 2.0 * _attn_layers(cfg) * cfg.n_heads * cfg.head_dim_
            * prompt_len * prompt_len / 2.0) * batch
    bytes_ = (total * _BF16
              + tokens * kv_bytes_per_token(cfg)      # KV write
              + 2.0 * tokens * cfg.d_model * _BF16)   # activations in/out
    return Cost(flops=flops + attn, bytes=bytes_,
                coll=_tp_collectives(cfg, tokens, n_devices))


def verify_cost(cfg: ModelConfig, batch: int, context: int, k: int,
                n_devices: int = 1) -> Cost:
    """Target-model verification of k draft tokens in ONE forward pass:
    k+1 positions of compute (k drafts + the bonus/correction logits), but
    the weights still stream only once — this is the whole speculative win:
    ``verify_cost(k) ≪ (k+1) * decode_cost`` whenever decode is
    memory-bound."""
    total, active = cfg.count_params()
    positions = k + 1
    flops = 2.0 * active * batch * positions
    kv = kv_bytes_per_token(cfg)
    bytes_ = (total * _BF16
              + batch * context * kv                 # cache read (once)
              + batch * positions * kv               # speculative KV append
              + batch * positions * cfg.padded_vocab * _BF16)
    return Cost(flops=flops, bytes=bytes_,
                coll=_tp_collectives(cfg, batch * positions, n_devices))


def _tp_collectives(cfg: ModelConfig, tokens: int, n_devices: int) -> dict:
    """Per-device all-reduce link bytes tensor parallelism adds: two
    activation all-reduces per block (attn out, mlp out), ring coefficient
    2x — the reference's ``hlo_cost`` convention. Zero off TP."""
    if n_devices <= 1:
        return {}
    link_bytes = (2.0                      # ring coefficient (all-reduce)
                  * 2.0 * cfg.n_layers     # two all-reduces per block
                  * tokens * cfg.d_model * _BF16)
    return {"all-reduce": [2.0 * cfg.n_layers, link_bytes]}


@dataclass(frozen=True)
class ServeCosts:
    """Per-phase service times (seconds) a serving workload books against
    the DES clock. ``verify(k)`` is affine in k so a bench can sweep draft
    depth without rebuilding costs."""

    prefill_per_token: float   # target prefill, per prompt token (per batch)
    decode_step: float         # one target decode step (whole batch)
    draft_step: float          # one draft-model decode step (whole batch)
    verify_base: float         # verify pass at k=0 (just the bonus position)
    verify_per_token: float    # marginal verify cost per extra draft token

    def verify(self, k: int) -> float:
        """One target verification pass over k draft tokens."""
        return self.verify_base + self.verify_per_token * k

    @classmethod
    def for_models(cls, target: ModelConfig, draft: ModelConfig,
                   batch: int = 8, context: int = 512,
                   target_devices: int = 1, draft_devices: int = 1
                   ) -> "ServeCosts":
        """Analytic costs for a (target, draft) pair at a fixed batch and
        nominal context length (KV traffic is charged at `context` — the
        mid-stream steady state — rather than growing per step, keeping the
        DES deterministic in shape)."""
        v0 = roofline_seconds(verify_cost(target, batch, context, 0,
                                          target_devices), target_devices)
        v4 = roofline_seconds(verify_cost(target, batch, context, 4,
                                          target_devices), target_devices)
        return cls(
            prefill_per_token=roofline_seconds(
                prefill_cost(target, batch, context, target_devices),
                target_devices) / max(1, context),
            decode_step=roofline_seconds(
                decode_cost(target, batch, context, target_devices),
                target_devices),
            draft_step=roofline_seconds(
                decode_cost(draft, batch, context, draft_devices),
                draft_devices),
            verify_base=v0,
            verify_per_token=(v4 - v0) / 4.0,
        )
