"""Model configuration for the 10-architecture zoo.

One composable decoder stack parameterized by a per-layer *block pattern*;
pattern entries are "mixer+ffn" pairs:

  "attn+mlp"   — GQA attention + SwiGLU MLP          (llama-family)
  "attn+moe"   — GQA attention + top-k MoE
  "mla+mlp"    — Multi-head Latent Attention + MLP   (deepseek-v2)
  "mla+moe"    — MLA + MoE
  "mamba+mlp"  — Mamba selective SSM + MLP           (jamba)
  "mamba+moe"  — Mamba + MoE
  "mlstm"      — xLSTM matrix-memory block (no separate FFN)
  "slstm"      — xLSTM scalar-memory block

The pattern is cycled over the layer stack; homogeneous groups are
`lax.scan`ned over stacked params (bounded HLO at 512 devices).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0           # always-on shared experts (deepseek-v2)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    q_lora_rank: int = 0        # 0 = full-rank queries (v2-lite)


@dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    expand: int = 2
    conv_width: int = 4
    dt_rank: int = 0            # 0 = auto (d_model / 16)


@dataclass(frozen=True)
class EncDecCfg:
    enc_layers: int = 12
    enc_len: int = 1500         # audio frames after the (stubbed) conv frontend


@dataclass(frozen=True)
class VLMCfg:
    n_patches: int = 576        # precomputed anyres patch embeddings (stub)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 = d_model // n_heads
    block_pattern: Tuple[str, ...] = ("attn+mlp",)
    first_layer_dense: bool = False         # deepseek-v2: layer 0 uses dense MLP
    qk_norm: bool = False
    mlp_gated: bool = True              # SwiGLU (False: 2-matrix GELU MLP)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    mla: Optional[MLACfg] = None
    mamba: Optional[MambaCfg] = None
    encdec: Optional[EncDecCfg] = None
    vlm: Optional[VLMCfg] = None
    # ---- performance / distribution knobs (hillclimb targets) ----
    attn_chunk: int = 512                   # flash-attention KV chunk
    remat: str = "full"                     # none | dots | full
    use_pallas: bool = False                # TPU deploy: Pallas kernels
    pad_heads_to: int = 0                   # pad q-heads for TP divisibility
    kv_repeat: int = 1                      # compute-time kv-head replication
                                            # (MaxText-style; exact for TP>KH)
    pad_experts_to: int = 0                 # pad experts for EP divisibility
    moe_dispatch: str = "gather"            # gather | scatter (hillclimb knob:
                                            # scatter lowers to partition-wide
                                            # reduce; gather stays local)
    decode_seq_shards: int = 1              # flash-decode cache shards (model axis)
    dtype: str = "bfloat16"

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_heads_padded(self) -> int:
        return max(self.n_heads, self.pad_heads_to)

    @property
    def n_kv_eff(self) -> int:
        """kv heads at compute/cache time (stored params keep n_kv_heads; the
        activation is repeated `kv_repeat`x so TP stays exact: q slot h maps
        to effective kv h // G_pad, whose source is h // (H_pad/KH) — the
        original grouping, provided pad q-slots are the last slot(s) of each
        KH-superblock (see init_attention's wo mask)."""
        kv = self.n_kv_heads * self.kv_repeat
        assert self.n_heads_padded % kv == 0, \
            f"{self.name}: padded heads {self.n_heads_padded} not divisible by kv_eff {kv}"
        return kv

    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def n_experts_padded(self) -> int:
        assert self.moe is not None
        return max(self.moe.n_experts, self.pad_experts_to)

    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        """Pattern for the scanned portion of the stack."""
        n = self.n_layers - (1 if self.first_layer_dense else 0)
        assert n % len(self.block_pattern) == 0, \
            f"{self.name}: {n} layers not divisible by pattern {len(self.block_pattern)}"
        return self.block_pattern

    @property
    def n_groups(self) -> int:
        n = self.n_layers - (1 if self.first_layer_dense else 0)
        return n // len(self.block_pattern)

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS and memory sanity) ----
    def count_params(self) -> Tuple[int, int]:
        """(total, active) parameter counts, embeddings included in total,
        excluded from active compute-FLOPs accounting (6ND uses non-embedding
        by convention for MoE 'active')."""
        D, Dh = self.d_model, self.head_dim_
        H, KH = self.n_heads, self.n_kv_heads
        total = active = 0

        def attn_params() -> int:
            if self.mla is not None:
                m = self.mla
                p = D * (m.kv_lora_rank + m.rope_head_dim)            # down kv
                p += m.kv_lora_rank * H * Dh * 2                      # up k, v
                p += D * H * (Dh + m.rope_head_dim)                   # q
                p += H * Dh * D                                       # out
                return p
            return D * H * Dh + 2 * D * KH * Dh + H * Dh * D

        def mlp_params() -> int:
            return (3 if self.mlp_gated else 2) * D * self.d_ff

        def moe_params() -> Tuple[int, int]:
            m = self.moe
            per = 3 * D * m.d_expert
            tot = m.n_experts * per + D * m.n_experts
            act = m.top_k * per + D * m.n_experts
            if m.n_shared:
                tot += m.n_shared * per
                act += m.n_shared * per
            return tot, act

        def mamba_params() -> int:
            c = self.mamba
            Di = c.expand * D
            dtr = c.dt_rank or D // 16
            return (D * 2 * Di + c.conv_width * Di + Di * (dtr + 2 * c.d_state)
                    + dtr * Di + Di * c.d_state + Di + Di * D)

        def xlstm_params(kind: str) -> int:
            if kind == "mlstm":
                Di = 2 * D   # block-diagonal qkv (blocksize 4): ~0 params
                return D * 2 * Di + 3 * Di * 4 + Di * 2 * H + Di * D
            Di = D
            return D * 4 * Di + 4 * H * (Di // H) ** 2 + Di * D

        layers = ([("attn+mlp" if self.moe is None else "attn+mlp")]
                  if self.first_layer_dense else [])
        layers += list(self.block_pattern) * self.n_groups
        for blk in layers:
            mixer, _, ffn = blk.partition("+")
            if mixer in ("attn", "mla"):
                p = attn_params()
                total += p
                active += p
            elif mixer == "mamba":
                p = mamba_params()
                total += p
                active += p
            elif mixer in ("mlstm", "slstm"):
                p = xlstm_params(mixer)
                total += p
                active += p
            if ffn == "mlp" or (blk == "attn+mlp" and self.d_ff):
                total += mlp_params()
                active += mlp_params()
            elif ffn == "moe":
                t, a = moe_params()
                total += t
                active += a
        if self.is_encdec:
            enc = (attn_params() + mlp_params()) * self.encdec.enc_layers
            cross = attn_params() * self.n_layers
            total += enc + cross
            active += enc + cross
        emb = self.padded_vocab * D * (1 if self.tie_embeddings else 2)
        return total + emb, active
