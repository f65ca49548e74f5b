"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
(d_expert = d_ff; total ~398B, active ~98B). Pattern of 8 layers: one
attention per 8 (1:7) and MoE on alternate layers (4 of 8).
kv_repeat=2 -> 16 effective kv heads.
"""
from ..models.config import MambaCfg, ModelConfig, MoECfg

_PATTERN = ("mamba+moe", "mamba+mlp", "mamba+moe", "mamba+mlp",
            "attn+moe", "mamba+mlp", "mamba+moe", "mamba+mlp")

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=24576, vocab_size=65536, block_pattern=_PATTERN,
    moe=MoECfg(n_experts=16, top_k=2, d_expert=24576),
    mamba=MambaCfg(d_state=16, expand=2, conv_width=4),
    rope_theta=1_000_000.0, kv_repeat=2,
)

SMOKE = ModelConfig(
    name="jamba-smoke", n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, block_pattern=_PATTERN,
    moe=MoECfg(n_experts=4, top_k=2, d_expert=128),
    mamba=MambaCfg(d_state=4, expand=2, conv_width=4),
)
