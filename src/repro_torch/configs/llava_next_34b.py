"""llava-next-34b [vlm] — anyres tiling (stubbed frontend).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. Backbone only; the
vision frontend is a stub: input_specs provides 576 precomputed patch
embeddings. 56 heads pad to 64 (per-superblock zero slots, exact geometry)
and kv_repeat=2 -> 16 effective kv heads for TP-16.
"""
from ..models.config import ModelConfig, VLMCfg

CONFIG = ModelConfig(
    name="llava-next-34b", n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, rope_theta=1_000_000.0,
    vlm=VLMCfg(n_patches=576), pad_heads_to=64, kv_repeat=2,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke", n_layers=3, d_model=64, n_heads=7, n_kv_heads=1,
    head_dim=8, d_ff=128, vocab_size=512, vlm=VLMCfg(n_patches=16),
    pad_heads_to=8,
)
