"""starcoder2-15b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
kv_repeat=4 -> 16 effective kv heads for TP-16.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab_size=49152, rope_theta=100_000.0, kv_repeat=4,
    mlp_gated=False,
)

SMOKE = ModelConfig(
    name="starcoder2-15b-smoke", n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=192, vocab_size=512, kv_repeat=1,
)
