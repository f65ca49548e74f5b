"""deepseek-67b [dense] — llama-arch. [arXiv:2401.02954; hf]

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
kv_repeat=2 -> 16 effective kv heads (exact; tied copies) for TP-16.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=102400, rope_theta=10_000.0, kv_repeat=2,
)

SMOKE = ModelConfig(
    name="deepseek-67b-smoke", n_layers=3, d_model=96, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab_size=512, kv_repeat=2,
)
