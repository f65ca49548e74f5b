"""smollm-135m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152. Heads (9) don't divide
the 16-way model axis: attention weights replicate over 'model' (tiny model —
DESIGN.md §5 divisibility fallback); MLP/vocab dims still TP-shard.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_ff=1536, vocab_size=49152, rope_theta=10_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, tie_embeddings=True,
)
