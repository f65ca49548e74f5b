"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks (7:1). [arXiv:2405.04517; unverified]

48L d_model=2048 4H d_ff=0 vocab=50304. Blocks carry their own projections
(no separate FFN). O(1) recurrent state -> runs the long_500k shape.
"""
from ..models.config import ModelConfig

_PATTERN = ("mlstm",) * 7 + ("slstm",)

CONFIG = ModelConfig(
    name="xlstm-1.3b", n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, block_pattern=_PATTERN, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="xlstm-smoke", n_layers=8, d_model=64, n_heads=2, n_kv_heads=2,
    d_ff=0, vocab_size=512, block_pattern=_PATTERN,
)
