"""whisper-small [audio] — enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

12L (decoder; + 12L encoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
input_specs provides precomputed frame embeddings (B, 1500, d_model) — the
conv frontend is the assignment's modality stub. Decoder uses RoPE instead of
Whisper's learned positions (geometry-preserving; noted in DESIGN.md).
Small model: attention replicates over 'model'; MLP/vocab TP-shard.
"""
from ..models.config import EncDecCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, encdec=EncDecCfg(enc_layers=12, enc_len=1500),
    mlp_gated=False, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, encdec=EncDecCfg(enc_layers=2, enc_len=30),
)
