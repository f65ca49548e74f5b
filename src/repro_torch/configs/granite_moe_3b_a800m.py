"""granite-moe-3b-a800m [moe] — 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

32L d_model=1536 24H (GQA kv=8) d_ff=512 (expert dim) vocab=49155,
MoE 40e top-8. Experts pad 40->48 for EP-16 (padded experts masked to -inf in
the router). Small attention (24H) replicates over 'model'.
"""
from ..models.config import ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab_size=49155,
    block_pattern=("attn+moe",),
    moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
    pad_experts_to=48, rope_theta=10_000.0,
    # TP-16: pad 24 q-heads to 32 (one zero slot per kv superblock, exact
    # geometry) + kv_repeat 8->16; unpadded attention replicates over 'model'
    # = 16x redundant attention flops (hillclimb iteration 3, §Perf)
    pad_heads_to=32, kv_repeat=2,
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=64, vocab_size=512, block_pattern=("attn+moe",),
    moe=MoECfg(n_experts=8, top_k=2, d_expert=64),
)
