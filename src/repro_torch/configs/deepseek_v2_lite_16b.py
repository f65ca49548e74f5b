"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6.
[arXiv:2405.04434; hf]

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; first layer dense
(d_ff=10944 per the HF config), 26 MoE layers. MLA: kv_lora_rank=512,
rope_head_dim=64, head_dim=128. 16 heads / 64 experts divide TP/EP-16 exactly.
"""
from ..models.config import MLACfg, ModelConfig, MoECfg

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=10944, vocab_size=102400, head_dim=128,
    block_pattern=("mla+moe",), first_layer_dense=True,
    mla=MLACfg(kv_lora_rank=512, rope_head_dim=64),
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-smoke", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, head_dim=16,
    block_pattern=("mla+moe",), first_layer_dense=True,
    mla=MLACfg(kv_lora_rank=32, rope_head_dim=8),
    moe=MoECfg(n_experts=4, top_k=2, d_expert=32, n_shared=1),
)
