"""The model stack in PyTorch: the ``attn+mlp`` and ``attn+moe`` decoders and xLSTM."""

from .config import (EncDecCfg, MambaCfg, MLACfg, ModelConfig, MoECfg, VLMCfg)
from .lm import LM, decode_step, forward, init_caches, init_params, loss_fn

__all__ = ["ModelConfig", "MoECfg", "MLACfg", "MambaCfg", "EncDecCfg",
           "VLMCfg", "LM", "init_params", "init_caches", "forward", "loss_fn",
           "decode_step"]
