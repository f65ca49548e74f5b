"""The model stack in PyTorch: the attention, MLA, MoE, Mamba and xLSTM
decoders, the encoder-decoder and VLM wrappers, and the Mamba mixer."""

from .config import (EncDecCfg, MambaCfg, MLACfg, ModelConfig, MoECfg, VLMCfg)
from .lm import LM, decode_step, forward, init_caches, init_params, loss_fn
from .ssm import Mamba, apply_mamba, init_mamba, init_mamba_state

__all__ = ["ModelConfig", "MoECfg", "MLACfg", "MambaCfg", "EncDecCfg",
           "VLMCfg", "LM", "init_params", "init_caches", "forward", "loss_fn",
           "decode_step", "Mamba", "init_mamba", "apply_mamba", "init_mamba_state"]
