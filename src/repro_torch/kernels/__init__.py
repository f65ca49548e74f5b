"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Each kernel is a CUDA source under ``csrc/``, built by ``build.py`` at first
use, and a Python wrapper that launches it on CUDA tensors, takes the plain
version on CPU tensors, and counts its launches.
"""

from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_backward, flash_attention_plain)
from .mlstm_chunk import (MLSTMChunkFunction, mlstm_chunk, mlstm_chunk_backward,
                          mlstm_chunk_plain)

__all__ = ["FlashAttentionFunction", "flash_attention", "flash_attention_backward",
           "flash_attention_plain", "MLSTMChunkFunction", "mlstm_chunk",
           "mlstm_chunk_backward", "mlstm_chunk_plain"]
