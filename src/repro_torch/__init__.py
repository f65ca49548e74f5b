"""AgileLog's model stack in PyTorch and CUDA, for one NVIDIA H100.

The port of ``repro`` (JAX): it imports ``torch`` and nothing of ``jax`` or
``repro``. The log (``core``, ``streams``), the configs and the speculative
driver are byte-identical copies of the JAX package's JAX-free modules.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .configs import ARCHS, get_config, get_smoke_config
from .convert import opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax
from .core import BoltSystem
from .kernels import flash_attention, mlstm_chunk
from .models import (LM, ModelConfig, decode_step, forward, init_caches,
                     init_params, loss_fn)
from .serve import (ModelDraft, ModelTarget, ServeEngine, SpeculativeDecoder,
                    decode_response, sequential_decode)
from .streams import Consumer, Producer, Topic

__all__ = ["ARCHS", "get_config", "get_smoke_config", "params_from_jax",
           "opt_state_from_jax", "params_to_jax", "opt_state_to_jax",
           "BoltSystem", "flash_attention", "mlstm_chunk", "LM", "ModelConfig",
           "init_params", "init_caches", "forward", "loss_fn", "decode_step",
           "ServeEngine", "ModelTarget", "ModelDraft", "SpeculativeDecoder",
           "decode_response", "sequential_decode", "Topic", "Producer",
           "Consumer"]
