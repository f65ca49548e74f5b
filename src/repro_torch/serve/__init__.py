"""Serving on the log: the subscription-fed batched engine and the model
adapters of the speculative-decode driver."""

from .engine import ModelDraft, ModelTarget, ServeEngine
from .speculative import (DecodeResult, RolloutResult, SpeculativeDecoder,
                          decode_response, sequential_decode,
                          sequential_decode_on_log)

__all__ = ["ServeEngine", "ModelTarget", "ModelDraft", "SpeculativeDecoder",
           "DecodeResult", "RolloutResult", "decode_response",
           "sequential_decode", "sequential_decode_on_log"]
