"""Serving on the log: the subscription-fed batched engine, the model
adapters of the speculative-decode driver, and the step costs of the H100
roofline for the DES benchmarks (``costs``)."""

from .costs import ServeCosts
from .engine import ModelDraft, ModelTarget, ServeEngine
from .speculative import (DecodeResult, RolloutResult, SpeculativeDecoder,
                          decode_response, sequential_decode,
                          sequential_decode_on_log)

__all__ = ["ServeEngine", "ModelTarget", "ModelDraft", "ServeCosts", "SpeculativeDecoder",
           "DecodeResult", "RolloutResult", "decode_response",
           "sequential_decode", "sequential_decode_on_log"]
