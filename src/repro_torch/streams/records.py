"""Record (de)serialization for the streaming layer.

Records are dicts serialized with orjson (fast, deterministic byte output).
A leading schema-id byte sequence is intentionally NOT used: schema validation
is a consumer/registry concern (and the supply-chain experiment relies on a
malformed record crashing an unguarded consumer, as with real Kafka payloads).
"""

from __future__ import annotations

from typing import Any, Dict

try:
    import orjson as _json

    def encode_record(rec: Dict[str, Any]) -> bytes:
        return _json.dumps(rec)

    def decode_record(data: bytes) -> Dict[str, Any]:
        return _json.loads(data)

except ImportError:  # pragma: no cover
    import json as _json2

    def encode_record(rec: Dict[str, Any]) -> bytes:
        return _json2.dumps(rec, separators=(",", ":")).encode()

    def decode_record(data: bytes) -> Dict[str, Any]:
        return _json2.loads(data.decode())
