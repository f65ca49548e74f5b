"""Data-streaming layer on top of AgileLog: topics, producers, consumers,
consumer groups, schemas, and windowed stream processors."""

from .records import decode_record, encode_record
from .topics import Consumer, Producer, SchemaRegistry, StreamProcessor, Topic

__all__ = ["Topic", "Producer", "Consumer", "SchemaRegistry",
           "StreamProcessor", "encode_record", "decode_record"]
