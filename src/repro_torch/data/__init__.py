"""Training data plane: token streams ingested into the shared log, consumed
as deterministic, exactly-resumable, host-sharded batches."""

from .pipeline import LogDataPipeline, TokenStreamWriter, synthetic_token_docs

__all__ = ["LogDataPipeline", "TokenStreamWriter", "synthetic_token_docs"]
