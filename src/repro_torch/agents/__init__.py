"""The paper's three agentic applications (§6.8), as deterministic agents.

The paper captures one LLM run and replays the trace for determinism; we do
the same one step further — the 'LLM plan' is a recorded decision sequence,
and the *system-side* tool calls (read / fork / inject / run-processor /
promote / squash) are fully real against Bolt.
"""

from .analytics import AnalyticsAgent
from .testing import StreamTestingAgent
from .supplychain import SupplyChainAgent

__all__ = ["AnalyticsAgent", "StreamTestingAgent", "SupplyChainAgent"]
