"""Response wrapper types engines can return through the router.

The port's copy of ``clearml_serving_tpu/serving/responses.py``.

Leaf module (no intra-package imports) so engines and the HTTP app can both
depend on it without cycles.
"""

from __future__ import annotations

from typing import Any, AsyncIterator


class StreamingOutput:
    """Engine phases may return this to stream SSE chunks through the router.

    ``generator`` yields str (already SSE-framed or raw data lines) or bytes.
    """

    def __init__(self, generator: AsyncIterator, content_type: str = "text/event-stream"):
        self.generator = generator
        self.content_type = content_type
        # set by the orchestrator: called once after the stream body finishes
        # (or the client disconnects) — used to emit the stats packet with the
        # real stream latency/TTFT instead of time-to-headers
        self.on_complete = None


class JSONOutput:
    """Engine phases may return this to control the HTTP status code."""

    def __init__(self, payload: Any, status: int = 200):
        self.payload = payload
        self.status = status


class TextOutput:
    """Engine phases may return this for a raw text body (e.g. the OpenAI
    transcription API's response_format=text, which expects text/plain — a
    JSON-encoded string would arrive wrapped in literal quotes)."""

    def __init__(self, text: str, content_type: str = "text/plain"):
        self.text = text
        self.content_type = content_type
