"""Structured request-lifecycle errors of the port.

A trimmed copy of ``clearml_serving_tpu/errors.py``: the engine
(``llm/engine.py``), the OpenAI front (``llm/openai_api.py``) and the HTTP
app (``serving/main.py``) raise these so the app can map a failure to its
status (408 deadline, 429 shed and 503 unavailable or stalled, each with a
``Retry-After`` hint) and clients can branch on a stable ``code``.

This module imports nothing: the app and the engine both take it.
"""

from __future__ import annotations

from typing import Optional


class RequestError(Exception):
    """A request-scoped failure with an HTTP mapping.

    ``status``: the HTTP status the app returns. ``code``: a stable
    machine-readable identifier carried in the JSON payload and in SSE
    error events. ``retry_after``: seconds for the ``Retry-After`` header
    (None omits the header).
    """

    status: int = 500
    code: str = "internal"
    default_retry_after: Optional[float] = None

    def __init__(self, message: str, *, retry_after: Optional[float] = None):
        super().__init__(message)
        self.retry_after = (
            retry_after if retry_after is not None else self.default_retry_after
        )

    def payload(self) -> dict:
        return {"detail": str(self), "code": self.code}


class DeadlineExceededError(RequestError):
    """A per-request budget (queue-wait, TTFT or total) elapsed."""

    status = 408
    code = "deadline_exceeded"

    def __init__(self, message: str, *, stage: str = "total",
                 retry_after: Optional[float] = None):
        super().__init__(message, retry_after=retry_after)
        self.stage = stage  # "queue" | "ttft" | "total"

    def payload(self) -> dict:
        out = super().payload()
        out["stage"] = self.stage
        return out


class EngineOverloadedError(RequestError):
    """Shed at admission: the pending queue or the KV pool is saturated,
    or the class-aware admission or the brownout controller dropped the
    request. 429: the server is healthy and the client should back off
    for the Retry-After hint, which the engine derives from its observed
    admission drain rate. ``shed_class`` names the priority class the shed
    was booked under (``class`` in the payload)."""

    status = 429
    code = "overloaded"
    default_retry_after = 1.0

    def __init__(self, message: str, *, retry_after: Optional[float] = None,
                 shed_class: Optional[str] = None):
        super().__init__(message, retry_after=retry_after)
        self.shed_class = shed_class

    def payload(self) -> dict:
        out = super().payload()
        if self.shed_class:
            out["class"] = self.shed_class
        return out


class EngineUnavailableError(RequestError):
    """The engine is stopped or the server is draining."""

    status = 503
    code = "unavailable"
    default_retry_after = 2.0


class EngineStepError(RequestError):
    """A device step (decode chunk, ragged step) failed for this request.
    The engine recovered: only the affected requests carry this error."""

    status = 500
    code = "engine_step_failed"


class EngineStuckError(RequestError):
    """The watchdog found the decode loop stalled and failed this request
    while recovering. Retryable once the engine reports ready again."""

    status = 503
    code = "engine_stalled"
    default_retry_after = 5.0


class UpstreamTimeoutError(RequestError):
    """gRPC upstream DEADLINE_EXCEEDED after the retry budget
    (``engines/grpc_client.py``)."""

    status = 504
    code = "upstream_timeout"


class UpstreamUnavailableError(RequestError):
    """gRPC upstream UNAVAILABLE after the retry budget
    (``engines/grpc_client.py``)."""

    status = 503
    code = "upstream_unavailable"
    default_retry_after = 2.0


class HostTierAutoSizeError(ValueError):
    """``prefix_cache_host_mb: "auto"`` could not size the host KV tier from
    /proc/meminfo (a platform without it, or without MemAvailable). Raised
    when the engine is built, so an endpoint fails at load, naming the knob,
    instead of serving without the tier its operator asked for."""
