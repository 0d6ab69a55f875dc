"""`jax_grpc` engine: the router's client of the engine server.

The port's copy of ``clearml_serving_tpu/engines/grpc_client.py``: async
gRPC with a per-event-loop channel cache, env-tunable channel options
(``TPUSERVE_GRPC_<OPTION>`` -> ``grpc.<option>``), optional gzip
compression (server config ``engine_grpc_compression``), the model
addressed as ``{serving_url}`` + version, numpy marshalling per the
endpoint I/O spec, single-output unwrap, and the retry policy: transient
upstream statuses (UNAVAILABLE, DEADLINE_EXCEEDED) retry with jittered
exponential backoff under an attempt ceiling and a time budget, then map
to 503 / 504; NOT_FOUND is a 422. ``RETRY_STATS`` counts attempts,
retries and exhausted calls for the statistics exporter.

The client runs no model: a router serving ``jax_grpc`` endpoints never
touches the card. The server is ``engine_server/server.py``
(``tpu-serving-torch-engine``), or the reference's: the wire is the same.
"""

from __future__ import annotations

import asyncio
import os
import random
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np

from .base import BaseEngineRequest, EndpointModelError, register_engine
from ..errors import UpstreamTimeoutError, UpstreamUnavailableError
from ..llm import faults

# grpc and ..engine_server.protocol (msgpack) are imported inside methods,
# so importing the engine registry needs neither

# upstream statuses worth retrying: the engine server restarting
# (UNAVAILABLE) or a transient per-call deadline (DEADLINE_EXCEEDED)
_TRANSIENT_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED")

# scrape-time retry counters (statistics.metrics register_engine_lifecycle
# exports them; a plain dict, no prometheus dependency here)
RETRY_STATS: Dict[str, int] = {"attempts": 0, "retries": 0, "exhausted": 0}


def grpc_lifecycle_stats() -> Dict[str, Any]:
    """Provider for the statistics lifecycle collector."""
    return {"grpc": dict(RETRY_STATS)}


def _grpc_code_name(ex: BaseException) -> Optional[str]:
    """Status-code name of a failed attempt: a real AioRpcError, or an
    injected fault carrying ``grpc_code`` (tests without a server)."""
    injected = getattr(ex, "grpc_code", None)
    if injected:
        return str(injected)
    code = getattr(ex, "code", None)
    if callable(code):
        try:
            return code().name
        except Exception:
            return None
    return None


def _channel_options() -> List:
    options = [
        ("grpc.max_receive_message_length", 256 * 1024 * 1024),
        ("grpc.max_send_message_length", 256 * 1024 * 1024),
    ]
    for key, value in os.environ.items():
        if key.startswith("TPUSERVE_GRPC_"):
            opt = "grpc." + key[len("TPUSERVE_GRPC_"):].lower()
            try:
                value = int(value)
            except ValueError:
                pass
            options.append((opt, value))
    return options


@register_engine("jax_grpc", modules=["grpc"])
class JaxGrpcEngineRequest(BaseEngineRequest):
    is_process_async = True

    def __init__(self, *args, **kwargs):
        self._channels: Dict[int, Any] = {}  # per-event-loop aio channels
        super().__init__(*args, **kwargs)

    def _native_load(self) -> Any:
        # the model lives in the engine-server process; nothing to load
        # here. The module-wide retry counters go on the serving registry
        # (idempotent; one entry for all jax_grpc endpoints)
        try:
            from ..statistics.metrics import register_engine_lifecycle

            register_engine_lifecycle(grpc_lifecycle_stats, key="grpc_client")
        except Exception:  # the metrics registry is optional observability
            pass
        return self.endpoint.model_id or True

    def _address(self) -> str:
        return self.get_server_config().get("engine_grpc_server") or os.environ.get(
            "TPUSERVE_DEFAULT_ENGINE_GRPC_ADDR", "127.0.0.1:8001"
        )

    def _get_channel(self):
        import grpc

        loop = asyncio.get_running_loop()
        entry = self._channels.get(id(loop))
        if entry is not None:
            loop_ref, channel = entry
            if loop_ref() is loop:  # id() reuse after a dead loop is detected
                return channel
            self._channels.pop(id(loop), None)
        # drop channels whose loops died (fd hygiene)
        for key in [k for k, (ref, _) in self._channels.items() if ref() is None]:
            self._channels.pop(key, None)
        compression = None
        if str(self.get_server_config().get("engine_grpc_compression", "")).lower() in (
            "1", "true", "gzip",
        ):
            compression = grpc.Compression.Gzip
        channel = grpc.aio.insecure_channel(
            self._address(), options=_channel_options(), compression=compression
        )
        self._channels[id(loop)] = (weakref.ref(loop), channel)
        return channel

    def _body_to_inputs(self, data: Any) -> Dict[str, np.ndarray]:
        names = self.endpoint.input_name or []
        types = self.endpoint.input_type or []
        if isinstance(data, dict) and names:
            raw = {}
            for i, name in enumerate(names):
                if name not in data:
                    raise ValueError("missing input {!r}".format(name))
                dtype = np.dtype(types[i]) if i < len(types) else np.float32
                raw[name] = np.asarray(data[name], dtype=dtype)
            return raw
        if isinstance(data, dict):
            return {k: np.asarray(v) for k, v in data.items()}
        dtype = np.dtype(types[0]) if types else np.float32
        name = names[0] if names else "input_0"
        return {name: np.asarray(data, dtype=dtype)}

    def _retry_config(self) -> Dict[str, float]:
        """The retry policy for transient upstream failures. Env-tunable:
        TPUSERVE_GRPC_RETRIES (attempt ceiling, default 3),
        TPUSERVE_GRPC_RETRY_BACKOFF (first delay seconds, default 0.05),
        TPUSERVE_GRPC_RETRY_BACKOFF_MAX (per-delay cap, default 2.0),
        TPUSERVE_GRPC_RETRY_BUDGET (total seconds across attempts,
        default 10). Server config keys of the same lowercase names win."""
        cfg = self.get_server_config()

        def knob(name: str, default: float) -> float:
            v = cfg.get(name.lower(), os.environ.get(name.upper()))
            return float(v) if v is not None else default

        return {
            "attempts": knob("tpuserve_grpc_retries", 3),
            "backoff": knob("tpuserve_grpc_retry_backoff", 0.05),
            "backoff_max": knob("tpuserve_grpc_retry_backoff_max", 2.0),
            "budget": knob("tpuserve_grpc_retry_budget", 10.0),
        }

    async def _call_with_retry(self, call, payload, timeout: float):
        """One logical inference call with jittered exponential backoff on
        transient upstream codes, bounded by an attempt ceiling AND a total
        time budget. After exhaustion the last transient failure maps to a
        503 (UNAVAILABLE) / 504 (DEADLINE_EXCEEDED); NOT_FOUND is a 422."""
        policy = self._retry_config()
        attempts = max(1, int(policy["attempts"]))
        t0 = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            RETRY_STATS["attempts"] += 1
            try:
                if faults.active():
                    faults.fire("grpc.call", attempt=attempt)
                return await call(payload, timeout=timeout)
            except Exception as ex:
                code = _grpc_code_name(ex)
                if code == "NOT_FOUND":
                    detail = getattr(ex, "details", None)
                    raise EndpointModelError(
                        str(detail() if callable(detail) else ex)
                    ) from None
                if code not in _TRANSIENT_CODES:
                    raise
                delay = min(
                    policy["backoff_max"],
                    policy["backoff"] * (2 ** (attempt - 1)),
                ) * (0.5 + random.random())  # full jitter in [0.5x, 1.5x)
                out_of_budget = time.monotonic() - t0 + delay > policy["budget"]
                if attempt >= attempts or out_of_budget:
                    RETRY_STATS["exhausted"] += 1
                    msg = "engine upstream {} after {} attempt(s): {}".format(
                        code, attempt, ex)
                    if code == "DEADLINE_EXCEEDED":
                        raise UpstreamTimeoutError(msg) from ex
                    raise UpstreamUnavailableError(msg) from ex
                RETRY_STATS["retries"] += 1
                await asyncio.sleep(delay)

    async def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "process"):
            out = self._preprocess.process(data, state, collect_fn)
            if asyncio.iscoroutine(out):
                out = await out
            return out
        if isinstance(data, np.ndarray):
            inputs = self._body_to_inputs(data)
        elif isinstance(data, dict) and all(isinstance(v, np.ndarray) for v in data.values()):
            inputs = data
        else:
            inputs = self._body_to_inputs(data)

        from ..engine_server import protocol

        channel = self._get_channel()
        call = channel.unary_unary(
            protocol.INFER_METHOD,
            request_serializer=None,
            response_deserializer=None,
        )
        payload = protocol.encode_infer_request(
            model=self.endpoint.serving_url,
            version=self.endpoint.version,
            inputs=inputs,
            output_names=self.endpoint.output_name,
        )
        response = await self._call_with_retry(
            call, payload, timeout=self.request_timeout()
        )
        outputs = protocol.decode_infer_response(response)
        if len(outputs) == 1:
            return next(iter(outputs.values()))
        return outputs

    def postprocess(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "postprocess"):
            return self._preprocess.postprocess(data, state, collect_fn)
        if isinstance(data, np.ndarray):
            return data.tolist()
        if isinstance(data, dict):
            return {
                k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in data.items()
            }
        return data
