"""HTTP front of the port: an aiohttp app serving one LLM endpoint.

Counterpart of ``clearml_serving_tpu/serving/main.py``'s ``build_app`` for
this slice: ``POST /serve/openai/v1/chat/completions``,
``/serve/openai/v1/completions``, ``/serve/openai/v1/tokenize`` and
``/serve/openai/v1/detokenize``, ``GET /serve/openai/v1/models``, ``GET|POST
/serve/openai/version`` (no body needed), ``GET /health`` (liveness) and
``GET /ready`` (readiness: 503 while draining or while the engine is
stopped or recovering from a watchdog trip, with its brownout stage). The
OpenAI routes pick the endpoint by the body's ``model`` field, like the
reference router; an unknown model is a 404, a refused request a 422, and
a request-lifecycle error (``errors.RequestError``) its own status and
payload with a ``Retry-After`` header (408, 429, 503). SIGTERM drains:
new requests shed with 503 ``draining`` while in-flight ones finish (up to
``TPUSERVE_DRAIN_TIMEOUT`` seconds, default 30), then the engine stops.
The control plane (state store, endpoint registry,
``ModelRequestProcessor``) arrives with a later slice.

Start a server::

    python -m clearml_serving_tpu_torch.serving.main \\
        --engine-config '{"preset": "llama3-8b", "cache": "paged"}'
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import traceback
from typing import Any, Optional

from aiohttp import web

from ..errors import RequestError
from ..llm.openai_api import LLMEngineRequest, build_engine, default_priority, warmup_mode

_OPENAI = "/serve/openai/v1/"
# the OpenAI routes that take a body naming the model: route -> handler
_ROUTES = {"chat/completions": "v1_chat_completions", "completions": "v1_completions",
           "tokenize": "v1_tokenize", "detokenize": "v1_detokenize"}


def _request_error_response(ex: RequestError) -> web.Response:
    """A lifecycle error as its status and payload, with a ``Retry-After``
    hint (whole seconds, at least 1) so clients back off."""
    headers = {}
    if ex.retry_after is not None:
        headers["Retry-After"] = str(max(1, int(round(ex.retry_after))))
    return web.json_response(ex.payload(), status=ex.status, headers=headers)


def build_app(endpoint: LLMEngineRequest) -> web.Application:
    app = web.Application()
    app["endpoint"] = endpoint
    # drain state: once draining, new requests shed with 503 while the
    # in-flight ones (counted here) finish. A mutable dict: the handlers
    # change it, never the app's mapping
    app["lifecycle"] = {"draining": False, "inflight": 0}

    async def _body(request: web.Request) -> Any:
        if not request.can_read_body:
            return {}
        return await request.json()

    async def openai_route(request: web.Request) -> web.StreamResponse:
        state = app["lifecycle"]
        if state["draining"]:
            return web.json_response({"detail": "server is draining", "code": "draining"},
                                     status=503, headers={"Retry-After": "5"})
        state["inflight"] += 1
        try:
            return await _openai_route(request)
        finally:
            state["inflight"] -= 1

    async def _openai_route(request: web.Request) -> web.StreamResponse:
        route = request.match_info["route"]
        try:
            body = await _body(request)
        except (ValueError, UnicodeDecodeError) as ex:
            return web.json_response({"detail": "unreadable request body: {}".format(ex)},
                                     status=422)
        if route == "models":
            return web.json_response(await endpoint.v1_models(body))
        handler = _ROUTES.get(route)
        if handler is None:
            return web.json_response({"detail": "unknown route {!r}".format(route)}, status=404)
        if not isinstance(body, dict) or not body.get("model"):
            return web.json_response(
                {"detail": "OpenAI route requires a JSON body with a 'model' field"},
                status=422,
            )
        if body["model"] != endpoint.model_name:
            return web.json_response(
                {"detail": "Error processing request: model {!r} not found".format(
                    body["model"])}, status=404,
            )
        try:
            out = await getattr(endpoint, handler)(body)
        except RequestError as ex:
            return _request_error_response(ex)
        except (ValueError, TypeError) as ex:
            return web.json_response(
                {"detail": "Error processing request: {} {}".format(type(ex).__name__, ex)},
                status=422,
            )
        except Exception as ex:
            traceback.print_exc()
            return web.json_response(
                {"detail": "Internal error: {} {}".format(type(ex).__name__, ex)},
                status=500,
            )
        if isinstance(out, dict):
            return web.json_response(out)
        resp = web.StreamResponse(
            status=200,
            headers={"Content-Type": "text/event-stream", "Cache-Control": "no-cache"},
        )
        try:
            try:
                await resp.prepare(request)
                async for line in out:
                    await resp.write(line.encode("utf-8"))
            except ConnectionResetError:
                pass
        finally:
            # frees the decode slot now if the client went away
            await out.aclose()
        try:
            await resp.write_eof()
        except ConnectionResetError:
            pass
        return resp

    async def version(request: web.Request) -> web.Response:
        # model-independent: answers without a body or a model
        return web.json_response(await endpoint.version({}))

    async def health(request: web.Request) -> web.Response:
        return web.json_response({
            "status": "ok",
            "endpoints": [endpoint.model_name],
            "engine": endpoint.engine.health(),
        })

    async def ready(request: web.Request) -> web.Response:
        """Readiness, apart from /health's liveness: 503 while draining or
        while the engine is not ready, so a load balancer stops routing
        here while /health keeps the process alive. A browned-out engine
        is still ready (it sheds by policy); its stage is reported."""
        engine_health = endpoint.engine.health()
        name = endpoint.model_name
        stage = (engine_health.get("brownout") or {}).get("stage", 0)
        body = {"brownout": {name: stage} if stage else {},
                "engines": {name: engine_health}}
        draining = app["lifecycle"]["draining"]
        if draining or not engine_health["ready"]:
            return web.json_response(
                dict(body, status="draining" if draining else "not_ready",
                     not_ready=[] if engine_health["ready"] else [name]),
                status=503, headers={"Retry-After": "5"})
        return web.json_response(dict(body, status="ready"))

    async def _stop_engine(app: web.Application) -> None:
        endpoint.engine.stop()

    app.router.add_route("*", "/serve/openai/version", version)
    app.router.add_post(_OPENAI + "{route:.+}", openai_route)
    app.router.add_get(_OPENAI + "{route:models}", openai_route)
    app.router.add_get("/health", health)
    app.router.add_get("/ready", ready)
    app.on_cleanup.append(_stop_engine)
    return app


async def drain_app(app: web.Application, timeout: Optional[float] = None) -> None:
    """Graceful drain: stop admitting (the routes answer 503 ``draining``
    from now on), wait for the in-flight requests up to ``timeout``
    seconds (``TPUSERVE_DRAIN_TIMEOUT``, default 30), then stop the
    engine, which fails whatever is left with 503 and frees its pages once
    the chunks in flight land."""
    state = app["lifecycle"]
    state["draining"] = True
    if timeout is None:
        timeout = float(os.environ.get("TPUSERVE_DRAIN_TIMEOUT", 30.0))
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while state["inflight"] > 0 and loop.time() < deadline:
        await asyncio.sleep(0.05)
    app["endpoint"].engine.stop()


def install_graceful_drain(app: web.Application) -> None:
    """SIGTERM -> drain -> exit: after the drain the process sends itself
    SIGINT, so aiohttp's own shutdown (connections, cleanup hooks) runs."""

    async def _on_startup(app: web.Application) -> None:
        loop = asyncio.get_running_loop()

        def _begin_drain() -> None:
            state = app["lifecycle"]
            if state["draining"]:
                return  # a second SIGTERM: the drain is under way
            # set before the task runs, so back-to-back signals start one
            # drain
            state["draining"] = True

            async def _drain_then_exit() -> None:
                await drain_app(app)
                os.kill(os.getpid(), signal.SIGINT)

            # held: the loop keeps only weak references to tasks
            state["drain_task"] = loop.create_task(_drain_then_exit())

        try:
            loop.add_signal_handler(signal.SIGTERM, _begin_drain)
        except (NotImplementedError, RuntimeError):
            pass  # no signal handlers here: the default handling stays

    app.on_startup.append(_on_startup)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--engine-config", required=True,
                        help="JSON aux engine block, e.g. "
                             "'{\"preset\": \"llama3-8b\", \"cache\": \"paged\"}'")
    parser.add_argument("--model-name", default="model",
                        help="the OpenAI 'model' this server answers to")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    args = parser.parse_args(argv)
    engine_cfg = json.loads(args.engine_config)
    engine, tokenizer = build_engine(engine_cfg, device=args.device)
    app = build_app(LLMEngineRequest(engine, tokenizer, args.model_name,
                                     warmup=warmup_mode(engine_cfg),
                                     default_priority=default_priority(engine_cfg)))
    install_graceful_drain(app)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
