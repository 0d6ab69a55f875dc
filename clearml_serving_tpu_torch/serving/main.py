"""HTTP front of the port: an aiohttp app serving one LLM endpoint.

Counterpart of ``clearml_serving_tpu/serving/main.py``'s ``build_app`` for
this slice: ``POST /serve/openai/v1/chat/completions``,
``GET /serve/openai/v1/models`` and ``GET /health``. The OpenAI routes pick
the endpoint by the body's ``model`` field, like the reference router; an
unknown model is a 404, a refused request a 422. The control plane (state
store, endpoint registry, ``ModelRequestProcessor``) arrives with a later
slice.

Start a server::

    python -m clearml_serving_tpu_torch.serving.main \\
        --engine-config '{"preset": "llama3-8b", "cache": "paged"}'
"""

from __future__ import annotations

import argparse
import json
import traceback
from typing import Any

from aiohttp import web

from ..llm.engine import EngineUnavailableError
from ..llm.openai_api import LLMEngineRequest, build_engine

_OPENAI = "/serve/openai/v1/"


def build_app(endpoint: LLMEngineRequest) -> web.Application:
    app = web.Application()

    async def _body(request: web.Request) -> Any:
        if not request.can_read_body:
            return {}
        return await request.json()

    async def openai_route(request: web.Request) -> web.StreamResponse:
        route = request.match_info["route"]
        try:
            body = await _body(request)
        except (ValueError, UnicodeDecodeError) as ex:
            return web.json_response({"detail": "unreadable request body: {}".format(ex)},
                                     status=422)
        if route == "models":
            return web.json_response(await endpoint.v1_models(body))
        if route != "chat/completions":
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
            out = await endpoint.v1_chat_completions(body)
        except (ValueError, TypeError) as ex:
            return web.json_response(
                {"detail": "Error processing request: {} {}".format(type(ex).__name__, ex)},
                status=422,
            )
        except EngineUnavailableError as ex:
            return web.json_response({"detail": "Service not ready: {}".format(ex)},
                                     status=503)
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

    async def health(request: web.Request) -> web.Response:
        return web.json_response({
            "status": "ok",
            "endpoints": [endpoint.model_name],
            "engine": endpoint.engine.health(),
        })

    async def _stop_engine(app: web.Application) -> None:
        endpoint.engine.stop()

    app.router.add_post(_OPENAI + "{route:.+}", openai_route)
    app.router.add_get(_OPENAI + "{route:models}", openai_route)
    app.router.add_get("/health", health)
    app.on_cleanup.append(_stop_engine)
    return app


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
    engine, tokenizer = build_engine(json.loads(args.engine_config), device=args.device)
    app = build_app(LLMEngineRequest(engine, tokenizer, args.model_name))
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
