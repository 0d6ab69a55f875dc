"""Serving HTTP router (aiohttp).

Route surface parity with the reference FastAPI app
(clearml_serving/serving/main.py:1-233):

- ``POST /serve/{endpoint}``, ``/serve/{endpoint}/{version}``;
- OpenAI-compatible ``POST|GET /serve/openai/{endpoint_type...}`` where the
  path tail (e.g. ``v1/chat/completions``) becomes the serve type and
  ``body["model"]`` names the endpoint;
- transparent gzip request decompression;
- error taxonomy: 404 endpoint-not-found, 422 model/backend/value errors,
  500 internal (with the instance id in the payload);
- hardware-OOM policy: crash-and-restart (``os._exit(1)``) unless dev mode
  (reference main.py:111-123: ``torch.cuda.OutOfMemoryError``);
- streaming: engines may return a ``StreamingOutput`` (async generator) which
  is forwarded as an SSE response through the router unchanged — preserving the
  pre/process/post hook contract the same way the reference passes vLLM's
  StreamingResponse through.

The route prefix is configurable via ``TPUSERVE_DEFAULT_SERVE_SUFFIX``
(default "serve"). Process model: single process, or ``TPUSERVE_NUM_PROCESS``
forked workers sharing the port via SO_REUSEPORT (gunicorn-equivalent).

The port's copy of ``clearml_serving_tpu/serving/main.py``. It differs in
three places: there is no profiler server (the reference's starts JAX's);
``main()`` takes ``--device`` (default ``cuda``), which the processor passes
to every engine it builds; and the app's cleanup stops the loaded engines.
Nothing here touches CUDA: the parent imports the engine modules before it
forks workers, and each worker builds its engines on its own.

Start the control plane and a server::

    python -m clearml_serving_tpu_torch create --name demo
    python -m clearml_serving_tpu_torch model add --engine llm --endpoint chat \
        --aux-config engine.preset=llama3-8b engine.cache=paged engine.kv_quant=int8
    python -m clearml_serving_tpu_torch.serving.main [--device cuda]

then ``POST /serve/openai/v1/chat/completions`` with ``"model": "chat"``, or
``POST /serve/chat``.
"""

from __future__ import annotations

import argparse
import asyncio
import gzip
import json
import os
import signal
import traceback
from typing import Any, Optional

import torch
from aiohttp import web

from .model_request_processor import (
    EndpointBackendError,
    EndpointNotFoundException,
    ModelRequestProcessor,
    ServingInitializationError,
)
from .responses import JSONOutput, StreamingOutput, TextOutput
from ..engines.base import EndpointModelError
from ..errors import RequestError


def _is_device_oom(ex: BaseException) -> bool:
    """Only the CUDA allocator's failure qualifies, never user-code error
    text."""
    return isinstance(ex, torch.cuda.OutOfMemoryError)


def _instance_id(processor: Optional[ModelRequestProcessor]) -> str:
    return getattr(processor, "_instance_id", "unknown") if processor else "unknown"


def _request_error_response(
    ex: RequestError, processor: Optional[ModelRequestProcessor]
) -> web.Response:
    """Structured lifecycle errors (errors.RequestError) map to their own
    status (408 deadline, 429/503 shed, 503/504 upstream) with a
    ``Retry-After`` hint so clients back off instead of hammering."""
    payload = ex.payload()
    payload["instance"] = _instance_id(processor)
    headers = {}
    if ex.retry_after is not None:
        headers["Retry-After"] = str(max(1, int(round(ex.retry_after))))
    return web.json_response(payload, status=ex.status, headers=headers)


async def _read_body(request: web.Request) -> Any:
    content_type = request.headers.get("Content-Type", "")
    if content_type.startswith("multipart/form-data"):
        # OpenAI audio API shape: file upload + form fields (model, language,
        # response_format, ...) — fields land in a dict, the upload's bytes
        # under its field name (usually "file")
        fields: dict = {}
        async for part in await request.multipart():
            if part.name is None:
                continue
            data = await part.read(decode=True)
            if part.filename is not None:
                fields[part.name] = data
            else:
                fields[part.name] = data.decode("utf-8", "replace")
        return fields
    raw = await request.read()
    # aiohttp transparently decompresses Content-Encoding: gzip; only
    # decompress here if the payload still carries the gzip magic (e.g. a
    # proxy stripped the header, or double-compressed clients).
    if raw[:2] == b"\x1f\x8b" and (
        request.headers.get("Content-Encoding", "").lower() == "gzip"
        or "gzip" in request.headers.get("Content-Type", "")
    ):
        raw = gzip.decompress(raw)
    if not raw:
        return None
    content_type = request.headers.get("Content-Type", "")
    if content_type and "application/json" not in content_type and "text/" not in content_type:
        return raw  # binary passthrough (e.g. image payloads, reference pytorch example)
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError):
        return raw


def _engine_health(processor: ModelRequestProcessor) -> dict:
    """Per-endpoint engine health for /ready: any loaded processor exposing
    an ``engine`` with a ``health()`` surface (the LLM engine core, or a
    replica group's fleet aggregate, or a ``jax`` endpoint's bucket runner),
    an ``encoder`` (an encoder endpoint's core) or an ``audio`` (an audio
    endpoint's core) contributes; plain CPU engines are stateless and
    always ready."""
    out = {}
    for url, proc in getattr(processor, "_engine_processor_lookup", {}).items():
        engine = (getattr(proc, "engine", None) or getattr(proc, "encoder", None)
                  or getattr(proc, "audio", None))
        health = getattr(engine, "health", None)
        if callable(health):
            try:
                out[url] = health()
            except Exception as ex:
                out[url] = {"ready": False, "error": str(ex)}
    return out


def _fleet_health(processor: ModelRequestProcessor) -> dict:
    """Health of REPLICA-GROUP engines only (those with a ``router``):
    /health is a liveness probe and must not pay every plain engine's full
    health snapshot, nor run ring sweeps it then discards, on each poll."""
    out = {}
    for url, proc in getattr(processor, "_engine_processor_lookup", {}).items():
        engine = getattr(proc, "engine", None)
        if getattr(engine, "router", None) is None:
            continue
        try:
            out[url] = engine.health()
        except Exception as ex:
            out[url] = {"ready": False, "error": str(ex)}
    return out


def _fleet_summary(engines: dict) -> dict:
    """The replica-fleet view of the engine healths: an endpoint backed by
    a replica group reports each replica's state and the router's ring. It
    is READY iff its ring has >= 1 member (the group's own ``ready``), so
    one tripped replica never flips /ready while its siblings serve. A
    process replica's row carries its worker's ``process`` block."""
    out = {}
    for url, h in engines.items():
        router = h.get("router")
        if not isinstance(router, dict):
            continue  # a single engine: no fleet block
        out[url] = {
            "replicas": router.get("replicas"),
            "ring_size": router.get("ring_size"),
            "ring": router.get("ring"),
            "ready": bool(h.get("ready")),
            "failovers": h.get("failovers", 0),
            "fleet_brownout": router.get("fleet_brownout"),
            "per_replica": {
                name: {
                    "ready": bool(rh.get("ready")),
                    "ring_state": rh.get("ring_state"),
                    "brownout_stage": (rh.get("brownout") or {}).get("stage", 0),
                    "queue_depth": rh.get("queue_depth", 0),
                    # a process replica's worker: backend, pid, alive,
                    # restarts (absent on in-process replicas)
                    **({"process": {k: rh["process"].get(k) for k in
                                    ("backend", "pid", "alive", "restarts")}}
                       if isinstance(rh.get("process"), dict) else {}),
                }
                for name, rh in (h.get("replicas") or {}).items()
            },
        }
    return out


def build_app(processor: ModelRequestProcessor) -> web.Application:
    app = web.Application(client_max_size=int(os.environ.get("TPUSERVE_MAX_BODY", 64 * 1024 * 1024)))
    app["processor"] = processor
    # SIGTERM drain state: once draining, new requests shed with 503 while
    # in-flight ones (inflight counter) finish up to the drain timeout.
    # A plain mutable dict: aiohttp deprecates reassigning app keys after
    # startup, so the handlers mutate THIS object, never the app mapping.
    app["lifecycle"] = {"draining": False, "inflight": 0}
    serve_suffix = os.environ.get("TPUSERVE_DEFAULT_SERVE_SUFFIX", "serve").strip("/")
    dev_mode = bool(os.environ.get("TPUSERVE_DEV_MODE"))

    async def process_with_exceptions(
        base_url: str, version: Optional[str], body: Any, serve_type: str
    ) -> web.StreamResponse:
        try:
            out = await processor.process_request(
                base_url=base_url, version=version, request_body=body, serve_type=serve_type
            )
        except EndpointNotFoundException as ex:
            return web.json_response(
                {"detail": "Error processing request: {}".format(ex)}, status=404
            )
        except RequestError as ex:
            return _request_error_response(ex, processor)
        except (EndpointModelError, EndpointBackendError, ValueError) as ex:
            return web.json_response(
                {
                    "detail": "Error processing request: {} {}".format(
                        type(ex).__name__, ex
                    ),
                    "instance": _instance_id(processor),
                },
                status=422,
            )
        except ServingInitializationError as ex:
            return web.json_response(
                {"detail": "Service not ready: {}".format(ex)}, status=500
            )
        except Exception as ex:
            if _is_device_oom(ex):
                # device OOM: the engine's state may be poisoned — crash so
                # the container restart loop brings up a clean process
                # (reference CUDA-OOM policy, main.py:111-123).
                if not dev_mode:
                    traceback.print_exc()
                    os._exit(1)
            traceback.print_exc()
            return web.json_response(
                {
                    "detail": "Internal error: {} {}".format(type(ex).__name__, ex),
                    "instance": _instance_id(processor),
                },
                status=500,
            )
        if isinstance(out, StreamingOutput):
            resp = web.StreamResponse(
                status=200,
                headers={
                    "Content-Type": out.content_type,
                    "Cache-Control": "no-cache",
                },
            )
            return resp, out  # handled by caller (needs the request to prepare)
        if isinstance(out, JSONOutput):
            return web.json_response(out.payload, status=out.status)
        if isinstance(out, TextOutput):
            return web.Response(text=out.text, content_type=out.content_type)
        if isinstance(out, (bytes, bytearray)):
            return web.Response(body=bytes(out), content_type="application/octet-stream")
        try:
            return web.json_response(out)
        except (TypeError, ValueError) as ex:
            return web.json_response(
                {
                    "detail": "Endpoint returned a non-JSON-serializable response "
                    "({}); return bytes or JSON-compatible types".format(ex),
                    "instance": _instance_id(processor),
                },
                status=500,
            )

    async def _respond(request: web.Request, result) -> web.StreamResponse:
        if isinstance(result, tuple):  # streaming
            resp, out = result
            try:
                try:
                    # prepare inside the guard: a disconnect racing the 200
                    # headers must still close the generator + emit stats
                    await resp.prepare(request)
                    async for chunk in out.generator:
                        if isinstance(chunk, str):
                            chunk = chunk.encode("utf-8")
                        await resp.write(chunk)
                except ConnectionResetError:
                    pass
            finally:
                # deliver GeneratorExit into the engine's SSE body NOW (frees
                # the decode slot on disconnect), then emit deferred stats
                aclose = getattr(out.generator, "aclose", None)
                if aclose is not None:
                    try:
                        await aclose()
                    except Exception:  # the client is gone: nobody receives it
                        pass
                if out.on_complete is not None:
                    out.on_complete()
            try:
                await resp.write_eof()
            except ConnectionResetError:
                pass
            return resp
        return result

    async def serve_model(request: web.Request) -> web.StreamResponse:
        state = app["lifecycle"]
        if state["draining"]:
            # graceful shutdown: stop admitting, let in-flight work finish
            return web.json_response(
                {"detail": "server is draining", "code": "draining"},
                status=503,
                headers={"Retry-After": "5"},
            )
        state["inflight"] += 1
        try:
            return await _serve_model_inner(request)
        finally:
            state["inflight"] -= 1

    async def _serve_model_inner(request: web.Request) -> web.StreamResponse:
        tail = request.match_info["tail"].strip("/")
        try:
            body = await _read_body(request)
        except Exception as ex:
            # malformed multipart/body must follow the 422 JSON error
            # contract, not aiohttp's default 500 page
            return web.json_response(
                {"detail": "unreadable request body: {}".format(ex)}, status=422
            )
        if tail.startswith("openai/"):
            # OpenAI-compatible: serve type is the path, endpoint is body.model
            serve_type = tail[len("openai/"):]
            if serve_type == "version":
                # model-independent (reference show_version): answer without
                # requiring a body/model so plain GET works
                from ..version import __version__

                return web.json_response({"version": __version__})
            if not isinstance(body, dict) or not body.get("model"):
                return web.json_response(
                    {"detail": "OpenAI route requires a JSON body with a 'model' field"},
                    status=422,
                )
            result = await process_with_exceptions(
                base_url=str(body["model"]), version=None, body=body, serve_type=serve_type
            )
            return await _respond(request, result)
        parts = tail.split("/")
        # longest-match: try full tail as endpoint, else endpoint/version split
        version = None
        base_url = tail
        if len(parts) > 1:
            # membership-only check on the live dicts (no per-request copies)
            if tail not in processor._endpoints and tail not in processor._model_monitoring_endpoints:
                base_url, version = "/".join(parts[:-1]), parts[-1]
        result = await process_with_exceptions(
            base_url=base_url, version=version, body=body, serve_type="process"
        )
        return await _respond(request, result)

    async def health(request: web.Request) -> web.Response:
        # liveness: 200 while the process serves anything; /ready below is
        # the routing signal. Fleet endpoints show each replica here too
        payload = {
            "status": "ok",
            "instance": _instance_id(processor),
            "endpoints": sorted(processor.list_endpoints()),
        }
        fleet = _fleet_summary(_fleet_health(processor))
        if fleet:
            payload["fleet"] = fleet
        return web.json_response(payload)

    async def dashboard(request: web.Request) -> web.Response:
        return web.json_response(processor.get_serving_layout())

    async def ready(request: web.Request) -> web.Response:
        """Readiness (distinct from /health liveness): 503 while draining or
        while any loaded engine reports not-ready (stopped / watchdog
        recovery in progress) — so load balancers stop routing here while
        /health keeps the container from being killed."""
        engines = _engine_health(processor)
        # a replica-group endpoint aggregates its own readiness (ready iff
        # >= 1 ring member); the fleet block carries each replica's state
        fleet = _fleet_summary(engines)
        not_ready = sorted(
            url for url, h in engines.items() if not h.get("ready")
        )
        # brownout summary (docs/slo_scheduling.md): a browned-out engine is
        # still READY — it is shedding load by policy, not failing — but
        # operators and load balancers watching /ready should see the stage
        brownout = {
            url: (h.get("brownout") or {}).get("stage", 0)
            for url, h in engines.items()
            if (h.get("brownout") or {}).get("stage")
        }
        draining = app["lifecycle"]["draining"]
        if draining or not_ready:
            return web.json_response(
                {
                    "status": "draining" if draining else "not_ready",
                    "instance": _instance_id(processor),
                    "not_ready": not_ready,
                    "brownout": brownout,
                    "fleet": fleet,
                    "engines": engines,
                },
                status=503,
                headers={"Retry-After": "5"},
            )
        return web.json_response(
            {
                "status": "ready",
                "instance": _instance_id(processor),
                "brownout": brownout,
                "fleet": fleet,
                "engines": engines,
            }
        )

    app.router.add_post("/{}/{{tail:.+}}".format(serve_suffix), serve_model)
    app.router.add_get("/{}/{{tail:openai/.+}}".format(serve_suffix), serve_model)
    app.router.add_get("/health", health)
    app.router.add_get("/ready", ready)
    app.router.add_get("/dashboard", dashboard)
    app.router.add_get("/", health)

    async def _stop_engines(app: web.Application) -> None:
        # the app's shutdown stops what its engines hold on the card
        for proc in list(processor._engine_processor_lookup.values()):
            stop = getattr(getattr(proc, "engine", None), "stop", None)
            if callable(stop):
                stop()

    app.on_cleanup.append(_stop_engines)
    return app


async def drain_app(
    app: web.Application,
    processor: Optional[ModelRequestProcessor],
    timeout: Optional[float] = None,
) -> None:
    """Graceful drain: stop admitting (serve_model starts answering 503 the
    moment ``draining`` flips), wait for in-flight requests up to
    ``timeout`` seconds, then stop the engines and daemons cleanly. Called
    from the SIGTERM handler; exposed separately so tests can drive it."""
    state = app["lifecycle"]
    state["draining"] = True
    if timeout is None:
        timeout = float(os.environ.get("TPUSERVE_DRAIN_TIMEOUT", 30.0))
    deadline = asyncio.get_running_loop().time() + timeout
    while state["inflight"] > 0 and asyncio.get_running_loop().time() < deadline:
        await asyncio.sleep(0.05)
    if processor is not None:
        for proc in list(
            getattr(processor, "_engine_processor_lookup", {}).values()
        ):
            engine = getattr(proc, "engine", None)
            stop = getattr(engine, "stop", None)
            if callable(stop):
                try:
                    stop()
                except Exception:
                    traceback.print_exc()
        try:
            processor.stop()
        except Exception:
            traceback.print_exc()


def install_graceful_drain(app: web.Application) -> None:
    """SIGTERM -> drain -> exit. aiohttp's run_app exits on SIGINT; after
    the drain completes we re-raise SIGINT against ourselves so its normal
    graceful-shutdown path (connection close, cleanup hooks) runs."""

    async def _on_startup(app: web.Application) -> None:
        loop = asyncio.get_running_loop()

        def _begin_drain() -> None:
            state = app["lifecycle"]
            if state["draining"]:
                return  # second SIGTERM: drain already in progress
            # flip synchronously: the guard above must close the window
            # BEFORE the drain task gets scheduled, or back-to-back SIGTERMs
            # would spawn duplicate drains (and duplicate exit SIGINTs)
            state["draining"] = True

            async def _drain_then_exit() -> None:
                await drain_app(app, app.get("processor"))
                os.kill(os.getpid(), signal.SIGINT)

            # held: the loop keeps only weak references to tasks
            state["drain_task"] = loop.create_task(_drain_then_exit())

        try:
            loop.add_signal_handler(signal.SIGTERM, _begin_drain)
        except (NotImplementedError, RuntimeError):
            pass  # non-unix / nested-loop environments keep default handling

    app.on_startup.append(_on_startup)


def setup_processor(device: str = "cuda") -> ModelRequestProcessor:
    """Resolve the control-plane service (env TPUSERVE_SERVICE_ID, or the most
    recent service) and launch the sync/stats daemons
    (reference init.py setup_task + startup_event). The engines are built
    on ``device`` at the launch's prefetch."""
    from ..engines import load_engine_modules

    load_engine_modules()
    service_id = os.environ.get("TPUSERVE_SERVICE_ID") or os.environ.get(
        "CLEARML_SERVING_TASK_ID"
    )
    processor = ModelRequestProcessor(service_id=service_id or None, device=device)
    poll_freq_min = float(os.environ.get("TPUSERVE_POLL_FREQ", 5.0))
    processor.launch(poll_frequency_sec=poll_freq_min * 60.0)
    return processor


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="The port's serving router over the "
                                     "control plane (TPUSERVE_* environment).")
    parser.add_argument("--device", default="cuda",
                        help="where the engines run: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    port = int(os.environ.get("TPUSERVE_PORT", 8080))
    host = os.environ.get("TPUSERVE_HOST", "0.0.0.0")
    num_proc = int(os.environ.get("TPUSERVE_NUM_PROCESS", 1))

    if num_proc > 1:
        # gunicorn-equivalent pre-fork model: N workers share the port via
        # SO_REUSEPORT; each builds its own processor (and CUDA context)
        # post-fork. The engine modules are imported once here, before the
        # fork; nothing in them touches CUDA.
        import multiprocessing

        from ..engines import load_engine_modules

        load_engine_modules()

        def _worker():
            processor = setup_processor(args.device)
            app = build_app(processor)
            install_graceful_drain(app)
            web.run_app(
                app, host=host, port=port, reuse_port=True,
                print=None,
            )

        procs = [multiprocessing.Process(target=_worker) for _ in range(num_proc)]
        for p in procs:
            p.start()

        def _forward_term(signum, frame):
            # pre-fork mode: SIGTERM lands on THIS parent (pid 1 in a
            # container) — forward it so every worker runs its graceful
            # drain instead of dying with the parent
            for p in procs:
                if p.is_alive():
                    p.terminate()

        signal.signal(signal.SIGTERM, _forward_term)
        for p in procs:
            p.join()
    else:
        processor = setup_processor(args.device)
        app = build_app(processor)
        install_graceful_drain(app)
        web.run_app(app, host=host, port=port)


if __name__ == "__main__":
    main()
