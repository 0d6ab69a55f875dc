"""Engine server: gRPC tensor-infer service over the model repo, on torch.

The port's copy of ``clearml_serving_tpu/engine_server/server.py``: the
router's ``jax_grpc`` client (``engines/grpc_client.py``) sends named typed
tensors; this process owns the card, runs each model's bucket graphs
behind its dynamic batcher, polls the control plane for model changes (hot
swap, the old model retired after its last batch) and exports Prometheus
metrics on a sidecar port: request and batch counters, the latency and
queue-delay histograms, and the card's memory gauges
(``statistics/metrics.py::StatisticsController.update_device_gauges``).

Run: ``tpu-serving-torch-engine [--device cuda]`` (or ``python -m
clearml_serving_tpu_torch.engine_server.server``) with
``TPUSERVE_SERVICE_ID`` and optionally ``TPUSERVE_STATE_ROOT``,
``TPUSERVE_ENGINE_PORT`` (8001), ``TPUSERVE_ENGINE_METRICS_PORT`` (8002)
and ``TPUSERVE_POLL_FREQ`` (minutes, 1). It serves on the card unless
``--device cpu`` is given.

``Status`` reports the torch devices (names and count) and, on the card,
this process's ``memory_allocated``/``memory_reserved``, where the
reference reports ``jax.devices()``. The reference's multi-host follower
(``serve_follower``, ``HostZeroDispatcher``) is not ported: ``main``
refuses ``TPUSERVE_COORDINATOR``, the variable that turns it on.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import time
from typing import Optional

import grpc
import numpy as np

from . import protocol
from .repo import EngineModelRepo


class _EngineHandler(grpc.GenericRpcHandler):
    """Generic byte-level handler: no protoc codegen (protocol.py)."""

    def __init__(self, servicer: "EngineServer"):
        self._servicer = servicer

    def service(self, handler_call_details):
        method = handler_call_details.method
        if method == protocol.INFER_METHOD:
            return grpc.unary_unary_rpc_method_handler(
                self._servicer.infer,
                request_deserializer=None,
                response_serializer=None,
            )
        if method == protocol.STATUS_METHOD:
            return grpc.unary_unary_rpc_method_handler(
                self._servicer.status,
                request_deserializer=None,
                response_serializer=None,
            )
        return None


class EngineMetrics:
    """Per-model gRPC-path observability: latency and queue-delay
    histograms, outcome-labelled request counters, and the rows of executed
    batches by kind (real request rows against bucket padding)."""

    def __init__(self, registry=None):
        from prometheus_client import REGISTRY, Counter, Histogram

        registry = registry if registry is not None else REGISTRY
        self.latency = Histogram(
            "engine_infer_latency_seconds",
            "end-to-end gRPC infer latency",
            ["model"],
            buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0),
            registry=registry,
        )
        self.queue_delay = Histogram(
            "engine_queue_delay_seconds",
            "dynamic-batcher queue wait (enqueue to batch start)",
            ["model"],
            buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25),
            registry=registry,
        )
        self.requests = Counter(
            "engine_infer_requests_total",
            "infer RPCs by outcome",
            ["model", "outcome"],
            registry=registry,
        )
        self.batch_rows = Counter(
            "engine_batch_rows_total",
            "rows entering executed batches, by kind (real request rows vs "
            "bucket-padding waste)",
            ["model", "kind"],
            registry=registry,
        )

    def wire_batcher(self, name: str, batcher) -> None:
        if batcher.on_queue_delay is None:
            observe = self.queue_delay.labels(model=name).observe
            batcher.on_queue_delay = observe
        if batcher.on_padding is None:
            real_c = self.batch_rows.labels(model=name, kind="real")
            pad_c = self.batch_rows.labels(model=name, kind="padded")

            def on_padding(real_rows: int, padded_rows: int) -> None:
                if real_rows:
                    real_c.inc(real_rows)
                if padded_rows:
                    pad_c.inc(padded_rows)

            batcher.on_padding = on_padding


def device_status(device) -> dict:
    """The torch devices, and this process's memory on the card."""
    import torch

    if device.type != "cuda":
        return {"devices": ["cpu"], "device_count": 1}
    count = torch.cuda.device_count()
    return {
        "devices": [torch.cuda.get_device_name(i) for i in range(count)],
        "device_count": count,
        "memory_allocated": int(torch.cuda.memory_allocated(device)),
        "memory_reserved": int(torch.cuda.memory_reserved(device)),
    }


class EngineServer:
    def __init__(self, repo: EngineModelRepo, metrics: Optional[EngineMetrics] = None):
        self.repo = repo
        self.metrics = metrics

    def _count(self, model_name: str, outcome: str) -> None:
        if self.metrics is not None:
            self.metrics.requests.labels(model=model_name, outcome=outcome).inc()

    async def infer(self, request_bytes: bytes, context) -> bytes:
        tic = time.monotonic()
        try:
            request = protocol.decode_infer_request(request_bytes)
        except Exception as ex:
            self._count("_undecodable", "bad_request")
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "bad request encoding: {}".format(ex)
            )
        model_name = request["model"]
        model = self.repo.get(model_name, request.get("version") or None)
        if model is None:
            self._count(model_name, "not_found")
            await context.abort(
                grpc.StatusCode.NOT_FOUND,
                "model {!r} version {!r} not loaded (have: {})".format(
                    model_name, request.get("version"), sorted(self.repo.list_models())
                ),
            )
        # metric label = the repo's canonical key, not the client-supplied
        # name: a model reachable under several names must not split its
        # series
        label = model.key
        if self.metrics is not None:
            self.metrics.wire_batcher(label, model.batcher)
        inputs_by_name = request["inputs"]
        # order inputs per the endpoint spec; single-input models accept any name
        if model.input_names:
            try:
                ordered = [inputs_by_name[name] for name in model.input_names]
            except KeyError as ex:
                self._count(label, "bad_request")
                await context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "missing input {} (expected {})".format(ex, model.input_names),
                )
        else:
            ordered = list(inputs_by_name.values())
        try:
            outputs = await model.batcher.infer(ordered)
        except Exception as ex:
            self._count(label, "error")
            await context.abort(
                grpc.StatusCode.INTERNAL, "inference failed: {}".format(ex)
            )
        names = model.output_names
        named = {
            (names[i] if i < len(names) else "output_{}".format(i)): np.asarray(out)
            for i, out in enumerate(outputs)
        }
        self._count(label, "ok")
        if self.metrics is not None:
            self.metrics.latency.labels(model=label).observe(
                time.monotonic() - tic
            )
        return protocol.encode_infer_response(named)

    async def status(self, request_bytes: bytes, context) -> bytes:
        return protocol.encode_obj(
            dict({"models": self.repo.list_models(), "time": time.time()},
                 **device_status(self.repo.device))
        )


def make_server(
    repo: EngineModelRepo, port: int = 0, metrics: Optional[EngineMetrics] = None
) -> "tuple[grpc.aio.Server, int]":
    server = grpc.aio.server(
        options=[
            ("grpc.max_receive_message_length", 256 * 1024 * 1024),
            ("grpc.max_send_message_length", 256 * 1024 * 1024),
        ]
    )
    server.add_generic_rpc_handlers((_EngineHandler(EngineServer(repo, metrics)),))
    bound_port = server.add_insecure_port("[::]:{}".format(port))
    return server, bound_port


async def serve(service_id: Optional[str] = None, device: str = "cuda") -> None:
    from prometheus_client import Gauge, start_http_server

    from ..serving.model_request_processor import ModelRequestProcessor
    from ..statistics.metrics import StatisticsController

    processor = ModelRequestProcessor(service_id=service_id, device=device)
    repo = EngineModelRepo(processor, device=device)
    repo.sync()

    port = int(os.environ.get("TPUSERVE_ENGINE_PORT", 8001))
    metrics_port = int(os.environ.get("TPUSERVE_ENGINE_METRICS_PORT", 8002))
    poll_freq_sec = float(os.environ.get("TPUSERVE_POLL_FREQ", 1.0)) * 60.0

    try:
        start_http_server(metrics_port)
        requests_g = Gauge("engine_requests_served", "requests served", ["model"])
        batches_g = Gauge("engine_batches_executed", "batches executed", ["model"])
        metrics = EngineMetrics()
        hbm = StatisticsController("", processor=None)
    except OSError:
        requests_g = batches_g = hbm = metrics = None

    server, bound = make_server(repo, port, metrics)
    await server.start()
    print("engine server: gRPC on :{} ({} models, {})".format(
        bound, len(repo.list_models()), repo.device), flush=True)

    async def reconcile_loop():
        while True:
            await asyncio.sleep(poll_freq_sec)
            try:
                await asyncio.to_thread(repo.sync)
                if requests_g is not None:
                    for name, info in repo.list_models().items():
                        requests_g.labels(model=name).set(info["requests_served"])
                        batches_g.labels(model=name).set(info["batches_executed"])
                    hbm.update_device_gauges()
            except Exception as ex:
                print("engine server reconcile error: {}".format(ex), flush=True)

    # held: the loop keeps only weak references to tasks
    reconcile = asyncio.get_running_loop().create_task(reconcile_loop())
    try:
        await server.wait_for_termination()
    finally:
        reconcile.cancel()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="The port's engine server (jax_grpc "
                                                 "endpoints over gRPC).")
    parser.add_argument("--device", default="cuda",
                        help="where the models run: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if os.environ.get("TPUSERVE_COORDINATOR"):
        raise SystemExit(
            "TPUSERVE_COORDINATOR is set, but the multi-host engine server "
            "(serve_follower, HostZeroDispatcher) is not ported to PyTorch yet"
        )
    service_id = os.environ.get("TPUSERVE_SERVICE_ID") or None
    asyncio.run(serve(service_id, device=args.device))


if __name__ == "__main__":
    main()
