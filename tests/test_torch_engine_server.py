"""The engine server of the ``jax_grpc`` topology: every scenario of the
reference's ``tests/test_engine_server.py`` run on ``clearml_serving_tpu``
(the reference) and ``clearml_serving_tpu_torch`` (the port) side by side,
plus the wire between them and the client's retry policy.

- The protocol's bytes are the reference's (and ``msgpack.packb``'s) for the
  same requests and responses; each package decodes the other's.
- The dynamic batcher coalesces concurrent requests, counts its padding and
  propagates errors alike in both packages; the port's runs each batch on
  the thread it is given.
- An in-process server per package over one control-plane state root and
  one MLP bundle the reference's ``save_bundle`` wrote: the port's client
  against the port's server, the reference's client against the port's
  server and the port's client against the reference's, all within 1e-5 of
  the reference's ``apply``; hot swap and removal (the old model retired:
  its graphs and weights released), versioned endpoints, the metrics'
  histograms and counters.
- The retry policy through the ``grpc.call`` fault seam: UNAVAILABLE
  retries then answers 503, DEADLINE_EXCEEDED 504, NOT_FOUND 422, with
  ``RETRY_STATS``; and a real server that stops answering.
"""

import asyncio
import dataclasses
import importlib
import threading
from types import SimpleNamespace

import jax
import msgpack
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu import models as jax_models
from clearml_serving_tpu.engines.jax_engine import save_bundle as jax_save_bundle

PACKAGES = ["clearml_serving_tpu", "clearml_serving_tpu_torch"]
IDS = ["reference", "port"]
MLP = {"in_dim": 4, "hidden": [8], "out_dim": 3}
TOL = 1e-5


def _package(name):
    return SimpleNamespace(
        name=name,
        port=name.endswith("_torch"),
        protocol=importlib.import_module(name + ".engine_server.protocol"),
        batcher=importlib.import_module(name + ".engine_server.batcher"),
        repo=importlib.import_module(name + ".engine_server.repo"),
        server=importlib.import_module(name + ".engine_server.server"),
        engines=importlib.import_module(name + ".engines"),
        base=importlib.import_module(name + ".engines.base"),
        grpc_client=importlib.import_module(name + ".engines.grpc_client"),
        ep=importlib.import_module(name + ".serving.endpoints"),
        mrp=importlib.import_module(name + ".serving.model_request_processor"),
        main=importlib.import_module(name + ".serving.main"),
        errors=importlib.import_module(name + ".errors"),
        faults=importlib.import_module(name + ".llm.faults"),
    )


REF, PORT = (_package(name) for name in PACKAGES)


@pytest.fixture(params=PACKAGES, ids=IDS)
def pk(request):
    return _package(request.param)


@pytest.fixture(autouse=True)
def own_cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TPUSERVE_CACHE_DIR", str(tmp_path / "cache"))


def _processor(pk, **kwargs):
    if pk.port:
        kwargs.setdefault("device", "cpu")
    return pk.mrp.ModelRequestProcessor(**kwargs)


def _repo(pk, processor):
    return pk.repo.EngineModelRepo(processor, device="cpu") if pk.port else \
        pk.repo.EngineModelRepo(processor)


# -- protocol -------------------------------------------------------------------

REQUESTS = [
    ("m", {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
           "b": np.array([[1, 2]], dtype=np.int64)}, "2", ["y"]),
    ("grpc_mlp", {"features": np.linspace(-1, 1, 8, dtype=np.float32).reshape(2, 4)},
     None, None),
    ("bert/3", {"input_ids": np.arange(256, dtype=np.int32).reshape(2, 128),
                "attention_mask": np.ones((2, 128), np.int32)}, "", ["logits"]),
    ("empty", {"x": np.zeros((0, 5), np.float64)}, "v1", []),
]
RESPONSES = [
    {"y": np.ones((2, 1), np.float32)},
    {"logits": np.linspace(0, 1, 2 * 128 * 9, dtype=np.float32).reshape(2, 128, 9),
     "ids": np.arange(3, dtype=np.int64)},
    {},
]


def test_protocol_roundtrip(pk):
    inputs = {
        "a": np.arange(6, dtype=np.float32).reshape(2, 3),
        "b": np.array([[1, 2]], dtype=np.int64),
    }
    data = pk.protocol.encode_infer_request("m", inputs, version="2", output_names=["y"])
    req = pk.protocol.decode_infer_request(data)
    assert req["model"] == "m" and req["version"] == "2" and req["outputs"] == ["y"]
    np.testing.assert_array_equal(req["inputs"]["a"], inputs["a"])
    assert req["inputs"]["b"].dtype == np.int64

    resp = pk.protocol.decode_infer_response(
        pk.protocol.encode_infer_response({"y": np.ones((2, 1), np.float32)})
    )
    assert resp["y"].shape == (2, 1)


@pytest.mark.parametrize("case", range(len(REQUESTS)))
def test_request_bytes_are_the_reference_wire(case):
    model, inputs, version, outputs = REQUESTS[case]
    want = REF.protocol.encode_infer_request(model, inputs, version=version,
                                             output_names=outputs)
    got = PORT.protocol.encode_infer_request(model, inputs, version=version,
                                             output_names=outputs)
    assert got == want
    assert got == msgpack.packb({
        "model": model, "version": version or "",
        "inputs": [{"name": k, "dtype": v.dtype.str, "shape": list(v.shape),
                    "data": np.ascontiguousarray(v).tobytes()} for k, v in inputs.items()],
        "outputs": list(outputs or [])}, use_bin_type=True)
    for decode in (REF.protocol.decode_infer_request, PORT.protocol.decode_infer_request):
        req = decode(got)
        assert req["model"] == model and req["version"] == (version or "")
        for k, v in inputs.items():
            assert req["inputs"][k].dtype == v.dtype
            np.testing.assert_array_equal(req["inputs"][k], v)


@pytest.mark.parametrize("case", range(len(RESPONSES)))
def test_response_and_status_bytes_are_the_reference_wire(case):
    outputs = RESPONSES[case]
    got = PORT.protocol.encode_infer_response(outputs)
    assert got == REF.protocol.encode_infer_response(outputs)
    back = REF.protocol.decode_infer_response(got)
    assert sorted(back) == sorted(outputs)
    for k, v in outputs.items():
        np.testing.assert_array_equal(back[k], v)
    status = {"models": {"m": {"buckets": [1, 2], "requests_served": 3}},
              "devices": ["cpu"], "time": 1.5 * case}
    assert PORT.protocol.encode_obj(status) == REF.protocol.encode_obj(status)
    assert PORT.protocol.decode_obj(REF.protocol.encode_obj(status)) == status


# -- batcher --------------------------------------------------------------------

def test_dynamic_batcher_batches_concurrent_requests(pk):
    calls = []

    def run_batch(concat):
        calls.append(int(concat[0].shape[0]))
        return [concat[0] * 2]

    async def run():
        batcher = pk.batcher.DynamicBatcher(run_batch, preferred_batch_size=4,
                                            max_queue_delay_us=50_000)
        outs = await asyncio.gather(
            *[batcher.infer([np.full((1, 2), i, np.float32)]) for i in range(4)]
        )
        return outs, batcher

    outs, batcher = asyncio.run(run())
    assert [o[0].tolist() for o in outs] == [[[2 * i, 2 * i]] for i in range(4)]
    # the four concurrent single-row requests coalesce (not 4x batch=1)
    assert batcher.batches_executed < 4
    assert batcher.requests_served == 4
    assert sum(calls) == 4


def test_dynamic_batcher_padding_observability(pk):
    """The bucket padding's waste is counted: padded_rows_sum and the
    on_padding hook report bucket - real rows per executed batch."""
    buckets = [4, 8]
    seen = []

    async def run():
        batcher = pk.batcher.DynamicBatcher(
            lambda concat: [concat[0]], preferred_batch_size=4, max_queue_delay_us=1000,
            bucket_for=lambda rows: next((b for b in buckets if rows <= b), rows),
        )
        batcher.on_padding = lambda real, pad: seen.append((real, pad))
        await asyncio.gather(
            *[batcher.infer([np.zeros((1, 2), np.float32)]) for _ in range(3)]
        )
        return batcher

    batcher = asyncio.run(run())
    assert batcher.batch_size_sum == 3
    assert batcher.padded_rows_sum == sum(p for _, p in seen)
    assert sum(r for r, _ in seen) == 3
    assert batcher.padded_rows_sum >= 1


def test_dynamic_batcher_row_cap_carries_to_the_next_batch(pk):
    """A request that would pass max_batch_size waits for the next batch;
    one larger than the cap is refused."""
    calls = []

    def run_batch(concat):
        calls.append(int(concat[0].shape[0]))
        return [concat[0] + 1]

    async def run():
        batcher = pk.batcher.DynamicBatcher(run_batch, preferred_batch_size=8,
                                            max_queue_delay_us=50_000, max_batch_size=4)
        outs = await asyncio.gather(*[batcher.infer([np.full((3, 1), i, np.float32)])
                                      for i in range(3)])
        with pytest.raises(ValueError, match="exceeds max_batch_size"):
            await batcher.infer([np.zeros((5, 1), np.float32)])
        return outs

    outs = asyncio.run(run())
    assert calls == [3, 3, 3]
    assert [o[0][:, 0].tolist() for o in outs] == [[i + 1.0] * 3 for i in range(3)]


def test_engine_metrics_padding_counter(pk):
    """EngineMetrics wires the padding hook into the per-model
    engine_batch_rows_total{kind} counter beside the queue-delay series."""
    from prometheus_client import CollectorRegistry

    registry = CollectorRegistry()
    metrics = pk.server.EngineMetrics(registry=registry)

    class _B:
        on_queue_delay = None
        on_padding = None

    b = _B()
    metrics.wire_batcher("m", b)
    b.on_padding(3, 5)
    assert registry.get_sample_value(
        "engine_batch_rows_total", {"model": "m", "kind": "real"}) == 3
    assert registry.get_sample_value(
        "engine_batch_rows_total", {"model": "m", "kind": "padded"}) == 5


def test_dynamic_batcher_error_propagates(pk):
    def run_batch(concat):
        raise RuntimeError("boom")

    async def run():
        batcher = pk.batcher.DynamicBatcher(run_batch, preferred_batch_size=2,
                                            max_queue_delay_us=100)
        with pytest.raises(RuntimeError):
            await batcher.infer([np.zeros((1, 2), np.float32)])
        return batcher

    batcher = asyncio.run(run())
    assert batcher.batches_executed == 0


def test_port_batcher_runs_on_the_given_thread_and_waits_idle():
    from concurrent.futures import ThreadPoolExecutor

    names = []

    def run_batch(concat):
        names.append(threading.current_thread().name)
        return [concat[0]]

    worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="model-step")

    async def run():
        batcher = PORT.batcher.DynamicBatcher(run_batch, preferred_batch_size=2,
                                              max_queue_delay_us=1000, executor=worker)
        assert batcher.idle() and batcher.loop is None
        pending = [asyncio.ensure_future(batcher.infer([np.zeros((1, 1), np.float32)]))
                   for _ in range(5)]
        await asyncio.sleep(0)
        assert not batcher.idle()
        await batcher.wait_idle()
        assert all(p.done() for p in pending)
        return batcher

    batcher = asyncio.run(run())
    worker.shutdown()
    assert batcher.requests_served == 5 and batcher.idle()
    assert set(names) == {n for n in names if n.startswith("model-step")} and names


# -- the served path --------------------------------------------------------------

@pytest.fixture()
def served(state_root, tmp_path):
    """One state root: a jax_grpc endpoint over an MLP bundle the
    reference's save_bundle wrote. Returns (reference processor, params)."""
    mrp = REF.mrp.ModelRequestProcessor(state_root=str(state_root), force_create=True,
                                        name="es")
    bundle = jax_models.build_model("mlp", MLP)
    params = bundle.init(jax.random.PRNGKey(0))
    bdir = tmp_path / "bundle"
    jax_save_bundle(bdir, "mlp", MLP, params)
    rec = mrp.registry.register("mlp", path=bdir, framework="jax")
    mrp.add_endpoint(REF.ep.ModelEndpoint(
        engine_type="jax_grpc", serving_url="grpc_mlp", model_id=rec.id,
        input_name="features", input_type="float32", input_size=[4],
        output_type="float32", output_name="logits"))
    mrp.serialize()
    return mrp, bundle, params


def _apply(bundle, params, x):
    return np.asarray(bundle.apply(params, np.asarray(x, np.float32)))


async def _start(pk, service_id, state_root, metrics=None):
    repo = _repo(pk, _processor(pk, service_id=service_id, state_root=str(state_root)))
    loaded = repo.sync()
    server, port = pk.server.make_server(repo, 0, metrics)
    await server.start()
    return repo, server, port, loaded


def _client_processor(pk, mrp, state_root, port):
    client = _processor(pk, service_id=mrp.get_id(), state_root=str(state_root))
    client.configure(external_engine_grpc_address="127.0.0.1:{}".format(port))
    client.deserialize(skip_sync=True)
    return client


@pytest.mark.parametrize("client_pk,server_pk", [(PORT, PORT), (REF, PORT), (PORT, REF)],
                         ids=["port-port", "reference-client-port-server",
                              "port-client-reference-server"])
def test_engine_server_end_to_end(served, state_root, client_pk, server_pk):
    mrp, bundle, params = served
    rows = [[1, 2, 3, 4], [4, 3, 2, 1]]

    async def run():
        repo, server, port, loaded = await _start(server_pk, mrp.get_id(), state_root)
        try:
            client = _client_processor(client_pk, mrp, state_root, port)
            out = await client.process_request("grpc_mlp", None, {"features": rows})
            one = await client.process_request("grpc_mlp", None, {"features": rows[:1]})
            # an unknown model -> the 422-class EndpointModelError
            proc = client._engine_processor_lookup["grpc_mlp"]
            bad_ep = dataclasses.replace(proc.endpoint, serving_url="ghost")
            bad = client_pk.engines.get_engine_cls("jax_grpc")(
                bad_ep, service=client._service, registry=client.registry)
            with pytest.raises(client_pk.base.EndpointModelError, match="not loaded"):
                await bad.process({"features": [[1, 2, 3, 4]]}, {}, None)
            return loaded, out, one, repo.list_models()
        finally:
            await server.stop(None)

    loaded, out, one, listed = asyncio.run(run())
    assert loaded == 1
    np.testing.assert_allclose(np.asarray(out), _apply(bundle, params, rows), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(np.asarray(one), _apply(bundle, params, rows[:1]), rtol=TOL,
                               atol=TOL)
    info = listed["grpc_mlp"]
    assert info["requests_served"] == 2 and info["rows_executed"] == 3
    assert info["padded_rows"] == 0  # 2 rows run at bucket 2, 1 at bucket 1
    if server_pk.port:
        # the warm-up's run at the smallest bucket, then one run a batch
        assert info["eager_runs"] == info["batches_executed"] + 1
        assert info["graph_captures"] == 0


def test_port_client_through_the_router_app(served, state_root):
    """The port's router (build_app) in front of the port's engine server:
    POST /serve/grpc_mlp answers the reference's rows; the router's process
    never made a model."""
    mrp, bundle, params = served
    rows = [[0.5, -1, 2, 0]] * 3

    async def run():
        repo, server, port, _ = await _start(PORT, mrp.get_id(), state_root)
        try:
            router = _client_processor(PORT, mrp, state_root, port)
            client = TestClient(TestServer(PORT.main.build_app(router)))
            await client.start_server()
            try:
                r = await client.post("/serve/grpc_mlp", json={"features": rows})
                return r.status, await r.json(), router
            finally:
                await client.close()
        finally:
            await server.stop(None)

    status, body, router = asyncio.run(run())
    assert status == 200, body
    np.testing.assert_allclose(np.asarray(body), _apply(bundle, params, rows), rtol=TOL,
                               atol=TOL)
    proc = router._engine_processor_lookup["grpc_mlp"]
    assert type(proc).__name__ == "JaxGrpcEngineRequest" and proc._model == proc.endpoint.model_id


def test_hot_swap_on_model_change(pk, served, state_root, tmp_path):
    mrp, bundle, params = served
    repo = _repo(pk, _processor(pk, service_id=mrp.get_id(), state_root=str(state_root)))
    assert repo.sync() == 1
    assert repo.sync() == 0  # unchanged -> no reload
    first = repo.get("grpc_mlp")

    # register a new model and repoint the endpoint at it
    params2 = bundle.init(jax.random.PRNGKey(7))
    bdir2 = tmp_path / "bundle2"
    jax_save_bundle(bdir2, "mlp", MLP, params2)
    rec2 = mrp.registry.register("mlp-v2", path=bdir2, framework="jax")
    ep = mrp.list_endpoints()["grpc_mlp"]
    ep.model_id = rec2.id
    mrp.add_endpoint(ep)
    mrp.serialize()

    assert repo.sync() == 1  # hot swap
    x = np.ones((1, 4), np.float32)
    second = repo.get("grpc_mlp")
    out = second.run_batch([x])[0]
    np.testing.assert_allclose(out, _apply(bundle, params2, x), rtol=TOL, atol=TOL)
    if pk.port:
        # the swapped-out model never served: released at once
        assert first.released.is_set() and first.runner is None and first.params is None
        with pytest.raises(RuntimeError, match="retired"):
            first.run_batch([x])

    # removing the endpoint drops the model
    mrp.remove_endpoint("grpc_mlp")
    mrp.serialize()
    repo.sync()
    assert repo.get("grpc_mlp") is None
    if pk.port:
        assert second.released.is_set()


def test_port_hot_swap_under_traffic_retires_after_the_last_batch(served, state_root,
                                                                  tmp_path):
    """Requests queued on the old model finish on it; its release waits for
    its batcher to go idle, then runs on the model's own thread."""
    mrp, bundle, params = served
    params2 = bundle.init(jax.random.PRNGKey(7))
    bdir2 = tmp_path / "bundle2"
    jax_save_bundle(bdir2, "mlp", MLP, params2)
    rec2 = mrp.registry.register("mlp-v2", path=bdir2, framework="jax")
    x = np.full((1, 4), 0.25, np.float32)

    async def run():
        repo = _repo(PORT, _processor(PORT, service_id=mrp.get_id(),
                                      state_root=str(state_root)))
        repo.sync()
        old = repo.get("grpc_mlp")
        gate = threading.Event()
        run_batch = old.run_batch

        def slow(concat):
            gate.wait(5)
            return run_batch(concat)

        old.batcher._run_batch = slow
        inflight = [asyncio.ensure_future(old.batcher.infer([x])) for _ in range(3)]
        await asyncio.sleep(0.05)
        ep = mrp.list_endpoints()["grpc_mlp"]
        ep.model_id = rec2.id
        mrp.add_endpoint(ep)
        mrp.serialize()
        assert await asyncio.to_thread(repo.sync) == 1
        assert not old.released.is_set() and old.runner is not None
        new = await repo.get("grpc_mlp").batcher.infer([x])
        gate.set()
        outs = await asyncio.gather(*inflight)
        for _ in range(200):
            if old.released.is_set():
                break
            await asyncio.sleep(0.01)
        return outs, new, old

    outs, new, old = asyncio.run(run())
    for out in outs:
        np.testing.assert_allclose(out[0], _apply(bundle, params, x), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(new[0], _apply(bundle, params2, x), rtol=TOL, atol=TOL)
    assert old.released.is_set() and old.runner is None


def test_engine_metrics_histograms(pk, served, state_root):
    """The gRPC path exports latency and queue-delay histograms and
    outcome-labelled counters, not gauges only."""
    from prometheus_client import CollectorRegistry

    mrp, bundle, params = served
    registry = CollectorRegistry()
    metrics = pk.server.EngineMetrics(registry=registry)

    async def run():
        repo, server, port, _ = await _start(pk, mrp.get_id(), state_root, metrics)
        try:
            client = _client_processor(pk, mrp, state_root, port)
            for _ in range(3):
                await client.process_request("grpc_mlp", None, {"features": [[1, 2, 3, 4]]})
        finally:
            await server.stop(None)

    asyncio.run(run())
    assert registry.get_sample_value(
        "engine_infer_requests_total", {"model": "grpc_mlp", "outcome": "ok"}) == 3.0
    assert registry.get_sample_value(
        "engine_infer_latency_seconds_count", {"model": "grpc_mlp"}) == 3.0
    assert registry.get_sample_value(
        "engine_queue_delay_seconds_count", {"model": "grpc_mlp"}) == 3.0
    assert registry.get_sample_value(
        "engine_batch_rows_total", {"model": "grpc_mlp", "kind": "real"}) == 3.0


def test_versioned_endpoint_through_jax_grpc(pk, state_root, tmp_path):
    """The client sends ``version``; the repo keys ``url/version``: two
    versions of one endpoint serve their own weights."""
    mrp = REF.mrp.ModelRequestProcessor(state_root=str(state_root), force_create=True,
                                        name="ver")
    bundle = jax_models.build_model("mlp", MLP)
    trees = {}
    for v, seed in (("1", 3), ("2", 4)):
        trees[v] = bundle.init(jax.random.PRNGKey(seed))
        jax_save_bundle(tmp_path / ("b" + v), "mlp", MLP, trees[v])
        rec = mrp.registry.register("mlp-" + v, path=tmp_path / ("b" + v), framework="jax")
        mrp.add_endpoint(REF.ep.ModelEndpoint(
            engine_type="jax_grpc", serving_url="vmlp", version=v, model_id=rec.id,
            input_name="features", input_type="float32", input_size=[4],
            output_type="float32", output_name="logits"))
    mrp.serialize()
    x = [[1.0, 0.0, -1.0, 2.0]]

    async def run():
        repo, server, port, loaded = await _start(PORT, mrp.get_id(), state_root)
        try:
            client = _client_processor(pk, mrp, state_root, port)
            outs = {v: await client.process_request("vmlp", v, {"features": x})
                    for v in ("1", "2")}
            return loaded, sorted(repo.list_models()), outs
        finally:
            await server.stop(None)

    loaded, keys, outs = asyncio.run(run())
    assert loaded == 2 and keys == ["vmlp/1", "vmlp/2"]
    for v in ("1", "2"):
        np.testing.assert_allclose(np.asarray(outs[v]), _apply(bundle, trees[v], x),
                                   rtol=TOL, atol=TOL)


def test_port_status_reports_the_torch_devices(served, state_root):
    mrp, _bundle, _params = served

    async def run():
        import grpc

        repo, server, port, _ = await _start(PORT, mrp.get_id(), state_root)
        try:
            async with grpc.aio.insecure_channel("127.0.0.1:{}".format(port)) as channel:
                call = channel.unary_unary(PORT.protocol.STATUS_METHOD)
                return PORT.protocol.decode_obj(await call(b""))
        finally:
            await server.stop(None)

    status = asyncio.run(run())
    assert status["devices"] == ["cpu"] and status["device_count"] == 1
    assert status["models"]["grpc_mlp"]["buckets"] == [1, 2, 4, 8, 16, 32, 64]
    assert "memory_allocated" not in status and isinstance(status["time"], float)


def test_port_models_run_on_their_leased_thread(served, state_root):
    """Each model's batches (and its warm-up) run on its own step thread
    from ``device.lease_step_worker``, returned to the pool at retirement."""
    from clearml_serving_tpu_torch import device

    mrp, _bundle, _params = served
    repo = _repo(PORT, _processor(PORT, service_id=mrp.get_id(), state_root=str(state_root)))
    repo.sync()
    model = repo.get("grpc_mlp")
    names = []
    run_batch = model.run_batch

    def spy(concat):
        names.append(threading.current_thread().name)
        return run_batch(concat)

    model.batcher._run_batch = spy

    async def run():
        return await asyncio.gather(*[model.batcher.infer([np.ones((1, 4), np.float32)])
                                      for _ in range(4)])

    asyncio.run(run())
    worker = model._worker
    assert names and all(n.startswith("step") for n in names)
    assert len({n for n in names}) == 1
    model.retire()  # its batcher is idle: released on the loop's next turn
    assert model.released.wait(5)
    assert worker in device._FREE_STEP_WORKERS[None]


def test_port_main_refuses_the_multi_host_coordinator(monkeypatch):
    monkeypatch.setenv("TPUSERVE_COORDINATOR", "10.0.0.1:1234")
    with pytest.raises(SystemExit, match="multi-host engine server"):
        PORT.server.main(["--device", "cpu"])


# -- the retry policy -------------------------------------------------------------

def _grpc_router(pk, state_root):
    mrp = _processor(pk, state_root=str(state_root), force_create=True, name="retry")
    payload = state_root.parent / "remote-model.bin"
    payload.write_bytes(b"the model lives in the engine server")
    rec = mrp.registry.register("m", path=payload, framework="jax")
    mrp.add_endpoint(pk.ep.ModelEndpoint(
        engine_type="jax_grpc", serving_url="remote", model_id=rec.id, input_name="x",
        input_type="float32", input_size=[4], output_name="y", output_type="float32"))
    mrp.serialize()
    # nothing listens there: only the fault seam answers
    mrp.configure(external_engine_grpc_address="127.0.0.1:9")
    mrp.deserialize(skip_sync=True)
    return mrp


async def _post(app, body):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/serve/remote", json=body)
        return r.status, await r.json()
    finally:
        await client.close()


@pytest.mark.parametrize("code,status,exhausted", [
    ("UNAVAILABLE", 503, 1), ("DEADLINE_EXCEEDED", 504, 1), ("NOT_FOUND", 422, 0)])
def test_retry_policy_through_the_fault_seam(pk, state_root, monkeypatch, code, status,
                                             exhausted):
    """Each attempt fires ``grpc.call``: transient codes retry up to the
    attempt ceiling (3), then answer 503 / 504 with the code's name;
    NOT_FOUND answers 422 at once. RETRY_STATS counts it all."""
    monkeypatch.setenv("TPUSERVE_GRPC_RETRY_BACKOFF", "0.001")
    mrp = _grpc_router(pk, state_root)
    stats = pk.grpc_client.RETRY_STATS
    before = dict(stats)
    pk.faults.configure([{"point": "grpc.call", "grpc_code": code}])
    try:
        got, body = asyncio.run(_post(pk.main.build_app(mrp), {"x": [[1, 2, 3, 4]]}))
    finally:
        pk.faults.clear()
    attempts = 3 if exhausted else 1
    assert got == status, body
    assert {k: stats[k] - before[k] for k in stats} == {
        "attempts": attempts, "retries": attempts - 1, "exhausted": exhausted}
    if exhausted:
        assert body["code"] == ("upstream_timeout" if status == 504 else "upstream_unavailable")
        assert "engine upstream {} after 3 attempt(s)".format(code) in body["detail"]
    assert pk.grpc_client.grpc_lifecycle_stats() == {"grpc": dict(stats)}


def test_retry_then_success_and_budget(pk, state_root, monkeypatch):
    """Two transient failures then the server answers: one logical call, two
    retries, nothing exhausted. A budget shorter than the first backoff
    gives up after one attempt."""
    monkeypatch.setenv("TPUSERVE_GRPC_RETRY_BACKOFF", "0.001")
    mrp = _grpc_router(pk, state_root)
    proc = mrp._get_processor("remote")
    stats = pk.grpc_client.RETRY_STATS

    async def answer(payload, timeout):
        return pk.protocol.encode_infer_response({"y": np.full((1, 2), 7.0, np.float32)})

    before = dict(stats)
    pk.faults.configure([{"point": "grpc.call", "grpc_code": "UNAVAILABLE", "times": 2}])
    try:
        out = asyncio.run(proc._call_with_retry(answer, b"", timeout=1.0))
    finally:
        pk.faults.clear()
    assert pk.protocol.decode_infer_response(out)["y"].tolist() == [[7.0, 7.0]]
    assert {k: stats[k] - before[k] for k in stats} == {
        "attempts": 3, "retries": 2, "exhausted": 0}

    monkeypatch.setenv("TPUSERVE_GRPC_RETRY_BACKOFF", "5")
    monkeypatch.setenv("TPUSERVE_GRPC_RETRY_BUDGET", "1")
    before = dict(stats)
    pk.faults.configure([{"point": "grpc.call", "grpc_code": "UNAVAILABLE"}])
    try:
        with pytest.raises(pk.errors.UpstreamUnavailableError, match="after 1 attempt"):
            asyncio.run(proc._call_with_retry(answer, b"", timeout=1.0))
    finally:
        pk.faults.clear()
    assert {k: stats[k] - before[k] for k in stats} == {
        "attempts": 1, "retries": 0, "exhausted": 1}


def test_a_stopped_server_answers_503_after_the_retries(pk, served, state_root,
                                                        monkeypatch):
    """A real upstream that went away: UNAVAILABLE on every attempt, 503."""
    monkeypatch.setenv("TPUSERVE_GRPC_RETRY_BACKOFF", "0.001")
    mrp, _bundle, _params = served

    async def run():
        repo, server, port, _ = await _start(PORT, mrp.get_id(), state_root)
        router = _client_processor(pk, mrp, state_root, port)
        ok = await _post_url(pk.main.build_app(router), "grpc_mlp")
        await server.stop(None)
        gone = await _post_url(pk.main.build_app(router), "grpc_mlp")
        return ok, gone

    ok, gone = asyncio.run(run())
    assert ok[0] == 200
    assert gone[0] == 503 and gone[1]["code"] == "upstream_unavailable", gone


async def _post_url(app, url):
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        r = await client.post("/serve/" + url, json={"features": [[1, 2, 3, 4]]})
        return r.status, await r.json()
    finally:
        await client.close()


def test_retry_counters_are_exported(pk, state_root, monkeypatch):
    """The client registers RETRY_STATS with the lifecycle collector: the
    serving registry exports grpc_client_upstream_total{kind} as they
    stand."""
    from prometheus_client import REGISTRY

    monkeypatch.setenv("TPUSERVE_GRPC_RETRY_BACKOFF", "0.001")
    mrp = _grpc_router(pk, state_root)
    pk.faults.configure([{"point": "grpc.call", "grpc_code": "UNAVAILABLE"}])
    try:
        got, _body = asyncio.run(_post(pk.main.build_app(mrp), {"x": [[1, 2, 3, 4]]}))
    finally:
        pk.faults.clear()
    assert got == 503
    # this package's collector (both packages' collectors sit on the one
    # process registry here)
    metrics = importlib.import_module(pk.name + ".statistics.metrics")
    collector = metrics._lifecycle_collectors[REGISTRY]["engine"]
    samples = {(s.name, s.labels.get("kind")): s.value for fam in collector.collect()
               for s in fam.samples if s.labels.get("model") == "grpc_client"}
    assert samples == {("grpc_client_upstream_total", kind): value
                       for kind, value in pk.grpc_client.RETRY_STATS.items()}
