"""The port's router, ``build_app(processor)`` of
``clearml_serving_tpu_torch/serving/main.py``, against the reference's: the
scenarios of ``test_router.py`` (the 404, the 422, gzip bodies, SSE, the
OpenAI route and an unsupported serve type, ``/health``, ``/dashboard``,
versioned paths, binary bodies) run on both apps, each over its own
package's processor with the same endpoints, and must give the same statuses
and bodies (instance ids and latencies aside). A service document written by
the reference's CLI with a ``jax`` endpoint deserializes whole on the port:
that endpoint answers 422, naming the engine the port does not serve yet,
and the others are served."""

import asyncio
import gzip
import importlib
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

PACKAGES = {"reference": "clearml_serving_tpu", "port": "clearml_serving_tpu_torch"}

ECHO_CODE = """
class Preprocess:
    def process(self, data, state, collect_fn):
        return {"echo": data}
"""

STREAM_CODE = """
from {pkg}.serving.main import StreamingOutput

class Preprocess:
    def process(self, data, state, collect_fn):
        async def gen():
            for i in range(3):
                yield f"data: chunk{{i}}\\n\\n"
        return StreamingOutput(gen())
"""

OPENAI_CODE = """
class Preprocess:
    def v1_chat_completions(self, data, state, collect_fn):
        return {"choices": [{"message": {"content": "hi from " + data["model"]}}]}
"""


def _mods(pkg):
    mrp = importlib.import_module(pkg + ".serving.model_request_processor")
    return (importlib.import_module(pkg + ".serving.endpoints").ModelEndpoint,
            importlib.import_module(pkg + ".serving.main").build_app,
            mrp.ModelRequestProcessor)


def _served(pkg, root, tmp_path):
    ModelEndpoint, _build_app, Processor = _mods(pkg)
    kwargs = {"device": "cpu"} if pkg.endswith("_torch") else {}
    mrp = Processor(state_root=str(root), force_create=True, name="t", **kwargs)
    for name, code in (("echo", ECHO_CODE), ("stream", STREAM_CODE.format(pkg=pkg)),
                       ("oai", OPENAI_CODE)):
        f = tmp_path / "{}_{}.py".format(pkg, name)
        f.write_text(code)
        mrp.add_endpoint(ModelEndpoint(engine_type="custom", serving_url=name),
                         preprocess_code=str(f))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    return mrp


@pytest.fixture(autouse=True)
def own_cache_dir(tmp_path, monkeypatch):
    """Each test copies user code into an artifact cache of its own: test
    files that run at once must not rename into one shared cache."""
    monkeypatch.setenv("TPUSERVE_CACHE_DIR", str(tmp_path / "cache"))


@pytest.fixture()
def served(state_root, tmp_path):
    """{"reference": processor, "port": processor}, the same endpoints."""
    return {side: _served(pkg, state_root / side, tmp_path)
            for side, pkg in PACKAGES.items()}


def _run(side, mrp, fn):
    build_app = _mods(PACKAGES[side])[1]

    async def runner():
        client = TestClient(TestServer(build_app(mrp)))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(runner())


def _both(served, fn):
    """``fn`` on each app; the two results must be equal."""
    got = {side: _run(side, mrp, fn) for side, mrp in served.items()}
    assert got["port"] == got["reference"]
    return got["port"]


async def _reply(r):
    """(status, body): JSON with the instance id dropped, else text."""
    try:
        body = await r.json()
    except (ValueError, TypeError):
        return r.status, await r.text()
    if isinstance(body, dict):
        body.pop("instance", None)
    return r.status, body


def test_serve_endpoint(served):
    async def fn(client):
        return await _reply(await client.post("/serve/echo", json={"x": 1}))

    assert _both(served, fn) == (200, {"echo": {"x": 1}})


def test_404(served):
    async def fn(client):
        return await _reply(await client.post("/serve/ghost", json={}))

    status, body = _both(served, fn)
    assert status == 404 and "not found" in body["detail"]


def test_422_on_custom_without_process(served, tmp_path):
    f = tmp_path / "empty.py"
    f.write_text("class Preprocess:\n    pass\n")
    for side, mrp in served.items():
        ModelEndpoint = _mods(PACKAGES[side])[0]
        mrp.add_endpoint(ModelEndpoint(engine_type="custom", serving_url="noproc"),
                         preprocess_code=str(f))

    async def fn(client):
        return await _reply(await client.post("/serve/noproc", json={}))

    status, body = _both(served, fn)
    assert status == 422 and "requires a Preprocess.process()" in body["detail"]


def test_gzip_request(served):
    async def fn(client):
        payload = gzip.compress(json.dumps({"z": 9}).encode())
        return await _reply(await client.post(
            "/serve/echo", data=payload,
            headers={"Content-Encoding": "gzip", "Content-Type": "application/json"}))

    assert _both(served, fn) == (200, {"echo": {"z": 9}})


def test_sse_streaming(served):
    async def fn(client):
        r = await client.post("/serve/stream", json={})
        return r.status, r.headers["Content-Type"], await r.text()

    status, ctype, text = _both(served, fn)
    assert status == 200 and ctype.startswith("text/event-stream")
    assert text == "data: chunk0\n\ndata: chunk1\n\ndata: chunk2\n\n"


def test_openai_route(served):
    async def fn(client):
        return await _reply(await client.post(
            "/serve/openai/v1/chat/completions",
            json={"model": "oai", "messages": [{"role": "user", "content": "hello"}]}))

    status, body = _both(served, fn)
    assert status == 200 and body["choices"][0]["message"]["content"] == "hi from oai"


def test_openai_route_requires_model(served):
    async def fn(client):
        return await _reply(await client.post("/serve/openai/v1/chat/completions",
                                              json={"messages": []}))

    assert _both(served, fn)[0] == 422


def test_openai_unsupported_serve_type(served):
    async def fn(client):
        bad = await _reply(await client.post("/serve/openai/v1/embeddings",
                                             json={"model": "oai"}))
        # the allowlist keeps URL-derived names off non-route attributes
        dunder = await _reply(await client.post("/serve/openai/__class__",
                                                json={"model": "oai"}))
        return bad, dunder

    (status, body), (d_status, d_body) = _both(served, fn)
    assert status == 422 and "does not support serve type" in body["detail"]
    assert d_status == 422 and "invalid serve type" in d_body["detail"]


def test_health(served):
    async def fn(client):
        return await _reply(await client.get("/health"))

    status, body = _both(served, fn)
    assert status == 200 and body["status"] == "ok"
    assert body["endpoints"] == ["echo", "oai", "stream"]


def test_dashboard(served):
    async def fn(client):
        await client.post("/serve/echo", json={"t": 1})
        await client.post("/serve/ghost", json={})  # 404: not an engine error
        r = await client.get("/dashboard")
        layout = await r.json()
        tele = {url: (t["requests"], t["errors"], t["mean_latency_ms"] is not None)
                for url, t in layout["telemetry"].items()}
        return r.status, layout["endpoints"], layout["routing"], layout["metrics"], tele

    status, table, routing, metrics, tele = _both(served, fn)
    assert status == 200
    assert any(e["endpoint"] == "echo" and e["loaded"] for e in table)
    assert routing == [] and metrics == {}
    # a 404 (endpoint-not-found) makes no telemetry entry
    assert tele == {"echo": (1, 0, True)}


def test_versioned_endpoint_path(served, tmp_path):
    f = tmp_path / "v.py"
    f.write_text(ECHO_CODE)
    for side, mrp in served.items():
        ModelEndpoint = _mods(PACKAGES[side])[0]
        mrp.add_endpoint(ModelEndpoint(engine_type="custom", serving_url="vmod", version="3"),
                         preprocess_code=str(f))

    async def fn(client):
        return await _reply(await client.post("/serve/vmod/3", json={"ok": True}))

    assert _both(served, fn) == (200, {"echo": {"ok": True}})


def test_binary_body_passthrough(served):
    """The echo preprocess wraps raw bytes in a dict, which is not
    JSON-serializable: the router answers a clean 500 JSON payload, not an
    unhandled exception."""

    async def fn(client):
        return await _reply(await client.post(
            "/serve/echo", data=b"\x89PNG...",
            headers={"Content-Type": "application/octet-stream"}))

    status, body = _both(served, fn)
    assert status == 500 and "non-JSON-serializable" in body["detail"]


def test_reference_document_with_a_jax_endpoint(state_root, tmp_path, capsys):
    """The reference's CLI writes a service with a ``jax`` endpoint beside a
    custom one; the port's processor reads it whole, answers the ``jax``
    endpoint (whose model id the registry lacks) with the reference
    processor's status and detail, and serves the custom endpoint as the
    reference's processor does."""
    from clearml_serving_tpu.__main__ import cli

    code = tmp_path / "echo.py"
    code.write_text(ECHO_CODE)
    assert cli(["create", "--name", "mixed"]) == 0
    svc = capsys.readouterr().out.strip().rsplit("id=", 1)[-1]
    assert cli(["--yes", "--id", svc, "model", "add", "--engine", "jax", "--endpoint", "clf",
                "--model-id", "abc", "--input-size", "[1,4]", "--input-type", "float32"]) == 0
    assert cli(["--yes", "--id", svc, "model", "add", "--engine", "custom",
                "--endpoint", "echo", "--preprocess", str(code)]) == 0
    capsys.readouterr()
    _, build_app, Processor = _mods(PACKAGES["port"])
    mrp = Processor(service_id=svc, state_root=str(state_root), device="cpu")
    assert mrp.deserialize(skip_sync=True)
    assert sorted(mrp.list_endpoints()) == ["clf", "echo"]
    assert mrp.list_endpoints()["clf"].engine_type == "jax"

    async def fn(client):
        clf = await _reply(await client.post("/serve/clf", json=[[1, 2, 3, 4]]))
        echo = await _reply(await client.post("/serve/echo", json={"a": 1}))
        health = await _reply(await client.get("/health"))
        return clf, echo, health

    (status, body), echo, health = _run("port", mrp, fn)
    _, _, RefProcessor = _mods(PACKAGES["reference"])
    ref = RefProcessor(service_id=svc, state_root=str(state_root))
    assert ref.deserialize(skip_sync=True)
    (ref_status, ref_body), ref_echo, _ = _run("reference", ref, fn)
    assert status == ref_status == 422
    assert body["detail"] == ref_body["detail"]
    assert "model 'abc' not found in registry" in body["detail"]
    assert echo == ref_echo == (200, {"echo": {"a": 1}})
    assert health[1]["endpoints"] == ["clf", "echo"]
