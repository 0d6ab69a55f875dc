"""An ``llm`` endpoint behind each package's processor and router, on
llama-tiny in float32.

- The reference's endpoint is built by its processor; its weights are
  carried (``convert_params``) into the port's endpoint
  (``LLMEngineRequest.wrap`` in a port processor). Greedy content is
  byte-identical on ``/serve/openai/v1/chat/completions`` (streaming and
  not), ``/serve/openai/v1/completions`` (streaming and not) and
  ``/serve/<endpoint>``, under ``two_dispatch`` and ``ragged`` and on int4
  weights; the stats packets through a ``file://`` broker at frequency 1
  carry the same keys and token counts.
- The aux ``chat`` block's ``response_role`` answers on both.
- The port's own path (the endpoint's aux block on the processor's device,
  built at ``launch()`` before any event loop runs) serves what a directly
  built engine serves.
- Eviction: the reference keeps an evicted engine alive and running (its
  watchdog task holds it); the port stops its engine once the in-flight
  stream ends, and the engine is freed.
- A fresh interpreter that imports the engine modules, writes a service
  and builds the app never touches CUDA (the pre-fork contract).
"""

import asyncio
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu.serving.endpoints import ModelEndpoint as JaxEndpoint
from clearml_serving_tpu.serving.main import build_app as jax_build_app
from clearml_serving_tpu.serving.model_request_processor import (
    ModelRequestProcessor as JaxProcessor,
)
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.models.llama import convert_params
from clearml_serving_tpu_torch.serving.endpoints import ModelEndpoint
from clearml_serving_tpu_torch.serving.main import build_app
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor
from clearml_serving_tpu_torch.statistics.broker import make_consumer
from torch_serving import port_processor

ROOT = Path(__file__).resolve().parents[1]
ENGINE_CFG = {
    "preset": "llama-tiny", "config": {"dtype": "float32"}, "max_batch": 2,
    "max_seq_len": 128, "prefill_buckets": [32, 64], "cache": "paged",
    "pipeline_depth": 1, "scheduler": "two_dispatch", "seed": 0,
}
ARMS = {
    "two_dispatch": {},
    "ragged": {"scheduler": "ragged", "step_token_budget": 12, "ragged_decode_steps": 2},
    "int4": {"weight_quant": "int4"},
}
URL = "chat"
CHAT = "/serve/openai/v1/chat/completions"
CMPL = "/serve/openai/v1/completions"
MESSAGES = [{"role": "user", "content": "name three colours of the sea"}]
# (path, body) of one run: every route the slice serves
CALLS = [
    (CHAT, {"model": URL, "messages": MESSAGES, "max_tokens": 12}),
    (CHAT, {"model": URL, "messages": MESSAGES, "max_tokens": 12, "stream": True}),
    (CHAT, {"model": URL, "max_tokens": 10, "messages": [
        {"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}]}),
    (CMPL, {"model": URL, "prompt": "The sea is", "max_tokens": 10}),
    (CMPL, {"model": URL, "prompt": "The sea is", "max_tokens": 10, "stream": True}),
    ("/serve/" + URL, {"messages": MESSAGES, "max_tokens": 12}),
]
STAT_FIELDS = ("_url", "_count", "gen_tokens", "prompt_tokens")


def _text(path, out):
    """(content, finish reason, usage) of a reply, streamed or not."""
    choice = out["choices"][0]
    text = choice["message"]["content"] if "message" in choice else choice["text"]
    return text, choice["finish_reason"], out.get("usage")


async def _call(client, path, body):
    r = await client.post(path, json=body)
    assert r.status == 200, await r.text()
    if not body.get("stream"):
        return _text(path, await r.json())
    pieces, finish = [], None
    async for raw in r.content:
        line = raw.decode().strip()
        if not line.startswith("data: ") or line == "data: [DONE]":
            continue
        chunk = json.loads(line[len("data: "):])
        assert "error" not in chunk, chunk
        choice = chunk["choices"][0]
        pieces.append(choice["delta"].get("content", "") if "delta" in choice
                      else choice["text"])
        finish = choice["finish_reason"] or finish
    return "".join(pieces), finish, None


def _serve(app, fn):
    async def runner():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await fn(client)
        finally:
            await client.close()

    return asyncio.run(runner())


async def _all_calls(client):
    return [await _call(client, path, body) for path, body in CALLS]


def _with_broker(mrp, broker):
    """Every request sampled into the stats queue, the broker configured."""
    mrp.configure(external_stats_broker="file://{}".format(broker),
                  default_metric_log_freq=1.0)
    mrp._last_update_hash = None
    mrp.deserialize(skip_sync=True)


def _packets(mrp):
    """The sampled packets, sent through the processor's broker producer
    and read back by a consumer."""
    producer = mrp._get_stats_producer()
    producer.send_batch(mrp._stats_queue.get_all(timeout=0.1))
    return make_consumer(mrp._stats_broker_url).poll()


@pytest.fixture()
def jax_mrp(tmp_path):
    old = os.environ.get("TPUSERVE_STATE_ROOT")
    os.environ["TPUSERVE_STATE_ROOT"] = str(tmp_path / "ref")
    try:
        yield lambda aux: _jax_endpoint(tmp_path / "ref", aux)
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old


def _jax_endpoint(root, aux):
    mrp = JaxProcessor(state_root=str(root), force_create=True, name="ref")
    mrp.add_endpoint(JaxEndpoint(engine_type="llm", serving_url=URL,
                                 auxiliary_cfg={"engine": aux}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    return mrp


@pytest.mark.parametrize("arm", list(ARMS))
def test_routes_byte_identical_to_the_reference_processor(arm, jax_mrp, tmp_path):
    aux = dict(ENGINE_CFG, **ARMS[arm])
    ref = jax_mrp(aux)
    _with_broker(ref, tmp_path / "ref_broker")
    want = _serve(jax_build_app(ref), _all_calls)
    want_packets = _packets(ref)
    params = jax.tree.map(np.asarray, ref._engine_processor_lookup[URL].engine.params)

    engine, tok = build_engine(aux, device="cpu", params=convert_params(params, device="cpu"))
    port = port_processor(engine, tok, URL, state_root=tmp_path / "port", **aux)
    _with_broker(port, tmp_path / "port_broker")
    got = _serve(build_app(port), _all_calls)
    assert got == want
    assert any(text for text, _f, _u in got)
    # streamed content equals the non-streamed content, and the plain POST
    # is the non-streaming chat
    assert got[1][0] == got[0][0] and got[4][0] == got[3][0] and got[5] == got[0]

    got_packets = _packets(port)
    assert len(got_packets) == len(want_packets) == len(CALLS)
    for g, w in zip(got_packets, want_packets):
        assert sorted(g) == sorted(w)
        assert {k: g[k] for k in STAT_FIELDS} == {k: w[k] for k in STAT_FIELDS}
        assert g["ttft"] >= 0.0
    assert [p["_url"] for p in got_packets] == [URL] * len(CALLS)


def test_response_role_from_the_aux_chat_block(jax_mrp, tmp_path):
    """Aux ``engine.chat.response_role`` names the reply's role on both
    packages, streamed and not; a body's ``response_role`` overrides it."""
    aux = dict(ENGINE_CFG, chat={"response_role": "bot"})
    bodies = [dict(CALLS[0][1], max_tokens=2),
              dict(CALLS[0][1], max_tokens=2, stream=True),
              dict(CALLS[0][1], max_tokens=2, response_role="narrator")]

    async def roles(client):
        out = []
        for body in bodies:
            r = await client.post(CHAT, json=body)
            assert r.status == 200
            if not body.get("stream"):
                out.append((await r.json())["choices"][0]["message"]["role"])
                continue
            for raw in (await r.text()).splitlines():
                if raw.startswith("data: {"):
                    delta = json.loads(raw[6:])["choices"][0]["delta"]
                    if "role" in delta:
                        out.append(delta["role"])
        return out

    ref = jax_mrp(aux)
    want = _serve(jax_build_app(ref), roles)
    params = jax.tree.map(np.asarray, ref._engine_processor_lookup[URL].engine.params)
    engine, tok = build_engine(ENGINE_CFG, device="cpu",
                               params=convert_params(params, device="cpu"))
    got = _serve(build_app(port_processor(engine, tok, URL, state_root=tmp_path / "port",
                                          **aux)), roles)
    assert got == want == ["bot", "bot", "narrator"]


def test_port_processor_builds_the_endpoint_at_launch_on_its_device(tmp_path, monkeypatch):
    """The port's path: the CLI writes the endpoint, ``setup_processor``
    (the inference server's) builds its engine from the aux block on the
    CPU at ``launch()``, before an event loop runs, and the engine serves
    from the app's loop what a directly built engine serves."""
    from clearml_serving_tpu_torch.__main__ import cli
    from clearml_serving_tpu_torch.serving.main import setup_processor

    monkeypatch.setenv("TPUSERVE_STATE_ROOT", str(tmp_path / "state"))
    monkeypatch.setenv("TPUSERVE_POLL_FREQ", "60")
    aux = ["engine.{}={}".format(k, json.dumps(v)) for k, v in ENGINE_CFG.items()]
    assert cli(["create", "--name", "served"]) == 0
    assert cli(["--yes", "model", "add", "--engine", "llm", "--endpoint", URL,
                "--aux-config"] + aux) == 0
    processor = setup_processor(device="cpu")
    try:
        proc = processor._engine_processor_lookup[URL]
        assert proc.engine is not None and proc.engine._loop_task is None
        assert str(proc.engine.model.device) == "cpu"
        got = _serve(build_app(processor), _all_calls)
    finally:
        processor.stop()
    engine, tok = build_engine(ENGINE_CFG, device="cpu")
    want = _serve(build_app(port_processor(engine, tok, URL, state_root=tmp_path / "direct")),
                  _all_calls)
    assert got == want and any(text for text, _f, _u in got)


async def _evict_during_stream(mrp, build, port: bool):
    """Serve one chat, start a stream, remove the endpoint and run the
    sync daemon's pass while it streams. Returns (the stream's content, a
    weakref to the engine, whether it was stopped, the engine's state after
    the stream). The reference's engine is read after ~5 s of collection.
    The port's is read where its release returns (``_release``, under
    ``CAPTURE_LOCK``), with the endpoint's request still held and nothing
    collected here: the release alone must have freed it."""
    client = TestClient(TestServer(build(mrp)))
    await client.start_server()
    try:
        first = await _call(client, *CALLS[0])
        proc = mrp._engine_processor_lookup[URL]
        engine = proc.engine
        ref = weakref.ref(engine)
        stops, released = [], []

        def recording_stop(stop=type(engine).stop):
            # holds the engine weakly: the test must not keep it alive
            stops.append(True)
            stop(ref())

        engine.stop = recording_stop
        del engine
        if port:
            release = proc._release

            def recording_release():
                release()
                released.append(ref())

            proc._release = recording_release
        else:
            del proc
        stream = asyncio.ensure_future(_call(client, CHAT, dict(CALLS[1][1], max_tokens=24)))
        while not ref().active_slots:
            await asyncio.sleep(0.01)
        mrp.remove_endpoint(URL)
        mrp.serialize()
        await asyncio.to_thread(mrp.deserialize)
        streamed = await stream
        if port:
            for _ in range(500):
                if released:
                    break
                await asyncio.sleep(0.01)
            assert len(released) == 1, "the evicted engine was not released"
            alive = released.pop()
        else:
            for _ in range(50):
                gc.collect()
                if ref() is None:
                    break
                await asyncio.sleep(0.1)
            alive = ref()
        state = None if alive is None else (alive._stopped, alive._watchdog_task.done())
        del alive
        return first, streamed, bool(stops), state
    finally:
        await client.close()


def test_evicted_engine_reference_keeps_it_port_stops_and_frees_it(jax_mrp, tmp_path):
    """Removing a served endpoint while it streams: the stream ends
    unbroken on both packages. The reference's processor drops its
    processor, but the engine stays alive, not stopped, its watchdog task
    still running (it holds the engine). The port stops the engine once
    the stream ended, and its release frees it: nothing holds it after,
    not even the endpoint's request object."""
    ref = jax_mrp(dict(ENGINE_CFG))
    r_first, r_stream, r_stopped, r_state = asyncio.run(
        _evict_during_stream(ref, jax_build_app, port=False))
    assert r_stream[1] == "length" and r_first[0]
    assert (r_stopped, r_state) == (False, (False, False))

    port = ModelRequestProcessor(state_root=str(tmp_path / "port"), force_create=True,
                                 name="port", device="cpu")
    port.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=URL,
                                    auxiliary_cfg={"engine": dict(ENGINE_CFG)}))
    port.serialize()
    port.deserialize(skip_sync=True)
    p_first, p_stream, p_stopped, p_state = asyncio.run(
        _evict_during_stream(port, build_app, port=True))
    assert p_stream[1] == "length" and p_first[0]
    assert p_stopped and p_state is None
    assert URL not in port._engine_processor_lookup


def test_engine_modules_and_the_app_leave_cuda_untouched(tmp_path):
    """In a fresh interpreter whose CUDA entry points raise: import the
    engine modules (what ``main()`` does before it forks workers), write a
    service with an ``llm`` endpoint through the CLI, deserialize it and
    build the app. Nothing reaches CUDA, and ``torch.cuda.is_initialized()``
    stays false."""
    code = (
        "import torch\n"
        "def poisoned(name):\n"
        "    def fn(*a, **k):\n"
        "        raise RuntimeError('CUDA touched: torch.cuda.' + name)\n"
        "    return fn\n"
        "for name in ('is_available', 'init', '_lazy_init', 'device_count',\n"
        "             'current_device', 'set_device', 'synchronize', 'get_device_name'):\n"
        "    setattr(torch.cuda, name, poisoned(name))\n"
        "from clearml_serving_tpu_torch.engines import load_engine_modules\n"
        "load_engine_modules()\n"
        "from clearml_serving_tpu_torch.__main__ import cli\n"
        "from clearml_serving_tpu_torch.serving.main import build_app\n"
        "from clearml_serving_tpu_torch.serving.model_request_processor import (\n"
        "    ModelRequestProcessor)\n"
        "assert cli(['create', '--name', 'fork']) == 0\n"
        "assert cli(['--yes', 'model', 'add', '--engine', 'llm', '--endpoint', 'chat',\n"
        "            '--aux-config', 'engine.preset=llama3-8b']) == 0\n"
        "mrp = ModelRequestProcessor()\n"
        "assert mrp.deserialize(skip_sync=True)\n"
        "build_app(mrp)\n"
        "print('cuda initialized:', torch.cuda.is_initialized())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["TPUSERVE_STATE_ROOT"] = str(tmp_path / "state")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("cuda initialized: False")


def test_inference_server_main_serves_on_the_cpu(tmp_path):
    """The steps a user runs: the CLI writes the service, ``python -m
    clearml_serving_tpu_torch.serving.main --device cpu`` serves its ``llm``
    endpoint (``TPUSERVE_*`` environment), answers a chat on both routes,
    and exits 0 after SIGTERM's drain."""
    import signal
    import socket
    import time
    import urllib.request

    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env.update(TPUSERVE_STATE_ROOT=str(tmp_path / "state"), TPUSERVE_PORT=str(port),
               TPUSERVE_HOST="127.0.0.1", TPUSERVE_POLL_FREQ="60")
    aux = ["engine.{}={}".format(k, json.dumps(v)) for k, v in ENGINE_CFG.items()]
    for argv in (["create", "--name", "served"],
                 ["--yes", "model", "add", "--engine", "llm", "--endpoint", URL,
                  "--aux-config"] + aux):
        out = subprocess.run([sys.executable, "-m", "clearml_serving_tpu_torch"] + argv,
                             cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-3000:]
    server = subprocess.Popen(
        [sys.executable, "-m", "clearml_serving_tpu_torch.serving.main", "--device", "cpu"],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = "http://127.0.0.1:{}".format(port)

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        deadline = time.monotonic() + 180
        while True:
            try:
                with urllib.request.urlopen(base + "/ready", timeout=5) as r:
                    ready = json.loads(r.read())
                break
            except OSError:
                assert server.poll() is None and time.monotonic() < deadline, \
                    server.stdout.read() if server.poll() is not None else "server not up"
                time.sleep(0.5)
        assert ready["status"] == "ready" and ready["engines"][URL]["ready"]
        status, chat = post(CHAT, CALLS[0][1])
        assert status == 200 and chat["usage"]["completion_tokens"] == 12
        status, plain = post("/serve/" + URL, CALLS[5][1])
        assert status == 200
        assert plain["choices"][0]["message"] == chat["choices"][0]["message"]
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            rc = server.wait(timeout=60)
        finally:
            if server.poll() is None:
                server.kill()
                server.wait(timeout=30)
    assert rc == 0, server.stdout.read()[-3000:]
