"""The HTTP surface of the port's request lifecycle
(``clearml_serving_tpu_torch/serving/main.py`` and ``llm/openai_api.py``)
beside the reference's (``tests/test_lifecycle_api.py``), llama-tiny in
float32, each scenario driven through both apps:

- an admission shed is a 429 with ``Retry-After`` >= 1 and ``code:
  overloaded`` on the streaming and the non-streaming route, before any
  stream header;
- a spent budget is a 408 ``deadline_exceeded`` on both routes, and a
  budget that runs out mid-stream an SSE error event;
- ``/ready`` follows the engine (503 while it recovers or once it is
  stopped) and the drain, while ``/health`` stays 200;
- a drain sheds new requests with 503 ``draining`` while the in-flight
  ones finish, then stops the engine with every page back;
- with no lifecycle knob, both fronts build their engine with the
  reference's defaults and shed the same burst at
  ``max(16, 4 * max_batch)``.

Where a request must stay in flight for a while, the ``engine.decode.stall``
seam holds its retire for seconds; the scenarios bound their own run.
"""

import asyncio
import json
import os

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.serving.endpoints import ModelEndpoint
from clearml_serving_tpu.serving.main import build_app as jax_build_app
from clearml_serving_tpu.serving.main import drain_app as jax_drain_app
from clearml_serving_tpu.serving.model_request_processor import ModelRequestProcessor
from clearml_serving_tpu_torch.llm import faults
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.models.llama import convert_params
from clearml_serving_tpu_torch.serving.main import build_app, drain_app
from torch_serving import port_processor

URL = "tiny_llm"
CHAT = "/serve/openai/v1/chat/completions"
ENGINE_CFG = {
    "preset": "llama-tiny",
    "config": {"dtype": "float32"},
    "max_batch": 2,
    "max_seq_len": 128,
    "prefill_buckets": [32, 64],
    "cache": "paged",
    "scheduler": "two_dispatch",
    "seed": 0,
}
# the reference lifecycle suite's endpoint: the watchdog is not under test
QUIET = dict(ENGINE_CFG, watchdog_interval=0)


def _mrp(root, name, cfg):
    mrp = ModelRequestProcessor(state_root=str(root), force_create=True, name=name)
    mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url=URL,
                                   auxiliary_cfg={"engine": dict(cfg)}))
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    return mrp


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    root = tmp_path_factory.mktemp("state")
    old = os.environ.get("TPUSERVE_STATE_ROOT")
    os.environ["TPUSERVE_STATE_ROOT"] = str(root)
    try:
        yield root
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old


@pytest.fixture(scope="module")
def ref_mrp(state):
    """The reference endpoint; one request loads its engine, whose weights
    the port's apps then carry."""
    mrp = _mrp(state, "llm-lifecycle", QUIET)
    _run(jax_build_app(mrp), lambda c, app: _post(c, _body()))
    return mrp


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


class Front:
    """One package's app: how to build it, reach its engine, arm its seams
    and drain it."""

    def __init__(self, name, mrp, state=None, cfg=QUIET):
        self.name, self.mrp, self.state, self.cfg = name, mrp, state, cfg
        self.faults = jax_faults if name == "jax" else faults
        self._port = None

    def app(self):
        if self.name == "jax":
            return jax_build_app(self.mrp)
        params = jax.tree.map(np.asarray, _ref_engine(self.mrp).params)
        engine, tok = build_engine(dict(self.cfg), device="cpu",
                                   params=convert_params(params, device="cpu"))
        self._port = port_processor(engine, tok, URL)
        return build_app(self._port)

    @property
    def engine(self):
        return _ref_engine(self.mrp) if self.name == "jax" else _ref_engine(self._port)

    async def drain(self, app, timeout):
        if self.name == "jax":
            await jax_drain_app(app, self.mrp, timeout=timeout)
        else:
            await drain_app(app, self._port, timeout=timeout)


def _ref_engine(mrp):
    return mrp._engine_processor_lookup[URL].engine


def _run(app, fn, timeout=120.0):
    async def runner():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await asyncio.wait_for(fn(client, app), timeout)
        finally:
            await client.close()

    return asyncio.run(runner())


def _body(**extra):
    return dict({"model": URL, "messages": [{"role": "user", "content": "hello"}],
                 "max_tokens": 4}, **extra)


async def _post(client, body):
    """(status, Retry-After or None, JSON body or SSE text)."""
    r = await client.post(CHAT, json=body)
    text = await r.text()
    try:
        payload = json.loads(text)
    except ValueError:
        payload = text
    return r.status, r.headers.get("Retry-After"), payload


def _both(ref_mrp, fn, **front_kw):
    return [_run(front.app(), lambda c, app, front=front: fn(front, c, app))
            for front in (Front("jax", ref_mrp, **front_kw), Front("port", ref_mrp, **front_kw))]


def test_shed_returns_429_with_retry_after(ref_mrp):
    async def fn(front, client, app):
        out = []
        for stream in (False, True):
            front.faults.configure([{"point": "engine.admit", "times": 1}])
            status, retry, payload = await _post(client, _body(stream=stream))
            out.append((status, int(retry) >= 1, payload["code"], payload["class"]))
        status, _, _ = await _post(client, _body())   # the overload cleared
        return out, status

    want, got = _both(ref_mrp, fn)
    assert got == want
    assert got == ([(429, True, "overloaded", "interactive")] * 2, 200)


def test_deadline_returns_408_on_both_routes(ref_mrp):
    async def fn(front, client, app):
        out = []
        for stream in (False, True):
            status, _, payload = await _post(client, _body(timeout=0, stream=stream))
            out.append((status, payload["code"], payload["stage"]))
        return out

    want, got = _both(ref_mrp, fn)
    assert got == want == [(408, "deadline_exceeded", "total")] * 2


@pytest.mark.timeout(300)
def test_streaming_deadline_mid_stream_emits_sse_error(ref_mrp):
    """A budget that runs out after the headers (a 4 s retire stall
    against a 1.5 s budget) cannot change the status line: the structured
    error arrives as an SSE error event."""

    async def fn(front, client, app):
        front.faults.configure([{"point": "engine.decode.stall", "action": "delay",
                                 "delay": 4.0, "times": 1}])
        status, _, text = await _post(client, _body(stream=True, max_tokens=100_000,
                                                    timeout=1.5))
        events = [json.loads(line[len("data: "):]) for line in text.splitlines()
                  if line.startswith("data: {")]
        errors = [e["error"]["type"] for e in events if "error" in e]
        return status, errors, text.rstrip().endswith("data: [DONE]")

    want, got = _both(ref_mrp, fn)
    assert got == want == (200, ["DeadlineExceededError"], True)


def test_ready_reflects_engine_health(ref_mrp):
    async def fn(front, client, app):
        out = []
        r = await client.get("/ready")
        out.append((r.status, (await r.json())["status"]))
        front.engine._recovering = True  # what a watchdog trip sets
        try:
            r = await client.get("/ready")
            body = await r.json()
            out.append((r.status, body["status"], body["not_ready"],
                        "Retry-After" in r.headers))
            r = await client.get("/health")
            out.append(r.status)  # liveness only
        finally:
            front.engine._recovering = False
        r = await client.get("/ready")
        out.append((r.status, (await r.json())["engines"][URL]["ready"]))
        return out

    want, got = _both(ref_mrp, fn)
    assert got == want
    assert got == [(200, "ready"), (503, "not_ready", [URL], True), 200, (200, True)]


def test_ready_carries_the_brownout_stage(ref_mrp):
    async def fn(front, client, app):
        engine = front.engine
        if engine._brownout is None:
            return None
        engine._brownout.stage = 2
        engine._brownout_checked = float("inf")  # no update may lower it now
        try:
            r = await client.get("/ready")
            return r.status, (await r.json())["brownout"]
        finally:
            engine._brownout.stage = 0
            engine._brownout_checked = 0.0

    want, got = _both(ref_mrp, fn)
    assert got == want == (200, {URL: 2})


@pytest.mark.timeout(300)
def test_graceful_drain_sheds_new_lets_inflight_finish(state):
    """An in-flight request (its first retire held 2 s) finishes with 200
    while a drain runs; a new POST meanwhile is a 503 ``draining`` with a
    Retry-After, /ready is 503 ``draining``, and the engine stops after the
    drain with every page back."""
    ref = _mrp(state, "llm-drain", QUIET)
    _run(jax_build_app(ref), lambda c, app: _post(c, _body()))

    async def fn(front, client, app):
        front.faults.configure([{"point": "engine.decode.stall", "action": "delay",
                                 "delay": 2.0, "times": 1}])
        inflight = asyncio.ensure_future(_post(client, _body(max_tokens=8)))
        while front.engine.active_slots == 0:
            await asyncio.sleep(0.01)
        drain = asyncio.ensure_future(front.drain(app, timeout=30.0))
        await asyncio.sleep(0.1)
        status, retry, payload = await _post(client, _body())
        r = await client.get("/ready")
        ready = (r.status, (await r.json())["status"])
        done = await inflight
        await drain
        engine = front.engine
        await engine.wait_drained()
        pool = engine.paged_cache.pool
        return dict(shed=(status, retry is not None, payload["code"]), ready=ready,
                    inflight=(done[0], done[2]["usage"]["completion_tokens"] >= 1),
                    stopped=not engine.health()["ready"],
                    pages_back=pool.free_pages == pool.num_pages - 1)

    want, got = [_run(front.app(), lambda c, app, front=front: fn(front, c, app))
                 for front in (Front("jax", ref), Front("port", ref))]
    assert got == want
    assert got == dict(shed=(503, True, "draining"), ready=(503, "draining"),
                       inflight=(200, True), stopped=True, pages_back=True)


@pytest.mark.timeout(300)
def test_default_config_sheds_at_the_reference_bound(state):
    """No lifecycle knob: both fronts build the engine with the reference's
    defaults (max_pending = max(16, 4 * max_batch) = 32 at max_batch 8, a
    30 s watchdog, preemption, brownout). Eight long chats hold the slots
    (a retire held 3 s once they all decode), then a burst of 40 chats: the same 8 are
    shed with 429 and a Retry-After on both, the rest answer 200."""
    cfg = dict(ENGINE_CFG, max_batch=8)
    ref = _mrp(state, "llm-defaults", cfg)
    _run(jax_build_app(ref), lambda c, app: _post(c, _body()))

    async def fn(front, client, app):
        engine = front.engine
        defaults = (engine.max_pending, engine._watchdog_interval, engine._preempt,
                    engine._brownout is not None)
        holders = [asyncio.ensure_future(_post(client, _body(max_tokens=100)))
                   for _ in range(8)]
        while engine.active_slots < 8:
            await asyncio.sleep(0.01)
        front.faults.configure([{"point": "engine.decode.stall", "action": "delay",
                                 "delay": 3.0, "times": 1}])
        burst = await asyncio.gather(*(_post(client, _body(max_tokens=2)) for _ in range(40)))
        held = await asyncio.gather(*holders)
        shed = [b for b in burst if b[0] == 429]
        return dict(defaults=defaults, shed=len(shed),
                    codes=sorted({(b[2]["code"], int(b[1]) >= 1) for b in shed}),
                    ok=sum(b[0] == 200 for b in burst), held=[h[0] for h in held])

    want, got = [_run(front.app(), lambda c, app, front=front: fn(front, c, app))
                 for front in (Front("jax", ref, cfg=cfg), Front("port", ref, cfg=cfg))]
    assert got == want
    assert got == dict(defaults=(32, 30.0, True, True), shed=8,
                       codes=[("overloaded", True)], ok=32, held=[200] * 8)
