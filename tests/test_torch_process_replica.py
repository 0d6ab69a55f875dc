"""The port's process fleet (clearml_serving_tpu_torch/serving/
process_replica.py) against the JAX package's, the reference's
``tests/test_process_replica.py`` run on the port.

Units: the ``EngineReplica`` surface pin, the control frame codec (the
port's frames are the reference's bytes), the request wire's remaining
budgets, guided requests refused with the reference's named error, and
errors rebuilt by name.

Real fleets, two ``device: cpu`` worker processes on llama-tiny at float32
over the JAX weights carried through the fleet's weights file: the greedy
streams equal the JAX ``LLMEngineCore``'s, a monolithic port engine's and
the port's in-process fleet's; a disaggregated pair ships KV over the
socket wire; a real SIGKILL (the ``replica.proc.crash`` seam) mid-stream
fails the stream over to the sibling byte-identically, and the worker
restarts as a new process, re-warms through the gate and serves, with a
bounded budget; ``stop()`` reaps every worker. The fleet endpoint behind
the port's processor answers what the JAX fleet endpoint answers, carries
each worker's ``process`` block on ``/ready`` and ``/health``, exports
each worker's lifecycle families, and its eviction reaps the workers. A
module fixture holds that no worker outlives the module.
"""

import asyncio
import inspect
import json
import os
import signal
import socket
import time

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import GenRequest as JaxGenRequest
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.serving import process_replica as ref_proc
from clearml_serving_tpu_torch.errors import (
    DeadlineExceededError,
    EngineOverloadedError,
    EngineUnavailableError,
)
from clearml_serving_tpu_torch.llm import faults
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.replica import EngineReplica, ReplicaGroup
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.serving.process_replica import (
    ProcessEngineReplica,
    _err_from_dict,
    _err_to_dict,
    _recv_frame_sock,
    _req_from_wire,
    _req_to_wire,
    _send_frame_sock,
    build_process_fleet,
)

TINY = {"preset": "llama-tiny", "dtype": "float32"}
MODEL = {"config": TINY, "seed": 0}
ENGINE = {"max_batch": 2, "max_seq_len": 64, "cache_mode": "paged", "page_size": 16,
          "num_pages": 64, "prefix_cache": 64, "prefix_block": 16,
          "prefill_buckets": [16, 32, 64], "eos_token_id": None, "pipeline_depth": 1}
# the workers' threads, kept few beside the other test processes
WORKER_ENV = {"OMP_NUM_THREADS": "2"}


def _children():
    """The pids of this process's live children (from /proc)."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/{}/stat".format(name)) as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me and fields[0] != "Z":
            out.append(int(name))
    return out


@pytest.fixture(scope="module", autouse=True)
def no_worker_outlives_the_module():
    before = set(_children())
    yield
    deadline = time.monotonic() + 30.0
    while set(_children()) - before and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not set(_children()) - before, "workers outlived the tests"


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _fleet(tiny_np, **kw):
    kwargs = dict(warmup_mode="off", device="cpu", startup_timeout=120.0, env=WORKER_ENV,
                  params=convert_params(tiny_np, device="cpu"))
    kwargs.update(kw)
    return build_process_fleet(MODEL, dict(ENGINE), kwargs.pop("n", 2), **kwargs)


async def _collect(engine, ids, n=6, Req=GenRequest, **kw):
    request = Req(prompt_ids=list(ids), max_new_tokens=n, **kw)
    return [int(t) async for t in engine.generate(request)]


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _wait_gone(pids, timeout=30.0):
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.1)
    return [p for p in pids if _alive(p)]


# -- the shared replica surface ----------------------------------------------------------


def test_process_replica_pins_the_engine_replica_surface():
    """Every public member the router and the group read on an
    ``EngineReplica`` exists on a ``ProcessEngineReplica``, a property
    where it is one, a coroutine where it is one."""
    for name, member in vars(EngineReplica).items():
        if name.startswith("_"):
            continue
        other = inspect.getattr_static(ProcessEngineReplica, name, None)
        assert other is not None, name
        if isinstance(member, property):
            assert isinstance(other, property), name
        if inspect.iscoroutinefunction(member):
            assert inspect.iscoroutinefunction(other), name


# -- frame codec -------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_frame_codec_roundtrip_and_truncation(pkg):
    send = _send_frame_sock if pkg == "port" else ref_proc._send_frame_sock
    recv = _recv_frame_sock if pkg == "port" else ref_proc._recv_frame_sock
    a, b = socket.socketpair()
    try:
        payload = {"id": 3, "op": "ping", "nested": {"x": [1, 2, 3]}}
        send(a, payload)
        # the other package reads the frame: one protocol
        assert (ref_proc._recv_frame_sock if pkg == "port" else _recv_frame_sock)(b) == payload
        send(a, payload)
        assert recv(b) == payload
        a.sendall(b"\xff\x00\x00\x00{")
        a.close()
        assert recv(b) is None
    finally:
        b.close()


# -- request wire ---------------------------------------------------------------------------


def _wire_request(Req):
    request = Req(prompt_ids=[1, 2, 3], max_new_tokens=7, temperature=0.5, top_k=11,
                  seed=42, logprobs=2, logit_bias={5: -1.5}, stop_token_ids=[9],
                  min_tokens=2, priority="batch", total_timeout=30.0)
    request._deadline = time.monotonic() + 10.0
    request._ship_to = "r1"
    request._shipped = True
    return request


def test_request_wire_roundtrip_carries_remaining_budgets():
    wire = _req_to_wire(_wire_request(GenRequest))
    assert 9.0 < wire["total_timeout"] <= 10.0
    assert wire["logit_bias"] == {"5": -1.5}
    rebuilt = _req_from_wire(json.loads(json.dumps(wire)))
    assert rebuilt.prompt_ids == [1, 2, 3]
    assert rebuilt.max_new_tokens == 7
    assert rebuilt.logit_bias == {5: -1.5}
    assert rebuilt.stop_token_ids == [9]
    assert rebuilt.seed == 42 and rebuilt.priority == "batch"
    assert rebuilt._ship_to == "r1"
    assert rebuilt._shipped is True


def test_rebuilt_request_keeps_its_budgets_where_the_reference_drops_them():
    """The wire carries the remaining budgets; the port's worker-side
    request keeps them. The reference's ``_req_from_wire`` passes only
    ``_REQ_FIELDS``, so its worker's request has no budget at all (a
    reference fault, ROADMAP section 3)."""
    port = _req_from_wire(_req_to_wire(_wire_request(GenRequest)))
    assert 9.0 < port.total_timeout <= 10.0
    ref_wire = ref_proc._req_to_wire(_wire_request(JaxGenRequest))
    assert 9.0 < ref_wire["total_timeout"] <= 10.0
    assert ref_proc._req_from_wire(ref_wire).total_timeout is None


def test_guided_requests_rejected_with_the_reference_named_error():
    from clearml_serving_tpu_torch.llm.guided import GuidedSpec

    request = GenRequest(prompt_ids=[1], max_new_tokens=1)
    request.guided = GuidedSpec("regex", "(yes|no)")
    ref_request = JaxGenRequest(prompt_ids=[1], max_new_tokens=1)
    ref_request.guided = {"choice": ["a", "b"]}
    with pytest.raises(ValueError, match="guided") as port_err:
        _req_to_wire(request)
    with pytest.raises(ValueError) as ref_err:
        ref_proc._req_to_wire(ref_request)
    assert str(port_err.value) == str(ref_err.value)


# -- error wire -------------------------------------------------------------------------------


def test_error_wire_reconstructs_by_name_with_fields():
    err = _err_from_dict(_err_to_dict(
        EngineOverloadedError("queue full", retry_after=2.5, shed_class="best_effort")))
    assert isinstance(err, EngineOverloadedError)
    assert err.retry_after == 2.5 and err.shed_class == "best_effort"
    err = _err_from_dict(_err_to_dict(DeadlineExceededError("too slow", stage="ttft")))
    assert isinstance(err, DeadlineExceededError) and err.stage == "ttft"
    assert isinstance(_err_from_dict(_err_to_dict(EngineUnavailableError("gone"))),
                      EngineUnavailableError)
    assert isinstance(_err_from_dict({"name": "MemoryError", "message": "x"}), MemoryError)
    err = _err_from_dict({"name": "WeirdVendorError", "message": "boom"})
    assert type(err) is RuntimeError and "boom" in str(err)
    # the reference's dicts read the same on the port
    for ex in (EngineOverloadedError("q", retry_after=1.0, shed_class="batch"),
               DeadlineExceededError("d", stage="queue")):
        assert _err_to_dict(ex) == ref_proc._err_to_dict(ex)


# -- real fleets -------------------------------------------------------------------------------

PROMPTS = [list(range(2, 22)), [7, 8, 9, 10], list(range(30, 63))]


def test_process_fleet_streams_equal_the_reference_mono_and_inprocess(tiny_np):
    """The two-process fleet's greedy streams equal the JAX engine's on the
    same weights, a monolithic port engine's and the port's in-process
    fleet's: the process boundary is a transport, never a numerics
    change. Each worker is a process of its own, alive, with a pid."""
    async def jax_arm():
        engine = JaxEngine(models.build_model("llama", TINY), tiny_np, **ENGINE)
        out = [await _collect(engine, ids, Req=JaxGenRequest) for ids in PROMPTS]
        await engine.wait_drained()
        engine.stop()
        return out

    async def port_arm(n):
        model = Llama(TINY, convert_params(tiny_np, device="cpu"))
        engines = [LLMEngineCore(model, replica="r{}".format(i), **ENGINE) for i in range(n)]
        engine = engines[0] if n == 1 else ReplicaGroup(engines)
        out = [await _collect(engine, ids) for ids in PROMPTS]
        await engine.wait_drained()
        engine.stop()
        return out

    expected = asyncio.run(jax_arm())
    assert asyncio.run(port_arm(1)) == expected
    assert asyncio.run(port_arm(2)) == expected
    group = _fleet(tiny_np)
    try:
        assert group.replica_backend == "process"
        got = [asyncio.run(_collect(group, ids)) for ids in PROMPTS]
        assert got == expected
        blocks = group.health()["replicas"]
        assert set(blocks) == {"r0", "r1"}
        pids = set()
        for block in blocks.values():
            proc = block["process"]
            assert proc["backend"] == "process" and proc["alive"] and proc["restarts"] == 0
            assert proc["pid"] > 0 and proc["pid"] != os.getpid()
            pids.add(proc["pid"])
            assert block["device"] == "cpu"
        assert len(pids) == 2
        assert group.router.stats()["replica_backend"] == "process"
        # each worker's kernels' counts and engine counters, read and reset
        counts = group.replicas[0].engine.launch_counts(reset=True)
        assert set(counts) == {"paged", "ragged", "tree", "int4"}
    finally:
        group.stop()


def test_process_fleet_disagg_ships_kv_over_sockets(tiny_np):
    """Prefill and decode workers: the prefix pages cross the socket wire,
    the decode worker hits them, and the stream equals the JAX engine's."""
    ids = list(range(2, 42))

    async def jax_arm():
        engine = JaxEngine(models.build_model("llama", TINY), tiny_np, **ENGINE)
        out = await _collect(engine, ids, Req=JaxGenRequest)
        engine.stop()
        return out

    expected = asyncio.run(jax_arm())
    group = _fleet(tiny_np, roles=["prefill", "decode"])
    try:
        toks = asyncio.run(_collect(group, ids))
        assert toks == expected
        assert group.ship_legs >= 1 and group.ship_leg_failures == 0
        pre = group.replicas[0].engine.health()["kv_ship"]
        dec = group.replicas[1].engine.health()["kv_ship"]
        assert pre["role"] == "prefill" and pre["ships"] == 1 and pre["ship_drops"] == 0
        assert dec["role"] == "decode" and dec["receives"] == 1 and dec["hits"] == 1
        assert dec["recomputes"] == 0
        wire = dec["transport"]["wire"]
        assert wire["frames_received"] == 1 and wire["recv_failures"] == 0
        assert pre["transport"]["wire"]["bytes_sent"] == wire["bytes_received"] > 0
        # a repeat turn: the decode worker holds the prefix, no second leg
        legs = group.ship_legs
        assert asyncio.run(_collect(group, ids)) == expected
        assert group.ship_legs == legs and group.ship_warm_skips == 1
    finally:
        group.stop()


def test_process_fleet_kill_worker_fails_over_and_restarts_with_rewarm(tiny_np):
    """The ``replica.proc.crash`` seam SIGKILLs worker r1 while a stream
    pinned to it is mid-way (its decode chunks slowed by an ``engine.decode``
    delay in the workers): the stream resumes on r0 and equals an
    uninterrupted one; the worker restarts as a new process, its warm gate
    closed and reopened, and a stream pinned to it serves. The budget is
    bounded: a second kill ejects the slot for good and the fleet still
    serves on r0."""
    ids = [3, 4, 5, 6, 7, 8, 9, 10]

    async def jax_arm():
        engine = JaxEngine(models.build_model("llama", TINY), tiny_np, **ENGINE)
        out = await _collect(engine, ids, n=24, Req=JaxGenRequest)
        engine.stop()
        return out

    expected = asyncio.run(jax_arm())
    slow = [{"point": "engine.decode", "action": "delay", "delay": 0.3, "times": -1}]
    env = dict(WORKER_ENV, TPUSERVE_FAULTS=json.dumps(slow))
    group = _fleet(tiny_np, heartbeat_interval=0.2, max_restarts=1, env=env,
                   warmup_mode="startup")
    try:
        asyncio.run(group.warmup())
        replica = group.replicas[1]
        pid0 = replica.engine.pid
        assert pid0 and replica.engine.is_ready and replica.warmed

        async def pinned_with_kill():
            request = GenRequest(prompt_ids=list(ids), max_new_tokens=24)
            request._replica_name = "r1"
            out = []
            async for token in group.generate(request):
                out.append(int(token))
                if len(out) == 6:
                    faults.configure([{"point": "replica.proc.crash", "action": "raise",
                                       "match_token": 1, "times": 1}])
            return out, request._replica_name

        got, home = asyncio.run(pinned_with_kill())
        assert got == expected and home == "r0"
        assert group.failovers == 1
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if replica.restarts >= 1 and replica.engine.is_ready:
                break
            time.sleep(0.1)
        faults.clear()
        assert replica.restarts == 1
        assert replica.engine.pid != pid0 and not _alive(pid0)
        assert not replica.warmed   # the gate closed for the new worker

        async def pinned():
            # a sweep from the loop schedules the re-warm; the ring takes
            # r1 back once its gate opens
            t0 = time.monotonic()
            while "r1" not in group.router.ring() and time.monotonic() - t0 < 60:
                group.router.sweep()
                await asyncio.sleep(0.05)
            request = GenRequest(prompt_ids=[11, 12, 13], max_new_tokens=4)
            request._replica_name = "r1"
            out = [int(t) async for t in group.generate(request)]
            return out, request._replica_name

        out, home = asyncio.run(pinned())
        assert len(out) == 4 and home == "r1"
        assert len(replica.warm_seconds) == 2
        health = group.health()["replicas"]["r1"]["process"]
        assert health["restarts"] == 1 and health["pid"] == replica.engine.pid
        os.kill(replica.engine.pid, signal.SIGKILL)
        deadline = time.monotonic() + 30.0
        while replica.engine.is_ready and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not replica.engine.is_ready
        assert len(asyncio.run(_collect(group, [21, 22, 23]))) == 6
        assert replica.restarts == 1
    finally:
        group.stop()


def test_a_dead_first_worker_leaves_the_fleet_serving(tiny_np):
    """Worker r0 SIGKILLed with no restart budget: the ring drops it, and a
    new request (validated, admitted and generated through the group)
    still serves on r1."""
    group = _fleet(tiny_np, heartbeat_interval=0.2, max_restarts=0)
    try:
        replica = group.replicas[0]
        os.kill(replica.engine.pid, signal.SIGKILL)
        deadline = time.monotonic() + 30.0
        while replica.engine.is_ready and time.monotonic() < deadline:
            time.sleep(0.05)
        group.router.sweep()
        assert group.router.ring() == ["r1"]
        request = GenRequest(prompt_ids=[5, 6, 7, 8], max_new_tokens=6)
        group.validate(request)
        group.check_admission(request)
        out = asyncio.run(_collect(group, [5, 6, 7, 8]))
        assert len(out) == 6 and request._replica_name == "r1"
    finally:
        group.stop()


def test_process_fleet_stop_reaps_every_worker(tiny_np):
    group = _fleet(tiny_np)
    pids = [r.engine.pid for r in group.replicas]
    base = group._process_runtime.base_dir
    assert all(pids) and os.path.isdir(base)
    group.stop()
    assert not _wait_gone(pids), "worker pids survived group.stop()"
    assert not os.path.exists(base)


def test_a_worker_that_dies_at_boot_fails_the_build_by_name(tiny_np):
    """A worker whose engine cannot be built exits before its handshake:
    ``build_process_fleet`` raises naming the replica and its exit code, and leaves no
    process or directory behind."""
    with pytest.raises(EngineUnavailableError, match="r0 worker exited with rc="):
        build_process_fleet(MODEL, dict(ENGINE, max_batch="many"), 2, warmup_mode="off",
                            device="cpu", startup_timeout=60.0, env=WORKER_ENV)


# -- the fleet endpoint ------------------------------------------------------------------------

FLEET_AUX = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "max_batch": 2,
             "max_seq_len": 128, "prefill_buckets": [32, 64], "cache": "paged",
             "prefix_cache": 32, "prefix_block": 16, "pipeline_depth": 1, "seed": 0,
             "replicas": 2}
CHAT_PATH = "/serve/openai/v1/chat/completions"


def test_fleet_endpoint_serves_what_the_reference_fleet_serves(tmp_path, monkeypatch):
    """A ``replica_backend: process`` endpoint behind the port's processor
    and router: the same chats as the JAX fleet endpoint answer the same
    content; ``/ready`` and ``/health`` carry each worker's ``process``
    block; the exporter shows each worker's lifecycle families; a guided
    request is refused by name (422); the eviction reaps the workers."""
    from aiohttp.test_utils import TestClient, TestServer
    from prometheus_client import REGISTRY, generate_latest

    from clearml_serving_tpu.serving.main import build_app as jax_build_app
    from clearml_serving_tpu_torch.llm import openai_api
    from clearml_serving_tpu_torch.serving.main import build_app
    from test_torch_replica import _jax_fleet_processor
    from torch_serving import port_processor

    monkeypatch.setattr(openai_api, "Llama", lambda *a, **k: pytest.fail("weights in the parent"))
    first = [{"role": "user", "content": "describe the sea in a few words please, calmly"}]
    bodies = [{"model": "chat", "messages": first, "max_tokens": 8},
              {"model": "chat", "max_tokens": 8, "stream": True, "messages": first + [
                  {"role": "assistant", "content": "blue"},
                  {"role": "user", "content": "and the sky?"}]}]

    async def calls(client, port):
        out = []
        for body in bodies:
            r = await client.post(CHAT_PATH, json=body)
            assert r.status == 200, await r.text()
            if body.get("stream"):
                text = ""
                async for raw in r.content:
                    line = raw.decode().strip()
                    if line.startswith("data: {"):
                        choice = json.loads(line[6:])["choices"][0]
                        text += choice["delta"].get("content") or ""
                out.append(text)
            else:
                out.append((await r.json())["choices"][0]["message"]["content"])
        extra = {}
        if port:
            r = await client.post(CHAT_PATH, json=dict(bodies[0], guided_regex="(yes|no)"))
            extra["guided"] = (r.status, await r.text())
            extra["exported"] = generate_latest(REGISTRY).decode()
        ready = await (await client.get("/ready")).json()
        health = await (await client.get("/health")).json()
        return out, ready["fleet"], health["fleet"], extra

    def serve(app, port=False):
        async def runner():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                return await calls(client, port)
            finally:
                await client.close()
        return asyncio.run(runner())

    ref = _jax_fleet_processor(FLEET_AUX, tmp_path / "ref")
    want = serve(jax_build_app(ref))
    jgroup = ref._engine_processor_lookup["chat"].engine
    params = jax.tree.map(np.asarray, jgroup.replicas[0].engine.params)
    jgroup.stop()
    aux = dict(FLEET_AUX, replica_backend="process")
    group, tok = openai_api.build_engine(aux, device="cpu",
                                         params=convert_params(params, device="cpu"))
    pids = [r.engine.pid for r in group.replicas]
    mrp = port_processor(group, tok, "chat", state_root=tmp_path / "port")
    proc = mrp._engine_processor_lookup["chat"]
    try:
        got = serve(build_app(mrp), port=True)
        assert got[0] == want[0] and all(got[0])
        for fleet in got[1:3]:
            chat = fleet["chat"]
            assert chat["ring"] == ["r0", "r1"] and chat["ready"]
            blocks = {name: row["process"] for name, row in chat["per_replica"].items()}
            assert sorted(b["pid"] for b in blocks.values()) == sorted(pids)
            for block in blocks.values():
                assert block["backend"] == "process" and block["alive"]
                assert block["restarts"] == 0
        for g, w in zip(got[1:3], want[1:3]):
            assert {k: v for k, v in g["chat"].items() if k != "per_replica"} == \
                {k: v for k, v in w["chat"].items() if k != "per_replica"}
        status, text = got[3]["guided"]
        assert status == 422 and "process-backend replicas" in text
        exported = got[3]["exported"]
        for name in ("r0", "r1"):
            assert 'engine_ready{{model="chat",replica="{}"}} 1.0'.format(name) in exported
        assert 'router_replica_backend{backend="process",model="chat"} 1.0' in exported
    finally:
        proc.retire()
        del group
    assert not _wait_gone(pids), "the eviction left workers alive"
    assert proc.engine is None and proc._metric_entries == []
    # (the reference's collectors of its own "chat" endpoint stay registered)
    assert 'backend="process",model="chat"' not in generate_latest(REGISTRY).decode()
