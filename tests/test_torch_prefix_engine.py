"""The port's engine with the radix prefix cache on (clearml_serving_tpu_torch/
llm/engine.py) against the JAX engine, llama-tiny in float32 with the same
weights through ``convert_params``, ``prefix_block`` 16 at ``page_size`` 4
and 16, under both schedulers, float and int8 KV, with the KV sanitizer
armed on both.

Held equal: greedy token streams; hits, misses and ``hit_tokens``; the
page ids every live slot maps during a wave of concurrent hits; after full
eviction (``max_nodes = 0``) every page back on both and 0 sanitizer
failures. Mirrors the reference's engine cases in
``tests/test_prefix_cache.py``, plus n-gram speculation under the ragged
scheduler, a preemption with the cache on, the cache's fault seams, the
warmup's cold-then-hit pairs and the OpenAI route.
"""

import asyncio
import os

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.llm import warmup as jax_warmup
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu_torch.llm import faults
from clearml_serving_tpu_torch.llm import warmup
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
BASE = dict(max_batch=4, max_seq_len=160, prefill_buckets=[32, 64, 128], eos_token_id=None,
            decode_steps=2, cache_mode="paged", prefix_cache=64, prefix_block=16)
SYSTEM = [(i * 5 + 1) % 256 for i in range(32)]
PROMPT = [(i * 7 + 3) % 256 for i in range(40)]


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


@pytest.fixture(autouse=True)
def armed(monkeypatch):
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


class Side:
    """One package under test: its engine and request class."""

    def __init__(self, name, tiny_np):
        self.name = name
        self.tiny_np = tiny_np
        self.Req = JaxGenRequest if name == "jax" else GenRequest
        self.faults = jax_faults if name == "jax" else faults

    def engine(self, kv_quant="", **kw):
        cfg = dict(TINY, kv_quant=kv_quant) if kv_quant else TINY
        kw = dict(BASE, **kw)
        if kw.get("scheduler") == "ragged":
            kw.setdefault("step_token_budget", 32)
        if self.name == "jax":
            kw.setdefault("pipeline_depth", 1)
            return JaxEngine(models.build_model("llama", cfg), self.tiny_np, **kw)
        kw.pop("cache_mode")
        return LLMEngineCore(Llama(cfg, convert_params(self.tiny_np, device="cpu")), **kw)


def _both(tiny_np, scenario, timeout=180.0):
    out = {}
    for name in ("jax", "port"):
        out[name] = asyncio.run(asyncio.wait_for(scenario(Side(name, tiny_np)), timeout))
    return out["jax"], out["port"]


async def _collect(engine, request):
    return [t async for t in engine.generate(request)]


def _counts(engine):
    s = engine._prefix.stats()
    return s["hits"], s["misses"], s["hit_tokens"]


def _evict_all(engine):
    """Full eviction (the reference's own probe): every page back."""
    engine._prefix.max_nodes = 0
    with engine._prefix._lock:
        engine._prefix._evict_over_budget()
    pool = engine.paged_cache.pool
    return pool.free_pages == pool.num_pages - 1


def _sanitizer_clean(engine):
    stats = engine._sanitizer.stats()
    return stats["checks"] > 0 and stats["failures"] == 0


SCHEDULERS = ["two_dispatch", "ragged"]


@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float32", "int8"])
@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_hit_streams_and_counts_match_reference(tiny_np, scheduler, kv_quant, page_size):
    """A prompt twice (miss + store, then a hit on its stored run), then
    prompts sharing only the system head, one after another: the streams,
    the counts and the cached pages equal the JAX engine's; on float KV
    every stream equals the same engine's without a cache."""
    prompts = [PROMPT, PROMPT, SYSTEM + [9, 8, 7, 6, 5], SYSTEM + [100, 101, 102]]

    async def scenario(s):
        engine = s.engine(kv_quant, scheduler=scheduler, page_size=page_size)
        streams = []
        for p in prompts:
            streams.append(await _collect(engine, s.Req(prompt_ids=list(p),
                                                        max_new_tokens=6)))
            await engine.wait_drained()
        out = dict(streams=streams, counts=_counts(engine),
                   cached=engine._prefix.stats()["cached_pages"],
                   pages_back=_evict_all(engine), clean=_sanitizer_clean(engine))
        engine.stop()
        return out

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["counts"][0] >= 2 and got["pages_back"] and got["clean"]
    if not kv_quant:
        async def plain():
            engine = Side("port", tiny_np).engine(scheduler=scheduler, page_size=page_size,
                                                  prefix_cache=None)
            out = [await _collect(engine, GenRequest(prompt_ids=list(p), max_new_tokens=6))
                   for p in prompts]
            engine.stop()
            return out

        assert asyncio.run(plain()) == got["streams"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_wave_of_concurrent_hits_maps_the_same_page_ids(tiny_np, scheduler):
    """A cold prompt stores the 32-token system head; then three prompts
    sharing it run concurrently. While all three are live, each slot's
    table starts with the stored run's page ids, the same ids on both
    packages; the streams and counts are equal; full eviction gives every
    page back, with the sanitizer clean."""

    async def scenario(s):
        engine = s.engine(scheduler=scheduler, page_size=4)
        pool = engine.paged_cache.pool
        first = await _collect(engine, s.Req(prompt_ids=SYSTEM + [7, 7, 7], max_new_tokens=6))
        await engine.wait_drained()
        hit = engine._prefix.lookup_pages(SYSTEM + [1], 0)   # counts as a hit
        head = list(hit["pages"])
        engine._prefix.release(hit)
        requests = [s.Req(prompt_ids=SYSTEM + [50 + i] * (3 + 5 * i), max_new_tokens=12)
                    for i in range(3)]
        tasks = [asyncio.ensure_future(_collect(engine, r)) for r in requests]
        tables = None
        while not all(t.done() for t in tasks):
            live = [pool.slot_pages(slot) for slot in range(pool.max_slots)
                    if pool.slot_length(slot) > 0]
            if len(live) == 3 and tables is None:
                tables = sorted(t[:len(head)] for t in live)
            await asyncio.sleep(0.0005)
        streams = [t.result() for t in tasks]
        await engine.wait_drained()
        out = dict(first=first, streams=streams, head=head, tables=tables,
                   counts=_counts(engine), pages_back=_evict_all(engine),
                   clean=_sanitizer_clean(engine))
        engine.stop()
        return out

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["tables"] == [got["head"]] * 3 and len(got["head"]) == 8
    assert got["counts"] == (4, 1, 128) and got["pages_back"] and got["clean"]


@pytest.mark.parametrize("page_size", [4, 16])
def test_ngram_speculation_under_ragged_with_prefix(tiny_np, page_size):
    """Prefix sharing beside n-gram verify rows (the reference's
    ``test_paged_prefix_composes_with_speculation`` under the ragged
    scheduler): the same greedy streams and counts as the JAX engine, and
    the verify rows' over-allocation truncates around shared pages
    without a leak."""
    prompt = [0] + [10, 20, 30, 10, 20, 30, 10, 20] * 3
    knobs = dict(scheduler="ragged", page_size=page_size, speculation="ngram", spec_k=3,
                 spec_ngram=2)

    async def scenario(s):
        engine = s.engine(**knobs)
        streams = []
        for _ in range(2):
            streams.append(await _collect(engine, s.Req(prompt_ids=list(prompt),
                                                        max_new_tokens=12)))
            await engine.wait_drained()
        out = dict(streams=streams, counts=_counts(engine), pages_back=_evict_all(engine),
                   clean=_sanitizer_clean(engine))
        engine.stop()
        return out

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["streams"][0] == got["streams"][1] and len(got["streams"][0]) == 12
    assert got["counts"][0] >= 1 and got["pages_back"] and got["clean"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_preemption_with_the_cache_on(tiny_np, scheduler):
    """A batch stream preempted for an interactive arrival, the cache on:
    both packages store the victim's history, and the stream equals its
    unpreempted run. The reference's resume looks the history up (one
    more hit, of the stored run's length) and prefills its tail; the port
    maps its parked pages back (ROADMAP §3), so its counts are the
    reference's less that one hit. The history's stored run is the same on
    both, and every page comes back."""
    prompt = [(i * 7 + 3) % 250 + 1 for i in range(17)]
    knobs = dict(max_batch=1, max_seq_len=128, prefill_buckets=[32, 64], page_size=16,
                 scheduler=scheduler)

    async def scenario(s):
        control = s.engine(**dict(knobs, prefix_cache=None))
        want = await _collect(control, s.Req(prompt_ids=list(prompt), max_new_tokens=24,
                                             priority="batch"))
        control.stop()
        engine = s.engine(**knobs)
        batch = s.Req(prompt_ids=list(prompt), max_new_tokens=24, priority="batch")
        b = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 6:
            await asyncio.sleep(0.005)
        hi = await _collect(engine, s.Req(prompt_ids=[1, 9, 9], max_new_tokens=2))
        got = await b
        await engine.wait_drained()
        stored = engine._prefix.match_len(list(prompt) + got)
        out = dict(want=want, got=got, hi=hi, preemptions=engine.counters["preemptions"],
                   counts=_counts(engine), stored=stored, pages_back=_evict_all(engine),
                   clean=_sanitizer_clean(engine))
        engine.stop()
        return out

    want, got = _both(tiny_np, scenario)
    assert got["got"] == got["want"] == want["got"] == want["want"]
    assert got["hi"] == want["hi"] and got["preemptions"] == want["preemptions"] == 1
    assert got["stored"] == want["stored"] >= 16
    history_hit = want["counts"][2] - got["counts"][2]
    assert (want["counts"][0] - got["counts"][0], want["counts"][1] - got["counts"][1]) == (1, 0)
    assert history_hit % 16 == 0 and history_hit >= 16
    assert got["pages_back"] and want["pages_back"] and got["clean"] and want["clean"]


@pytest.mark.parametrize("scheduler", SCHEDULERS)
def test_prefill_fault_on_a_hit_releases_its_pin(tiny_np, scheduler):
    """The ``engine.prefill`` seam fails the admission of a prompt that
    would hit: that request alone fails, the next one hits, and the
    lookup's pin never outlives the admission (the sanitizer stays clean
    through every step and the drain)."""

    async def scenario(s):
        engine = s.engine(scheduler=scheduler, page_size=4)
        await _collect(engine, s.Req(prompt_ids=SYSTEM + [7, 7], max_new_tokens=4))
        await engine.wait_drained()
        s.faults.configure([{"point": "engine.prefill", "action": "raise", "times": 1,
                             "match_token": 201}])
        try:
            await _collect(engine, s.Req(prompt_ids=SYSTEM + [201, 3], max_new_tokens=4))
            failed = None
        except Exception as ex:  # the injected fault is the outcome
            failed = type(ex).__name__
        s.faults.clear()
        after = await _collect(engine, s.Req(prompt_ids=SYSTEM + [202, 3], max_new_tokens=4))
        await engine.wait_drained()
        out = dict(failed=failed, after=after, counts=_counts(engine),
                   pins=engine.paged_cache.pool.snapshot()["pins"],
                   pages_back=_evict_all(engine), clean=_sanitizer_clean(engine))
        engine.stop()
        return out

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["failed"] == "InjectedFault" and got["pins"] == {}
    assert got["counts"][0] == 1 and got["pages_back"] and got["clean"]


def test_pool_seam_and_headroom_with_a_cached_prefix(tiny_np):
    """Admission control's pool headroom subtracts the cached prefix: a
    pool too small for the whole prompt admits a hit; the ``engine.pool``
    seam reads the pool as saturated (a 429 under ``pool``)."""
    from clearml_serving_tpu_torch.errors import EngineOverloadedError

    engine = Side("port", tiny_np).engine(page_size=4, num_pages=20, max_pending=8,
                                          max_batch=1)

    async def run():
        await _collect(engine, GenRequest(prompt_ids=SYSTEM + [7, 7], max_new_tokens=2))
        await engine.wait_drained()
        pool = engine.paged_cache.pool
        long = GenRequest(prompt_ids=SYSTEM + [9] * 40)
        assert not pool.can_allocate(len(long.prompt_ids) + 1)
        engine.check_admission(long)                       # the head is cached
        faults.configure([{"point": "engine.pool", "action": "raise", "times": 1}])
        with pytest.raises(EngineOverloadedError):
            engine.check_admission(GenRequest(prompt_ids=[1, 2, 3]))
        faults.clear()
        assert engine.counters["sheds_pool"] == 1
        engine.check_admission(GenRequest(prompt_ids=[1, 2, 3]))

    asyncio.run(run())
    engine.stop()


def test_release_seam_leak_is_named_by_the_sanitizer(tiny_np):
    """The ``engine.release`` seam loses a finished slot's page references:
    the armed sanitizer's drain audit names the leaked pages."""
    from clearml_serving_tpu_torch.llm.kv_sanitizer import KVSanitizerError

    engine = Side("port", tiny_np).engine(page_size=4)
    faults.configure([{"point": "engine.release", "action": "raise", "times": 1}])

    async def run():
        await _collect(engine, GenRequest(prompt_ids=PROMPT, max_new_tokens=3))
        await engine.wait_drained()

    with pytest.raises(KVSanitizerError, match="leaked pages at drain"):
        asyncio.run(run())
    engine.stop()


def test_health_and_lifecycle_carry_the_cache(tiny_np):
    engine = Side("port", tiny_np).engine(page_size=4)

    async def run():
        for _ in range(2):
            await _collect(engine, GenRequest(prompt_ids=PROMPT, max_new_tokens=3))
        await engine.wait_drained()

    asyncio.run(run())
    for snap in (engine.health(), engine.lifecycle_stats()):
        assert snap["prefix_cache"] == engine._prefix.stats()
        assert snap["prefix_cache"]["hits"] == 1 and snap["cow_events"] == 0
        assert snap["sanitizer"]["failures"] == 0
    engine.stop()


def test_warmup_runs_the_reference_cold_then_hit_pairs(tiny_np):
    """With the cache on, the startup warmup is the reference's
    ``warmup_plan(full=False)``: per bucket a cold prompt storing a head,
    then a hit on it."""
    port = Side("port", tiny_np).engine(page_size=4)
    ref = Side("jax", tiny_np).engine(page_size=4)
    plan = warmup.warmup_plan(port)
    assert plan == jax_warmup.warmup_plan(ref, full=False)
    asyncio.run(port.warmup())
    pairs = sum(1 for b in (32, 64, 128, 160) if b > 16)
    assert port._prefix.stats()["hits"] == pairs == len(plan) // 2
    assert port._sanitizer.stats()["failures"] == 0
    port.stop()
    ref.stop()


# -- the OpenAI route ---------------------------------------------------------------


def test_openai_route_content_equals_reference_with_the_cache(tmp_path):
    """Aux ``prefix_cache`` on both routes: the same chats (a repeat and a
    chat sharing the system message) give byte-identical content, and the
    port's engine counts its hits."""
    from aiohttp.test_utils import TestClient, TestServer

    from clearml_serving_tpu.serving.endpoints import ModelEndpoint
    from clearml_serving_tpu.serving.main import build_app as jax_build_app
    from clearml_serving_tpu.serving.model_request_processor import ModelRequestProcessor
    from clearml_serving_tpu_torch.llm.openai_api import build_engine
    from torch_serving import port_app

    cfg = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "max_batch": 2,
           "max_seq_len": 160, "prefill_buckets": [32, 64, 128], "cache": "paged",
           "page_size": 4, "pipeline_depth": 1, "scheduler": "two_dispatch", "seed": 0,
           "prefix_cache": 16, "prefix_block": 16}
    system = {"role": "system", "content": "answer in one short line"}
    bodies = [{"messages": [system, {"role": "user", "content": "hello"}], "max_tokens": 8},
              {"messages": [system, {"role": "user", "content": "hello"}], "max_tokens": 8},
              {"messages": [system, {"role": "user", "content": "sea"}], "max_tokens": 8}]

    async def chats(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            out = []
            for body in bodies:
                r = await client.post("/serve/openai/v1/chat/completions",
                                      json=dict(body, model="tiny_llm"))
                assert r.status == 200, await r.text()
                out.append((await r.json())["choices"][0]["message"]["content"])
            return out
        finally:
            await client.close()

    old = os.environ.get("TPUSERVE_STATE_ROOT")
    os.environ["TPUSERVE_STATE_ROOT"] = str(tmp_path)
    try:
        mrp = ModelRequestProcessor(state_root=str(tmp_path), force_create=True, name="llm")
        mrp.add_endpoint(ModelEndpoint(engine_type="llm", serving_url="tiny_llm",
                                       auxiliary_cfg={"engine": dict(cfg)}))
        mrp.serialize()
        mrp.deserialize(skip_sync=True)
        want = asyncio.run(chats(jax_build_app(mrp)))
        jax_engine = mrp._engine_processor_lookup["tiny_llm"].engine
        np_params = jax.tree.map(np.asarray, jax_engine.params)
        jax_hits = jax_engine._prefix.stats()["hits"]
    finally:
        if old is None:
            os.environ.pop("TPUSERVE_STATE_ROOT", None)
        else:
            os.environ["TPUSERVE_STATE_ROOT"] = old
    engine, tok = build_engine(cfg, device="cpu", params=convert_params(np_params, device="cpu"))
    got = asyncio.run(chats(port_app(engine, tok, "tiny_llm")))
    assert got == want and all(got)
    assert engine._prefix.stats()["hits"] == jax_hits >= 2
