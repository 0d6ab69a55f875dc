"""The two-dispatch admission of the port (clearml_serving_tpu_torch/llm/
engine.py): prefills in background admission tasks, committed at chunk
boundaries, paced by the prefill gate, with chunked prefill.

The reference's tests on the port: the gate's semantics on the port's copy
of ``_PrefillGate`` (tests/test_llm_engine.py), chunked prefill equal to
the one-dispatch prefill with C = 4 and C = 6 and its mini cache a
multiple of C, brownout stage 3 shrinking the gate's budget
(tests/test_scheduler.py), and a deterministic form of the segment
interleave. Then the port against the JAX engine with the same knobs:
greedy streams byte-equal with chunked prefill off, 4 and 6, at depth 1
and 2, on model-dtype and int8 KV, with more requests than slots. Then the
port alone: a live row decoding through a slow prefill, a failing prefill,
a cancel and a stop during a prefill, each ending with every page back and
the strict ledger's drain audit clean; a commit that finds no pages; and
many admissions under a short interpreter switch interval (llama-tiny,
float32, the JAX weights carried over by ``convert_params``).
"""

import asyncio
import sys
import threading
import time

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu_torch.llm import faults, lifecycle_ledger
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore, _PrefillGate
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ENGINE = dict(max_batch=2, max_seq_len=128, prefill_buckets=[16, 32], eos_token_id=257,
              decode_steps=4)
# the reference test's prompts: 9 tokens (C=4: 4+4+1), 17 tokens (4x4+1)
# and 2 tokens (shorter than C: one dispatch)
CHUNK_PROMPTS = [[256, 5, 9, 13, 2, 7, 40, 41, 42], [256] + list(range(1, 17)), [256, 3]]
# four requests through two slots, every length above C = 6
PROMPTS = [[256] + [(7 * i + 3 * j) % 250 + 1 for j in range(n - 1)]
           for i, n in enumerate((9, 14, 23, 31))]


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


@pytest.fixture(autouse=True)
def _no_faults():
    faults.clear()
    yield
    faults.clear()


def _cfg(kv_quant):
    return dict(TINY, kv_quant=kv_quant) if kv_quant else TINY


def _kw(kv_quant="", **knobs):
    # int8 pools take 32-token pages, the reference's default for them
    return dict(ENGINE, page_size=32 if kv_quant else 16, **knobs)


def _port(tiny_np, kv_quant="", **knobs):
    return LLMEngineCore(Llama(_cfg(kv_quant), convert_params(tiny_np, device="cpu")),
                         **_kw(kv_quant, **knobs))


async def _collect(engine, request):
    return [t async for t in engine.generate(request)]


def _run_group(engine, request_cls, prompts, **req_kw):
    """Submit every prompt at once; the per-prompt streams, after the
    engine drained."""

    async def go():
        outs = await asyncio.gather(*(_collect(engine, request_cls(prompt_ids=list(p), **req_kw))
                                      for p in prompts))
        await engine.wait_drained()
        return outs

    return asyncio.run(asyncio.wait_for(go(), 120))


def _all_pages_back(engine):
    pool = engine.paged_cache.pool
    return (pool.free_pages == pool.num_pages - 1 and not engine._quarantine
            and not engine._admitting and not engine._ready)


# -- the reference's tests on the port -----------------------------------------------


def test_prefill_gate_semantics():
    """Decode-first pacing: open while decode idles, bounded permits while
    it is active, the starvation bound when decode stops depositing."""
    gate = _PrefillGate(segments_per_chunk=2, stall_timeout=0.2)

    # inactive: acquire never blocks and never consumes permits
    t0 = time.perf_counter()
    for _ in range(10):
        gate.acquire()
    assert time.perf_counter() - t0 < 0.05

    # active: the budget is segments_per_chunk; the third acquire waits
    # for a deposit
    gate.set_active(True)
    gate.acquire()
    gate.acquire()
    released = threading.Event()

    def depositor():
        time.sleep(0.05)
        gate.deposit()
        released.set()

    threading.Thread(target=depositor, daemon=True).start()
    t0 = time.perf_counter()
    gate.acquire()  # the deposit's permit, not the 0.2 s stall timeout
    waited = time.perf_counter() - t0
    assert released.is_set() and 0.03 < waited < 0.19

    # the starvation bound: no deposit, proceeds after ~stall_timeout
    gate.deposit()
    gate.acquire()
    gate.acquire()
    t0 = time.perf_counter()
    gate.acquire()
    assert 0.15 < time.perf_counter() - t0 < 1.0

    # deactivating releases a waiter at once
    gate.deposit()
    gate.acquire()
    gate.acquire()
    t0 = time.perf_counter()
    threading.Thread(target=lambda: (time.sleep(0.03), gate.set_active(False)),
                     daemon=True).start()
    gate.acquire()
    assert time.perf_counter() - t0 < 0.15

    # permits are set at a deposit, never banked; a bypass takes none
    gate.set_active(True)
    gate.deposit()
    gate.deposit()
    assert gate._permits == 2
    gate.acquire(bypass=True)
    assert gate._permits == 2
    # brownout's budget clamps the permits and restores on None
    gate.set_budget(1)
    assert gate._spc == 1 and gate._permits == 1
    gate.set_budget(None)
    assert gate._spc == 2


@pytest.mark.parametrize("c", [4, 6])
def test_chunked_prefill_matches_plain(tiny_np, c):
    """Chunked prefill (C-token segments over the mini cache) generates the
    greedy tokens of the one-dispatch prefill, ragged last segments
    included. C = 6 divides no bucket (16, 32): the mini cache is rounded
    up to a multiple of C, or the last segment's write would fall past
    it."""

    async def run(engine):
        return [await _collect(engine, GenRequest(prompt_ids=p, max_new_tokens=5))
                for p in CHUNK_PROMPTS]

    plain = asyncio.run(run(_port(tiny_np)))
    engine = _port(tiny_np, chunked_prefill_size=c)
    assert engine._chunked == c
    sizes, init_cache = [], engine.model.init_cache

    def spy(b, length):
        sizes.append(length)
        return init_cache(b, length)

    engine.model.init_cache = spy
    assert asyncio.run(run(engine)) == plain
    assert sizes and all(s % c == 0 for s in sizes)
    # the 2-token prompt took one dispatch; the other two were chunked
    assert len(sizes) == 2 and engine.counters["prefills"] == 3
    assert _all_pages_back(engine)


def test_brownout_stage3_sets_the_gate_budget(tiny_np):
    """The stage transition to 3 shrinks the per-chunk segment budget to 1
    and a transition below 3 restores the configured value
    (tests/test_scheduler.py's two-dispatch gate hook)."""
    engine = _port(tiny_np, max_seq_len=64, brownout=True, brownout_dwell=0.0,
                   prefill_segments_per_decode=3)
    gate = engine._prefill_gate
    assert gate is not None and gate._spc == 3
    engine._brownout_checked = 0.0
    engine._brownout.update = lambda *a, **k: 3  # force the stage
    engine._brownout.stage = 0
    engine._update_brownout()
    assert gate._spc == 1
    engine._brownout.update = lambda *a, **k: 0
    engine._brownout.stage = 3
    engine._brownout_checked = 0.0
    engine._update_brownout()
    assert gate._spc == 3
    engine.stop()


@pytest.mark.parametrize("knobs,gated", [
    ({}, True), ({"prefill_segments_per_decode": 0}, False),
    ({"prefill_segments_per_decode": None}, False), ({"scheduler": "ragged"}, False),
], ids=["default", "zero", "none", "ragged"])
def test_gate_is_built_on_two_dispatch_only(tiny_np, knobs, gated):
    engine = _port(tiny_np, **knobs)
    assert (engine._prefill_gate is not None) == gated
    if gated:
        assert engine._prefill_gate._spc == 2 and engine._prefill_gate._stall_timeout == 2.0
    engine.stop()


def test_aux_keys_reach_the_engine(tiny_np):
    """The OpenAI front maps the reference's aux keys: ``chunked_prefill``
    (not ``chunked_prefill_size``), ``prefill_segments_per_decode`` (2
    when absent) and ``prefill_stall_timeout``."""
    params = convert_params(tiny_np, device="cpu")
    base = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "cache": "paged",
            "max_batch": 2, "max_seq_len": 128, "prefill_buckets": [32]}
    engine, _tok = build_engine(base, device="cpu", params=params)
    assert engine._chunked == 0 and engine._prefill_gate._spc == 2
    engine.stop()
    engine, _tok = build_engine(dict(base, chunked_prefill=8, prefill_segments_per_decode=3,
                                     prefill_stall_timeout=0.5), device="cpu", params=params)
    gate = engine._prefill_gate
    assert engine._chunked == 8 and gate._spc == 3 and gate._stall_timeout == 0.5
    engine.stop()
    engine, _tok = build_engine(dict(base, prefill_segments_per_decode=0), device="cpu",
                                params=params)
    assert engine._prefill_gate is None
    engine.stop()
    with pytest.raises(ValueError, match="chunked_prefill_size"):
        build_engine(dict(base, chunked_prefill_size=8), device="cpu", params=params)


class _RecordingGate(_PrefillGate):
    """The gate, recording each dispatch it lets through ("P" when paced)
    and each deposit ("D": a decode chunk retired) under its own lock, so
    the record's order is the order in which permits were taken and
    refreshed."""

    def __init__(self, events, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.events = events

    def deposit(self):
        with self._cond:
            super().deposit()
            self.events.append("D")

    def take(self, bypass=False):
        with self._cond:
            paced = self._active and not bypass
            taken = super().take(bypass)
            if taken:
                self.events.append("P" if paced else "p")
            return taken


def test_prefill_segments_interleave_with_decode(tiny_np):
    """While a row decodes, a long prompt's chunked-prefill segment train
    takes at most ``segments_per_chunk`` segments per decode chunk, and the
    admission overlaps decode (the reference's test, made deterministic:
    depth 1, so each dispatch is followed by its own retire; a 10 s stall
    timeout, so no segment times out past the gate; the record taken inside
    the gate's lock, where the permits are counted)."""
    engine = _port(tiny_np, chunked_prefill_size=4, decode_steps=1, pipeline_depth=1,
                   prefill_buckets=[16, 32, 64], eos_token_id=None)
    events = []
    engine._prefill_gate = _RecordingGate(events, segments_per_chunk=1, stall_timeout=10.0)
    dispatch = engine._dispatch_device
    lock = threading.Lock()

    def recorded_dispatch(prep):
        with lock:
            events.append("d")
        return dispatch(prep)

    engine._dispatch_device = recorded_dispatch

    async def run():
        # the first row decodes 100 one-token chunks; the second request is
        # submitted once the first decodes, so its segments meet an active
        # gate: 33 tokens, 9 segments of 4
        agen = engine.generate(GenRequest(prompt_ids=[256, 1, 2], max_new_tokens=100))
        out_a = [await agen.__anext__()]
        b = asyncio.ensure_future(_collect(engine, GenRequest(
            prompt_ids=[256] + list(range(1, 33)), max_new_tokens=2)))
        async for token in agen:
            out_a.append(token)
        return out_a, await b

    out_a, out_b = asyncio.run(asyncio.wait_for(run(), 120))
    assert len(out_a) == 100 and len(out_b) == 2
    seq = "".join(events)
    paced = seq.replace("d", "")
    assert paced.count("P") == 9, seq  # every segment met the active gate
    window = paced[: paced.rindex("D") + 1]
    assert max(len(run_) for run_ in window.split("D")) <= 1, seq
    # the segments overlapped decode: chunks were dispatched between them
    first, last = seq.index("P"), seq.rindex("P")
    assert seq[first:last].count("d") >= 7, seq
    assert _all_pages_back(engine)


def test_interactive_admission_passes_a_gated_segment_train(tiny_np):
    """A one-dispatch interactive admission that arrives while a batch
    admission's segment train waits at the gate is not queued behind the
    train: the train waits for its permits on the event loop, so the
    stream's prefill thread takes the interactive dispatch at once, and
    its first token lands while the train still has segments to go."""
    engine = _port(tiny_np, max_batch=3, chunked_prefill_size=4, decode_steps=1,
                   pipeline_depth=1, prefill_buckets=[16, 32, 64], eos_token_id=None)
    events = []
    engine._prefill_gate = _RecordingGate(events, segments_per_chunk=1, stall_timeout=10.0)

    async def run():
        live = engine.generate(GenRequest(prompt_ids=[256, 1, 2], max_new_tokens=100))
        out_live = [await live.__anext__()]
        # 33 tokens: 9 segments of 4, one per decode chunk
        batch = asyncio.ensure_future(_collect(engine, GenRequest(
            prompt_ids=[256] + list(range(1, 33)), max_new_tokens=2, priority="batch")))
        while events.count("P") < 2:
            await asyncio.sleep(0.001)
        mark = len(events)
        inter = engine.generate(GenRequest(prompt_ids=[256, 7, 8], max_new_tokens=2,
                                           priority="interactive"))
        out_inter = [await inter.__anext__()]
        paced_at_first = events.count("P")
        out_inter += [t async for t in inter]
        out_batch = await batch
        out_live += [t async for t in live]
        return out_live, out_batch, out_inter, mark, paced_at_first

    out_live, out_batch, out_inter, mark, paced = asyncio.run(asyncio.wait_for(run(), 120))
    assert len(out_live) == 100 and len(out_batch) == 2 and len(out_inter) == 2
    seq = "".join(events)
    assert seq.count("P") == 9, seq
    # the interactive dispatch went through between two of the train's
    # segments, and its first token came before the train's last one
    assert seq.index("p", mark) < seq.rindex("P"), seq
    assert paced < 9, seq
    assert _all_pages_back(engine)


# -- the port against the JAX engine ---------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("chunk", [None, 4, 6], ids=["unchunked", "c4", "c6"])
def test_greedy_streams_match_reference(tiny_np, kv_quant, depth, chunk):
    """Four requests through two slots, admissions prefilling beside
    decode, the same knobs on both sides (the gate on at 2 segments per
    chunk, its default): byte-equal greedy streams and every page back."""
    knobs = dict(pipeline_depth=depth, chunked_prefill_size=chunk,
                 prefill_segments_per_decode=2)
    jax_engine = JaxEngine(models.build_model("llama", _cfg(kv_quant)), tiny_np,
                           cache_mode="paged", scheduler="two_dispatch", **_kw(kv_quant, **knobs))
    want = _run_group(jax_engine, JaxGenRequest, PROMPTS, max_new_tokens=11)
    jax_engine.stop()
    port = _port(tiny_np, kv_quant, **knobs)
    got = _run_group(port, GenRequest, PROMPTS, max_new_tokens=11)
    port.stop()
    assert got == want
    assert all(len(s) >= 1 for s in got) and max(len(s) for s in got) > 4
    assert port.counters["prefills"] == len(PROMPTS)
    assert _all_pages_back(port)


# -- the port alone: concurrency, failure, cancel and stop -------------------------------


def test_live_row_decodes_through_a_slow_prefill(tiny_np):
    """A live row keeps emitting while another request's prefill runs for
    at least 0.3 s in its worker (the reference's overlapped admission):
    no decode chunk waits for a prefill."""
    engine = _port(tiny_np, eos_token_id=None)
    prefill = engine.model.prefill
    emitted, during = [], []

    def slow_prefill(tokens, seq_lens):
        if int(seq_lens[0]) == len(PROMPTS[1]):
            start, t0 = len(emitted), time.monotonic()
            deadline = t0 + 30.0
            while (time.monotonic() - t0 < 0.3 or len(emitted) < start + 8) \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            during.append(len(emitted) - start)
        return prefill(tokens, seq_lens)

    engine.model.prefill = slow_prefill

    async def run():
        async def live():
            async for t in engine.generate(GenRequest(prompt_ids=PROMPTS[0],
                                                      max_new_tokens=60)):
                emitted.append(t)

        task = asyncio.ensure_future(live())
        while len(emitted) < 2:
            await asyncio.sleep(0.001)
        out = await _collect(engine, GenRequest(prompt_ids=PROMPTS[1], max_new_tokens=6))
        await task
        await engine.wait_drained()
        return out

    out = asyncio.run(asyncio.wait_for(run(), 120))
    assert during and during[0] >= 8
    assert len(out) == 6 and len(emitted) == 60
    assert _all_pages_back(engine)
    # the admission's stream is the one it has alone
    alone = _port(tiny_np, eos_token_id=None)
    assert asyncio.run(_collect(alone, GenRequest(prompt_ids=PROMPTS[1],
                                                  max_new_tokens=6))) == out


@pytest.fixture
def strict_ledger(monkeypatch):
    monkeypatch.setenv("TPUSERVE_LEDGER", "strict")
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    yield
    lifecycle_ledger.get().reset(strict=False)
    lifecycle_ledger.disarm()


def _cached_port(tiny_np, **knobs):
    """A strict-ledger engine with the prefix cache: the admissions below
    hold a prefix hit's pin while they prefill."""
    engine = _port(tiny_np, prefix_cache=64, prefix_block=16, eos_token_id=None, **knobs)
    assert engine._ledger is not None
    engine._ledger.reset(strict=True)
    return engine


def _drain_clean(engine):
    """Every page back, the strict ledger's drain audit clean (it raises on
    a leak) and nothing outstanding but the cache's own references."""
    assert _all_pages_back_or_cached(engine)
    engine._ledger.check("drain", drained=True, domains=engine._ledger_domains())
    stats = engine._ledger.stats()
    assert stats["leaks"] == 0 and stats["double_releases"] == 0
    for resource, n in stats["outstanding"].items():
        if lifecycle_ledger.RESOURCES[resource]["drain_zero"]:
            assert n == 0, resource


def _all_pages_back_or_cached(engine):
    pool = engine.paged_cache.pool
    cached = engine._prefix.cached_pages if engine._prefix is not None else 0
    return (pool.free_pages + cached == pool.num_pages - 1 and not engine._admitting
            and not engine._ready and not engine._quarantine
            and all(r is None for r in engine._slot_req))


# a head stored by a first request, then hit by the requests under test:
# their tails prefill in 16-token segments through prefill_chunk
HEAD = [256] + [(5 * j) % 250 + 1 for j in range(31)]


def _tail(k, n=20):
    return [(11 * k + 3 * j) % 250 + 1 for j in range(n)]


def test_failing_prefill_fails_only_its_request(tiny_np, strict_ledger):
    """The ``engine.prefill`` seam raises in one admission's worker: that
    request fails, the live row and a later admission go on, and the
    failed admission's slot comes back."""
    engine = _cached_port(tiny_np)
    victim = HEAD + [499] + _tail(1)

    async def run():
        await _collect(engine, GenRequest(prompt_ids=HEAD + _tail(0), max_new_tokens=2))
        faults.configure([{"point": "engine.prefill", "action": "raise", "times": 1,
                           "match_token": 499}])
        live = asyncio.ensure_future(_collect(engine, GenRequest(
            prompt_ids=HEAD + _tail(2), max_new_tokens=30)))
        with pytest.raises(faults.InjectedFault):
            await _collect(engine, GenRequest(prompt_ids=victim, max_new_tokens=8))
        after = await _collect(engine, GenRequest(prompt_ids=HEAD + _tail(3),
                                                  max_new_tokens=8))
        out = await live
        await engine.wait_drained()
        return out, after

    out, after = asyncio.run(asyncio.wait_for(run(), 120))
    assert len(out) == 30 and len(after) == 8
    assert engine._prefix.stats()["hits"] >= 2
    _drain_clean(engine)
    engine.stop()


def _slow_tail(engine, entered: threading.Event, hold: float = 0.3):
    """Make the hit tail's first ``prefill_chunk`` segment take ``hold``
    seconds in the worker, with the hit's pin held, and flag its start."""
    chunk = engine.model.prefill_chunk

    def slow(*args, **kwargs):
        if not entered.is_set():
            entered.set()
            time.sleep(hold)
        return chunk(*args, **kwargs)

    engine.model.prefill_chunk = slow


def test_cancel_during_prefill_is_cleaned_up(tiny_np, strict_ledger):
    """A request cancelled while its admission prefills (its hit pinned):
    the commit drops it, the pin and the slot come back, the consumer ends
    without an error, and the live row is untouched."""
    engine = _cached_port(tiny_np)
    entered = threading.Event()

    async def run():
        await _collect(engine, GenRequest(prompt_ids=HEAD + _tail(0), max_new_tokens=2))
        _slow_tail(engine, entered)
        live = asyncio.ensure_future(_collect(engine, GenRequest(
            prompt_ids=[256, 7, 8, 9], max_new_tokens=40)))
        request = GenRequest(prompt_ids=HEAD + _tail(5), max_new_tokens=8)
        gen = engine.generate(request)
        first = asyncio.ensure_future(gen.__anext__())
        while not entered.is_set():
            await asyncio.sleep(0.001)
        # still prefilling, the hit's pages pinned by the worker
        assert engine._admitting and engine.paged_cache.pool._pins
        request.cancel()
        with pytest.raises(StopAsyncIteration):
            await first
        out = await live
        await engine.wait_drained()
        return out, request

    out, request = asyncio.run(asyncio.wait_for(run(), 120))
    assert len(out) == 40 and request.error is None and request.produced == 0
    _drain_clean(engine)
    engine.stop()


def test_stop_during_prefill_is_cleaned_up(tiny_np, strict_ledger):
    """``stop()`` while an admission prefills (its hit pinned): the live
    row and the admission fail with 503, the admission's pin drops when its
    worker returns, and every page comes back."""
    engine = _cached_port(tiny_np)
    entered = threading.Event()

    async def run():
        await _collect(engine, GenRequest(prompt_ids=HEAD + _tail(0), max_new_tokens=2))
        _slow_tail(engine, entered)
        live = asyncio.ensure_future(_collect(engine, GenRequest(
            prompt_ids=[256, 7, 8, 9], max_new_tokens=100)))
        admitted = asyncio.ensure_future(_collect(engine, GenRequest(
            prompt_ids=HEAD + _tail(6), max_new_tokens=8)))
        while not entered.is_set():
            await asyncio.sleep(0.001)
        engine.stop()
        results = await asyncio.gather(live, admitted, return_exceptions=True)
        await asyncio.gather(*engine._admission_tasks)
        await engine.wait_drained()
        return results

    results = asyncio.run(asyncio.wait_for(run(), 120))
    assert [type(r).__name__ for r in results] == ["EngineUnavailableError"] * 2
    _drain_clean(engine)


def test_commit_without_pages_fails_only_its_request(tiny_np):
    """Two admissions prefill at once into a pool that holds one of them:
    page pressure is decided at the commit, on the loop thread, where the
    second one fails alone (MemoryError) and its slot comes back; the
    first decodes to its end."""
    # 40-token prompts need 3 pages of 16 each (with a 4-token chunk's
    # extension): the pool's 4 usable pages hold one
    engine = _port(tiny_np, num_pages=5, eos_token_id=None)
    commit = engine._commit_ready

    def together():
        if len(engine._ready) >= 2:
            commit()

    engine._commit_ready = together
    prompts = [[256] + [(3 * i + 5 * j) % 250 + 1 for j in range(39)] for i in range(2)]

    async def run():
        outs = await asyncio.gather(*(_collect(engine, GenRequest(prompt_ids=p,
                                                                  max_new_tokens=4))
                                      for p in prompts), return_exceptions=True)
        await engine.wait_drained()
        return outs

    outs = asyncio.run(asyncio.wait_for(run(), 120))
    kinds = sorted(type(o).__name__ for o in outs)
    assert kinds == ["MemoryError", "list"], outs
    assert [len(o) for o in outs if isinstance(o, list)] == [4]
    assert _all_pages_back(engine)


def test_concurrent_admissions_under_a_short_switch_interval(tiny_np):
    """24 requests through 8 slots, admission workers switching the
    interpreter every microsecond beside the loop's dispatch and retire
    threads: every prefill is counted once (the workers' counter updates
    are locked), every greedy stream is the one the same requests give at
    the default interval, and every page comes back."""
    prompts = [[256] + [(5 * i + 7 * j) % 250 + 1 for j in range(6 + i % 9)]
               for i in range(24)]
    outs = {}
    for label, interval in (("default", None), ("short", 1e-6)):
        engine = _port(tiny_np, max_batch=8, eos_token_id=None)
        old = sys.getswitchinterval()
        try:
            if interval:
                sys.setswitchinterval(interval)
            outs[label] = _run_group(engine, GenRequest, prompts, max_new_tokens=6)
        finally:
            sys.setswitchinterval(old)
        assert engine.counters["prefills"] == len(prompts)
        assert _all_pages_back(engine)
        engine.stop()
    assert outs["short"] == outs["default"]
    assert all(len(s) == 6 for s in outs["short"])
