"""The port's request lifecycle (``clearml_serving_tpu_torch/errors.py``,
``llm/faults.py`` and the lifecycle of ``llm/engine.py``) against the
reference on the CPU, llama-tiny in float32 with the same weights through
``convert_params``.

- Unit parity: one operation sequence, made with numpy from a seed, goes
  through the reference's ``_ClassedPendingQueue`` and the port's (pop
  order, evictions, live counts, depths), and one score sequence on a
  synthetic clock through both ``_BrownoutController`` (stages, transition
  counts, change times).
- Engine scenarios, each run on the JAX engine and on the port, mirroring
  ``tests/test_chaos.py`` and ``tests/test_scheduler.py``: the outcomes are
  compared, never the timings (error class, ``status``, ``code``, stage,
  shed class, the counters, free pages after recovery or drain, and the
  survivors' greedy token streams).

Deadlines and stalls are driven through the fault seams and through
budgets that have already run out. The tests whose outcome rests on the
wall clock (a watchdog interval against an injected stall, a total budget
against an injected retire stall) keep seconds of margin between the two,
and bound their own run with ``asyncio.wait_for`` and the ``timeout`` mark.
"""

import asyncio
import time

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu import errors as jax_errors
from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
    _BrownoutController as JaxBrownout,
    _ClassedPendingQueue as JaxQueue,
)
from clearml_serving_tpu_torch import errors
from clearml_serving_tpu_torch.llm import faults
from clearml_serving_tpu_torch.llm.engine import (
    PRIORITY_CLASSES,
    GenRequest,
    LLMEngineCore,
    _BrownoutController,
    _ClassedPendingQueue,
)
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
# the reference chaos suite's engine (tests/test_chaos.py _make_engine)
BASE = dict(max_batch=4, max_seq_len=128, prefill_buckets=[16, 32], eos_token_id=257,
            scheduler="two_dispatch")


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


@pytest.fixture(autouse=True)
def clean_faults():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


class Side:
    """One package under test: its engine, request class, fault seams and
    errors."""

    def __init__(self, name, tiny_np):
        self.name = name
        self.tiny_np = tiny_np
        self.Req = JaxGenRequest if name == "jax" else GenRequest
        self.faults = jax_faults if name == "jax" else faults
        self.errors = jax_errors if name == "jax" else errors

    def engine(self, **kw):
        kw = dict(BASE, **kw)
        if self.name == "jax":
            return JaxEngine(models.build_model("llama", TINY), self.tiny_np,
                             cache_mode="paged", **kw)
        return LLMEngineCore(Llama(TINY, convert_params(self.tiny_np, device="cpu")), **kw)


def _both(tiny_np, scenario, timeout=120.0):
    """``scenario(side)``'s outcome on the reference and on the port, each
    in its own event loop, bounded by ``timeout`` seconds."""
    out = {}
    for name in ("jax", "port"):
        out[name] = asyncio.run(asyncio.wait_for(scenario(Side(name, tiny_np)), timeout))
        faults.clear()
        jax_faults.clear()
    return out["jax"], out["port"]


def _err(ex):
    """The comparable outcome of a lifecycle error."""
    return (type(ex).__name__, ex.status, ex.code, getattr(ex, "stage", None),
            getattr(ex, "shed_class", None))


async def _collect(engine, req):
    return [t async for t in engine.generate(req)]


async def _outcome(engine, req):
    """The request's tokens, and its error's outcome (None when it ended)."""
    got = []
    try:
        async for t in engine.generate(req):
            got.append(t)
    except Exception as ex:  # the error is the outcome under test
        return got, _err(ex)
    return got, None


def _pages_back(engine):
    pool = engine.paged_cache.pool
    return pool.free_pages == pool.num_pages - 1 and not engine._quarantine


LIFECYCLE_COUNTERS = ("sheds_queue", "sheds_pool", "deadline_queue", "deadline_ttft",
                      "deadline_total", "watchdog_trips", "step_failures", "preemptions")


def _counters(engine):
    return {k: engine.counters[k] for k in LIFECYCLE_COUNTERS}


# -- unit parity: the classed queue and the brownout controller -----------------


def _queue_ops(seed, n=400):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            deadline = None if rng.random() < 0.3 else float(rng.integers(0, 50))
            ops.append(("put", PRIORITY_CLASSES[rng.integers(0, 3)], deadline,
                        bool(rng.random() < 0.15)))
        elif r < 0.75:
            ops.append(("get",))
        elif r < 0.85:
            ops.append(("shed", PRIORITY_CLASSES[rng.integers(0, 3)]))
        elif r < 0.92:
            ops.append(("cancel", int(rng.integers(0, 10_000))))
        else:
            ops.append(("waiting", PRIORITY_CLASSES[rng.integers(0, 3)]))
    return ops


def _replay_queue(queue_cls, req_cls, ops, floor):
    q = queue_cls(starvation_floor=floor)
    live, trace = [], []
    for op in ops:
        if op[0] == "put":
            _, cls, deadline, resumed = op
            r = req_cls(prompt_ids=[len(live) + 1], max_new_tokens=1, priority=cls)
            r._deadline = deadline
            r.produced = 1 if resumed else 0
            live.append(r)
            q.put_nowait(r)
        elif op[0] == "get":
            try:
                trace.append(("get", q.get_nowait().prompt_ids[0]))
            except asyncio.QueueEmpty:
                trace.append(("get", None))
        elif op[0] == "shed":
            victim = q.shed_lowest(op[1])
            trace.append(("shed", victim.prompt_ids[0] if victim is not None else None))
        elif op[0] == "cancel" and live:
            live[op[1] % len(live)].cancelled = True
        elif op[0] == "waiting":
            trace.append(("waiting", q.waiting(op[1])))
        trace.append(("depths", q.depths(), q.qsize()))
    trace.append(("rest", sorted(r.prompt_ids[0] for r in q.pop_all())))
    return trace


@pytest.mark.parametrize("seed,floor", [(0, 8), (1, 3), (2, 1)])
def test_classed_queue_sequence_equals_reference(seed, floor):
    ops = _queue_ops(seed)
    want = _replay_queue(JaxQueue, JaxGenRequest, ops, floor)
    got = _replay_queue(_ClassedPendingQueue, GenRequest, ops, floor)
    assert got == want
    assert any(t[0] == "shed" and t[1] is not None for t in got)
    assert any(t[0] == "get" and t[1] is not None for t in got)


@pytest.mark.parametrize("seed,dwell", [(0, 2.0), (1, 0.5), (2, 10.0)])
def test_brownout_sequence_equals_reference(seed, dwell):
    rng = np.random.default_rng(seed)
    # a synthetic clock and a score that wanders across every threshold
    now, score, steps = 1000.0, 0.0, []
    for _ in range(500):
        now += float(rng.exponential(0.4))
        score = float(np.clip(score + rng.normal(0, 0.12), 0.0, 1.4))
        steps.append((score, now))
    traces = []
    for cls in (JaxBrownout, _BrownoutController):
        c = cls(dwell=dwell)
        traces.append([(c.update(s, {"queue": s}, now=t), c.transitions, c._changed_at)
                       for s, t in steps])
    assert traces[1] == traces[0]
    assert {stage for stage, _, _ in traces[1]} == {0, 1, 2, 3}


# -- admission ---------------------------------------------------------------------


def test_queue_bound_sheds_with_retry_after(tiny_np):
    """max_batch 1, max_pending 1: A holds the slot, B waits, C is shed
    with a 429 and a Retry-After; B runs once A is gone."""

    async def scenario(s):
        engine = s.engine(max_batch=1, max_pending=1, eos_token_id=None)
        agen = engine.generate(s.Req(prompt_ids=[256, 1], max_new_tokens=10_000))
        await agen.__anext__()
        b = asyncio.ensure_future(_collect(engine, s.Req(prompt_ids=[256, 2],
                                                         max_new_tokens=2)))
        while engine._pending.qsize() < 1:
            await asyncio.sleep(0.005)
        shed = None
        try:
            await _collect(engine, s.Req(prompt_ids=[256, 3], max_new_tokens=2))
        except s.errors.EngineOverloadedError as ex:
            shed = _err(ex) + (ex.retry_after is not None, ex.payload()["class"])
        await agen.aclose()
        out_b = await b
        await engine.wait_drained()
        outcome = dict(shed=shed, b=out_b, counters=_counters(engine),
                       by_class=engine._class_sheds, pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["shed"] == ("EngineOverloadedError", 429, "overloaded", None, "interactive",
                           True, "interactive")
    assert got["counters"]["sheds_queue"] == 1 and len(got["b"]) == 2
    assert got["pages_back"]


def test_injected_admission_and_class_sheds(tiny_np):
    async def scenario(s):
        engine = s.engine()
        out = []
        for point, cls in (("engine.admit", "interactive"), ("engine.admit.class", "batch")):
            s.faults.configure([{"point": point, "times": 1}])
            req = s.Req(prompt_ids=[256], max_new_tokens=1, priority=cls)
            try:
                engine.check_admission(req)
            except s.errors.EngineOverloadedError as ex:
                out.append(_err(ex) + (ex.payload(),))
            engine.check_admission(req)  # the spec fired once
        outcome = dict(sheds=out, counters=_counters(engine), by_class=engine._class_sheds)
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert [e[4] for e in got["sheds"]] == ["interactive", "batch"]
    assert got["by_class"] == {"queue": {"interactive": 1}, "class": {"batch": 1}}


def test_interactive_arrival_evicts_queued_best_effort(tiny_np):
    """At the bound, a higher-class arrival evicts the queued best-effort
    request (its own stream gets the 429) instead of being shed."""

    async def scenario(s):
        engine = s.engine(max_batch=1, max_pending=1, decode_steps=1, eos_token_id=None)
        agen = engine.generate(s.Req(prompt_ids=[1, 2], max_new_tokens=10_000))
        await agen.__anext__()
        be = asyncio.ensure_future(_outcome(engine, s.Req(
            prompt_ids=[1, 3], max_new_tokens=2, priority="best_effort")))
        while engine._pending.qsize() < 1:
            await asyncio.sleep(0.005)
        hi = asyncio.ensure_future(_collect(engine, s.Req(prompt_ids=[1, 4], max_new_tokens=2)))
        be_out = await be
        await agen.aclose()
        hi_out = await hi
        await engine.wait_drained()
        outcome = dict(be=be_out, hi=hi_out, by_class=engine._class_sheds,
                       counters=_counters(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["be"] == ([], ("EngineOverloadedError", 429, "overloaded", None, "best_effort"))
    assert got["by_class"] == {"queue": {"best_effort": 1}} and len(got["hi"]) == 2


def test_stopped_engine_is_unavailable(tiny_np):
    async def scenario(s):
        engine = s.engine()
        engine.stop()
        outcome = await _outcome(engine, s.Req(prompt_ids=[256], max_new_tokens=1))
        with pytest.raises(s.errors.EngineUnavailableError):
            engine.check_admission(s.Req(prompt_ids=[256], max_new_tokens=1))
        return dict(outcome=outcome, ready=engine.is_ready, health=engine.health()["ready"])

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["outcome"] == ([], ("EngineUnavailableError", 503, "unavailable", None, None))
    assert not got["ready"] and not got["health"]


# -- deadlines ---------------------------------------------------------------------


def test_ttft_deadline_on_a_spent_budget(tiny_np):
    """A TTFT budget that runs out before any prefill can finish: 408
    ``ttft`` at the admission's commit; the engine keeps serving."""

    async def scenario(s):
        engine = s.engine()
        spent = await _outcome(engine, s.Req(prompt_ids=[256, 5], max_new_tokens=4,
                                             ttft_timeout=1e-9))
        after = await _collect(engine, s.Req(prompt_ids=[256, 2], max_new_tokens=3))
        await engine.wait_drained()
        outcome = dict(spent=spent, after=after, counters=_counters(engine),
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["spent"] == ([], ("DeadlineExceededError", 408, "deadline_exceeded", "ttft", None))
    assert got["counters"]["deadline_ttft"] == 1 and got["pages_back"]


def test_queue_wait_deadline_expires_parked_request(tiny_np):
    async def scenario(s):
        engine = s.engine(max_batch=1, decode_steps=1, eos_token_id=None)
        agen = engine.generate(s.Req(prompt_ids=[256, 1], max_new_tokens=10_000))
        await agen.__anext__()
        parked = await _outcome(engine, s.Req(prompt_ids=[256, 2], max_new_tokens=2,
                                              queue_timeout=1e-9))
        await agen.aclose()
        await engine.wait_drained()
        outcome = dict(parked=parked, counters=_counters(engine),
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["parked"] == ([], ("DeadlineExceededError", 408, "deadline_exceeded", "queue",
                                  None))
    assert got["counters"]["deadline_queue"] == 1


@pytest.mark.timeout(300)
def test_total_deadline_at_submission_and_mid_decode(tiny_np):
    """A zero budget is a 408 before queueing. A 1.5 s budget whose first
    chunk's retire stalls 4 s (injected) keeps the first token and is cut
    at the next emission; the slot and its pages come back."""

    async def scenario(s):
        engine = s.engine(decode_steps=2, eos_token_id=None)
        warm = await _collect(engine, s.Req(prompt_ids=[256, 3], max_new_tokens=6))
        await engine.wait_drained()
        spent = await _outcome(engine, s.Req(prompt_ids=[256, 3], max_new_tokens=4,
                                             total_timeout=0))
        s.faults.configure([{"point": "engine.decode.stall", "action": "delay",
                             "delay": 4.0, "times": 1}])
        cut = await _outcome(engine, s.Req(prompt_ids=[256, 3], max_new_tokens=100_000,
                                           total_timeout=1.5))
        await engine.wait_drained()
        outcome = dict(spent=spent, cut=cut, warm=warm, counters=_counters(engine),
                       active=engine.active_slots, pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    deadline = ("DeadlineExceededError", 408, "deadline_exceeded", "total", None)
    assert got["spent"] == ([], deadline)
    assert got["cut"] == (got["warm"][:1], deadline)
    assert got["counters"]["deadline_total"] == 2
    assert got["active"] == 0 and got["pages_back"]


# -- watchdog ----------------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("depth", [1, 2])
def test_watchdog_recovery_with_inflight_queue(tiny_np, depth):
    """Three live requests; a 4 s stall of the retire leg (injected) trips
    a 1 s watchdog while chunks are in flight. Only those requests fail
    (503 ``engine_stalled``), the engine reports not-ready until the stale
    leg lands, the pipeline is discarded, every page comes back, and the
    next greedy request equals the same request before the trip."""

    async def scenario(s):
        engine = s.engine(decode_steps=2, watchdog_interval=1.0, page_size=4,
                          pipeline_depth=depth, eos_token_id=None)
        probe = dict(prompt_ids=[256, 9], max_new_tokens=6)
        before = await _collect(engine, s.Req(**probe))
        await engine.wait_drained()
        free0 = engine.paged_cache.pool.free_pages
        victims = [s.Req(prompt_ids=[256, 40 + i], max_new_tokens=600) for i in range(3)]
        tasks = [asyncio.ensure_future(_outcome(engine, v)) for v in victims]
        while not all(v.produced >= 1 for v in victims):
            await asyncio.sleep(0.01)
        s.faults.configure([{"point": "engine.decode.stall", "action": "delay",
                             "delay": 4.0, "times": 1}])
        saw_not_ready = False
        while not all(t.done() for t in tasks):
            saw_not_ready |= not engine.is_ready
            await asyncio.sleep(0.01)
        while not engine.is_ready:
            saw_not_ready = True
            await asyncio.sleep(0.01)
        outcomes = [t.result()[1] for t in tasks]
        after = await _collect(engine, s.Req(**probe))
        await engine.wait_drained()
        outcome = dict(outcomes=outcomes, saw_not_ready=saw_not_ready,
                       trips=engine.counters["watchdog_trips"], before=before, after=after,
                       free_same=engine.paged_cache.pool.free_pages == free0,
                       pages_back=_pages_back(engine), inflight=len(engine._inflight),
                       ready=engine.health()["ready"])
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario, timeout=150.0)
    assert got == want
    assert got["outcomes"] == [("EngineStuckError", 503, "engine_stalled", None, None)] * 3
    assert got["saw_not_ready"] and got["trips"] == 1 and got["ready"]
    assert got["after"] == got["before"]
    assert got["free_same"] and got["pages_back"] and got["inflight"] == 0


@pytest.mark.timeout(300)
def test_slow_dispatch_inside_the_grace_does_not_trip(tiny_np):
    """A dispatch that takes 3 s (an injected delay in the dispatch
    worker, where a first-use kernel build or a graph capture runs) under a
    1 s watchdog stays inside the grace of 10 intervals: no trip, and the
    stream is the undelayed one."""

    async def scenario(s):
        engine = s.engine(decode_steps=2, watchdog_interval=1.0, eos_token_id=None)
        probe = dict(prompt_ids=[256, 12], max_new_tokens=8)
        before = await _collect(engine, s.Req(**probe))
        await engine.wait_drained()
        s.faults.configure([{"point": "engine.decode", "action": "delay", "delay": 3.0,
                             "times": 1}])
        slow = await _collect(engine, s.Req(**probe))
        await engine.wait_drained()
        outcome = dict(before=before, slow=slow, trips=engine.counters["watchdog_trips"],
                       ready=engine.is_ready)
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario, timeout=150.0)
    assert got == want
    assert got["trips"] == 0 and got["slow"] == got["before"] and got["ready"]


# -- step failures -----------------------------------------------------------------


def test_decode_seam_fails_only_the_matched_request(tiny_np):
    """An ``engine.decode`` raise matched to one request fails it with 500
    ``engine_step_failed``; its neighbour's stream is the clean one."""
    marker = 301

    async def scenario(s):
        engine = s.engine(decode_steps=2, eos_token_id=None)
        clean = await _collect(engine, s.Req(prompt_ids=[256, 7], max_new_tokens=9))
        await engine.wait_drained()
        s.faults.configure([{"point": "engine.decode", "match_token": marker, "times": 1}])
        poisoned, healthy = await asyncio.gather(
            _outcome(engine, s.Req(prompt_ids=[256, marker], max_new_tokens=40)),
            _outcome(engine, s.Req(prompt_ids=[256, 7], max_new_tokens=9)))
        await engine.wait_drained()
        outcome = dict(poisoned=poisoned[1], healthy=healthy, clean=clean,
                       failures=engine.counters["step_failures"],
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["poisoned"] == ("EngineStepError", 500, "engine_step_failed", None, None)
    assert got["healthy"] == (got["clean"], None)
    assert got["failures"] == 1 and got["pages_back"]


def test_retire_fault_isolates_matched_request(tiny_np):
    marker = 301

    async def scenario(s):
        engine = s.engine(decode_steps=2, page_size=4, pipeline_depth=2, eos_token_id=None)
        await _collect(engine, s.Req(prompt_ids=[256, 1], max_new_tokens=2))
        await engine.wait_drained()
        s.faults.configure([{"point": "engine.decode.retire", "match_token": marker,
                             "times": 1, "message": "retire blew up"}])
        poisoned, healthy = await asyncio.gather(
            _outcome(engine, s.Req(prompt_ids=[256, marker], max_new_tokens=40)),
            _outcome(engine, s.Req(prompt_ids=[256, 7], max_new_tokens=6)))
        await engine.wait_drained()
        outcome = dict(poisoned=poisoned[1], healthy=healthy,
                       failures=engine.counters["step_failures"],
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["poisoned"] == ("EngineStepError", 500, "engine_step_failed", None, None)
    assert len(got["healthy"][0]) == 6 and got["healthy"][1] is None
    assert got["failures"] == 1 and got["pages_back"]


def test_dispatch_prepare_seam_fails_batch_structurally(tiny_np):
    async def scenario(s):
        engine = s.engine(decode_steps=1)
        await _collect(engine, s.Req(prompt_ids=[256, 1], max_new_tokens=2))
        s.faults.configure([{"point": "engine.dispatch.prepare", "times": 1,
                             "message": "prep seam"}])
        failed = await _outcome(engine, s.Req(prompt_ids=[256, 2], max_new_tokens=8))
        after = await _collect(engine, s.Req(prompt_ids=[256, 3], max_new_tokens=4))
        await engine.wait_drained()
        outcome = dict(failed=failed, after=after,
                       failures=engine.counters["step_failures"],
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["failed"][1] == ("EngineStepError", 500, "engine_step_failed", None, None)
    assert got["failures"] == 1 and got["after"] and got["pages_back"]


def test_drain_seam_fires_at_the_drained_boundary(tiny_np):
    async def scenario(s):
        engine = s.engine(decode_steps=1)
        spec = s.faults.FaultSpec(point="engine.drain", action="delay", times=-1)
        s.faults.configure([spec])
        await _collect(engine, s.Req(prompt_ids=[256, 4], max_new_tokens=2))
        await engine.wait_drained()
        engine.stop()
        return spec.fired

    want, got = _both(tiny_np, scenario)
    assert got == want == 1


# -- preemption --------------------------------------------------------------------


PREEMPT = dict(max_batch=1, max_seq_len=128, prefill_buckets=[32, 64], eos_token_id=None,
               decode_steps=2, page_size=16)
BATCH_PROMPT = [(i * 7 + 3) % 250 + 1 for i in range(17)]


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_greedy_stream_identical_across_batch_preemption(tiny_np, scheduler):
    """A batch stream preempted for an interactive arrival equals its
    unpreempted run token for token, on both packages: the reference's
    victim resumes through a fresh prefill of its history, the port's maps
    its parked KV pages back and decodes on."""
    knobs = dict(PREEMPT, scheduler=scheduler,
                 **({"step_token_budget": 16} if scheduler == "ragged" else {}))

    async def scenario(s):
        control = s.engine(**knobs)
        want = await _collect(control, s.Req(prompt_ids=list(BATCH_PROMPT), max_new_tokens=24,
                                             priority="batch"))
        control.stop()
        engine = s.engine(**knobs)
        batch = s.Req(prompt_ids=list(BATCH_PROMPT), max_new_tokens=24, priority="batch")
        b = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 6:
            await asyncio.sleep(0.005)
        hi = await _collect(engine, s.Req(prompt_ids=[1, 9, 9], max_new_tokens=2))
        got = await b
        await engine.wait_drained()
        outcome = dict(want=want, got=got, hi=hi, preemptions=engine.counters["preemptions"],
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["got"] == got["want"] and len(got["got"]) == 24
    assert got["preemptions"] == 1 and len(got["hi"]) == 2 and got["pages_back"]


def test_preempt_fault_aborts_without_leaking_pages(tiny_np):
    """The first preemption attempt dies at the ``engine.preempt`` seam:
    the victim keeps decoding in its slot, the retry at a later boundary
    preempts, and every page comes back."""

    async def scenario(s):
        engine = s.engine(**PREEMPT)
        batch = s.Req(prompt_ids=[256] + [(i * 3 + 1) % 250 for i in range(16)],
                      max_new_tokens=30, priority="batch")
        b = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 4:
            await asyncio.sleep(0.005)
        spec = s.faults.FaultSpec(point="engine.preempt", times=1)
        s.faults.configure([spec])
        hi = await _collect(engine, s.Req(prompt_ids=[256, 9], max_new_tokens=2))
        out_b = await b
        await engine.wait_drained()
        outcome = dict(hi=len(hi), b=len(out_b), fired=spec.fired,
                       preemptions=engine.counters["preemptions"],
                       pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got == dict(hi=2, b=30, fired=1, preemptions=1, pages_back=True)


def test_preempt_budget_makes_request_immune(tiny_np):
    async def scenario(s):
        engine = s.engine(**dict(PREEMPT, decode_steps=1, prefill_buckets=[16]),
                          preempt_budget=0)
        batch = s.Req(prompt_ids=[1, 2, 3], max_new_tokens=12, priority="batch")
        b = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 2:
            await asyncio.sleep(0.005)
        hi = await _collect(engine, s.Req(prompt_ids=[1, 5], max_new_tokens=2))
        out_b = await b
        await engine.wait_drained()
        outcome = dict(hi=len(hi), b=len(out_b), preemptions=engine.counters["preemptions"])
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want == dict(hi=2, b=12, preemptions=0)


def test_stop_frees_a_queued_victims_pages(tiny_np):
    """stop() while a preempted request waits in the queue (its slot taken
    by a long interactive stream): both end with 503 and every page comes
    back, the victim's parked ones included on the port."""

    async def scenario(s):
        engine = s.engine(**PREEMPT)
        batch = s.Req(prompt_ids=list(BATCH_PROMPT), max_new_tokens=100, priority="batch")
        b = asyncio.ensure_future(_outcome(engine, batch))
        while batch.produced < 4:
            await asyncio.sleep(0.005)
        hi = s.Req(prompt_ids=[1, 9, 9], max_new_tokens=100)
        h = asyncio.ensure_future(_outcome(engine, hi))
        while not (engine.counters["preemptions"] and hi.produced >= 2):
            await asyncio.sleep(0.005)
        queued = engine._pending.qsize()
        engine.stop()
        outcomes = [(await t)[1] for t in (b, h)]
        while not engine._loop_task.done():
            await asyncio.sleep(0.01)
        return dict(queued=queued, outcomes=outcomes, pages_back=_pages_back(engine))

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got == dict(queued=1, pages_back=True, outcomes=[
        ("EngineUnavailableError", 503, "unavailable", None, None)] * 2)


# -- stop --------------------------------------------------------------------------


def test_stop_with_chunks_in_flight_reclaims_pages(tiny_np):
    """stop() while the depth-2 pipeline holds chunks: both consumers end
    with 503 ``unavailable`` and the loop's exit frees every page once the
    chunks in flight landed."""

    async def scenario(s):
        engine = s.engine(decode_steps=2, page_size=4, pipeline_depth=2, eos_token_id=None)
        reqs = [s.Req(prompt_ids=[256, 20 + i], max_new_tokens=10_000) for i in range(2)]
        tasks = [asyncio.ensure_future(_outcome(engine, r)) for r in reqs]
        while not all(r.produced > 2 for r in reqs):
            await asyncio.sleep(0.01)
        engine.stop()
        outcomes = [(await t)[1] for t in tasks]
        while not engine._loop_task.done():
            await asyncio.sleep(0.01)
        return dict(outcomes=outcomes, pages_back=_pages_back(engine),
                    inflight=len(engine._inflight))

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["outcomes"] == [("EngineUnavailableError", 503, "unavailable", None, None)] * 2
    assert got["pages_back"] and got["inflight"] == 0


# -- brownout stage effects ----------------------------------------------------------


def _hold_stage(engine, stage):
    engine._brownout.stage = stage
    engine._brownout._changed_at = time.monotonic()  # the dwell holds it


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_brownout_stage2_caps_batch_tokens_not_interactive(tiny_np, scheduler):
    async def scenario(s):
        knobs = dict(step_token_budget=16) if scheduler == "ragged" else {}
        engine = s.engine(max_batch=2, prefill_buckets=[16], eos_token_id=None, decode_steps=4,
                          brownout=True, brownout_batch_cap=5, brownout_dwell=120.0,
                          scheduler=scheduler, **knobs)
        _hold_stage(engine, 2)
        out_b, out_i = await asyncio.gather(
            _collect(engine, s.Req(prompt_ids=[1, 2], max_new_tokens=50, priority="batch")),
            _collect(engine, s.Req(prompt_ids=[1, 3], max_new_tokens=7)))
        await engine.wait_drained()
        outcome = dict(b=out_b, i=out_i, pages_back=_pages_back(engine))
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert len(got["b"]) == 5 and len(got["i"]) == 7 and got["pages_back"]


def test_brownout_stage3_sheds_best_effort_and_shrinks_the_ragged_budget(tiny_np):
    async def scenario(s):
        engine = s.engine(max_batch=2, prefill_buckets=[16], eos_token_id=None,
                          brownout=True, brownout_dwell=120.0, scheduler="ragged",
                          step_token_budget=128)
        budgets = [engine._effective_token_budget()]
        _hold_stage(engine, 3)
        budgets.append(engine._effective_token_budget())
        budgets.append(engine.lifecycle_stats()["ragged"]["effective_budget"])
        shed = None
        try:
            engine.check_admission(s.Req(prompt_ids=[1], max_new_tokens=1,
                                         priority="best_effort"))
        except s.errors.EngineOverloadedError as ex:
            shed = _err(ex)
        engine.check_admission(s.Req(prompt_ids=[1], max_new_tokens=1))
        engine.check_admission(s.Req(prompt_ids=[1], max_new_tokens=1, priority="batch"))
        _hold_stage(engine, 0)
        budgets.append(engine._effective_token_budget())
        outcome = dict(budgets=budgets, shed=shed, by_class=engine._class_sheds)
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["budgets"] == [128, 18, 18, 128]
    assert got["shed"] == ("EngineOverloadedError", 429, "overloaded", None, "best_effort")
    assert got["by_class"] == {"brownout": {"best_effort": 1}}


SPEC = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 64], eos_token_id=None,
            decode_steps=2, scheduler="ragged", step_token_budget=12, speculation="ngram",
            spec_k=4, spec_ngram=2)


def test_brownout_stage1_parks_speculation(tiny_np):
    """At stage 1 no verify row rides a launch; the greedy streams equal
    those of a plain ragged engine."""

    async def scenario(s):
        prompts = [[5, 9, 2, 17, 5, 9, 2], [3, 3, 7, 3, 3, 7, 3]]
        plain = s.engine(**{k: v for k, v in SPEC.items()
                            if k not in ("speculation", "spec_k", "spec_ngram")})
        want = await asyncio.gather(*(_collect(plain, s.Req(prompt_ids=p, max_new_tokens=10))
                                      for p in prompts))
        plain.stop()
        engine = s.engine(**SPEC, brownout=True, brownout_dwell=120.0)
        _hold_stage(engine, 1)
        got = await asyncio.gather(*(_collect(engine, s.Req(prompt_ids=p, max_new_tokens=10))
                                     for p in prompts))
        await engine.wait_drained()
        outcome = dict(want=want, got=got,
                       verify_rows=engine.lifecycle_stats()["ragged"]["step_rows"]["spec_verify"])
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["got"] == got["want"] and got["verify_rows"] == 0


# -- observability -------------------------------------------------------------------


def test_lifecycle_keys_and_meanings_equal_reference(tiny_np):
    """After a shed, an expired budget and a served request, the lifecycle
    fields of ``lifecycle_stats()`` and ``health()`` hold the reference's
    keys and values."""
    keys = ("queue_depth", "queue_depths", "active_slots", "ready", "sheds", "sheds_by_class",
            "preemptions", "brownout", "deadlines", "watchdog_trips", "step_failures")
    health_keys = ("ready", "stopped", "recovering", "active_slots", "queue_depth",
                   "queue_depths", "preemptions", "brownout", "watchdog_trips",
                   "step_failures")

    async def scenario(s):
        engine = s.engine(max_pending=8, brownout_dwell=120.0)
        s.faults.configure([{"point": "engine.admit.class", "times": 1}])
        with pytest.raises(s.errors.EngineOverloadedError):
            engine.check_admission(s.Req(prompt_ids=[1], max_new_tokens=1, priority="batch"))
        await _outcome(engine, s.Req(prompt_ids=[256, 5], max_new_tokens=2, total_timeout=0))
        await _collect(engine, s.Req(prompt_ids=[256, 6], max_new_tokens=2))
        await engine.wait_drained()
        stats, health = engine.lifecycle_stats(), engine.health()
        # the brownout score reads the pool, whose size differs between
        # the packages' defaults; its stage and signal names do not
        for block in (stats["brownout"], health["brownout"]):
            block.pop("score")
            block["signals"] = sorted(block["signals"])
        outcome = dict(stats={k: stats[k] for k in keys},
                       health={k: health[k] for k in health_keys})
        engine.stop()
        return outcome

    want, got = _both(tiny_np, scenario)
    assert got == want
    assert got["stats"]["sheds_by_class"] == {"class": {"batch": 1}}
    assert got["stats"]["deadlines"] == {"queue": 0, "ttft": 0, "total": 1}
