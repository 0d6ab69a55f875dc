"""The sampling surface of the port's engine (clearml_serving_tpu_torch/
llm/engine.py, llm/decode_graph.py) against the JAX engine on the same
llama-tiny float32 weights (``convert_params``):

- seeded sampled streams (temperature 0.8, top_p 0.9) with penalties,
  logit bias and ``min_tokens`` equal token for token under both
  schedulers at depth 1 and 2, three requests through two slots (one
  admitted mid-decode), with their logprob entries within 1e-5 and equal
  top ids;
- the same on a prefix-cache hit and through a host-tier promotion;
- under ``ragged`` + ``speculation: ngram`` (chain and tree): rows with
  extras or logprobs ride the launches as plain rows and equal their
  unspeculated streams; a logprob row beside a speculating greedy row;
- a seeded stream independent of the batch around it;
- ``score_prompt`` within 1e-5 with equal ranks and top ids;
- preemption never picks a slot with extras or logprobs;
- every validation error with the reference's message, and the commit's
  reset of a reused slot's rows.
"""

import asyncio

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ENGINE = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 32, 64], eos_token_id=257,
              decode_steps=4, cache_mode="paged", page_size=16)
LP_TOL = 1e-5
PROMPTS = [[256] + [(7 * i + 3 * j) % 250 + 1 for j in range(11)] for i in range(3)]
# three seeded sampled requests, each with a different extra; logprobs on
# two of them
SAMPLED = [
    dict(temperature=0.8, top_p=0.9, seed=11, presence_penalty=0.5, frequency_penalty=0.3,
         repetition_penalty=1.2, logit_bias={65: 2.0, 257: -3.0}, min_tokens=5, logprobs=3),
    dict(temperature=0.8, top_p=0.9, seed=12, min_tokens=4, logit_bias={257: 4.0},
         stop_token_ids=[257, 70], logprobs=0),
    dict(temperature=0.8, top_p=0.9, seed=2 ** 31 - 1, repetition_penalty=0.8),
]


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _jax(tiny_np, **kw):
    return JaxEngine(models.build_model("llama", TINY), tiny_np, **dict(ENGINE, **kw))


def _port(tiny_np, **kw):
    return LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **dict(ENGINE, **kw))


def _run(engine, request_cls, specs, max_new=20):
    """Submit every (prompt, kwargs) at once: per request (tokens, logprob
    entries), after the engine drained."""

    async def go():
        async def one(ids, kw):
            r = request_cls(prompt_ids=list(ids), max_new_tokens=max_new, **kw)
            return [t async for t in engine.generate(r)], r.logprob_entries

        outs = await asyncio.gather(*(one(p, kw) for p, kw in specs))
        await engine.wait_drained()
        return outs

    return asyncio.run(go())


def _same_entries(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and g["top_ids"] == w["top_ids"]
        assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
        np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"], atol=LP_TOL, rtol=0)


def _same(got, want):
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        _same_entries(gl, wl)


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_seeded_extras_streams_equal_the_reference(tiny_np, scheduler, depth):
    specs = list(zip(PROMPTS, SAMPLED))
    kw = dict(scheduler=scheduler, pipeline_depth=depth)
    jax_engine = _jax(tiny_np, **kw)
    want = _run(jax_engine, JaxGenRequest, specs)
    jax_engine.stop()
    port = _port(tiny_np, **kw)
    got = _run(port, GenRequest, specs)
    _same(got, want)
    # the floors held: no stop token before min_tokens
    assert all(len(t) >= 5 for t, _ in got[:1]) and len(got[1][0]) >= 4
    assert got[0][1] and got[1][1] and not got[2][1]
    assert port.paged_cache.pool.free_pages == port.paged_cache.pool.num_pages - 1
    port.stop()


def test_seeded_stream_is_independent_of_the_batch(tiny_np):
    """A seeded request alone, and beside two others (admitted after it,
    mid-decode), gives the same tokens, at depth 2."""
    alone = _port(tiny_np)
    want = _run(alone, GenRequest, [(PROMPTS[0], SAMPLED[0])])[0]
    alone.stop()
    crowd = _port(tiny_np, max_batch=3)

    async def go():
        first = GenRequest(prompt_ids=list(PROMPTS[0]), max_new_tokens=20, **SAMPLED[0])
        task = asyncio.ensure_future(_collect(crowd, first))
        await asyncio.sleep(0)
        others = [_collect(crowd, GenRequest(prompt_ids=list(p), max_new_tokens=12,
                                             temperature=1.0, seed=99))
                  for p in PROMPTS[1:]]
        await asyncio.gather(*others)
        return await task, first.logprob_entries

    got = asyncio.run(go())
    crowd.stop()
    assert got[0] == want[0]
    _same_entries(got[1], want[1])


async def _collect(engine, request):
    return [t async for t in engine.generate(request)]


PREFIX = dict(prefix_cache=64, prefix_block=16)
HEAD = [(7 * i + 3) % 100 + 1 for i in range(36)]   # two cached blocks


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_prefix_hit_and_promoted_streams_equal_the_reference(tiny_np, scheduler):
    """A cold admission stores the prompt's head; the same seeded request
    again hits it, then, after the run is demoted to the host tier, hits
    it through a promotion: each stream the JAX engine's."""
    spec = dict(SAMPLED[0])
    kw = dict(PREFIX, scheduler=scheduler, prefix_cache_host_pages=16)
    out = {}
    for name, build, cls in (("jax", _jax, JaxGenRequest), ("port", _port, GenRequest)):
        engine = build(tiny_np, **kw)
        cold = _run(engine, cls, [(HEAD, spec)])[0]
        hit = _run(engine, cls, [(HEAD, spec)])[0]
        engine._prefix.spill(0)
        promoted = _run(engine, cls, [(HEAD, spec)])[0]
        out[name] = (cold, hit, promoted, engine._prefix.stats()["hits_by_tier"])
        engine.stop()
    for got, want in zip(out["port"][:3], out["jax"][:3]):
        _same([got], [want])
    assert out["port"][3] == out["jax"][3] == {"hbm": 1, "host": 1}


SPEC_A = [5, 9, 2, 17, 5, 9, 2]
SPEC_B = [3, 3, 7, 3, 3, 7, 3]
RAGGED = dict(scheduler="ragged", step_token_budget=12, decode_steps=2)
SPEC = dict(speculation="ngram", spec_k=4, spec_ngram=2)


@pytest.mark.parametrize("tree", [False, True], ids=["chain", "tree"])
def test_extras_rows_under_speculation_equal_their_plain_streams(tiny_np, tree):
    """The reference's ``test_extras_disable_speculation_but_match_plain``
    and ``test_speculative_mixed_batch_logprobs`` on the port: a greedy row
    with penalties and a seeded logprob row ride the verify launches as
    plain rows beside a speculating greedy row; every stream and entry
    equals the unspeculated engine's, and the extras rows never verify."""
    specs = [(SPEC_A, dict(presence_penalty=10.0)),
             (SPEC_B, {}),
             ([256, 4], dict(temperature=0.8, seed=7, logprobs=2))]
    plain = _port(tiny_np, max_batch=3, **RAGGED)
    want = _run(plain, GenRequest, specs, max_new=10)
    plain.stop()
    spec_kw = dict(SPEC, spec_tree=True, spec_branch=2) if tree else SPEC
    engine = _port(tiny_np, max_batch=3, **RAGGED, **spec_kw)
    verified = []
    variant_of = engine._ragged_variant

    def spy(plan):
        # a launch with verify rows: the slots its acceptance runs on
        if plan["row_logit_idx"] is not None:
            verified.append(np.nonzero(plan["spec_mask"] | plan["sspec_mask"])[0].tolist())
        return variant_of(plan)

    engine._ragged_variant = spy
    got = _run(engine, GenRequest, specs, max_new=10)
    engine.stop()
    _same(got, want)
    assert verified and all(slots == [1] or slots == [] for slots in verified)
    assert engine.counters["ragged_verify_steps"] > 0
    # the JAX engine agrees on the speculating batch
    jax_engine = _jax(tiny_np, max_batch=3, eos_token_id=257, **RAGGED, **spec_kw)
    ref = _run(jax_engine, JaxGenRequest, specs, max_new=10)
    jax_engine.stop()
    _same(got, ref)


@pytest.mark.parametrize("n", [2, 17, 40])
def test_score_prompt_equals_the_reference(tiny_np, n):
    ids = [256] + [(13 * i + 5) % 250 + 1 for i in range(n - 1)]
    jax_engine = _jax(tiny_np)
    want = jax_engine.score_prompt(ids)
    jax_engine.stop()
    port = _port(tiny_np)
    got = port.score_prompt(ids)
    port.stop()
    assert len(got) == len(want) == n - 1
    for g, w in zip(got, want):
        assert (g["id"], g["rank"], g["top_ids"]) == (w["id"], w["rank"], w["top_ids"])
        assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
        np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"], atol=LP_TOL, rtol=0)


def test_score_prompt_blocks_agree_with_one_block(tiny_np, monkeypatch):
    """The 256-position blocks are an order of work, not a result: blocks
    of 7 give the entries of one block."""
    from clearml_serving_tpu_torch.llm import engine as engine_mod

    ids = [256] + [(5 * i + 1) % 250 + 1 for i in range(30)]
    port = _port(tiny_np)
    whole = port.score_prompt(ids)
    monkeypatch.setattr(engine_mod, "_SCORE_BLOCK", 7)
    blocked = port.score_prompt(ids)
    port.stop()
    for a, b in zip(whole, blocked):
        assert (a["rank"], a["top_ids"]) == (b["rank"], b["top_ids"])
        assert abs(a["logprob"] - b["logprob"]) <= 1e-6


def test_preemption_skips_extras_and_logprob_slots(tiny_np):
    """Batch-class slots with extras or logprobs are never victims: an
    interactive arrival waits for a plain batch slot."""
    engine = _port(tiny_np, max_batch=2, preempt_batch=True, max_pending=8)
    long = dict(priority="batch", max_new_tokens=60)

    async def go():
        extras = GenRequest(prompt_ids=list(PROMPTS[0]), seed=3, temperature=0.9, **long)
        lp = GenRequest(prompt_ids=list(PROMPTS[1]), logprobs=1, **long)
        tasks = [asyncio.ensure_future(_collect(engine, r)) for r in (extras, lp)]
        while engine.active_slots < 2 or min(extras.produced, lp.produced) < 2:
            await asyncio.sleep(0.01)
        hi = GenRequest(prompt_ids=list(PROMPTS[2]), max_new_tokens=4)
        await _collect(engine, hi)
        await asyncio.gather(*tasks)
        return extras, lp

    extras, lp = asyncio.run(go())
    engine.stop()
    assert engine.counters["preemptions"] == 0
    assert extras._preempt_count == lp._preempt_count == 0
    assert len(lp.logprob_entries) == lp.produced == 60


BAD = [
    dict(logit_bias={"x": 1.0}),
    dict(logit_bias={999999: 1.0}),
    dict(repetition_penalty=0.0),
    dict(min_tokens=-1),
    dict(min_tokens=50, max_new_tokens=10),
    dict(min_tokens=2, stop_token_ids=list(range(9))),
    dict(logprobs=-1),
    dict(logprobs=21),
]


@pytest.mark.parametrize("bad", BAD, ids=["bias_key", "bias_range", "repetition", "min_neg",
                                          "min_over_max", "min_stop_ids", "lp_neg", "lp_k"])
def test_validation_errors_are_the_references(tiny_np, bad):
    kw = dict(dict(prompt_ids=[256, 1, 2], max_new_tokens=10), **bad)
    msgs = []
    for build, cls in ((_jax, JaxGenRequest), (_port, GenRequest)):
        engine = build(tiny_np)
        with pytest.raises(ValueError) as info:
            engine.validate(cls(**kw))
        msgs.append(str(info.value))
        engine.stop()
    assert msgs[0] == msgs[1]


def test_reused_slot_starts_from_reset_rows(tiny_np):
    """A slot that served a request with bias and penalties serves a greedy
    request with penalties and no bias next: the stream equals the same
    request on a fresh engine (the commit reset the histogram, bias and
    prompt rows), at depth 1 and 2."""
    nxt = dict(presence_penalty=0.5, frequency_penalty=0.2, repetition_penalty=1.1)
    for depth in (1, 2):
        fresh = _port(tiny_np, max_batch=1, pipeline_depth=depth)
        want = _run(fresh, GenRequest, [(PROMPTS[2], nxt)])[0]
        fresh.stop()
        engine = _port(tiny_np, max_batch=1, pipeline_depth=depth)
        _run(engine, GenRequest, [(PROMPTS[0], dict(SAMPLED[0], logit_bias={97: 30.0}))])
        assert engine._extras is not None
        got = _run(engine, GenRequest, [(PROMPTS[2], nxt)])[0]
        engine.stop()
        assert got[0] == want[0]


def test_slot_after_a_watchdog_trip_starts_from_reset_rows(tiny_np):
    """Depth 2, one slot: a biased request's chunks are in flight when a
    3 s retire stall trips a 1 s watchdog; the pipeline is discarded with
    a histogram update already run. The slot's next request (penalties,
    no bias) gives the stream of a fresh engine."""
    from clearml_serving_tpu_torch.llm import faults

    nxt = dict(presence_penalty=0.5, frequency_penalty=0.2)
    fresh = _port(tiny_np, max_batch=1)
    want = _run(fresh, GenRequest, [(PROMPTS[2], nxt)])[0]
    fresh.stop()
    engine = _port(tiny_np, max_batch=1, watchdog_interval=1.0)

    async def go():
        victim = GenRequest(prompt_ids=list(PROMPTS[0]), max_new_tokens=600,
                            logit_bias={97: 30.0}, presence_penalty=0.1)
        task = asyncio.ensure_future(_collect(engine, victim))
        while victim.produced < 2 or not engine._inflight:
            await asyncio.sleep(0.005)
        faults.configure([{"point": "engine.decode.stall", "action": "delay", "delay": 3.0,
                           "times": 1}])
        try:
            with pytest.raises(Exception) as info:
                await task
        finally:
            faults.clear()
        while not engine.is_ready:
            await asyncio.sleep(0.01)
        nxt_req = GenRequest(prompt_ids=list(PROMPTS[2]), max_new_tokens=20, **nxt)
        return type(info.value).__name__, await _collect(engine, nxt_req)

    try:
        err, got = asyncio.run(asyncio.wait_for(go(), 120))
    finally:
        engine.stop()
    assert err == "EngineStuckError" and engine.counters["watchdog_trips"] == 1
    assert got == want[0]
