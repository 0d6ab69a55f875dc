"""Guided decoding in the port's engine (clearml_serving_tpu_torch/llm/
engine.py, llm/decode_graph.py) against the JAX engine on the same
llama-tiny float32 weights (``convert_params``) and ``ByteTokenizer(512)``:

- mixed-grammar batches (a regex, ``json_object``, a JSON schema with an
  enum, and an unguided row), greedy and seeded sampled (temperature 0.9,
  one row with penalties and logprobs), equal token for token under
  two-dispatch at depth 1 and 2 and under ``ragged`` with multi-step
  windows, one guided admission arriving mid-decode; logprob entries
  within 1e-5 with equal top ids; a grammar growing the tables into a
  larger bucket while a chunk is in flight at depth 2;
- ``ragged`` with tree speculation: a guided row beside a greedy verify
  row; the guided row never verifies and every stream is the JAX tree
  engine's;
- a prefix-cache hit of a guided chat;
- an unguided request reusing a guided request's freed slot at depth 2
  decodes unconstrained, as at depth 1 (the reference's depth-2 engine
  constrains it, ROADMAP §3);
- the registry: references at 0 after a cancel during prefill, after a
  drain and across a rebuild of the tables; the state-budget error; a
  guided slot never preempted; the ledger's ``guided.ref`` clean at drain
  and a lost release named; ``health()["guided"]``;
- a chunk with no guided slot keeps the plain variant keys;
- the validation errors, with the reference's messages."""

import asyncio
import json
import time

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm import guided as jax_guided
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from clearml_serving_tpu_torch.llm import engine as engine_module
from clearml_serving_tpu_torch.llm import faults, lifecycle_ledger
from clearml_serving_tpu_torch.llm import guided as port_guided
from clearml_serving_tpu_torch.llm.decode_graph import ChunkVariant
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ENGINE = dict(max_batch=4, max_seq_len=96, prefill_buckets=[16, 32, 64], eos_token_id=257,
              decode_steps=4, cache_mode="paged", page_size=16)
LP_TOL = 1e-5
PROMPTS = [[256] + [(7 * i + 3 * j) % 250 + 1 for j in range(11)] for i in range(5)]
SCHEMA = json.dumps({"type": "object", "properties": {
    "dir": {"enum": ["north", "south"]}, "n": {"type": "integer"},
    "ok": {"type": "boolean"}}, "required": ["dir", "n", "ok"]})
GRAMMARS = [("regex", "(north|south|east|west)"), ("json_object", ""),
            ("json_schema", SCHEMA), None, ("regex", "[a-z]{2,6}( [a-z]{2,6}){0,3}\\.")]
SAMPLED = [dict(temperature=0.9, seed=5, logprobs=2), dict(temperature=0.9, seed=6),
           dict(temperature=0.9, seed=7, presence_penalty=0.4, repetition_penalty=1.2),
           dict(), dict(temperature=0.9, seed=8, logprobs=0)]


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _jax(tiny_np, **kw):
    return JaxEngine(models.build_model("llama", TINY), tiny_np,
                     tokenizer=JaxByteTokenizer(512), **dict(ENGINE, **kw))


def _port(tiny_np, **kw):
    kw.setdefault("tokenizer", ByteTokenizer(512))
    return LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **dict(ENGINE, **kw))


def _spec(mod, grammar):
    return None if grammar is None else mod.GuidedSpec(*grammar)


def _run(engine, request_cls, mod, rows, max_new=24, late=()):
    """Submit each (prompt, grammar, kwargs) row; the rows of ``late``
    wait for the first row's first token (a mid-decode admission). Per row
    (tokens, logprob entries), after the engine drained."""

    async def go():
        first = asyncio.Event()

        async def one(i, ids, grammar, kw):
            if i in late:
                await first.wait()
            r = request_cls(prompt_ids=list(ids), max_new_tokens=max_new,
                            guided=_spec(mod, grammar), **kw)
            out = []
            async for t in engine.generate(r):
                out.append(t)
                first.set()
            first.set()
            return out, r.logprob_entries

        outs = await asyncio.gather(*(one(i, *row) for i, row in enumerate(rows)))
        await engine.wait_drained()
        return outs

    return asyncio.run(go())


def _same(got, want):
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        assert len(gl) == len(wl)
        for g, w in zip(gl, wl):
            assert g["id"] == w["id"] and g["top_ids"] == w["top_ids"]
            assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
            np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"], atol=LP_TOL,
                                       rtol=0)


def _held(tiny_np, rows, late=(), max_new=24, **kw):
    jax_engine = _jax(tiny_np, **kw)
    want = _run(jax_engine, JaxGenRequest, jax_guided, rows, max_new, late)
    jax_engine.stop()
    port = _port(tiny_np, **kw)
    got = _run(port, GenRequest, port_guided, rows, max_new, late)
    _same(got, want)
    return got, port


def _matches(grammar, toks):
    """A finished guided output is a whole match of its grammar; an
    unfinished one a live prefix."""
    dfa = port_guided.ByteDFA.from_regex(
        grammar[1] if grammar[0] == "regex" else port_guided.json_object_regex(3)
        if grammar[0] == "json_object" else port_guided.json_schema_to_regex(
            json.loads(grammar[1])))
    finished = bool(toks) and toks[-1] == 257
    ids = toks[:-1] if finished else toks
    if any(t >= 256 for t in ids):  # the grammar admits byte ids alone
        return False
    body = bytes(ids)
    if finished:
        return dfa.matches(body)
    state = 0
    for b in body:
        state = int(dfa.trans[state, b])
        if state < 0:
            return False
    return True


SCHEDULERS = [("two_dispatch", 1), ("two_dispatch", 2), ("ragged", 1), ("ragged", 2)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
@pytest.mark.parametrize("scheduler,depth", SCHEDULERS,
                         ids=["{}-depth{}".format(s, d) for s, d in SCHEDULERS])
def test_guided_streams_equal_the_reference(tiny_np, scheduler, depth, sampled):
    """Four rows admitted at once and a fifth, guided, admitted mid-decode
    into the fifth slot (no slot is reused: see
    ``test_unguided_request_reusing_a_guided_slot``)."""
    kws = SAMPLED if sampled else [dict(logprobs=1)] + [dict()] * 4
    rows = [(p, g, kw) for p, g, kw in zip(PROMPTS, GRAMMARS, kws)]
    kw = dict(scheduler=scheduler, pipeline_depth=depth, max_batch=5)
    if scheduler == "ragged":
        kw.update(step_token_budget=24, ragged_decode_steps=4)
    got, port = _held(tiny_np, rows, late=(4,), **kw)
    for (toks, _lp), grammar in zip(got, GRAMMARS):
        if grammar is not None:
            assert _matches(grammar, toks), (grammar, toks)
    health = port.health()["guided"]
    # grammars compile in workers while rows decode: when every row of the
    # grammars compiled so far has finished as the next compile lands, the
    # tables are rebuilt without them (the epoch moves); else all four stay
    keys = {port_guided.GuidedSpec(*g).cache_key() for g in GRAMMARS if g is not None}
    assert set(port._grammars) <= keys and health["refs"] == 0
    assert (health["grammars"] == 4) == (port._gepoch == 0)
    assert health["bucket"] >= health["states"] > 0 and health["table_bytes"] > 0
    assert (port._gstate == -1).all() and port._slot_guided_key == [None] * 5
    if scheduler == "ragged":
        assert port.counters["ragged_chain_steps"] > 0
    port.stop()


def test_bucket_growth_with_a_chunk_in_flight(tiny_np):
    """Depth 2: a small grammar decodes, then a ``json_object`` admission
    grows the tables into a larger bucket while the first one's chunks are
    in flight; both streams are the reference's, and the outgrown bucket's
    buffers are gone once its readers ran."""
    rows = [(PROMPTS[0], ("regex", "[a-z]{1,40}"), dict()),
            (PROMPTS[1], ("json_object", ""), dict(temperature=0.9, seed=3))]
    buckets = []
    port_tables = LLMEngineCore._guided_device_tables

    def spy(engine):
        bucket = port_tables(engine)
        buckets.append(bucket)
        return bucket

    LLMEngineCore._guided_device_tables = spy
    try:
        _got, port = _held(tiny_np, rows, late=(1,), max_new=40, pipeline_depth=2)
    finally:
        LLMEngineCore._guided_device_tables = port_tables
    assert buckets[0] < buckets[-1]
    port._drop_outgrown_buckets()
    assert list(port._gdev) == [buckets[-1]] and not port._gstale
    port.stop()


SPEC_A = [5, 9, 2, 17, 5, 9, 2]


def test_guided_row_beside_a_tree_verify_row(tiny_np):
    """Ragged with tree speculation: a repetitive greedy chat verifies
    drafts while a guided one rides the same launches as a plain decode
    row; neither stream leaves the JAX tree engine's."""
    rows = [([256] + SPEC_A * 2, None, dict()),
            (PROMPTS[0], ("regex", "(north|south|east|west)( (north|south|east|west)){0,6}"),
             dict(temperature=0.9, seed=4))]
    kw = dict(scheduler="ragged", step_token_budget=24, decode_steps=2, max_batch=2,
              speculation="ngram", spec_k=4, spec_ngram=2, spec_tree=True, spec_branch=2)
    verify_slots = []
    eligible = LLMEngineCore._spec_eligible_mask

    def spy(engine, active):
        greedy, sampled = eligible(engine, active)
        verify_slots.append((greedy | sampled, engine._gstate.copy()))
        return greedy, sampled

    LLMEngineCore._spec_eligible_mask = spy
    try:
        got, port = _held(tiny_np, rows, max_new=30, **kw)
    finally:
        LLMEngineCore._spec_eligible_mask = eligible
    assert port.step_rows["spec_verify"] > 0
    assert all(not (mask & (gstate >= 0)).any() for mask, gstate in verify_slots)
    assert any((gstate >= 0).any() for _mask, gstate in verify_slots)
    assert _matches(rows[1][1], got[1][0])
    port.stop()


def test_prefix_hit_of_a_guided_chat(tiny_np):
    """The same guided chat twice on a prefix-cache engine: the second
    admission's first token comes from the hit path, under the grammar's
    start row; both runs are the reference's."""
    prompt = [256] + [(5 * j) % 250 + 1 for j in range(40)]
    grammar = ("json_schema", SCHEMA)
    for scheduler in ("two_dispatch", "ragged"):
        kw = dict(scheduler=scheduler, prefix_cache=16, prefix_block=16)
        outs = []
        for engine, cls, mod in ((_jax(tiny_np, **kw), JaxGenRequest, jax_guided),
                                 (_port(tiny_np, **kw), GenRequest, port_guided)):
            outs.append([_run(engine, cls, mod, [(prompt, grammar, dict())])[0]
                         for _ in range(2)])
            hits = engine._prefix.stats()["hits"]
            engine.stop()
            assert hits >= 1
        _same(outs[1], outs[0])


def test_unguided_request_reusing_a_guided_slot(tiny_np):
    """One slot, depth 2: a guided request finishes on EOS inside a chunk
    while the next chunk, dispatched before the retire, still carries its
    slot; an unguided request then takes the slot. Its stream is the one
    it has at depth 1 and on the JAX engine at depth 1. The JAX engine at
    depth 2 re-anchors the freed slot's stale DFA state at that next
    chunk's retire and masks the unguided request with it (ROADMAP §3)."""
    rows = [(PROMPTS[0], ("regex", "(north|south|east|west)"), dict()),
            (PROMPTS[3], None, dict())]
    outs = {}
    for name, make, cls, mod in (("jax", _jax, JaxGenRequest, jax_guided),
                                 ("port", _port, GenRequest, port_guided)):
        for depth in (1, 2):
            engine = make(tiny_np, max_batch=1, pipeline_depth=depth)
            outs[name, depth] = [t for t, _ in _run(engine, cls, mod, rows)]
            engine.stop()
    assert outs["port", 2] == outs["port", 1] == outs["jax", 1]
    assert outs["jax", 2][0] == outs["port", 2][0]
    successor = outs["port", 2][1]
    assert len(successor) > 2 and successor[-1] != 257
    # the reference's depth-2 successor: its first token (sampled before
    # any chunk) is right, then the stale accepting state allows only EOS
    assert outs["jax", 2][1] == successor[:1] + [257]


def test_cancel_during_prefill_returns_the_reference(tiny_np):
    """A client gone while its guided prefill is in flight (the reference
    test at tests/test_llm_engine.py:783): the admission's registry
    reference comes back, and guided decoding goes on for the next one."""
    marker = 301
    engine = _port(tiny_np)

    async def run():
        faults.configure([{"point": "engine.prefill", "action": "delay", "delay": 0.3,
                           "match_token": marker, "times": 1}])
        b = GenRequest(prompt_ids=[256, marker], max_new_tokens=8,
                       guided=port_guided.GuidedSpec("regex", "(yes|no)"))
        b_task = asyncio.ensure_future(_collect(engine, b))
        await asyncio.sleep(0.1)
        b.cancel()
        assert await asyncio.wait_for(b_task, timeout=30) == []
        refs = [e["refs"] for e in engine._grammars.values()]
        out = await _collect(engine, GenRequest(
            prompt_ids=[256, 2], max_new_tokens=8,
            guided=port_guided.GuidedSpec("regex", "(yes|no)")))
        await engine.wait_drained()
        return refs, out

    try:
        refs, out = asyncio.run(run())
    finally:
        faults.clear()
    assert refs == [0] and out
    assert all(e["refs"] == 0 for e in engine._grammars.values())
    engine.stop()


async def _collect(engine, request):
    return [t async for t in engine.generate(request)]


def test_rebuild_after_every_grammar_drained(tiny_np):
    """Once every reference is gone, the next new grammar rebuilds the
    combined tables from offset 0 (the device chain's states of the old
    generation are not read), and its stream is its stream alone."""
    engine = _port(tiny_np, pipeline_depth=2)
    a = _run(engine, GenRequest, port_guided,
             [(PROMPTS[0], ("json_object", ""), dict())])
    states, bucket = (engine.health()["guided"][k] for k in ("states", "bucket"))
    epoch = engine._gepoch
    b = _run(engine, GenRequest, port_guided,
             [(PROMPTS[1], ("regex", "[0-9]{3}"), dict())])
    assert engine._gepoch == epoch + 1
    health = engine.health()["guided"]
    assert health["grammars"] == 1 and health["refs"] == 0 and health["states"] < states
    # the rebuild keeps the bucket: buckets only grow
    assert health["bucket"] == bucket
    engine.stop()
    fresh = _port(tiny_np, pipeline_depth=2)
    assert _run(fresh, GenRequest, port_guided,
                [(PROMPTS[1], ("regex", "[0-9]{3}"), dict())]) == b
    fresh.stop()
    assert a[0][0]


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_live_rows_decode_while_a_grammar_compiles(tiny_np, monkeypatch, scheduler):
    """A new grammar compiles in a worker while the loop goes on (the
    reference's admission task): a live unguided stream emits eight more
    tokens while the compile is held, then the guided admission opens into
    the slot it reserved, matches its grammar and returns its reference."""
    engine = _port(tiny_np, scheduler=scheduler)
    compile_guided = port_guided.compile_guided
    emitted, during = [], []

    def slow_compile(*args, **kwargs):
        start = len(emitted)
        deadline = time.monotonic() + 30.0
        while len(emitted) < start + 8 and time.monotonic() < deadline:
            time.sleep(0.005)
        during.append(len(emitted) - start)
        return compile_guided(*args, **kwargs)

    monkeypatch.setattr(port_guided, "compile_guided", slow_compile)

    async def run():
        live = GenRequest(prompt_ids=PROMPTS[0], max_new_tokens=60, min_tokens=60)

        async def consume():
            async for t in engine.generate(live):
                emitted.append(t)

        task = asyncio.ensure_future(consume())
        while len(emitted) < 2:
            await asyncio.sleep(0.001)
        out = await _collect(engine, GenRequest(
            prompt_ids=PROMPTS[1], max_new_tokens=8,
            guided=port_guided.GuidedSpec("regex", "(north|south)")))
        await task
        await engine.wait_drained()
        return out

    out = asyncio.run(run())
    assert during and during[0] >= 8
    assert len(emitted) == 60 and _matches(("regex", "(north|south)"), out)
    assert all(e["refs"] == 0 for e in engine._grammars.values())
    assert not engine._admitting and not engine._grammar_preps
    engine.stop()


def test_state_budget_error(tiny_np, monkeypatch):
    monkeypatch.setattr(engine_module, "_GUIDED_STATE_BUDGET", 60)
    engine = _port(tiny_np)

    async def run():
        small = GenRequest(prompt_ids=PROMPTS[0], max_new_tokens=30,
                           guided=port_guided.GuidedSpec("regex", "[a-z]{1,30}"))
        big = GenRequest(prompt_ids=PROMPTS[1], max_new_tokens=4,
                         guided=port_guided.GuidedSpec("json_object"))
        task = asyncio.ensure_future(_collect(engine, small))
        await asyncio.sleep(0)
        with pytest.raises(ValueError, match="guided-grammar state budget exhausted"):
            await _collect(engine, big)
        await task
        await engine.wait_drained()

    asyncio.run(run())
    assert all(e["refs"] == 0 for e in engine._grammars.values())
    engine.stop()


def test_guided_slot_is_never_preempted(tiny_np):
    engine = _port(tiny_np, max_batch=1, preempt_batch=True)

    async def run():
        batch = GenRequest(prompt_ids=PROMPTS[0], max_new_tokens=40, priority="batch",
                           guided=port_guided.GuidedSpec("regex", "[a-z]{1,40}"))
        task = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 2:
            await asyncio.sleep(0.01)
        urgent = await _collect(engine, GenRequest(prompt_ids=PROMPTS[1], max_new_tokens=4))
        return await task, urgent

    guided_out, urgent = asyncio.run(run())
    assert engine.counters["preemptions"] == 0 and urgent
    assert _matches(("regex", "[a-z]{1,40}"), guided_out)
    engine.stop()


@pytest.fixture
def armed_ledger(monkeypatch):
    monkeypatch.setenv("TPUSERVE_LEDGER", "1")
    lifecycle_ledger.get().reset(strict=False)
    yield lifecycle_ledger.get()
    lifecycle_ledger.get().reset(strict=False)
    lifecycle_ledger.disarm()


def test_ledger_guided_refs_clean_at_drain_and_a_lost_release_named(tiny_np, armed_ledger,
                                                                     monkeypatch):
    engine = _port(tiny_np, pipeline_depth=2)
    rows = [(p, g, dict()) for p, g in zip(PROMPTS[:3], GRAMMARS[:3])]
    _run(engine, GenRequest, port_guided, rows, max_new=12)
    stats = engine.health()["ledger"]
    assert stats["leaks"] == 0 and stats["outstanding"]["guided.ref"] == 0
    assert armed_ledger.stats()["acquires"] > 0
    # a lost release: the next slot release drops its deref
    deref = engine._deref_guided_key
    lost = []

    def lose_once(key, request=None):
        if not lost:
            lost.append(key)
            return
        deref(key, request)

    monkeypatch.setattr(engine, "_deref_guided_key", lose_once)
    _run(engine, GenRequest, port_guided, [(PROMPTS[0], GRAMMARS[0], dict())], max_new=12)
    stats = engine.health()["ledger"]
    assert lost and stats["outstanding"]["guided.ref"] == 1 and stats["leaks"] >= 1
    leaked = [e for e in armed_ledger.outstanding_entries() if e["resource"] == "guided.ref"]
    assert leaked and "engine.py" in leaked[0]["site"]
    engine.stop()


def test_plain_chunks_keep_their_variant_keys(tiny_np):
    """A chunk with no guided slot replays the variant it replayed before
    guided decoding existed: ``ChunkVariant(greedy)`` (guided 0); a chunk
    with one carries the tables' bucket."""
    engine = _port(tiny_np, pipeline_depth=2)
    variants = []
    prepare = engine._prepare_dispatch

    def spy(mask, epoch):
        prep = prepare(mask, epoch)
        variants.append(prep["variant"])
        return prep

    engine._prepare_dispatch = spy
    _run(engine, GenRequest, port_guided,
         [(PROMPTS[0], None, dict()), (PROMPTS[1], None, dict(temperature=0.9))])
    # the greedy row may commit, and decode alone, before the sampled one
    assert ChunkVariant(False) in variants
    assert set(variants) <= {ChunkVariant(False), ChunkVariant(True)}
    plain = len(variants)
    _run(engine, GenRequest, port_guided, [(PROMPTS[0], None, dict())])
    assert set(variants[plain:]) == {ChunkVariant(True)}
    guided_from = len(variants)
    _run(engine, GenRequest, port_guided, [(PROMPTS[0], ("json_object", ""), dict())])
    bucket = engine.health()["guided"]["bucket"]
    assert ChunkVariant(True, guided=bucket) in variants[guided_from:]
    assert ChunkVariant(True, guided=bucket).label() == "greedy+guided{}".format(bucket)
    engine.stop()


BAD = [("nope", "x"), ("regex", "(unclosed"), ("regex", r"\bword\b"),
       ("json_schema", "{not json"), ("json_schema", json.dumps({"type": "object",
                                                                  "properties": 5}))]


@pytest.mark.parametrize("spec", BAD, ids=[b[0] + ":" + b[1][:10] for b in BAD])
def test_validation_errors_are_the_reference(tiny_np, spec):
    jax_engine = _jax(tiny_np)
    port = _port(tiny_np)
    with pytest.raises(ValueError) as want:
        jax_engine.validate(JaxGenRequest(prompt_ids=[256], guided=jax_guided.GuidedSpec(*spec)))
    with pytest.raises(ValueError) as got:
        port.validate(GenRequest(prompt_ids=[256], guided=port_guided.GuidedSpec(*spec)))
    assert str(got.value) == str(want.value)
    jax_engine.stop()
    port.stop()


def test_guided_without_a_tokenizer_or_eos_raises(tiny_np):
    spec = port_guided.GuidedSpec("regex", "(a|b)")
    for kw, msg in ((dict(tokenizer=None), "needs the engine's tokenizer"),
                    (dict(eos_token_id=None), "requires an eos token")):
        engine = _port(tiny_np, **kw)
        with pytest.raises(ValueError, match=msg):
            engine.validate(GenRequest(prompt_ids=[256], guided=spec))
        engine.stop()
