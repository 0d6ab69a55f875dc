"""The ragged launch as one function over staged buffers
(clearml_serving_tpu_torch/llm/ragged_graph.py) against the reference, on
the CPU, llama-tiny in float32 with the same weights through
``convert_params``:

- per launch key (windows 1, 2 and 4; chain and tree verify rows; a
  sampled verify row; the extras with a seeded row; logprobs; a guided
  row), the port's engine under ``scheduler: ragged``, every step
  ``run_ragged`` over its ``RaggedLayout`` views, gives the JAX engine's
  streams token for token (a sampled verify row's greedy neighbour, since
  the engines' generators differ), logprob entries within 1e-5, and the
  key was launched;
- the verify rows' acceptance with the reference's own draws injected:
  equal to the reference's samplers, chain and tree, greedy and sampled;
- ``RaggedLayout``: a plan packed and read back gives every array bitwise,
  also after a row was dropped;
- the fixed-shape tree KV compaction leaves the pools bitwise as the
  reference's form leaves them, on a forest with moves and non-moves;
- the null launch of every plain key writes the null page alone."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu.llm.sampling import (
    SamplingParams as JaxSamplingParams,
    greedy_tree_walk as jax_greedy_tree_walk,
    speculative_sample_chain as jax_speculative_sample_chain,
    speculative_sample_tree as jax_speculative_sample_tree,
)
from clearml_serving_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from clearml_serving_tpu.llm import guided as jax_guided
from clearml_serving_tpu_torch.llm import guided as port_guided
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.llm.ragged_graph import (
    RaggedLayout,
    RaggedVariant,
    compact_tree_kv,
    plain_variants,
    ragged_draws,
    run_ragged,
    spec_accept,
)
from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
LP_TOL = 1e-5
# the reference's ragged and spec engine tests' prompts
LONG = [(i * 7 + 3) % 250 + 1 for i in range(40)]
SHORT = [5, 9, 2, 17, 33]
MID = [(i * 13 + 5) % 250 + 1 for i in range(19)]
SPEC_A = [5, 9, 2, 17, 5, 9, 2]
SPEC_B = [3, 3, 7, 3, 3, 7, 3]
ENGINE = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 64], eos_token_id=None,
              decode_steps=4, scheduler="ragged", step_token_budget=12)
SPEC = dict(speculation="ngram", spec_k=4, spec_ngram=2)

# key class -> (engine knobs, rows of (prompt, request kwargs), tokens a
# row, the row whose stream the reference must give (None: every row), the
# launched keys' predicate)
KEYS = {
    "window1": (dict(ragged_decode_steps=1), [(SHORT, {}), (LONG, {}), (MID, {})], 24, None,
                lambda v: v.steps == 1),
    "window2": (dict(ragged_decode_steps=2), [(SHORT, {}), (LONG, {}), (MID, {})], 24, None,
                lambda v: v.steps == 2),
    "window4": (dict(ragged_decode_steps=4), [(SHORT, {}), (LONG, {}), (MID, {})], 24, None,
                lambda v: v.steps == 4),
    "chain": (SPEC, [(SPEC_A, {}), (SPEC_B, {})], 10, None, lambda v: v.verify == "chain"),
    "tree": (dict(SPEC, spec_tree=True, spec_branch=2), [(SPEC_A, {}), (SPEC_B, {})], 10,
             None, lambda v: v.verify == "tree"),
    "sampled_verify": (dict(SPEC, spec_tree=True, spec_branch=2),
                       [(SPEC_A, {}), (SPEC_B, dict(temperature=0.7))], 10, 0,
                       lambda v: v.sampled_verify),
    "extras": (dict(ragged_decode_steps=2),
               [(SHORT, dict(temperature=0.8, seed=7, presence_penalty=0.5)),
                (LONG, dict(repetition_penalty=1.3)), (MID, dict(temperature=0.9, seed=3))],
               24, None, lambda v: v.extras and v.seeded),
    "logprobs": (dict(ragged_decode_steps=2),
                 [(SHORT, dict(logprobs=2)), (LONG, {}), (MID, dict(logprobs=0))], 24, None,
                 lambda v: v.lp),
    "guided": (dict(ragged_decode_steps=2, eos_token_id=257),
               [(SHORT, dict(guided=("json_object", ""))), (LONG, {}),
                (MID, dict(guided=("regex", "(north|south|east|west)")))], 24, None,
               lambda v: v.guided > 0),
}


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _streams(engine, request_cls, guided_mod, rows, n):
    """Each (prompt, kwargs) row submitted once the previous one streamed
    its first token, so admissions share launches with live rows. Per row
    (tokens, logprob entries), after the engine drained."""

    async def one(ids, kw, started, go):
        if started is not None:
            await started.wait()
        kw = dict(kw)
        if kw.get("guided") is not None:
            kw["guided"] = guided_mod.GuidedSpec(*kw["guided"])
        request = request_cls(prompt_ids=list(ids), max_new_tokens=n, **kw)
        out = []
        async for t in engine.generate(request):
            out.append(t)
            go.set()
        go.set()
        return out, request.logprob_entries

    async def run():
        events = [asyncio.Event() for _ in rows]
        outs = await asyncio.gather(*(
            one(p, kw, events[i - 1] if i else None, events[i])
            for i, (p, kw) in enumerate(rows)))
        await engine.wait_drained()
        return outs

    return asyncio.run(run())


def _same_entries(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["id"] == w["id"] and g["top_ids"] == w["top_ids"]
        np.testing.assert_allclose(g["logprob"], w["logprob"], atol=LP_TOL, rtol=LP_TOL)
        np.testing.assert_allclose(g["top_logprobs"], w["top_logprobs"], atol=LP_TOL,
                                   rtol=LP_TOL)


@pytest.mark.parametrize("key", list(KEYS))
def test_run_ragged_streams_equal_the_reference(tiny_np, key):
    knobs, rows, n, only, launched = KEYS[key]
    kw = dict(ENGINE, **knobs)
    jax_engine = JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                           pipeline_depth=1, tokenizer=JaxByteTokenizer(512), **kw)
    want = _streams(jax_engine, JaxGenRequest, jax_guided, rows, n)
    jax_engine.stop()
    port = LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")),
                         tokenizer=ByteTokenizer(512), **kw)
    keys = []
    variant_of = port._ragged_variant

    def spy(plan):
        keys.append(variant_of(plan))
        return keys[-1]

    port._ragged_variant = spy
    got = _streams(port, GenRequest, port_guided, rows, n)
    port.stop()
    for i, ((gt, gl), (wt, wl)) in enumerate(zip(got, want)):
        if only is None or i == only:
            assert gt == wt, (key, i)
            _same_entries(gl or [], wl or [])
    assert all(len(t) >= 1 for t, _ in got)
    assert any(launched(v) for v in keys), (key, sorted(set(keys)))
    pool = port.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


def _jax_draws(key, b, n, v):
    r_acc, r_gum = jax.random.split(key)
    return {"spec_uniform": torch.from_numpy(np.array(jax.random.uniform(r_acc, (b, n - 1)))),
            "spec_noise": torch.from_numpy(np.array(jax.random.gumbel(r_gum, (b, n, v),
                                                                       jnp.float32)))}


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("verify", ["chain", "tree"])
def test_spec_accept_equals_the_reference_with_its_draws(verify, sampled):
    """The reference's in-launch acceptance (``_spec_accept`` of its
    ragged step): greedy rows the argmax chain or greedy tree walk, sampled
    rows the rejection samplers with the reference's draws, rows that do
    not verify accepting nothing and keeping the identity node map."""
    b, k, v = 5, 4, 24
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
    logits[..., :4] += 2.5
    parents = np.tile(np.array([-1, 0, 1, 0, 3], np.int32), (b, 1))
    if verify == "chain":
        parents = np.tile(np.arange(-1, k, dtype=np.int32), (b, 1))
    tokens = rng.integers(0, 4, (b, k + 1)).astype(np.int32)
    n_nodes = np.array([5, 5, 3, 5, 5], np.int32)
    spec = np.array([1, 0, 1, 0, 0], bool)
    sspec = np.array([0, 0, 0, 1, 1], bool) if sampled else np.zeros(b, bool)
    temp = np.where(sspec, 0.8, 0.0).astype(np.float32)
    layout = RaggedLayout(b, 16, 1, 4, 1, k)
    views = layout.views(*(t.numpy() for t in layout.stage(dict(
        spec_mask=spec, sspec_mask=sspec, drafts=tokens[:, 1:], tree_tokens=tokens,
        tree_parents=parents, tree_n=n_nodes, temperature=temp), pin=False)))
    views = {name: torch.from_numpy(np.ascontiguousarray(a)) for name, a in views.items()}
    key = jax.random.PRNGKey(11)
    draws = _jax_draws(key, b, k + 1, v) if sampled else {}
    variant = RaggedVariant(verify=verify, sampled_verify=sampled)
    sampling = JaxSamplingParams(jnp.asarray(temp), jnp.zeros(b, jnp.int32),
                                 jnp.ones(b, jnp.float32))
    from clearml_serving_tpu_torch.llm.sampling import SamplingParams
    g, acc, nodes = spec_accept(variant, views, torch.from_numpy(logits), SamplingParams(
        torch.from_numpy(temp), torch.zeros(b, dtype=torch.int32), torch.ones(b)), draws)
    # the reference's acceptance, line for line
    sl = jnp.asarray(logits)
    spec_any = spec | sspec
    if verify == "tree":
        t_tok, t_par, t_n = jnp.asarray(tokens), jnp.asarray(parents), jnp.asarray(n_nodes)
        g_g, acc_g, nodes_g = jax_greedy_tree_walk(jnp.argmax(sl, axis=-1).astype(jnp.int32),
                                                   t_tok, t_par, t_n)
        g_s, acc_s, nodes_s = jax_speculative_sample_tree(sl, t_tok, t_par, t_n, sampling, key)
        want_g = np.where(sspec[:, None], g_s, g_g)
        want_acc = np.where(sspec, acc_s, np.where(spec, acc_g, 0))
        ident = np.broadcast_to(np.arange(k + 1, dtype=np.int32), (b, k + 1))
        want_nodes = np.where(spec_any[:, None], np.where(sspec[:, None], nodes_s, nodes_g),
                              ident)
        np.testing.assert_array_equal(nodes.numpy(), want_nodes)
    else:
        assert nodes is None
        drafts = jnp.asarray(tokens[:, 1:])
        g_a = jnp.argmax(sl, axis=-1).astype(jnp.int32)
        acc_g = jnp.sum(jnp.cumprod((drafts == g_a[:, :k]).astype(jnp.int32), axis=1), axis=1)
        g_s, acc_s = jax_speculative_sample_chain(sl, drafts, sampling, key)
        want_g = np.where(sspec[:, None], g_s, g_a)
        want_acc = np.where(sspec, acc_s, np.where(spec, acc_g, 0))
    np.testing.assert_array_equal(acc.numpy(), want_acc)
    rows = spec_any
    np.testing.assert_array_equal(g.numpy()[rows], np.asarray(want_g)[rows])


def _tiny_engine(tiny_np, **kw):
    return LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")),
                         **dict(ENGINE, **kw))


def _plan_with_rows(engine):
    """A ragged plan with a live decode row and a prefill job (slot 0
    decoding, slot 1 admitting), made through the engine's own planner
    after a real admission."""

    async def run():
        first = asyncio.Event()

        async def decode():
            async for _ in engine.generate(GenRequest(prompt_ids=list(SHORT),
                                                      max_new_tokens=40)):
                first.set()

        task = asyncio.ensure_future(decode())
        await first.wait()
        # freeze the loop: plan by hand with the decode row live and a job
        engine._stopped = True
        await asyncio.sleep(0.05)
        return task

    async def go():
        task = await run()
        request = GenRequest(prompt_ids=list(LONG), max_new_tokens=4)
        request.prompt_len = len(request.prompt_ids)
        engine._open_ragged_job(request, 1)
        active = np.array([r is not None for r in engine._slot_req])
        plan = engine._prepare_ragged(active)
        task.cancel()
        return plan

    return asyncio.run(go())


PLAN_ARRAYS = ("tokens", "tok_pos", "tok_row", "tok_valid", "write_page", "write_offset",
               "row_last", "row_starts", "row_lens", "kv_lens", "spec_mask", "sspec_mask",
               "temperature", "top_k", "top_p", "chain_mask")


@pytest.mark.parametrize("drop", [False, True], ids=["as_planned", "row_dropped"])
def test_layout_round_trips_the_plan(tiny_np, drop):
    engine = _tiny_engine(tiny_np, ragged_decode_steps=2)
    plan = _plan_with_rows(engine)
    if drop:
        engine._ragged_drop_row(plan, 1)
    host_i32, host_f32 = engine._stage_ragged(plan)
    views = engine._ragged_layout.views(host_i32.numpy(), host_f32.numpy())
    for name in PLAN_ARRAYS:
        want = plan[name]
        if want is None:
            continue
        got = views[name][tuple(slice(0, n) for n in np.shape(want))]
        assert np.array_equal(got.astype(np.asarray(want).dtype), want), name
    np.testing.assert_array_equal(views["page_table"],
                                  engine.paged_cache.pool.page_table(engine._pages_per_seq))
    spec_any = plan["spec_mask"] | plan["sspec_mask"]
    np.testing.assert_array_equal(views["active"], plan["decode_mask"] & ~spec_any)
    # the chained step's coordinates: the decode row's second window token
    if plan["launch_steps"] > 1:
        assert views["chain_wp"][0, 0] > 0
    assert (plan["row_lens"][1] == 0) == drop


def _jax_compaction(pools, row_starts, nodes, spec_any, write_page, write_offset):
    """The reference's KV path compaction, its lines from the ragged step
    (``clearml_serving_tpu/llm/engine.py``, the ``tree is not None``
    branch)."""
    nn = nodes.shape[1]
    pos = jnp.arange(1, nn, dtype=jnp.int32)
    src = (row_starts[:, None] + nodes[:, 1:]).reshape(-1)
    dst = (row_starts[:, None] + pos[None, :]).reshape(-1)
    move = (spec_any[:, None] & (nodes[:, 1:] != pos[None, :])).reshape(-1)
    sp, so = write_page[src], write_offset[src]
    dp = jnp.where(move, write_page[dst], 0)
    do = jnp.where(move, write_offset[dst], 0)
    return [p.at[:, :, dp, do].set(p[:, :, sp, so]) for p in pools]


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_tree_compaction_equals_the_reference_form(kv_quant):
    """Two tree rows (one moving nodes 3, 4 to positions 1, 2, one
    accepting its primary chain: no move), a plain row and an idle row; a
    row start near the axis' end so the flat indices clamp."""
    b, k, t = 4, 4, 24
    cache = PagedKVCache(2, 2, 8, num_pages=9, page_size=4, max_slots=b, dtype=torch.float32,
                         kv_quant=kv_quant, device="cpu")
    rng = np.random.default_rng(5)
    for p in cache._pools():
        p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)
                                 * (10 if p.dtype == torch.int8 else 1)).to(p.dtype))
    row_starts = np.array([0, 8, 16, 22], np.int32)
    write_page = rng.integers(1, 9, t).astype(np.int32)
    write_offset = rng.integers(0, 4, t).astype(np.int32)
    nodes = np.array([[0, 3, 4, 3, 4], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4]],
                     np.int32)
    spec = np.array([1, 1, 0, 0], bool)
    layout = RaggedLayout(b, t, 1, 4, 1, k)
    host = layout.stage(dict(row_starts=row_starts, write_page=write_page,
                             write_offset=write_offset, spec_mask=spec), pin=False)
    views = layout.views(*host)
    want = _jax_compaction([jnp.asarray(p.numpy()) for p in cache._pools()],
                           jnp.asarray(row_starts), jnp.asarray(nodes), jnp.asarray(spec),
                           jnp.asarray(write_page), jnp.asarray(write_offset))
    compact_tree_kv(cache, views, torch.from_numpy(nodes))
    for got, ref in zip(cache._pools(), want):
        # page 0 is the null page: the non-moves' target, never read
        np.testing.assert_array_equal(got.numpy()[:, :, 1:], np.asarray(ref)[:, :, 1:])
    moved = cache._pools()[0].numpy()
    assert moved[:, :, write_page[1], write_offset[1]].tolist() == \
        moved[:, :, write_page[3], write_offset[3]].tolist()


@pytest.mark.parametrize("verify", ["", "chain", "tree"])
def test_null_launch_of_every_plain_key_writes_the_null_page_alone(tiny_np, verify):
    knobs = {} if not verify else dict(SPEC, spec_tree=verify == "tree")
    engine = _tiny_engine(tiny_np, **knobs)
    rng = np.random.default_rng(0)
    for p in engine.paged_cache._pools():
        p.copy_(torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32)))
    before = [p.clone() for p in engine.paged_cache._pools()]
    keys = plain_variants(engine._ragged_steps_cap, engine._verify_kind)
    assert len(keys) == (18 if verify else 6)
    for variant in keys:
        host = engine._ragged_layout.stage({}, pin=False)
        # zero draws, as a capture's warm-up run reads them
        draws = ragged_draws(variant, engine.max_batch, engine.model.vocab_size,
                             engine._spec_k, None, "cpu")
        out = engine._run_ragged(variant, *host,
                                 {name: torch.zeros_like(t) for name, t in draws.items()})
        assert tuple(out["sampled"].shape) == (variant.steps, engine.max_batch)
    for was, now in zip(before, engine.paged_cache._pools()):
        assert torch.equal(was[:, :, 1:], now[:, :, 1:])


def test_eager_launch_is_repeatable(tiny_np):
    """The same staged inputs and draws give the same outputs bitwise (the
    graphed and eager steps run this one function)."""
    engine = _tiny_engine(tiny_np, **SPEC, spec_tree=True)
    variant = RaggedVariant(steps=2, verify="tree", sampled_verify=True, greedy=False)
    gen = torch.Generator().manual_seed(1)
    draws = ragged_draws(variant, engine.max_batch, engine.model.vocab_size, engine._spec_k,
                         gen, "cpu")
    outs = []
    for _ in range(2):
        host = engine._ragged_layout.stage({"temperature": np.full(2, 0.7, np.float32)},
                                           pin=False)
        outs.append(run_ragged(engine.model, engine.paged_cache,
                               engine._ragged_layout.views(*host), variant, draws,
                               block_map=False))
    for name in outs[0]:
        assert torch.equal(outs[0][name], outs[1][name]), name
