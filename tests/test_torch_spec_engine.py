"""Speculative verify rows in the port (spec-as-row under the ragged
scheduler) against the reference, llama-tiny in float32 with the same
weights through ``convert_params``:

- ``Llama.forward_ragged`` with ``row_logit_idx`` and ``tree_anc`` (chain
  and forest verify rows beside a prefill chunk and a decode row) against
  the JAX ``forward_ragged``: atol 1e-4 on the last-token and gathered
  logits and on the pool rows written;
- the engine's plain / chain / tree arms on the reference's own prompts and
  settings (``tests/test_spec_tree.py``): greedy streams byte-identical to
  each other and to the JAX ragged engine's, model-dtype and int8 pools;
  an oracle forest whose accepted path skips nodes (KV path compaction
  held over the launches after it); a temperature-0.7 row; ``health()``;
  knob and aux-key errors; the HTTP content of a tree endpoint."""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import (
    GenRequest as JaxGenRequest,
    LLMEngineCore as JaxEngine,
)
from clearml_serving_tpu.llm.kv_cache import PagedKVCache as JaxPagedKVCache
from clearml_serving_tpu.ops.paged_attention import tree_ancestors as jax_tree_ancestors
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.llm.spec_proposer import DraftForest
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.ops.paged_attention import ragged_layout
from torch_serving import port_app

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ATOL = 1e-4
# the reference's spec tree engine tests' prompts and settings
SPEC_A = [5, 9, 2, 17, 5, 9, 2]
SPEC_B = [3, 3, 7, 3, 3, 7, 3]
ENGINE = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 64], eos_token_id=None,
              decode_steps=2, scheduler="ragged", step_token_budget=12)
SPEC = dict(speculation="ngram", spec_k=4, spec_ngram=2)
ARMS = {"plain": {}, "chain": SPEC, "tree": dict(SPEC, spec_tree=True, spec_branch=2)}


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _cfg(kv_quant):
    return dict(TINY, kv_quant=kv_quant) if kv_quant else dict(TINY)


def _page_kw(kv_quant):
    # int8 pools take 32-token pages, the reference's default for them
    return {"page_size": 32 if kv_quant else 16}


KV = pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])


# -- forward_ragged with verify rows -------------------------------------------

# (history, query tokens, topology) per row: a decode row, a prefill chunk
# at history 0, a chain verify row, a forest verify row, an idle row
ROWS = [(11, 1, None), (0, 7, None), (6, 5, "chain"), (9, 5, "forest"), (0, 0, None)]
PARENTS = {"chain": [-1, 0, 1, 2, 3], "forest": [-1, 0, 1, 0, 0]}


@pytest.mark.parametrize("tree", [False, True], ids=["chain_rows", "tree_anc"])
@KV
def test_forward_ragged_verify_rows_match_reference(tiny_np, kv_quant, tree):
    cfg = _cfg(kv_quant)
    bundle = models.build_model("llama", cfg)
    model = Llama(cfg, convert_params(tiny_np, device="cpu"))
    geo = dict(num_pages=24, page_size=4, max_slots=len(ROWS))
    jcache = JaxPagedKVCache(bundle.n_layers, bundle.n_kv_heads, bundle.head_dim,
                             dtype="float32", kv_quant=kv_quant, **geo)
    tcache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                          dtype=torch.float32, kv_quant=kv_quant, device="cpu", **geo)
    rng = np.random.default_rng(11)
    for slot, (hist, _n, _t) in enumerate(ROWS):
        if not hist:
            continue
        ids = rng.integers(0, 512, hist).astype(np.int32)
        _last, mini = bundle.prefill(tiny_np, jnp.asarray(ids[None]),
                                     jnp.asarray([hist], jnp.int32),
                                     bundle.init_cache(1, hist))
        parts = [np.array(mini[k])[:, 0, :hist] for k in ("k", "v")]
        if kv_quant:
            parts += [np.array(mini[k])[:, 0, :hist] for k in ("k_scale", "v_scale")]
        jcache.write_prompt(slot, parts[0], parts[1], hist, *parts[2:])
        tcache.write_prompt(slot, *(torch.from_numpy(p) for p in parts[:2]), hist,
                            *(torch.from_numpy(p) for p in parts[2:]))
    row_lens = np.array([n for _h, n, _t in ROWS], np.int32)
    starts, _br, _bq, t = ragged_layout(row_lens, 1, total=int(row_lens.sum()) + 3)
    tokens = np.zeros(t, np.int32)
    tok_pos = np.zeros(t, np.int32)
    tok_row = np.zeros(t, np.int32)
    tok_valid = np.zeros(t, bool)
    write_page = np.zeros(t, np.int32)
    write_offset = np.zeros(t, np.int32)
    row_last = np.zeros(len(ROWS), np.int32)
    kv_lens = np.zeros(len(ROWS), np.int32)
    anc = np.full((t, 5), -1, np.int32)
    anc[:, 0] = -2
    for slot, (hist, n, topo) in enumerate(ROWS):
        if not n:
            continue
        s = int(starts[slot])
        jcache.pool.extend(slot, n)
        tcache.pool.extend(slot, n)
        coords = jcache.pool.token_coords(slot, hist, n)
        tokens[s:s + n] = rng.integers(0, 512, n)
        depth = np.arange(n)
        if tree and topo == "forest":
            depth = np.array([0, 1, 2, 1, 1])        # siblings share a position
        if tree and topo is not None:
            anc[s:s + n] = jax_tree_ancestors(PARENTS[topo], n, width=5)
        tok_pos[s:s + n] = hist + depth
        tok_row[s:s + n] = slot
        tok_valid[s:s + n] = True
        write_page[s:s + n] = [p for p, _ in coords]
        write_offset[s:s + n] = [o for _, o in coords]
        row_last[slot] = s + n - 1
        kv_lens[slot] = hist + n
    row_logit_idx = np.zeros((len(ROWS), 5), np.int32)
    for slot in range(len(ROWS)):
        if row_lens[slot]:
            row_logit_idx[slot] = starts[slot] + np.minimum(np.arange(5), row_lens[slot] - 1)
    table = jcache.pool.page_table(6)
    flat = (tokens, tok_pos, tok_row, tok_valid, row_last)
    rows = (table, kv_lens, starts, row_lens, write_page, write_offset)
    jkw = {"row_logit_idx": jnp.asarray(row_logit_idx)}
    tkw = {"row_logit_idx": torch.from_numpy(row_logit_idx)}
    if tree:
        jkw["tree_anc"] = jnp.asarray(anc)
        tkw["tree_anc"] = torch.from_numpy(anc)
    if kv_quant:
        jkw.update(k_scales=jcache.k_scale, v_scales=jcache.v_scale)
        tkw.update(k_scales=tcache.k_scale, v_scales=tcache.v_scale)
    out = bundle.forward_ragged(tiny_np, *(jnp.asarray(a) for a in flat), jcache.k, jcache.v,
                                *(jnp.asarray(a) for a in rows), **jkw)
    last, gathered = model.forward_ragged(
        torch.from_numpy(tokens).long(), *(torch.from_numpy(a) for a in flat[1:]),
        tcache.k, tcache.v, *(torch.from_numpy(a) for a in rows), **tkw)
    (want_last, want_gathered) = out[0]
    live = row_lens > 0
    np.testing.assert_allclose(last.numpy()[live], np.asarray(want_last)[live],
                               atol=ATOL, rtol=ATOL)
    assert gathered.shape == (len(ROWS), 5, model.vocab_size)
    np.testing.assert_allclose(gathered.numpy()[live], np.asarray(want_gathered)[live],
                               atol=ATOL, rtol=ATOL)
    # the last-token logits keep their own path: equal to a call without
    # the gather
    if not tree:
        plain = model.forward_ragged(
            torch.from_numpy(tokens).long(), *(torch.from_numpy(a) for a in flat[1:]),
            tcache.k, tcache.v, *(torch.from_numpy(a) for a in rows),
            **{k: v for k, v in tkw.items() if k != "row_logit_idx"})
        assert torch.equal(plain, last)
    wp, wo = write_page[tok_valid], write_offset[tok_valid]
    names = ("k", "v") + (("k_scale", "v_scale") if kv_quant else ())
    for i, name in enumerate(names):
        got = getattr(tcache, name)[:, :, wp, wo].numpy()
        want = np.asarray(out[1 + i])[:, :, wp, wo]
        if kv_quant and name in ("k", "v"):
            # int8 codes may differ by one where x/scale sits on a .5 tie
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
            assert (got == want).mean() > 0.99
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


# -- the engine ---------------------------------------------------------------


def _staggered(engine, request_cls, prompts, n=10, temperatures=None):
    """The reference test's traffic: each prompt 50 ms after the previous."""

    async def one(i, ids):
        if i:
            await asyncio.sleep(0.05 * i)
        temperature = temperatures[i] if temperatures else 0.0
        return [t async for t in engine.generate(request_cls(
            prompt_ids=list(ids), max_new_tokens=n, temperature=temperature))]

    async def run():
        outs = await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
        await engine.wait_drained()
        return outs

    return asyncio.run(run())


def _port(tiny_np, kv_quant, **kw):
    cfg = _cfg(kv_quant)
    return LLMEngineCore(Llama(cfg, convert_params(tiny_np, device="cpu")),
                         **ENGINE, **_page_kw(kv_quant), **kw)


@KV
def test_plain_chain_tree_streams_equal_each_other_and_reference(tiny_np, kv_quant):
    jax_engine = JaxEngine(models.build_model("llama", _cfg(kv_quant)), tiny_np,
                           cache_mode="paged", pipeline_depth=1, **ENGINE,
                           **_page_kw(kv_quant), **ARMS["tree"])
    want = _staggered(jax_engine, JaxGenRequest, [SPEC_A, SPEC_B])
    jax_engine.stop()
    streams, health = {}, {}
    for arm, kw in ARMS.items():
        engine = _port(tiny_np, kv_quant, **kw)
        streams[arm] = _staggered(engine, GenRequest, [SPEC_A, SPEC_B])
        health[arm] = engine.health()["ragged"]
        pool = engine.paged_cache.pool
        assert pool.free_pages == pool.num_pages - 1      # every page came back
    assert streams["plain"] == want
    assert streams["chain"] == want
    assert streams["tree"] == want
    assert all(len(s) == 10 for s in want)
    for arm in ("chain", "tree"):
        assert health[arm]["step_rows"]["spec_verify"] >= 1
        assert health[arm]["spec_acceptance"]["count"] >= 1
        assert health[arm]["spec_proposer"]["proposed"] >= 1
    assert health["tree"]["spec_tree_depth"]["count"] >= 1
    assert health["tree"]["spec_proposer"]["name"] == "ngram-forest"
    assert health["chain"]["spec_proposer"]["name"] == "ngram-chain"
    assert health["chain"]["spec_tree_depth"] is None
    assert health["plain"]["spec_proposer"] is None
    assert health["plain"]["step_rows"]["spec_verify"] == 0
    # accepted drafts: fewer launches per decode token than one
    assert health["tree"]["decode_tokens"] > health["tree"]["steps"] - 2


@KV
def test_sampled_row_completes_beside_a_greedy_one(tiny_np, kv_quant):
    """A temperature-0.7 row rides the same verify launches (rejection
    sampling, chain and tree); the greedy row beside it keeps its stream."""
    plain = _staggered(_port(tiny_np, kv_quant), GenRequest, [SPEC_A])[0]
    for arm in ("chain", "tree"):
        engine = _port(tiny_np, kv_quant, **ARMS[arm])
        greedy, sampled = _staggered(engine, GenRequest, [SPEC_A, SPEC_B],
                                     temperatures=[0.0, 0.7])
        assert greedy == plain and len(sampled) == 10
        assert all(0 <= t < engine.model.vocab_size for t in sampled)
        assert engine.health()["ragged"]["step_rows"]["spec_verify"] >= 2
        pool = engine.paged_cache.pool
        assert pool.free_pages == pool.num_pages - 1


class _OracleForest:
    """A forest proposer that knows each request's greedy stream: the
    primary branch (nodes 1, 2) drafts wrong tokens, a sibling (node 3)
    the right next token and its child (node 4) the one after, so the
    accepted path is nodes 3, 4 and their K/V must move to positions 1, 2."""

    name = "oracle"

    def __init__(self, streams, vocab):
        self.streams = streams          # prompt tuple -> prompt + greedy stream
        self.vocab = vocab

    def propose(self, slots, hists, tokbuf, k):
        assert k == 4
        s = len(slots)
        tokens = np.zeros((s, 5), np.int32)
        for i, (slot, hist) in enumerate(zip(slots, hists)):
            full = next(f for f in self.streams.values()
                        if list(tokbuf[slot, :hist]) == f[:hist])
            right = [full[hist + j] if hist + j < len(full) else 0 for j in range(2)]
            tokens[i] = [0, (right[0] + 1) % self.vocab, 7, right[0], right[1]]
        parents = np.tile(np.array([-1, 0, 1, 0, 3], np.int32), (s, 1))
        depths = np.tile(np.array([0, 1, 2, 1, 2], np.int32), (s, 1))
        return DraftForest(tokens, parents, depths, np.full(s, 5, np.int32),
                           np.ones(s, bool))

    def stats(self):
        return {}


@KV
def test_tree_kv_compaction_holds_over_later_launches(tiny_np, kv_quant):
    prompts = [SPEC_A, SPEC_B]
    plain = _staggered(_port(tiny_np, kv_quant), GenRequest, prompts, n=16)
    engine = _port(tiny_np, kv_quant, **ARMS["tree"])
    engine._spec_proposer = _OracleForest(
        {tuple(p): list(p) + s for p, s in zip(prompts, plain)}, engine.model.vocab_size)
    got = _staggered(engine, GenRequest, prompts, n=16)
    assert got == plain
    depth = engine.health()["ragged"]["spec_tree_depth"]
    # the skipping path was accepted (depth 2) in most verify launches
    assert depth["counts"][2] >= 3
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


def test_verify_row_the_pool_cannot_extend_fails_only_its_request(tiny_np):
    """Four usable 16-token pages: a tree verify row that cannot take its
    k+1 positions is dropped from the launch (its mask rows revert to
    plain causal) and its request fails with MemoryError after the tokens
    it had, which equal the plain stream's; every page comes back."""
    prompt = [(i * 7 + 3) % 250 + 1 for i in range(40)]
    engine = _port(tiny_np, "", **ARMS["tree"], num_pages=5)

    async def run():
        out = []
        with pytest.raises(MemoryError, match="exhausted"):
            async for t in engine.generate(GenRequest(prompt_ids=prompt, max_new_tokens=40)):
                out.append(t)
        await engine.wait_drained()
        return out

    got = asyncio.run(run())
    plain = _staggered(_port(tiny_np, ""), GenRequest, [prompt], n=40)[0]
    assert len(got) >= 15 and got == plain[:len(got)]
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


def test_spec_tree_seam_demotes_only_the_matched_row(tiny_np):
    """An ``engine.spec.tree`` raise matched to one request demotes that
    request's verify row to plain decode in the same launch (twice): both
    greedy streams equal an undisturbed run's and the JAX engine's under
    the same fault, the fallbacks are counted, the other row kept
    speculating, and no page leaks (the seam fires before any
    allocation)."""
    from clearml_serving_tpu.llm import faults as jax_faults
    from clearml_serving_tpu_torch.llm import faults

    marked = [211] + SPEC_A
    spec = {"point": "engine.spec.tree", "match_token": 211, "times": 2}
    clean = _staggered(_port(tiny_np, "", **ARMS["tree"]), GenRequest, [marked, SPEC_B])
    jax_engine = JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                           pipeline_depth=1, **ENGINE, **_page_kw(""), **ARMS["tree"])
    engine = _port(tiny_np, "", **ARMS["tree"])
    try:
        jax_faults.configure([dict(spec)])
        want = _staggered(jax_engine, JaxGenRequest, [marked, SPEC_B])
        faults.configure([dict(spec)])
        got = _staggered(engine, GenRequest, [marked, SPEC_B])
    finally:
        faults.clear()
        jax_faults.clear()
        jax_engine.stop()
    assert got == want == clean
    ragged = engine.lifecycle_stats()["ragged"]
    assert engine.counters["spec_tree_fallbacks"] == 2 == ragged["spec_tree_fallbacks"]
    assert jax_engine.counters["spec_tree_fallbacks"] == 2
    assert ragged["step_rows"]["spec_verify"] >= 1
    pool = engine.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


def test_health_reports_the_spec_fields(tiny_np):
    engine = _port(tiny_np, "", **ARMS["tree"])
    ragged = engine.health()["ragged"]
    assert ragged["step_rows"] == {"prefill": 0, "decode": 0, "spec_verify": 0}
    assert ragged["spec_acceptance"]["buckets"] == [0.0, 0.2, 0.4, 0.6, 0.8, 1.0]
    assert ragged["spec_tree_depth"]["buckets"] == [0, 1, 2, 3, 4, 8, 16]
    assert ragged["spec_proposer"] == {"name": "ngram-forest", "proposed": 0, "hit": 0,
                                       "branched": 0}


@pytest.mark.parametrize("knobs", [
    {"speculation": "medusa"},
    {"spec_tree": True},
    {"spec_tree": True, "speculation": ""},
], ids=["not_ngram", "tree_without_speculation", "tree_with_empty_speculation"])
def test_knob_errors_equal_reference(tiny_np, knobs):
    with pytest.raises(ValueError) as want:
        JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                  pipeline_depth=1, **dict(ENGINE, **knobs))
    with pytest.raises(ValueError) as got:
        _port(tiny_np, "", **knobs)
    assert str(got.value) == str(want.value)


def test_speculation_under_two_dispatch_raises_naming_it(tiny_np):
    with pytest.raises(ValueError, match="speculation.*serial speculation scan"):
        LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")),
                      **dict(ENGINE, scheduler="two_dispatch"), **SPEC)


AUX = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "cache": "paged",
       "max_batch": 2, "max_seq_len": 128, "prefill_buckets": [32, 64],
       "scheduler": "ragged", "step_token_budget": 12, "seed": 0}


@pytest.mark.parametrize("key,value", [("spec_k", "four"), ("spec_ngram", None),
                                       ("spec_branch", "2.5")])
def test_aux_key_errors_equal_the_reference_parse(tiny_np, key, value):
    """The aux block parses the keys as the reference's route does
    (``int(engine_cfg.get(...))``), so a bad value raises the same error."""
    with pytest.raises((ValueError, TypeError)) as want:
        int({key: value}.get(key, 4))
    with pytest.raises(type(want.value)) as got:
        build_engine(dict(AUX, speculation="ngram", **{key: value}), device="cpu",
                     params=convert_params(tiny_np, device="cpu"))
    assert str(got.value) == str(want.value)


def test_build_engine_passes_the_spec_aux_keys(tiny_np):
    engine, _tok = build_engine(
        dict(AUX, speculation="ngram", spec_k=3, spec_ngram=1, spec_sampling=False,
             spec_tree=True, spec_branch=3),
        device="cpu", params=convert_params(tiny_np, device="cpu"))
    assert (engine._speculation, engine._spec_k, engine._spec_ngram) == ("ngram", 3, 1)
    assert engine._spec_sampling is False and engine._spec_tree is True
    assert engine._spec_proposer.branch == 3


CHAT = "/serve/openai/v1/chat/completions"


def _http_contents(tiny_np, **aux):
    engine, tok = build_engine(dict(AUX, **aux), device="cpu",
                               params=convert_params(tiny_np, device="cpu"))
    app = port_app(engine, tok, "tiny_llm")

    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        out = []
        try:
            for content in ("abcabcabcabc", "the sea the sea the"):
                for stream in (False, True):
                    r = await client.post(CHAT, json={
                        "model": "tiny_llm", "max_tokens": 16, "stream": stream,
                        "messages": [{"role": "user", "content": content}]})
                    assert r.status == 200, await r.text()
                    if not stream:
                        out.append((await r.json())["choices"][0]["message"]["content"])
                        continue
                    pieces = []
                    async for raw in r.content:
                        line = raw.decode().strip()
                        if line.startswith("data: ") and line != "data: [DONE]":
                            delta = json.loads(line[6:])["choices"][0]["delta"]
                            pieces.append(delta.get("content") or "")
                    out.append("".join(pieces))
        finally:
            await client.close()
        return out, engine.health()["ragged"]

    return asyncio.run(run())


def test_tree_endpoint_content_equals_plain_ragged_endpoint(tiny_np):
    want, _ = _http_contents(tiny_np)
    got, ragged = _http_contents(tiny_np, speculation="ngram", spec_tree=True)
    assert got == want and any(want)
    assert ragged["step_rows"]["spec_verify"] >= 1
