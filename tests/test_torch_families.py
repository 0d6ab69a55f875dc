"""The model families of the port's paged path held against the reference's
``build(cfg)`` bundle and engine on llama-tiny-shaped configs in float32:
RoPE scaling (llama3, linear, yarn with and without ``attention_factor``,
longrope at positions on both sides of its original window), Qwen2's QKV
biases, tied embeddings, the Gemma deltas (``norm_offset`` norms, GeGLU,
``embed_scale``, ``head_dim`` twice ``dim / n_heads``), exact gelu and a
``query_scale`` override.

The reference initializes QKV biases and offset norms to zero, so every
test perturbs them (and the other norms) with seeded values first; the same
numpy weights then go to both sides through ``convert_params``.

- The logits of ``prefill``, ``prefill_chunk``, ``decode_paged`` and
  ``forward_ragged`` agree to atol = rtol = 1e-4.
- Greedy streams of the port's engine equal the JAX engine's under
  ``two_dispatch`` and ``ragged`` for llama3, Qwen2 and Gemma; Qwen2 also on
  int4 weights.
"""

import asyncio
import math

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
from clearml_serving_tpu.llm.kv_cache import PagedKVCache as JaxPagedKVCache
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.llm.openai_api import build_engine, make_tokenizer
from clearml_serving_tpu_torch.models.llama import (
    Llama,
    RopeTable,
    convert_params,
    deployed_rope_scaling,
    resolve_config,
)
from clearml_serving_tpu_torch.ops.quant import quantize_llama_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ATOL = 1e-4
_LONGROPE_RNG = np.random.default_rng(11)

# llama-tiny: dim 64, 4 query / 2 KV heads of 16 dims, max_seq_len 256
FAMILIES = {
    "llama3": {"rope_theta": 500000.0, "rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 32}},
    "linear": {"rope_scaling": {"type": "linear", "factor": 2.0}},
    "yarn": {"rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                              "original_max_position_embeddings": 32}},
    # the original window defaults from max_seq_len, the factor is explicit
    "yarn_attention_factor": {"rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                                               "attention_factor": 1.3}},
    # the window ends at 16: the prompts and decode rows below cross it
    "longrope": {"rope_scaling": {
        "rope_type": "longrope", "original_max_position_embeddings": 16,
        "short_factor": (1.0 + _LONGROPE_RNG.random(8)).round(3).tolist(),
        "long_factor": (2.0 + 4.0 * _LONGROPE_RNG.random(8)).round(3).tolist()}},
    "qwen2": {"attn_bias": True, "rope_theta": 1000000.0, "norm_eps": 1e-6},
    "tied": {"tie_embeddings": True},
    "gemma": {"norm_offset": True, "hidden_act": "gelu_pytorch_tanh", "tie_embeddings": True,
              "embed_scale": math.sqrt(64), "head_dim": 32, "n_kv_heads": 4,
              "norm_eps": 1e-6},
    "gelu": {"hidden_act": "gelu"},
    "query_scale": {"query_scale": 0.1},
}


def _cfg(family, kv_quant=""):
    cfg = dict(TINY, **FAMILIES[family])
    if kv_quant:
        cfg["kv_quant"] = kv_quant
    return cfg


def _perturbed(params, seed=0):
    """Seeded values on the leaves the reference initializes to a constant
    (norms, QKV biases), so their arithmetic shows in the logits."""
    rng = np.random.default_rng(seed)

    def fix(key, a):
        if key.endswith("norm"):
            return (np.asarray(a) + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
        if key in ("bq", "bk", "bv"):
            return (0.5 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    out = {k: fix(k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: fix(k, v) for k, v in layer.items()} for layer in params["layers"]]
    return out


_TREES = {}


def _np_params(family):
    """The family's reference weights (``build(cfg).init``), perturbed."""
    if family not in _TREES:
        bundle = models.build_model("llama", _cfg(family))
        tree = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))
        _TREES[family] = _perturbed(tree)
    return _TREES[family]


def _pair(family, kv_quant=""):
    cfg = _cfg(family, kv_quant)
    params = _np_params(family)
    return models.build_model("llama", cfg), params, Llama(cfg, convert_params(params, "cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=ATOL)


FAMILY_IDS = sorted(FAMILIES)


def test_family_leaves_follow_the_reference():
    """init's leaves: no lm_head when tied, QKV biases of the projections'
    widths, the Gemma head_dim decoupled from dim."""
    assert "lm_head" not in _np_params("tied") and "lm_head" not in _np_params("gemma")
    layer = _np_params("qwen2")["layers"][0]
    assert layer["bq"].shape == (64,) and layer["bk"].shape == layer["bv"].shape == (32,)
    _bundle, _params, model = _pair("gemma")
    assert model.head_dim == 32 and model.lm_head is None
    assert tuple(model.layers[0].wq.shape) == (64, 4 * 32)


@pytest.mark.parametrize("family", FAMILY_IDS)
def test_prefill_logits_and_cache(family):
    bundle, params, model = _pair(family)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    seq_lens = np.array([24, 13], np.int32)
    last_j, cache_j = bundle.prefill(params, jnp.asarray(tokens), jnp.asarray(seq_lens),
                                     bundle.init_cache(2, 24))
    last_t, cache_t = model.prefill(torch.from_numpy(tokens).long(), torch.from_numpy(seq_lens))
    _close(last_t.numpy(), last_j)
    for key in ("k", "v"):
        for b, n in enumerate(seq_lens):
            _close(cache_t[key][:, b, :n].numpy(), np.asarray(cache_j[key])[:, b, :n])


@pytest.mark.parametrize("family", FAMILY_IDS)
def test_prefill_chunk_logits_and_cache(family):
    """A 12-token prompt, then chunks of 8 at starts 12 and 20 (the last
    padded past the prompt's end); the cache buffers agree too."""
    bundle, params, model = _pair(family)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 512, 26).astype(np.int32)
    size, plen = 32, 12
    toks = np.zeros((1, size), np.int32)
    toks[0, :plen] = ids[:plen]
    _, jc = bundle.prefill(params, jnp.asarray(toks), jnp.asarray([plen], jnp.int32),
                           bundle.init_cache(1, size))
    tc = {key: torch.from_numpy(np.array(value)) for key, value in jc.items()}
    for start in (12, 20):
        n = min(8, len(ids) - start)
        seg = np.zeros((1, 8), np.int32)
        seg[0, :n] = ids[start:start + n]
        jl, jc = bundle.prefill_chunk(params, jnp.asarray(seg), jnp.asarray([start], jnp.int32),
                                      jnp.asarray([n - 1], jnp.int32), jc)
        tl, tc = model.prefill_chunk(torch.from_numpy(seg).long(), torch.tensor([start]),
                                     torch.tensor([n - 1]), tc)
        _close(tl.numpy(), jl)
        for key in jc:
            np.testing.assert_allclose(tc[key].float().numpy(),
                                       np.asarray(jc[key]).astype(np.float32),
                                       atol=ATOL, rtol=ATOL, err_msg=key)


def _write_history(bundle, params, jcache, tcache, slot, ids, quant):
    """A prompt's K/V from the reference's prefill, written into both
    sides' pools at ``slot``, so a step starts from the same state."""
    n = len(ids)
    _last, mini = bundle.prefill(params, jnp.asarray(ids[None]), jnp.asarray([n], jnp.int32),
                                 bundle.init_cache(1, n))
    parts = [np.array(mini[k])[:, 0, :n] for k in ("k", "v")]
    if quant:
        parts += [np.array(mini[k])[:, 0, :n] for k in ("k_scale", "v_scale")]
    jcache.write_prompt(slot, parts[0], parts[1], n, *parts[2:])
    tcache.write_prompt(slot, *(torch.from_numpy(p) for p in parts[:2]), n,
                        *(torch.from_numpy(p) for p in parts[2:]))


def _caches(bundle, model, kv_quant, num_pages, max_slots):
    geo = dict(num_pages=num_pages, page_size=4, max_slots=max_slots)
    jcache = JaxPagedKVCache(bundle.n_layers, bundle.n_kv_heads, bundle.head_dim,
                             dtype="float32", kv_quant=kv_quant, **geo)
    tcache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                          dtype=torch.float32, kv_quant=kv_quant, device="cpu", **geo)
    return jcache, tcache


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
@pytest.mark.parametrize("family", FAMILY_IDS)
def test_decode_paged_three_steps(family, kv_quant):
    """Rows at 19 and 6 tokens decode three steps: positions 19-21 and 6-8
    (both sides of longrope's window of 16)."""
    bundle, params, model = _pair(family, kv_quant)
    jcache, tcache = _caches(bundle, model, kv_quant, num_pages=16, max_slots=2)
    rng = np.random.default_rng(2)
    for slot, n in enumerate((19, 6)):
        _write_history(bundle, params, jcache, tcache, slot,
                       rng.integers(0, 512, n).astype(np.int32), bool(kv_quant))
    next_tokens = rng.integers(0, 512, 2).astype(np.int32)
    for _step in range(3):
        lengths0 = jcache.pool.lengths().copy()
        wp, wo = np.zeros(2, np.int32), np.zeros(2, np.int32)
        for slot in (0, 1):
            start = jcache.pool.slot_length(slot)
            jcache.pool.extend(slot, 1)
            tcache.pool.extend(slot, 1)
            ((wp[slot], wo[slot]),) = jcache.pool.token_coords(slot, start, 1)
        table = jcache.pool.page_table(8)
        scale_j = {"k_scales": jcache.k_scale, "v_scales": jcache.v_scale} if kv_quant else {}
        out = bundle.decode_paged(params, jnp.asarray(next_tokens), jcache.k, jcache.v,
                                  jnp.asarray(table), jnp.asarray(lengths0), jnp.asarray(wp),
                                  jnp.asarray(wo), **scale_j)
        logits_j = out[0]
        if kv_quant:
            jcache.k, jcache.v, jcache.k_scale, jcache.v_scale = out[1:]
        else:
            jcache.k, jcache.v = out[1:]
        scale_t = {"k_scales": tcache.k_scale, "v_scales": tcache.v_scale} if kv_quant else {}
        logits_t = model.decode_paged(
            torch.from_numpy(next_tokens).long(), tcache.k, tcache.v, torch.from_numpy(table),
            torch.from_numpy(lengths0), torch.from_numpy(wp), torch.from_numpy(wo), **scale_t)
        _close(logits_t.numpy(), logits_j)
        next_tokens = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)


# (history in the cache, query tokens this step) per row: a decode row past
# longrope's window, a chunk at history 0 that crosses it, a chunk
# mid-history, an idle row
ROWS = [(21, 1), (0, 18), (6, 9), (0, 0)]


@pytest.mark.parametrize("family", FAMILY_IDS)
def test_forward_ragged_logits(family):
    bundle, params, model = _pair(family)
    jcache, tcache = _caches(bundle, model, "", num_pages=32, max_slots=len(ROWS))
    rng = np.random.default_rng(7)
    for slot, (hist, _n) in enumerate(ROWS):
        if hist:
            _write_history(bundle, params, jcache, tcache, slot,
                           rng.integers(0, 512, hist).astype(np.int32), False)
    row_lens = np.array([n for _h, n in ROWS], np.int32)
    t = int(row_lens.sum()) + 3
    starts = np.concatenate([[0], np.cumsum(row_lens)[:-1]]).astype(np.int32)
    flat = {name: np.zeros(t, np.int32) for name in
            ("tokens", "tok_pos", "tok_row", "write_page", "write_offset")}
    tok_valid = np.zeros(t, bool)
    row_last = np.zeros(len(ROWS), np.int32)
    kv_lens = np.zeros(len(ROWS), np.int32)
    for slot, (hist, n) in enumerate(ROWS):
        if not n:
            continue
        s = int(starts[slot])
        jcache.pool.extend(slot, n)
        tcache.pool.extend(slot, n)
        coords = jcache.pool.token_coords(slot, hist, n)
        flat["tokens"][s:s + n] = rng.integers(0, 512, n)
        flat["tok_pos"][s:s + n] = hist + np.arange(n)
        flat["tok_row"][s:s + n] = slot
        tok_valid[s:s + n] = True
        flat["write_page"][s:s + n] = [p for p, _ in coords]
        flat["write_offset"][s:s + n] = [o for _, o in coords]
        row_last[slot] = s + n - 1
        kv_lens[slot] = hist + n
    table = jcache.pool.page_table(8)
    head = (flat["tokens"], flat["tok_pos"], flat["tok_row"], tok_valid, row_last)
    rows = (table, kv_lens, starts, row_lens, flat["write_page"], flat["write_offset"])
    out = bundle.forward_ragged(params, *(jnp.asarray(a) for a in head), jcache.k, jcache.v,
                                *(jnp.asarray(a) for a in rows))
    logits = model.forward_ragged(
        torch.from_numpy(head[0]).long(), *(torch.from_numpy(a) for a in head[1:]),
        tcache.k, tcache.v, *(torch.from_numpy(a) for a in rows))
    live = row_lens > 0
    _close(logits.numpy()[live], np.asarray(out[0])[live])


@pytest.mark.parametrize("family", ["yarn", "yarn_attention_factor", "longrope"])
def test_rope_tables_take_the_reference_defaults(family):
    """The build-time defaults of the reference (yarn's original window and
    longrope's deployed length from max_seq_len) and the attention factor
    on cos/sin, against the reference's ``_rope`` at positions 0-63."""
    from clearml_serving_tpu.models.llama import _rope

    cfg = resolve_config(_cfg(family))
    scaling = deployed_rope_scaling(cfg)
    if family == "longrope":
        assert scaling["max_position_embeddings"] == 256
    else:
        assert scaling["original_max_position_embeddings"] == (
            256 if family == "yarn_attention_factor" else 32)
    pos = np.arange(64, dtype=np.int32)[None]
    cos_j, sin_j = _rope(jnp.asarray(pos), 16, float(cfg["rope_theta"]), scaling)
    cos_t, sin_t = RopeTable(16, float(cfg["rope_theta"]), scaling)(torch.from_numpy(pos))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6, rtol=1e-6)


# -- the engine ---------------------------------------------------------------

ENGINE = dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 64], eos_token_id=None,
              decode_steps=2)
LONG = [(i * 7 + 3) % 250 + 1 for i in range(40)]
SHORT = [5, 9, 2, 17, 33]
MID = [(i * 13 + 5) % 250 + 1 for i in range(19)]
SCHEDULERS = {
    "two_dispatch": {"scheduler": "two_dispatch"},
    "ragged": {"scheduler": "ragged", "step_token_budget": 12, "ragged_decode_steps": 2},
}
# Qwen2 at widths that give its int4 projections 2 scale groups (K = 256)
QWEN_WIDE = {"dim": 256, "n_heads": 4, "n_kv_heads": 2, "ffn_dim": 512}


def _staggered(engine, request_cls, prompts, n=8):
    """Each prompt is submitted once the previous one has its first token,
    so later admissions overlap live decode streams."""

    async def one(ids, started, go):
        if started is not None:
            await started.wait()
        out = []
        async for t in engine.generate(request_cls(prompt_ids=list(ids), max_new_tokens=n)):
            out.append(t)
            go.set()
        return out

    async def run():
        events = [asyncio.Event() for _ in prompts]
        outs = await asyncio.gather(*(
            one(p, events[i - 1] if i else None, events[i]) for i, p in enumerate(prompts)))
        await engine.wait_drained()
        return outs

    return asyncio.run(run())


@pytest.mark.parametrize("sched", sorted(SCHEDULERS))
@pytest.mark.parametrize("family,wq", [("llama3", ""), ("qwen2", ""), ("gemma", ""),
                                       ("qwen2", "int4")],
                         ids=["llama3", "qwen2", "gemma", "qwen2_int4"])
def test_greedy_streams_match_reference(family, wq, sched):
    cfg = dict(_cfg(family), **(QWEN_WIDE if wq else {}))
    if wq:
        bundle = models.build_model("llama", cfg)
        params = _perturbed(jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0))))
    else:
        bundle, params = models.build_model("llama", cfg), _np_params(family)
    knobs = dict(ENGINE, **SCHEDULERS[sched])
    quant = {"weight_quant": wq} if wq else {}
    jax_engine = JaxEngine(bundle, params, cache_mode="paged", pipeline_depth=1, **quant,
                           **knobs)
    want = _staggered(jax_engine, JaxGenRequest, [SHORT, LONG, MID])
    want_weights = jax_engine.lifecycle_stats()["weights"]
    jax_engine.stop()
    tree = convert_params(params, device="cpu")
    if wq:
        tree = quantize_llama_params(tree, bits=4)
    port = LLMEngineCore(Llama(cfg, tree), **quant, **knobs)
    got = _staggered(port, GenRequest, [SHORT, LONG, MID])
    assert got == want
    assert all(len(s) == 8 for s in got)
    assert port.health()["weights"] == want_weights
    pool = port.paged_cache.pool
    assert pool.free_pages == pool.num_pages - 1


# -- the aux engine block -----------------------------------------------------

def test_build_engine_takes_a_family_no_preset_matches():
    """engine.config over a preset name the port does not know carries every
    key of the family, the nested rope_scaling included, to the model."""
    config = resolve_config(dict(_cfg("qwen2"), rope_scaling=FAMILIES["yarn"]["rope_scaling"]))
    assert "preset" not in config and config["vocab_size"] == 512
    engine, tok = build_engine({"preset": "qwen2-tiny", "config": config, "cache": "paged",
                                "max_batch": 2, "max_seq_len": 96,
                                "prefill_buckets": [16, 64]}, device="cpu")
    model = engine.model
    assert model.attn_bias and model.eps == 1e-6 and model.theta == 1000000.0
    assert model.rope_scaling == dict(FAMILIES["yarn"]["rope_scaling"])
    assert model.rope.att == pytest.approx(0.1 * math.log(4.0) + 1.0)
    assert tok.vocab_size == 512
    engine.stop()


@pytest.mark.parametrize("vocab", [152064, 256000], ids=["qwen2.5", "gemma"])
def test_tokenizer_takes_the_family_vocab(vocab):
    assert make_tokenizer(resolve_config({"preset": "x", "vocab_size": vocab})).vocab_size == vocab


@pytest.mark.parametrize("knob", [{"sliding_window": 16}, {"attn_logit_softcap": 50.0}],
                         ids=["sliding_window", "softcap"])
def test_paged_refusals_carry_the_reference_words(knob):
    """A family the paged kernels do not serve is refused on cache=paged
    with the reference engine's words, before any weight is made."""
    cfg = dict(TINY, **knob)
    bundle = models.build_model("llama", cfg)
    with pytest.raises(ValueError) as want:
        JaxEngine(bundle, bundle.init(jax.random.PRNGKey(0)), cache_mode="paged",
                  pipeline_depth=1, **ENGINE)
    with pytest.raises(ValueError) as got:
        build_engine({"preset": "llama-tiny", "config": dict(knob, dtype="float32"),
                      "cache": "paged"}, device="cpu")
    assert str(got.value) == str(want.value)
