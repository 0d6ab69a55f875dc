"""The port's Llama (clearml_serving_tpu_torch/models/llama.py) held against
the reference's ``build(cfg)`` bundle on llama-tiny (2 layers, head_dim 16) in
float32, on the same weights (carried over by ``convert_params``) and the
same numpy inputs. Logits and written K/V agree to atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.kv_cache import PagedKVCache as JaxPagedKVCache
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.models.llama import (
    Llama,
    convert_params,
    init_params,
    resolve_config,
)

TINY = {"preset": "llama-tiny", "dtype": "float32"}
ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny_params():
    bundle = models.build_model("llama", TINY)
    params = bundle.init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _pair(np_params, kv_quant=""):
    cfg = dict(TINY, kv_quant=kv_quant) if kv_quant else dict(TINY)
    bundle = models.build_model("llama", cfg)
    model = Llama(cfg, convert_params(np_params, device="cpu"))
    return bundle, model


def test_prefill_last_logits_and_cache(tiny_params):
    bundle, model = _pair(tiny_params)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (2, 16)).astype(np.int32)
    seq_lens = np.array([16, 9], np.int32)
    last_j, cache_j = bundle.prefill(
        tiny_params, jnp.asarray(tokens), jnp.asarray(seq_lens), bundle.init_cache(2, 16)
    )
    last_t, cache_t = model.prefill(torch.from_numpy(tokens).long(),
                                    torch.from_numpy(seq_lens))
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=ATOL, rtol=ATOL)
    for key in ("k", "v"):
        for b, n in enumerate(seq_lens):
            np.testing.assert_allclose(
                cache_t[key][:, b, :n].numpy(), np.asarray(cache_j[key])[:, b, :n],
                atol=ATOL, rtol=ATOL,
            )


def _write_prompt_both(bundle, params, model, jcache, tcache, tokens, lens):
    """Prefill each prompt on the reference and write the SAME K/V into both
    sides' pools, so the decode comparison starts from identical state."""
    quant = bool(model.kv_quant)
    for slot, (row, n) in enumerate(zip(tokens, lens)):
        _last, mini = bundle.prefill(
            params, jnp.asarray(row[None]), jnp.asarray([n], jnp.int32),
            bundle.init_cache(1, len(row)),
        )
        k, v = np.array(mini["k"])[:, 0, :n], np.array(mini["v"])[:, 0, :n]
        scales = ()
        if quant:
            scales = (np.array(mini["k_scale"])[:, 0, :n],
                      np.array(mini["v_scale"])[:, 0, :n])
        jcache.write_prompt(slot, k, v, n, *scales)
        tcache.write_prompt(slot, torch.from_numpy(k), torch.from_numpy(v), n,
                            *(torch.from_numpy(s) for s in scales))


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_decode_paged_three_steps(tiny_params, kv_quant):
    bundle, model = _pair(tiny_params, kv_quant)
    geo = dict(num_pages=16, page_size=4, max_slots=2)
    jcache = JaxPagedKVCache(bundle.n_layers, bundle.n_kv_heads, bundle.head_dim,
                             dtype="float32", kv_quant=kv_quant, **geo)
    tcache = PagedKVCache(model.n_layers, model.n_kv_heads, model.head_dim,
                          dtype=torch.float32, kv_quant=kv_quant, device="cpu", **geo)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 512, (2, 12)).astype(np.int32)
    lens = [11, 6]   # 11 = two full pages and a partial third
    _write_prompt_both(bundle, tiny_params, model, jcache, tcache, tokens, lens)
    next_tokens = rng.integers(0, 512, 2).astype(np.int32)
    for _step in range(3):
        lengths0 = jcache.pool.lengths().copy()
        np.testing.assert_array_equal(lengths0, tcache.pool.lengths())
        wp, wo = np.zeros(2, np.int32), np.zeros(2, np.int32)
        for slot in (0, 1):
            start = jcache.pool.slot_length(slot)
            jcache.pool.extend(slot, 1)
            tcache.pool.extend(slot, 1)
            ((wp[slot], wo[slot]),) = jcache.pool.token_coords(slot, start, 1)
            assert tcache.pool.token_coords(slot, start, 1) == [(wp[slot], wo[slot])]
        table = jcache.pool.page_table(4)
        np.testing.assert_array_equal(table, tcache.pool.page_table(4))
        scale_j = ({"k_scales": jcache.k_scale, "v_scales": jcache.v_scale}
                   if kv_quant else {})
        out = bundle.decode_paged(
            tiny_params, jnp.asarray(next_tokens), jcache.k, jcache.v,
            jnp.asarray(table), jnp.asarray(lengths0), jnp.asarray(wp), jnp.asarray(wo),
            **scale_j,
        )
        if kv_quant:
            logits_j, jcache.k, jcache.v, jcache.k_scale, jcache.v_scale = out
        else:
            logits_j, jcache.k, jcache.v = out
        scale_t = ({"k_scales": tcache.k_scale, "v_scales": tcache.v_scale}
                   if kv_quant else {})
        logits_t = model.decode_paged(
            torch.from_numpy(next_tokens).long(), tcache.k, tcache.v,
            torch.from_numpy(table), torch.from_numpy(lengths0),
            torch.from_numpy(wp), torch.from_numpy(wo), **scale_t,
        )
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   atol=ATOL, rtol=ATOL)
        # the rows this step wrote
        for name in ("k", "v"):
            got = getattr(tcache, name)[:, :, wp, wo].numpy()
            want = np.asarray(getattr(jcache, name))[:, :, wp, wo]
            if kv_quant:
                # int8 codes may differ by one where x/scale sits on a .5 tie
                assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
                assert (got == want).mean() > 0.99
                np.testing.assert_allclose(
                    getattr(tcache, name + "_scale")[:, :, wp, wo].numpy(),
                    np.asarray(getattr(jcache, name + "_scale"))[:, :, wp, wo],
                    rtol=1e-5, atol=1e-7,
                )
            else:
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
        next_tokens = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_params_round_trips_every_leaf(dtype):
    bundle = models.build_model("llama", {"preset": "llama-tiny", "dtype": dtype})
    np_tree = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(3)))
    tree = convert_params(np_tree, device="cpu")
    want_dtype = getattr(torch, dtype)

    def same(t, a):
        assert t.dtype == want_dtype and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))

    for key in ("embed", "final_norm", "lm_head"):
        same(tree[key], np_tree[key])
    assert len(tree["layers"]) == len(np_tree["layers"])
    for t_layer, j_layer in zip(tree["layers"], np_tree["layers"]):
        assert set(t_layer) == set(j_layer)
        for key in j_layer:
            same(t_layer[key], j_layer[key])


def test_convert_params_takes_stacked_layers(tiny_params):
    stacked = dict(tiny_params)
    stacked["layers"] = {k: np.stack([layer[k] for layer in tiny_params["layers"]])
                         for k in tiny_params["layers"][0]}
    tree = convert_params(stacked, device="cpu")
    for t_layer, j_layer in zip(tree["layers"], tiny_params["layers"]):
        for key in j_layer:
            np.testing.assert_array_equal(t_layer[key].numpy(), j_layer[key])


ROPE_SCALINGS = {
    "llama3": {"rope_type": "llama3", "factor": 8.0, "original_max_position_embeddings": 16},
    "linear": {"rope_type": "linear", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0},
    "longrope": {"type": "longrope", "short_factor": [1.0 + i / 8 for i in range(8)],
                 "long_factor": [2.0 + i / 4 for i in range(8)],
                 "original_max_position_embeddings": 8},
}
# each type with one fault: the factor missing, or a factor list of the
# wrong length
BAD_ROPE_SCALINGS = {
    "llama3": {"rope_type": "llama3"},
    "linear": {"rope_type": "linear"},
    "yarn": {"rope_type": "yarn", "beta_fast": 16.0},
    "longrope": dict(ROPE_SCALINGS["longrope"], long_factor=[1.0] * 4),
}


@pytest.mark.parametrize("rope_type", sorted(ROPE_SCALINGS))
def test_rope_scaling_raises(rope_type):
    """A bad config of each RoPE type raises what the reference's build()
    raises, with the same words, before any weight is made."""
    cfg = dict(TINY, rope_scaling=BAD_ROPE_SCALINGS[rope_type])
    with pytest.raises((KeyError, ValueError)) as want:
        models.build_model("llama", cfg)
    with pytest.raises(type(want.value)) as got:
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("rope_type", sorted(ROPE_SCALINGS))
def test_rope_scaling_matches_reference(rope_type):
    """Each RoPE type's prefill logits equal the reference's on the same
    weights (positions 0-15, past llama3's and longrope's windows)."""
    cfg = dict(TINY, rope_scaling=ROPE_SCALINGS[rope_type])
    bundle = models.build_model("llama", cfg)
    params = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))
    model = Llama(cfg, convert_params(params, device="cpu"))
    tokens = np.random.default_rng(3).integers(0, 512, (2, 16)).astype(np.int32)
    seq_lens = np.array([16, 11], np.int32)
    want, _ = bundle.prefill(params, jnp.asarray(tokens), jnp.asarray(seq_lens),
                             bundle.init_cache(2, 16))
    got, _ = model.prefill(torch.from_numpy(tokens).long(), torch.from_numpy(seq_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("knob", [
    {"lora_rank": 4}, {"n_experts": 4}, {"attn_logit_softcap": 50.0},
    {"final_logit_softcap": 30.0}, {"sliding_window": 32},
    {"alt_window": True}, {"post_block_norms": True},
    {"int4_fused": False},
], ids=["lora", "moe", "softcap", "final_softcap", "sliding_window", "alt_window",
        "post_block_norms", "int4_fused"])
def test_unsupported_model_knobs_raise(knob):
    """What stays for a later slice raises naming the knob, before any
    weight is made."""
    with pytest.raises(NotImplementedError, match=next(iter(knob))):
        init_params(dict(TINY, **knob), torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("knob", [
    {"tie_embeddings": True}, {"hidden_act": "gelu_tanh"},
], ids=["tied", "gelu"])
def test_served_model_knobs_match_reference(knob):
    """Knobs this port refused before the model families came: tied
    embeddings and GeGLU give the reference's prefill logits."""
    cfg = dict(TINY, **knob)
    bundle = models.build_model("llama", cfg)
    params = jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))
    model = Llama(cfg, convert_params(params, device="cpu"))
    tokens = np.random.default_rng(4).integers(0, 512, (1, 12)).astype(np.int32)
    want, _ = bundle.prefill(params, jnp.asarray(tokens), jnp.asarray([12], jnp.int32),
                             bundle.init_cache(1, 12))
    got, _ = model.prefill(torch.from_numpy(tokens).long(), torch.tensor([12]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_unknown_hidden_act_raises_the_reference_words():
    cfg = dict(TINY, hidden_act="relu2")
    with pytest.raises(ValueError) as want:
        models.build_model("llama", cfg)
    with pytest.raises(ValueError) as got:
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert str(got.value) == str(want.value)


def test_init_params_full_width_shapes_and_scale():
    cfg = resolve_config(TINY)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    model = Llama(cfg, params)
    assert model.head_dim == 16 and model.group == 2
    w = params["layers"][0]["w_down"]
    assert tuple(w.shape) == (128, 64)
    # fan_in**-0.5 scaling: std ~ 128**-0.5
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    assert torch.equal(params["final_norm"], torch.ones(64))


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(TINY, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["model_dtype_pools", "int8"])
def test_kv_cache_writes_match_reference(kv_quant):
    """write_prompt (page-spanning prompt) then append_token, on both
    sides' caches: same page ids, same pool rows and scale rows."""
    rng = np.random.default_rng(4)
    n_layers, hkv, d, n = 2, 2, 16, 11
    geo = dict(num_pages=8, page_size=4, max_slots=2)
    jcache = JaxPagedKVCache(n_layers, hkv, d, dtype="float32", kv_quant=kv_quant, **geo)
    tcache = PagedKVCache(n_layers, hkv, d, dtype=torch.float32, kv_quant=kv_quant,
                          device="cpu", **geo)
    k = rng.standard_normal((n_layers, n, hkv, d)).astype(np.float32)
    v = rng.standard_normal((n_layers, n, hkv, d)).astype(np.float32)
    kt = rng.standard_normal((n_layers, hkv, d)).astype(np.float32)
    vt = rng.standard_normal((n_layers, hkv, d)).astype(np.float32)
    if kv_quant:
        k, v, kt, vt = (np.round(x * 20).clip(-127, 127).astype(np.int8)
                        for x in (k, v, kt, vt))
        scales = [rng.random(s).astype(np.float32) + 0.1
                  for s in ((n_layers, n, hkv),) * 2 + ((n_layers, hkv),) * 2]
    else:
        scales = [None] * 4
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    jcache.write_prompt(1, k, v, n, scales[0], scales[1])
    tcache.write_prompt(1, t(k), t(v), n, t(scales[0]), t(scales[1]))
    jcache.append_token(1, kt, vt, scales[2], scales[3])
    tcache.append_token(1, t(kt), t(vt), t(scales[2]), t(scales[3]))
    pages = jcache.pool.slot_pages(1)
    assert tcache.pool.slot_pages(1) == pages and len(pages) == 3
    assert tcache.pool.slot_length(1) == jcache.pool.slot_length(1) == n + 1
    live = np.asarray(pages)
    names = ("k", "v") + (("k_scale", "v_scale") if kv_quant else ())
    for name in names:
        want = np.asarray(getattr(jcache, name))[:, :, live].reshape(n_layers, hkv, 12, -1)
        got = getattr(tcache, name)[:, :, live].numpy().reshape(n_layers, hkv, 12, -1)
        np.testing.assert_array_equal(got[:, :, : n + 1], want[:, :, : n + 1])
