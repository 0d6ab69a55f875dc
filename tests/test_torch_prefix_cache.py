"""The port's radix prefix cache (clearml_serving_tpu_torch/llm/
prefix_cache.py), KV sanitizer (llm/kv_sanitizer.py) and
``Llama.prefill_chunk`` against the reference's.

- One seeded sequence of ``store_pages``, ``lookup_pages``/``release``,
  ``match_len``, ``uncount_hit``, ``pin_run``/``unpin_run`` and budget
  evictions goes through the reference's tree and the port's, each over
  its own pool holding the same pages: equal hit lengths, page lists,
  ``stats()`` and pool states after every step.
- The reference's ``tests/test_prefix_cache.py`` unit cases on paged
  payloads, and the sanitizer cases of ``tests/test_kv_page_lifecycle.py``.
- ``prefill_chunk`` over a mini cache a prefill filled, float32 and int8
  KV: logits and the cache it writes within ``ATOL`` 1e-4 of the
  reference's (``tests/test_torch_llama.py``'s tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.kv_cache import PagePool as JaxPagePool
from clearml_serving_tpu.llm.prefix_cache import RadixPrefixCache as JaxRadix
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache, PagePool
from clearml_serving_tpu_torch.llm.kv_sanitizer import (
    KVSanitizer,
    KVSanitizerError,
    enabled as sanitizer_enabled,
)
from clearml_serving_tpu_torch.llm.prefix_cache import RadixPrefixCache
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

ATOL = 1e-4


# -- the tree against the reference's on one seeded sequence ----------------------


def _tree_pair(**budget):
    geo = dict(num_pages=64, page_size=2, max_slots=4)
    port_pool, ref_pool = PagePool(**geo), JaxPagePool(**geo)
    kw = dict(block=4, page_bytes=64, **budget)
    return (RadixPrefixCache(pool=port_pool, **kw), port_pool,
            JaxRadix(pool=ref_pool, **kw), ref_pool)


@pytest.mark.parametrize("budget", [dict(max_nodes=6), dict(max_nodes=64, max_bytes=640),
                                    dict(max_nodes=64, max_pages=9)],
                         ids=["nodes", "bytes", "pages"])
@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_tree_sequence_matches_reference(seed, budget):
    rng = np.random.default_rng(seed)
    port, port_pool, ref, ref_pool = _tree_pair(**budget)
    heads = [rng.integers(1, 6, 16).tolist() for _ in range(3)]
    hits, pins = [], []
    for step in range(160):
        kind = rng.integers(6)
        ids = list(heads[rng.integers(3)][:int(rng.integers(5, 17))])
        ids += rng.integers(1, 6, int(rng.integers(0, 6))).tolist()
        if kind == 0:
            slot = int(rng.integers(4))
            for pool in (port_pool, ref_pool):
                pool.free(slot)
                pool.allocate(slot, len(ids))
            port.store_pages(ids, 0, port_pool.slot_pages(slot))
            ref.store_pages(ids, 0, ref_pool.slot_pages(slot))
            if rng.random() < 0.5:
                port_pool.free(slot)
                ref_pool.free(slot)
        elif kind == 1:
            got, want = port.lookup_pages(ids, 0), ref.lookup_pages(ids, 0)
            assert (got and (got["len"], got["pages"], got["tier"])) == \
                (want and (want["len"], want["pages"], want["tier"])), step
            if got:
                hits.append((got, want))
        elif kind == 2 and hits:
            got, want = hits.pop(int(rng.integers(len(hits))))
            if rng.random() < 0.3:
                port.uncount_hit(got)
                ref.uncount_hit(want)
            port.release(got)
            ref.release(want)
            port.release(got)   # releasing twice is a no-op
        elif kind == 3:
            assert port.match_len(ids) == ref.match_len(ids)
        elif kind == 4:
            pins.append((port.pin_run(ids, 0), ref.pin_run(ids, 0)))
            assert (pins[-1][0] is None) == (pins[-1][1] is None)
        elif kind == 5 and pins:
            got, want = pins.pop(int(rng.integers(len(pins))))
            port.unpin_run(got)
            ref.unpin_run(want)
        assert port.stats() == ref.stats(), step
        assert port_pool.snapshot() == ref_pool.snapshot(), step
        assert (len(port), port.cached_pages, port.total_bytes) == \
            (len(ref), ref.cached_pages, ref.total_bytes)
        assert port.page_refs() == ref.page_refs()
    assert port.stats()["evictions"] > 0


def test_lora_namespace_and_backend_knob():
    """Adapter index 0 is the only namespace the port uses; another index
    misses. A tiering backend is served once its host tier is enabled (the
    reference's message when it is not), and the dense backend (no pool)
    raises."""
    cache, pool = _paged_cache()
    pool.allocate(0, 6)
    cache.store_pages([1, 2, 3, 4, 5, 6], 0, pool.slot_pages(0))
    assert cache.match_len([1, 2, 3, 4, 9], 0) == 4
    assert cache.lookup_pages([1, 2, 3, 4, 9], 1) is None
    backend = PagedKVCache(1, 1, 4, num_pages=8, page_size=2, max_slots=2,
                           dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="host tier is not enabled"):
        RadixPrefixCache(pool=backend.pool, block=4, backend=backend)
    backend.enable_host_tier(4)
    tiered = RadixPrefixCache(pool=backend.pool, block=4, backend=backend, host_max_pages=3)
    assert tiered.host_max_pages == 3 and tiered.stats()["host_pages"] == 0
    with pytest.raises(ValueError, match="dense"):
        RadixPrefixCache(block=4)


# -- the reference's unit cases, on paged payloads (tests/test_prefix_cache.py) ---


def _paged_cache(block=4, page_size=2, **kw):
    pool = PagePool(num_pages=32, page_size=page_size, max_slots=4)
    return RadixPrefixCache(block=block, pool=pool, page_bytes=64, **kw), pool


def _store(cache, pool, ids, slot=0):
    pool.free(slot)
    pool.allocate(slot, len(ids))
    cache.store_pages(ids, 0, pool.slot_pages(slot))
    pool.free(slot)


def _hit_len(cache, ids):
    hit = cache.lookup_pages(ids, 0)
    if hit is None:
        return 0
    cache.release(hit)
    return hit["len"]


def test_block_alignment_and_partial_hits():
    cache, pool = _paged_cache()
    ids = list(range(1, 12))                     # prefix cap = floor(10/4)*4 = 8
    assert cache.longest_prefix_len(len(ids)) == 8
    _store(cache, pool, ids)
    assert _hit_len(cache, ids) == 8
    assert _hit_len(cache, ids[:4] + [99, 98, 97, 96, 95]) == 4
    assert _hit_len(cache, ids[:8] + [55, 44, 33]) == 8
    assert _hit_len(cache, [7, 7, 7, 7, 7]) == 0


def test_store_extends_existing_path():
    cache, pool = _paged_cache(block=2)
    _store(cache, pool, [1, 2, 3])
    assert len(cache) == 1
    _store(cache, pool, [1, 2, 5, 6, 7])
    assert len(cache) == 2
    assert _hit_len(cache, [1, 2, 5, 6, 9]) == 4


def test_uncount_hit_reclassifies_as_miss():
    cache, pool = _paged_cache(block=2)
    _store(cache, pool, [1, 2, 3])
    hit = cache.lookup_pages([1, 2, 9], 0)
    assert cache.hits == 1 and cache.hit_tokens == 2
    cache.release(hit)
    cache.uncount_hit(hit)
    assert cache.hits == 0 and cache.misses == 1 and cache.hit_tokens == 0


def test_lru_leaf_eviction():
    cache, pool = _paged_cache(block=2, max_nodes=2)
    _store(cache, pool, [1, 2, 3])
    _store(cache, pool, [4, 5, 6])
    assert _hit_len(cache, [1, 2, 3]) == 2       # touch -> most recent
    _store(cache, pool, [7, 8, 9])               # evicts the [4, 5] leaf
    assert _hit_len(cache, [4, 5, 6]) == 0
    assert _hit_len(cache, [1, 2, 3]) == 2
    assert _hit_len(cache, [7, 8, 9]) == 2
    assert cache.evictions == 1


def test_eviction_is_leaf_first():
    cache, pool = _paged_cache(block=2, max_nodes=3)
    _store(cache, pool, [1, 2, 3, 4, 5, 6, 7])   # 3 chained nodes
    _store(cache, pool, [9, 9, 9])
    assert _hit_len(cache, [1, 2, 3, 4, 0, 0, 0]) == 4
    assert _hit_len(cache, [9, 9, 0]) == 2


def test_byte_budget_eviction():
    cache, pool = _paged_cache(block=2, max_nodes=64, max_bytes=2 * 64)
    for ids in ([1, 2, 3], [4, 5, 6], [7, 8, 9]):
        _store(cache, pool, ids)
    assert cache.total_bytes <= 2 * 64 and len(cache) == 2


def test_store_pages_takes_refs_and_lookup_pins():
    cache, pool = _paged_cache()
    ids = [1, 2, 3, 4, 5, 6]
    pool.allocate(0, 6)
    pages = pool.slot_pages(0)
    cache.store_pages(ids, 0, pages)
    assert cache.cached_pages == 2
    assert pool.page_refcount(pages[0]) == 2
    pool.free(0)
    assert pool.page_refcount(pages[0]) == 1
    assert pool.page_refcount(pages[2]) == 0
    hit = cache.lookup_pages([1, 2, 3, 4, 9, 9], 0)
    assert hit["len"] == 4 and hit["pages"] == pages[:2]
    assert pool.page_refcount(pages[0]) == 2
    cache.release(hit)
    assert pool.page_refcount(pages[0]) == 1


def test_paged_eviction_never_frees_live_slot_pages():
    cache, pool = _paged_cache(max_nodes=1)
    pool.allocate(0, 6)
    pages0 = pool.slot_pages(0)
    cache.store_pages([1, 2, 3, 4, 5, 6], 0, pages0)
    pool.allocate(1, 6)
    cache.store_pages([7, 8, 9, 10, 11, 12], 0, pool.slot_pages(1))
    assert cache.evictions == 1
    assert all(pool.page_refcount(p) == 1 for p in pages0)
    free_before = pool.free_pages
    pool.free(0)
    assert pool.free_pages == free_before + len(pages0)


def test_pin_run_protects_stored_run_from_eviction():
    cache, pool = _paged_cache(max_nodes=1)
    pool.allocate(0, 6)
    cache.store_pages([1, 2, 3, 4, 5, 6], 0, pool.slot_pages(0))
    pin = cache.pin_run([1, 2, 3, 4, 5, 6], 0)
    assert pin is not None and pin["len"] == 4
    pool.allocate(1, 6)
    cache.store_pages([7, 8, 9, 10, 11, 12], 0, pool.slot_pages(1))
    assert cache.match_len([1, 2, 3, 4, 9]) == 4
    hit = cache.lookup_pages([1, 2, 3, 4, 9, 9], 0)
    assert hit is not None and hit["len"] == 4
    cache.release(hit)
    cache.unpin_run(pin)
    assert len(cache) <= 1
    pool.allocate(2, 6)
    cache.store_pages([13, 14, 15, 16, 17, 18], 0, pool.slot_pages(2))
    assert cache.match_len([1, 2, 3, 4, 9]) == 0


def test_pin_run_miss_returns_none_and_unpin_tolerates_it():
    cache, _pool = _paged_cache()
    assert cache.pin_run([1, 2, 3], 0) is None
    cache.unpin_run(None)


# -- the sanitizer (tests/test_kv_page_lifecycle.py) --------------------------------


@pytest.fixture
def armed_sanitizer(monkeypatch):
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    assert sanitizer_enabled()


def _pool():
    return PagePool(num_pages=16, page_size=4, max_slots=4)


def test_sanitizer_clean_pool_passes_all_checks(armed_sanitizer):
    pool = _pool()
    san = KVSanitizer(pool)
    pool.allocate(0, 10)
    pool.allocate(1, 5)
    san.check("step")
    pool.free(0)
    pool.free(1)
    san.check("drain", drained=True)
    assert san.stats() == {"checks": 2, "failures": 0}


def test_sanitizer_names_unaccounted_reference():
    pool = _pool()
    san = KVSanitizer(pool)
    pages = pool.allocate(0, 4)
    with pool._lock:
        pool._refs[pages[0]] += 1
    with pytest.raises(KVSanitizerError) as ei:
        san.check("step")
    assert ei.value.pages == [pages[0]]
    assert "refcount conservation" in str(ei.value)
    assert "page {}".format(pages[0]) in str(ei.value)


def test_sanitizer_catches_free_list_corruption():
    pool = _pool()
    san = KVSanitizer(pool)
    pages = pool.allocate(0, 4)
    with pool._lock:
        pool._free.append(pages[0])
    with pytest.raises(KVSanitizerError) as ei:
        san.check("step")
    assert "free list" in str(ei.value)


def test_sanitizer_catches_slot_table_shape_drift():
    pool = _pool()
    san = KVSanitizer(pool)
    pool.allocate(0, 5)
    with pool._lock:
        pool._slot_len[0] = 9
    with pytest.raises(KVSanitizerError) as ei:
        san.check("step")
    assert "slot 0" in str(ei.value)


def test_sanitizer_drain_flags_abandoned_slot_pages():
    pool = _pool()
    san = KVSanitizer(pool)
    pages = pool.allocate(0, 8)
    san.check("step")
    with pytest.raises(KVSanitizerError) as ei:
        san.check("drain", drained=True)
    assert ei.value.where == "drain"
    assert sorted(ei.value.pages) == sorted(pages)
    assert "leaked pages at drain" in str(ei.value)


def test_sanitizer_accounts_radix_cache_and_pins():
    pool = PagePool(num_pages=32, page_size=4, max_slots=4)
    cache = RadixPrefixCache(max_nodes=16, block=4, pool=pool, page_bytes=64)
    san = KVSanitizer(pool, cache)
    ids = list(range(1, 14))
    pool.allocate(0, len(ids))
    cache.store_pages(ids, 0, pool.slot_pages(0))
    san.check("step")
    hit = cache.lookup_pages(ids, 0)
    assert hit is not None and len(hit["pages"]) == 3
    san.check("step")
    cache.release(hit)
    san.check("step")
    pool.free(0)
    san.check("drain", drained=True)
    assert san.stats()["failures"] == 0


def test_sanitizer_accounts_parked_pages_as_pins():
    """A preempted request's parked pages are pins: conservation holds
    while they wait, and a drain with pages still parked is flagged."""
    pool = _pool()
    san = KVSanitizer(pool)
    parked = pool.detach(0) if pool.allocate(0, 9) else None
    san.check("step")
    with pytest.raises(KVSanitizerError, match="pins outlived drain"):
        san.check("drain", drained=True)
    pool.release(parked)
    san.check("drain", drained=True)


def test_int8_sanitizer_checks_scale_shape_and_names_scale_rows():
    cache = PagedKVCache(1, 1, 2, num_pages=8, page_size=4, max_slots=2,
                         dtype=torch.float32, kv_quant="int8", device="cpu")
    pool = cache.pool
    san = KVSanitizer(pool, paged_cache=cache)
    san.check("step")
    pool.allocate(0, 8)
    with pytest.raises(KVSanitizerError) as err:
        san.check("drain", drained=True)
    assert "scale rows" in str(err.value)
    pool.free(0)
    cache.k_scale = torch.zeros((1, 1, 4, 4))
    with pytest.raises(KVSanitizerError) as err:
        san.check("step")
    assert "lifecycle" in str(err.value)


# -- prefill_chunk against the reference's ------------------------------------------


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float32", "int8"])
def test_prefill_chunk_matches_reference(kv_quant):
    """A 20-token prompt prefilled into an 80-token mini cache, then three
    chunks of 16 at absolute starts 20, 36 and 52 (the last padded past
    the prompt's end, its logits at the last real token; the middle one
    without logits): the logits and every buffer of the cache equal the
    reference's within ``ATOL``."""
    cfg = {"preset": "llama-tiny", "dtype": "float32"}
    if kv_quant:
        cfg["kv_quant"] = kv_quant
    bundle = models.build_model("llama", cfg)
    params = bundle.init(jax.random.PRNGKey(0))
    model = Llama(cfg, convert_params(jax.tree.map(np.asarray, params), device="cpu"))
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 512, 60).astype(np.int32)
    size, plen = 80, 20
    toks = np.zeros((1, size), np.int32)
    toks[0, :plen] = ids[:plen]
    _, jc = bundle.prefill(params, jnp.asarray(toks), jnp.asarray([plen], jnp.int32),
                           bundle.init_cache(1, size))
    tc = {key: torch.from_numpy(np.array(value)) for key, value in jc.items()}
    for start, with_logits in ((20, True), (36, False), (52, True)):
        n = min(16, len(ids) - start)
        seg = np.zeros((1, 16), np.int32)
        seg[0, :n] = ids[start:start + n]
        jl, jc = bundle.prefill_chunk(params, jnp.asarray(seg), jnp.asarray([start], jnp.int32),
                                      jnp.asarray([n - 1], jnp.int32), jc,
                                      with_logits=with_logits)
        tl, tc = model.prefill_chunk(torch.from_numpy(seg).long(), torch.tensor([start]),
                                     torch.tensor([n - 1]), tc, with_logits=with_logits)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
        for key in jc:
            np.testing.assert_allclose(tc[key].float().numpy(),
                                       np.asarray(jc[key]).astype(np.float32),
                                       atol=ATOL, rtol=0, err_msg=key)


def test_prefill_chunk_refuses_lora():
    model = Llama({"preset": "llama-tiny", "dtype": "float32"},
                  convert_params(jax.tree.map(np.asarray, models.build_model(
                      "llama", {"preset": "llama-tiny", "dtype": "float32"}).init(
                          jax.random.PRNGKey(0))), device="cpu"))
    with pytest.raises(NotImplementedError, match="LoRA"):
        model.prefill_chunk(torch.zeros((1, 4), dtype=torch.long), torch.tensor([0]),
                            torch.tensor([3]), {}, lora_idx=torch.tensor([0]))
