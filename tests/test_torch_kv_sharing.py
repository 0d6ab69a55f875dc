"""Page sharing in the port's paged KV cache (clearml_serving_tpu_torch/
llm/kv_cache.py) against the reference's (clearml_serving_tpu/llm/
kv_cache.py): refcounts, pins, ``map_shared``, copy on write, and the
parking of a preempted request's pages (``detach``/``attach``/``release``,
which the reference expresses as pins, ``map_shared`` and ``truncate``).

- One operation sequence, made with numpy from a seed, goes through both
  pools; after every step the slot tables and lengths, refcounts, free
  list, pins, pending copies on write and ``cow_events`` are equal.
- ``apply_pending_cow``, ``write_prompt_shared`` and ``gather_pages`` on
  float32 and int8 pools give the reference's pool arrays exactly.
- The cases of the reference's ``tests/test_kv_page_lifecycle.py`` that
  touch these modules, on the port.
"""

import numpy as np
import pytest
import torch

from clearml_serving_tpu.llm.kv_cache import (
    PagedKVCache as JaxPagedKVCache,
    PagePool as JaxPagePool,
)
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache, PagePool


def _pool(num_pages=16, page_size=4, max_slots=4):
    return PagePool(num_pages=num_pages, page_size=page_size, max_slots=max_slots)


def _state(pool):
    snap = pool.snapshot()
    return dict(snap, cow_events=pool.cow_events, free_pages=pool.free_pages,
                shared=pool.shared_pages)


# -- the port against the reference on one seeded operation sequence ------------


class _RefParking:
    """The reference pool with the port's parking operations expressed in
    its own primitives: a detach pins the slot's pages and frees the slot;
    an attach maps them back whole, truncates to the tokens and drops the
    pins; a release drops the pins."""

    def __init__(self, pool):
        self.pool = pool

    def detach(self, slot):
        pages = self.pool.slot_pages(slot)
        self.pool.pin_pages(pages)
        self.pool.free(slot)
        return pages

    def attach(self, slot, pages, tokens):
        self.pool.map_shared(slot, pages, len(pages) * self.pool.page_size)
        self.pool.truncate(slot, tokens)
        self.pool.unpin_pages(pages)

    def release(self, pages):
        return self.pool.unpin_pages(pages)


def _apply(pool, parking, op):
    """Run one operation on a pool; returns its result, or the exception's
    class name."""
    name, args = op
    try:
        if name in ("detach", "attach", "release"):
            return getattr(parking, name)(*args)
        return getattr(pool, name)(*args)
    except (MemoryError, ValueError, RuntimeError) as ex:
        return type(ex).__name__


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_operation_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    geo = dict(num_pages=24, page_size=4, max_slots=4)
    port, ref = PagePool(**geo), JaxPagePool(**geo)
    port_parking, ref_parking = port, _RefParking(ref)
    refs, pins, parked = [], [], []   # cache-held runs, pinned runs, parked runs
    kinds = ("allocate", "extend", "truncate", "free", "ref", "unref", "pin", "unpin",
             "map_shared", "detach", "attach", "release")
    for step in range(300):
        kind = kinds[rng.integers(len(kinds))]
        slot = int(rng.integers(geo["max_slots"]))
        length = ref.slot_length(slot)
        held = ref.slot_pages(slot)
        op = None
        if kind == "allocate" and not held:
            op = ("allocate", (slot, int(rng.integers(1, 14))))
        elif kind == "extend" and held:
            op = ("extend", (slot, int(rng.integers(1, 6))))
        elif kind == "truncate" and held:
            op = ("truncate", (slot, int(rng.integers(0, length + 2))))
        elif kind == "free":
            op = ("free", (slot,))
        elif kind in ("ref", "pin") and held:
            lo = int(rng.integers(len(held)))
            run = held[lo:lo + int(rng.integers(1, 4))]
            (refs if kind == "ref" else pins).append(run)
            op = ("ref_pages" if kind == "ref" else "pin_pages", (run,))
        elif kind in ("unref", "unpin") and (refs if kind == "unref" else pins):
            runs = refs if kind == "unref" else pins
            run = runs.pop(int(rng.integers(len(runs))))
            op = ("unref_pages" if kind == "unref" else "unpin_pages", (run,))
        elif kind == "map_shared" and not held and refs:
            run = refs[int(rng.integers(len(refs)))]
            if all(ref.page_refcount(p) > 0 for p in run):
                op = ("map_shared", (slot, list(run), len(run) * geo["page_size"]))
        elif kind == "detach" and held:
            op = ("detach", (slot,))
        elif kind == "attach" and not held and parked:
            pages, tokens = parked.pop(int(rng.integers(len(parked))))
            op = ("attach", (slot, pages, int(rng.integers(0, tokens + 1))))
        elif kind == "release" and parked:
            pages, _tokens = parked.pop(int(rng.integers(len(parked))))
            op = ("release", (pages,))
        if op is None:
            continue
        want = _apply(ref, ref_parking, op)
        got = _apply(port, port_parking, op)
        assert got == want, (step, op)
        if op[0] == "detach":
            parked.append((list(want), length))
        if kind in ("extend", "truncate", "free") and rng.random() < 0.3:
            assert port.drain_pending_cow() == ref.drain_pending_cow()
        assert _state(port) == _state(ref), (step, op)
        assert port.page_table(8).tolist() == ref.page_table(8).tolist()
    assert port.cow_events == ref.cow_events


# -- device side: copy on write, the shared-prefix write, the gather ------------


def _caches(kv_quant, **geo):
    geo = dict(dict(n_layers=2, n_kv_heads=2, head_dim=4, num_pages=10, page_size=4,
                    max_slots=3), **geo)
    jax_cache = JaxPagedKVCache(dtype="float32", kv_quant=kv_quant, **geo)
    port = PagedKVCache(dtype=torch.float32, kv_quant=kv_quant, device="cpu", **geo)
    return jax_cache, port


def _kv(rng, n, kv_quant, layers=2, heads=2, d=4):
    if kv_quant:
        k = rng.integers(-127, 128, (layers, n, heads, d)).astype(np.int8)
        v = rng.integers(-127, 128, (layers, n, heads, d)).astype(np.int8)
        ks = rng.random((layers, n, heads)).astype(np.float32)
        vs = rng.random((layers, n, heads)).astype(np.float32)
        return k, v, ks, vs
    return (rng.standard_normal((layers, n, heads, d)).astype(np.float32),
            rng.standard_normal((layers, n, heads, d)).astype(np.float32))


def _assert_pools_equal(jax_cache, port):
    names = ("k", "v", "k_scale", "v_scale") if port.kv_quant else ("k", "v")
    for name in names:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      np.asarray(getattr(jax_cache, name)))


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float32", "int8"])
def test_cow_and_shared_prompt_writes_match_reference_pools(kv_quant):
    """A prompt written and its pages shared, the slot extending into its
    shared tail page (copy on write), a hit's shared-prefix write and a
    token append on top: every pool array equals the reference's."""
    rng = np.random.default_rng(4)
    jax_cache, port = _caches(kv_quant)
    parts = _kv(rng, 10, kv_quant)
    for cache, conv in ((jax_cache, np.asarray), (port, torch.from_numpy)):
        cache.write_prompt(0, *(conv(p) for p in parts[:2]), 10,
                           *(conv(p) for p in parts[2:]))
    for cache in (jax_cache, port):
        pages = cache.pool.slot_pages(0)
        cache.pool.ref_pages(pages[:2])          # the cache stores 8 tokens
        cache.pool.ref_pages(pages[2:])          # and the tail page (shared)
        cache.pool.extend(0, 1)                  # copy on write of the tail page
        assert cache.pool.cow_events == 1
        assert cache.apply_pending_cow() == 1
    _assert_pools_equal(jax_cache, port)
    assert port.pool.snapshot() == jax_cache.pool.snapshot()
    tail = _kv(rng, 3, kv_quant)
    shared = port.pool.slot_pages(0)[:2]
    jax_cache.write_prompt_shared(1, shared, 8, *tail[:2], 11, *tail[2:])
    port.write_prompt_shared(1, shared, 8, *(torch.from_numpy(p) for p in tail[:2]), 11,
                             *(torch.from_numpy(p) for p in tail[2:]))
    _assert_pools_equal(jax_cache, port)
    assert port.pool.slot_pages(1)[:2] == shared
    token = _kv(rng, 1, kv_quant)
    jax_cache.append_token(1, *(p[:, 0] for p in token[:2]), *(p[:, 0] for p in token[2:]))
    port.append_token(1, *(torch.from_numpy(p[:, 0]) for p in token[:2]),
                      *(torch.from_numpy(p[:, 0]) for p in token[2:]))
    _assert_pools_equal(jax_cache, port)
    assert port.pool.snapshot() == jax_cache.pool.snapshot()


@pytest.mark.parametrize("kv_quant", ["", "int8"], ids=["float32", "int8"])
def test_gather_pages_matches_reference_gather(kv_quant):
    """The hit path's dense mini cache: the shared pages gathered (the list
    padded with the null page) equal the reference engine's gather."""
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    jax_cache, port = _caches(kv_quant)
    parts = _kv(rng, 10, kv_quant)
    jax_cache.write_prompt(0, *parts[:2], 10, *parts[2:])
    port.write_prompt(0, *(torch.from_numpy(p) for p in parts[:2]), 10,
                      *(torch.from_numpy(p) for p in parts[2:]))
    pages = port.pool.slot_pages(0)[:2] + [0, 0]
    got = port.gather_pages(pages)
    idx = jnp.asarray(pages, jnp.int32)
    for name in ("k", "v", "k_scale", "v_scale")[:4 if kv_quant else 2]:
        pool = getattr(jax_cache, name)
        sk = pool[:, :, idx]                                  # [L, H, NP, P(, D)]
        sk = sk.reshape(sk.shape[:2] + (-1,) + sk.shape[4:])
        want = np.asarray(jnp.moveaxis(sk, 1, 2)[:, None])
        np.testing.assert_array_equal(got[name].numpy(), want)


# -- the reference's page-lifecycle cases (tests/test_kv_page_lifecycle.py) ------


def test_allocate_free_roundtrip():
    pool = _pool()
    pages = pool.allocate(0, 10)
    assert len(pages) == 3
    assert all(pool.page_refcount(p) == 1 for p in pages)
    assert pool.free_pages == 15 - 3
    pool.free(0)
    assert pool.free_pages == 15
    assert all(pool.page_refcount(p) == 0 for p in pages)


def test_truncate_returns_only_unshared_surplus():
    pool = _pool()
    pool.allocate(0, 16)
    pages = pool.slot_pages(0)
    pool.ref_pages(pages[3:])
    pool.truncate(0, 5)
    assert pool.slot_pages(0) == pages[:2]
    assert pool.page_refcount(pages[2]) == 0
    assert pool.page_refcount(pages[3]) == 1
    assert pool.slot_length(0) == 5
    assert pool.free_pages == 15 - 2 - 1


def test_truncate_past_length_raises():
    pool = _pool()
    pool.allocate(0, 4)
    with pytest.raises(ValueError):
        pool.truncate(0, 5)


def test_extend_after_truncate_reuses_tail_page():
    pool = _pool()
    pool.allocate(0, 8)
    pool.truncate(0, 5)
    assert pool.extend(0, 1) == []
    assert len(pool.extend(0, 3)) == 1


def test_ref_unref_errors():
    pool = _pool()
    with pytest.raises(RuntimeError):
        pool.ref_pages([3])
    pages = pool.allocate(0, 4)
    pool.ref_pages(pages)
    assert pool.unref_pages(pages) == 0
    pool.free(0)
    assert pool.page_refcount(pages[0]) == 0


def test_map_shared_zero_copy_mapping():
    pool = _pool()
    pool.allocate(0, 8)
    shared = pool.slot_pages(0)
    pool.ref_pages(shared)
    pool.free(0)
    assert all(pool.page_refcount(p) == 1 for p in shared)
    pool.map_shared(1, shared, 8)
    assert pool.slot_pages(1) == shared
    assert all(pool.page_refcount(p) == 2 for p in shared)
    assert pool.slot_length(1) == 8
    pool.free(1)
    assert pool.unref_pages(shared) == len(shared)
    assert pool.free_pages == 15


def test_map_shared_requires_alignment_and_empty_slot():
    pool = _pool()
    pool.allocate(0, 8)
    shared = pool.slot_pages(0)
    with pytest.raises(ValueError):
        pool.map_shared(1, shared, 7)
    pool.allocate(1, 2)
    with pytest.raises(RuntimeError):
        pool.map_shared(1, shared, 8)


def test_extend_into_shared_tail_page_cows():
    pool = _pool()
    pool.allocate(0, 6)
    pages = pool.slot_pages(0)
    pool.ref_pages([pages[1]])
    new = pool.extend(0, 1)
    assert pool.cow_events == 1
    swapped = pool.slot_pages(0)
    assert swapped[0] == pages[0] and swapped[1] != pages[1]
    assert pool.page_refcount(pages[1]) == 1
    assert pool.page_refcount(swapped[1]) == 1
    assert pool.drain_pending_cow() == [(pages[1], swapped[1])]
    assert new == []


def test_extend_page_aligned_never_cows():
    pool = _pool()
    pool.allocate(0, 8)
    pool.ref_pages(pool.slot_pages(0))
    new = pool.extend(0, 1)
    assert pool.cow_events == 0
    assert len(new) == 1


def test_cow_exhaustion_raises_memory_error():
    pool = PagePool(num_pages=3, page_size=4, max_slots=2)
    pool.allocate(0, 6)
    pool.ref_pages([pool.slot_pages(0)[1]])
    with pytest.raises(MemoryError):
        pool.extend(0, 1)


def _float_cache():
    return PagedKVCache(1, 1, 2, num_pages=8, page_size=4, max_slots=2,
                        dtype=torch.float32, device="cpu")


def _int8_cache():
    return PagedKVCache(1, 1, 2, num_pages=8, page_size=4, max_slots=2,
                        dtype=torch.float32, kv_quant="int8", device="cpu")


def test_paged_kv_cache_cow_copies_device_page():
    cache = _float_cache()
    pool = cache.pool
    k = torch.arange(6 * 2, dtype=torch.float32).reshape(1, 6, 1, 2)
    cache.write_prompt(0, k, k * 10.0, 6)
    pages = pool.slot_pages(0)
    pool.ref_pages([pages[1]])
    pool.extend(0, 1)
    assert pool.cow_events == 1
    assert cache.apply_pending_cow() == 1
    new_tail = pool.slot_pages(0)[1]
    assert torch.equal(cache.k[0, 0, new_tail], cache.k[0, 0, pages[1]])
    assert torch.equal(cache.v[0, 0, new_tail], cache.v[0, 0, pages[1]])


def test_write_prompt_shared_scatters_only_tail():
    cache = _float_cache()
    pool = cache.pool
    k = torch.arange(8 * 2, dtype=torch.float32).reshape(1, 8, 1, 2)
    cache.write_prompt(0, k, k, 8)
    shared = pool.slot_pages(0)
    pool.ref_pages(shared)
    before = cache.k[0, 0, shared[0]].clone()
    tail = 100.0 + torch.arange(3 * 2, dtype=torch.float32).reshape(1, 3, 1, 2)
    cache.write_prompt_shared(1, shared, 8, tail, tail, 11)
    assert pool.slot_pages(1)[:2] == shared and len(pool.slot_pages(1)) == 3
    assert torch.equal(cache.k[0, 0, shared[0]], before)
    own = pool.slot_pages(1)[2]
    assert torch.equal(cache.k[0, 0, own, :3], tail[0, :, 0])
    with pytest.raises(ValueError):
        _float_cache().write_prompt_shared(0, [1], 3, tail, tail, 6)


def test_int8_cow_copies_scale_rows_with_the_page():
    cache = _int8_cache()
    pool = cache.pool
    k_q = torch.arange(6 * 2, dtype=torch.int8).reshape(1, 6, 1, 2)
    k_s = (0.25 + torch.arange(6, dtype=torch.float32)).reshape(1, 6, 1)
    cache.write_prompt(0, k_q, k_q, 6, k_s, k_s * 2.0)
    pages = pool.slot_pages(0)
    pool.ref_pages([pages[1]])
    pool.extend(0, 1)
    assert pool.cow_events == 1
    assert cache.apply_pending_cow() == 1
    new_tail = pool.slot_pages(0)[1]
    for name in ("k", "k_scale", "v_scale"):
        pool_t = getattr(cache, name)
        assert torch.equal(pool_t[0, 0, new_tail], pool_t[0, 0, pages[1]])


def test_int8_write_prompt_shared_scatters_tail_scales():
    cache = _int8_cache()
    pool = cache.pool
    k = torch.arange(8 * 2, dtype=torch.int8).reshape(1, 8, 1, 2)
    s = (1.0 + torch.arange(8, dtype=torch.float32)).reshape(1, 8, 1)
    cache.write_prompt(0, k, k, 8, s, s)
    shared = pool.slot_pages(0)
    pool.ref_pages(shared)
    before = cache.k_scale[0, 0, shared[0]].clone()
    tail = torch.full((1, 3, 1, 2), 7, dtype=torch.int8)
    tail_s = torch.full((1, 3, 1), 0.5)
    with pytest.raises(ValueError):
        cache.write_prompt_shared(1, shared, 8, tail, tail, 11)
    cache.write_prompt_shared(1, shared, 8, tail, tail, 11, tail_s, tail_s)
    assert torch.equal(cache.k_scale[0, 0, shared[0]], before)
    own = pool.slot_pages(1)[2]
    assert torch.equal(cache.k_scale[0, 0, own, :3], tail_s[0, :, 0])


def test_pin_unpin_roundtrip_and_accounting():
    pool = _pool()
    pages = pool.allocate(0, 8)
    pool.pin_pages(pages)
    assert all(pool.page_refcount(p) == 2 for p in pages)
    pool.free(0)
    assert all(pool.page_refcount(p) == 1 for p in pages)
    assert pool.unpin_pages(pages) == len(pages)
    assert pool.free_pages == 15


def test_unpin_without_pin_raises():
    pool = _pool()
    pages = pool.allocate(0, 4)
    with pytest.raises(RuntimeError):
        pool.unpin_pages(pages)
    pool.free(0)


# -- parking a preempted request's pages ------------------------------------------


def test_detach_attach_release_move_references_as_pins():
    """A detached slot's references become pins: a cache reference keeps a
    parked page alive through a release, an attach trims the pages past
    its tokens, and every page comes back."""
    pool = _pool()
    pages = pool.allocate(0, 12)               # 3 pages
    pool.ref_pages(pages[:1])                  # the cache stores the first
    parked = pool.detach(0)
    assert parked == pages and pool.slot_pages(0) == []
    assert pool.snapshot()["pins"] == {p: 1 for p in pages}
    pool.attach(2, parked, 5)                  # 2 pages hold 5 tokens
    assert pool.slot_pages(2) == pages[:2] and pool.slot_length(2) == 5
    assert pool.snapshot()["pins"] == {} and pool.page_refcount(pages[2]) == 0
    with pytest.raises(ValueError):
        pool.attach(2, parked, 5)              # the slot holds pages
    again = pool.detach(2)
    assert pool.release(again) == 1            # the cache keeps the first page
    assert pool.page_refcount(pages[0]) == 1
    pool.unref_pages(pages[:1])
    assert pool.free_pages == 15


def test_allocate_cache_pages_matches_reference():
    """Pages minted for the cache (one reference each, in no slot) come off
    the free list as the reference's do; too many raise MemoryError."""
    port, ref = _pool(), JaxPagePool(num_pages=16, page_size=4, max_slots=4)
    for pool in (port, ref):
        pool.allocate(0, 5)
    assert port.allocate_cache_pages(3) == ref.allocate_cache_pages(3)
    assert port.snapshot() == ref.snapshot()
    for pool in (port, ref):
        with pytest.raises(MemoryError):
            pool.allocate_cache_pages(pool.free_pages + 1)
