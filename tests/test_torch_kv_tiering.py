"""The port's host-RAM KV tier (clearml_serving_tpu_torch/llm/kv_cache.py
``HostKVTier``, ``PagedKVCache`` demote/promote/reap, the tiered
``RadixPrefixCache`` and the sanitizer's two-tier checks) against the
reference's, scenario by scenario of ``tests/test_kv_tiering.py``: each
runs on both packages and the outcomes are compared.

- Pool level: demote then promote gives back the same bytes, data planes
  and int8 scale rows, bf16 and int8 pools filled from one numpy seed, and
  the same bytes in both packages.
- The tree's transitions: the LRU run demoted whole, the host budget
  skipping pinned runs, re-online by reference, the pool-pressure fallback,
  a pinned suffix that never drops; one seeded sequence of 200 store,
  lookup, release, pin, unpin and spill operations with equal ``stats()``
  and pool states after every one.
- The knobs (``"auto"`` against a fake /proc/meminfo), the four host-tier
  sanitizer failures, and the engine: a demoted warm hit's greedy stream
  under both schedulers at depth 1 and 2, and the promote and demote fault
  seams.

Everything here is copies and integer bookkeeping: every comparison is
exact.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.errors import HostTierAutoSizeError as JaxAutoSizeError
from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.llm import kv_cache as jax_kv_cache
from clearml_serving_tpu.llm.engine import GenRequest as JaxGenRequest
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.llm.kv_sanitizer import KVSanitizer as JaxSanitizer
from clearml_serving_tpu.llm.kv_sanitizer import KVSanitizerError as JaxSanitizerError
from clearml_serving_tpu.llm.prefix_cache import RadixPrefixCache as JaxRadix
from clearml_serving_tpu_torch.errors import HostTierAutoSizeError
from clearml_serving_tpu_torch.llm import faults
from clearml_serving_tpu_torch.llm import kv_cache
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_sanitizer import KVSanitizer, KVSanitizerError
from clearml_serving_tpu_torch.llm.openai_api import build_engine
from clearml_serving_tpu_torch.llm.prefix_cache import RadixPrefixCache
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

QCFG = {"preset": "llama-tiny", "dtype": "float32", "kv_quant": "int8"}
PACKAGES = ("jax", "port")


@pytest.fixture(autouse=True)
def _armed_sanitizer(monkeypatch):
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", QCFG)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


# -- one package's primitives --------------------------------------------------------


class Pkg:
    """The tier's primitives of one package, built alike."""

    def __init__(self, name):
        self.name = name
        jax_side = name == "jax"
        self.Radix = JaxRadix if jax_side else RadixPrefixCache
        self.Sanitizer = JaxSanitizer if jax_side else KVSanitizer
        self.SanitizerError = JaxSanitizerError if jax_side else KVSanitizerError
        self.HostKVTier = jax_kv_cache.HostKVTier if jax_side else kv_cache.HostKVTier

    def paged(self, num_pages=9, page_size=4, head_dim=8, kv_quant="int8", max_slots=2):
        if self.name == "jax":
            return jax_kv_cache.PagedKVCache(2, 2, head_dim, num_pages=num_pages,
                                             page_size=page_size, max_slots=max_slots,
                                             dtype="bfloat16", kv_quant=kv_quant)
        return kv_cache.PagedKVCache(2, 2, head_dim, num_pages=num_pages, page_size=page_size,
                                     max_slots=max_slots, dtype=torch.bfloat16,
                                     kv_quant=kv_quant, device="cpu")

    def tiered(self, num_pages=9, host_pages=6, page_size=4, kv_quant="int8", max_slots=2,
               **budgets):
        pc = self.paged(num_pages=num_pages, page_size=page_size, kv_quant=kv_quant,
                        max_slots=max_slots)
        pc.enable_host_tier(host_pages)
        cache = self.Radix(block=page_size, pool=pc.pool, page_bytes=64, backend=pc, **budgets)
        return pc, cache

    def fill(self, pc, slot, tokens, seed=0):
        """Allocate ``tokens`` for ``slot`` and write K/V (and int8 scales)
        made from one numpy seed."""
        L, H, D = pc.k.shape[0], pc.k.shape[1], pc.k.shape[4]
        rng = np.random.default_rng(seed)
        if pc.kv_quant:
            k = rng.integers(-100, 100, (L, tokens, H, D)).astype(np.int8)
            v = rng.integers(-100, 100, (L, tokens, H, D)).astype(np.int8)
            ks = rng.random((L, tokens, H)).astype(np.float32)
            vs = rng.random((L, tokens, H)).astype(np.float32)
        else:
            k = rng.standard_normal((L, tokens, H, D)).astype(np.float32)
            v = rng.standard_normal((L, tokens, H, D)).astype(np.float32)
            ks = vs = None
        pc.pool.allocate(slot, tokens)
        pages = pc.pool.slot_pages(slot)
        if self.name == "jax":
            conv = (lambda a: jnp.asarray(a)) if pc.kv_quant else (
                lambda a: jnp.asarray(a).astype(jnp.bfloat16))
            scales = (jnp.asarray(ks), jnp.asarray(vs)) if pc.kv_quant else ()
            pc._scatter_pages(pages, conv(k), conv(v), *scales)
        else:
            conv = torch.from_numpy if pc.kv_quant else (
                lambda a: torch.from_numpy(a).to(torch.bfloat16))
            scales = (torch.from_numpy(ks), torch.from_numpy(vs)) if pc.kv_quant else ()
            pc._scatter(pages, 0, conv(k), conv(v), *scales)

    @staticmethod
    def rows(pc, pages):
        """The pools' rows of ``pages`` as numpy bits (bf16 as uint16)."""
        out = []
        for pool in (pc.k, pc.v, pc.k_scale, pc.v_scale):
            if pool is None:
                continue
            if isinstance(pool, torch.Tensor):
                t = pool[:, :, pages]
                out.append(t.view(torch.int16).numpy().view(np.uint16)
                           if t.dtype == torch.bfloat16 else t.numpy())
            else:
                a = np.asarray(pool[:, :, jnp.asarray(pages)])
                out.append(a.view(np.uint16) if a.dtype.itemsize == 2 else a)
        return out

    def audit(self, pc, cache, where, drained=False):
        self.Sanitizer(pc.pool, prefix_cache=cache, paged_cache=pc).check(where, drained=drained)

    def reap(self, pc, force=True):
        return pc.reap_promotions(force=force)


def _both(scenario):
    """Run ``scenario(Pkg)`` on both packages; the outcomes must be equal."""
    want, got = (scenario(Pkg(name)) for name in PACKAGES)
    assert got == want
    return got


def _equal_bits(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


# -- HostKVTier allocator ----------------------------------------------------------------


def test_host_tier_allocator_roundtrip():
    def scenario(p):
        tier = p.HostKVTier(4, 8, 2, 2, 16, dtype=np.int8 if p.name == "jax" else torch.int8,
                            quantized=True)
        out = [(tier.free_pages, tier.used_pages)]
        ids = tier.allocate(3)
        out.append((sorted(ids), tier.used_pages))
        with pytest.raises(MemoryError):
            tier.allocate(2)
        tier.free(ids[:2])
        out.append(tier.free_pages)
        with pytest.raises(RuntimeError):
            tier.free([ids[0]])  # double free
        snap = tier.snapshot()
        out.append((len(snap["free"]) + len(snap["used"]), snap["num_pages"]))
        out.append((tier.quantized, tier.page_bytes))
        return out

    got = _both(scenario)
    assert got[-1] == (True, 2 * 2 * 2 * 8 * 16 + 2 * 2 * 2 * 8 * 4)


def test_port_tier_slabs_are_page_major_and_plain_on_the_cpu():
    pc = Pkg("port").paged(kv_quant="int8")
    tier = pc.enable_host_tier(3)
    assert tuple(tier.hk.shape) == (3, 2, 2, 4, 8) and tier.hk.dtype == torch.int8
    assert tuple(tier.hk_scale.shape) == (3, 2, 2, 4) and tier.hk_scale.dtype == torch.float32
    assert not tier.pinned and not tier.hk.is_pinned()
    assert tier.alloc_seconds >= 0


# -- pool-level demote / promote ---------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["int8", ""], ids=["int8", "bf16"])
def test_demote_promote_pages_byte_identical(kv_quant):
    """Demote a stored run, promote it on a hit: the promoted pages' K/V
    (and int8 scale rows) equal their bytes before demotion, in both
    packages, and the two packages hold the same bytes."""
    def scenario(p):
        pc, cache = p.tiered(kv_quant=kv_quant)
        ids = list(range(9))
        p.fill(pc, 0, 9)
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        before = p.rows(pc, pc.pool.slot_pages(0)[:2])
        pc.pool.free(0)
        moved = cache.spill(0)
        p.audit(pc, cache, "post-demote", drained=True)
        hit = cache.lookup_pages(ids)
        p.audit(pc, cache, "post-promote")
        after = p.rows(pc, hit["pages"])
        assert _equal_bits(before, after)
        p.reap(pc)
        stats = pc.tier_stats()
        out = dict(moved=moved, tier=hit["tier"], len=hit["len"], pages=hit["pages"],
                   tier_stats={k: stats[k] for k in ("host_pages_used", "host_pages_capacity",
                                                     "host_page_bytes", "demoted_pages_total",
                                                     "promoted_pages_total",
                                                     "promotions_reaped")},
                   stats=cache.stats(), scales=pc.host_tier.hk_scale is not None)
        cache.release(hit)
        p.audit(pc, cache, "end", drained=True)
        return out, before

    (got, port_bytes), (want, jax_bytes) = scenario(Pkg("port")), scenario(Pkg("jax"))
    assert got == want
    assert _equal_bits(port_bytes, jax_bytes)
    assert got["moved"] == 2 and got["tier"] == "host"
    assert got["tier_stats"]["demoted_pages_total"] == 2
    assert got["tier_stats"]["promotions_reaped"] == 1
    assert got["scales"] == bool(kv_quant)


def test_promotion_stages_host_ids_in_any_order():
    """Promotions stage one copy per run of consecutive host ids: host ids
    out of order and in broken runs land on the right device pages, bytes
    equal to the reference's same promotion."""
    def scenario(p):
        pc = p.paged(num_pages=12)
        tier = pc.enable_host_tier(6)
        p.fill(pc, 0, 20, seed=5)
        pages = pc.pool.slot_pages(0)          # 5 pages
        before = p.rows(pc, pages)
        host_ids = pc.demote_pages(pages)      # ascending ids 0..4
        pc.pool.free(0)
        order = [3, 0, 4, 1, 2]
        fresh = pc.pool.allocate_cache_pages(5)
        pc.promote_pages([host_ids[i] for i in order], fresh)
        pc.reap_promotions(force=True)
        after = p.rows(pc, fresh)
        want = [b[:, :, order] for b in before]
        assert _equal_bits(want, after)
        return [a.tolist() for a in after], tier.used_pages

    assert _both(scenario)[1] == 0


def test_export_pages_is_the_page_major_readback():
    """``export_pages`` returns the same page-major slabs as the reference's."""
    def scenario(p):
        pc = p.paged()
        p.fill(pc, 0, 9, seed=3)
        slabs = pc.export_pages(pc.pool.slot_pages(0))
        out = {}
        for name in ("hk", "hv", "hk_scale", "hv_scale"):
            a = slabs[name]
            out[name] = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return out

    got, want = scenario(Pkg("port")), scenario(Pkg("jax"))
    assert got.keys() == want.keys()
    for name in got:
        assert got[name].shape == want[name].shape and np.array_equal(got[name], want[name])


def test_second_lookup_after_promotion_is_hbm():
    def scenario(p):
        pc, cache = p.tiered()
        ids = list(range(9))
        p.fill(pc, 0, 9)
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        pc.pool.free(0)
        cache.spill(0)
        first = cache.lookup_pages(ids)
        cache.release(first)
        second = cache.lookup_pages(ids)
        cache.release(second)
        return first["tier"], second["tier"], cache.stats()

    first, second, stats = _both(scenario)
    assert (first, second) == ("host", "hbm")
    assert stats["hits_by_tier"] == {"hbm": 1, "host": 1}


def test_match_len_counts_resident_run_only():
    def scenario(p):
        pc, cache = p.tiered()
        ids = list(range(9))
        p.fill(pc, 0, 9)
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        pc.pool.free(0)
        before = cache.match_len(ids)
        cache.spill(0)
        return before, cache.match_len(ids)

    assert _both(scenario) == (8, 0)


# -- LRU, budgets, pins ----------------------------------------------------------------


def test_device_budget_demotes_lru_run_whole():
    """A new run stored over the device budget demotes the older run whole,
    in one batched round; the new run stays resident."""
    def scenario(p):
        pc, cache = p.tiered(num_pages=17, host_pages=8, max_pages=2)
        a, b = list(range(9)), list(range(100, 109))
        p.fill(pc, 0, 9, seed=1)
        cache.store_pages(a, 0, pc.pool.slot_pages(0))
        p.fill(pc, 1, 9, seed=2)
        cache.store_pages(b, 0, pc.pool.slot_pages(1))
        s = cache.stats()
        hit_b = cache.lookup_pages(b)
        cache.release(hit_b)
        hit_a = cache.lookup_pages(a)
        cache.release(hit_a)
        pc.pool.free(0)
        pc.pool.free(1)
        p.reap(pc)
        p.audit(pc, cache, "lru", drained=True)
        return s, hit_b["tier"], hit_a["tier"], pc.pool.snapshot()

    s, tier_b, tier_a, _ = _both(scenario)
    assert s["cached_pages"] == 2 and s["host_pages"] == 2 and s["demotions"] == 1
    assert (tier_b, tier_a) == ("hbm", "host")


def test_host_budget_drops_lru_but_skips_pinned():
    """The host budget drops LRU runs for real; a pinned run is neither
    demoted nor dropped; a pin on a promoted run reports no host nodes."""
    def scenario(p):
        pc, cache = p.tiered(num_pages=33, host_pages=16, max_slots=4, host_max_pages=2)
        runs = [list(range(i * 100, i * 100 + 9)) for i in range(3)]
        for slot, ids in enumerate(runs):
            p.fill(pc, slot, 9, seed=slot)
            cache.store_pages(ids, 0, pc.pool.slot_pages(slot))
            pc.pool.free(slot)
        pin = cache.pin_run(runs[0])
        out = [pin["host_nodes"]]
        cache.spill(0)
        out.append(cache.stats())
        hit0 = cache.lookup_pages(runs[0])
        out.append(hit0["tier"])
        cache.release(hit0)
        out.append(cache.lookup_pages(runs[1]))
        hit2 = cache.lookup_pages(runs[2])
        out.append(hit2["tier"])
        cache.release(hit2)
        pin2 = cache.pin_run(runs[2])
        out.append(pin2["host_nodes"])
        cache.unpin_run(pin2)
        cache.unpin_run(pin)
        p.reap(pc)
        p.audit(pc, cache, "host-lru", drained=True)
        return out

    out = _both(scenario)
    assert out[0] == 0
    assert out[1]["host_pages"] == 2 and out[1]["cached_pages"] == 2
    assert out[2] == "hbm" and out[3] is None and out[4] == "host" and out[5] == 0


def test_pinned_runs_are_never_demoted():
    def scenario(p):
        pc, cache = p.tiered(num_pages=17, host_pages=8)
        ids = list(range(9))
        p.fill(pc, 0, 9)
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        pc.pool.free(0)
        pin = cache.pin_run(ids)
        pinned = cache.spill(0), cache.stats()["cached_pages"]
        cache.unpin_run(pin)
        return pinned, cache.spill(0)

    assert _both(scenario) == ((0, 2), 2)


def test_store_reonlines_demoted_path_by_reference():
    """A store whose walk crosses demoted nodes points them at the slot's
    own pages (no copy) before attaching below them."""
    def scenario(p):
        pc, cache = p.tiered(num_pages=17, host_pages=8)
        ids = list(range(13))   # 12 storable tokens: 3 blocks
        p.fill(pc, 0, 13)
        cache.store_pages(ids[:9], 0, pc.pool.slot_pages(0))
        cache.spill(0)
        host = cache.stats()["host_pages"]
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        s = cache.stats()
        hit = cache.lookup_pages(ids)
        by_reference = hit["pages"] == pc.pool.slot_pages(0)[:3]
        cache.release(hit)
        pc.pool.free(0)
        p.audit(pc, cache, "reonline", drained=True)
        return host, s, hit["tier"], hit["len"], by_reference

    host, s, tier, length, by_reference = _both(scenario)
    assert host == 2 and s["host_pages"] == 0 and s["cached_pages"] == 3 and by_reference
    assert s["promotions"] == 1 and (tier, length) == ("hbm", 12)


def test_promotion_pool_pressure_falls_back_to_resident_prefix():
    """No free device pages for the promotion: the demoted run drops and
    the hit degrades to a miss, with nothing leaked."""
    def scenario(p):
        pc, cache = p.tiered(num_pages=9, host_pages=8)
        ids = list(range(9))
        p.fill(pc, 0, 9)
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        cache.spill(0)
        pc.pool.free(0)
        pc.pool.allocate(1, 8 * pc.pool.page_size)   # every free page
        hit = cache.lookup_pages(ids)
        host_pages = cache.stats()["host_pages"]
        pc.pool.free(1)
        p.audit(pc, cache, "fallback", drained=True)
        return hit, host_pages, cache.stats()

    hit, host_pages, _ = _both(scenario)
    assert hit is None and host_pages == 0


def test_promotion_failure_never_drops_pinned_suffix():
    """Another request's failed promotion must not drop a pinned demoted
    run: the hit degrades, the run survives for the pin holder."""
    def scenario(p):
        pc, cache = p.tiered(num_pages=9, host_pages=8)
        ids = list(range(9))
        p.fill(pc, 0, 9)
        cache.store_pages(ids, 0, pc.pool.slot_pages(0))
        cache.spill(0)
        pc.pool.free(0)
        pin = cache.pin_run(ids)
        pc.pool.allocate(1, 8 * pc.pool.page_size)
        hit = cache.lookup_pages(ids)
        survived = cache.stats()["host_pages"]
        pc.pool.free(1)
        resumed = cache.lookup_pages(ids)
        cache.release(resumed)
        cache.unpin_run(pin)
        p.reap(pc)
        p.audit(pc, cache, "pinned-survives", drained=True)
        return pin["host_nodes"], hit, survived, resumed["tier"]

    assert _both(scenario) == (2, None, 2, "host")


# -- one seeded sequence through both trees ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_tiered_sequence_matches_reference(seed):
    """200 seeded store, lookup, release, pin, unpin, spill and match_len
    operations through the reference's tiered tree and the port's, each
    over its own pool and tier: equal outcomes, ``stats()``, pool
    bookkeeping and host occupancy after every operation; demotions,
    promotions, host drops and promotion fallbacks all occur."""
    rng = np.random.default_rng(seed)
    sides = []
    for name in PACKAGES:
        p = Pkg(name)
        pc, cache = p.tiered(num_pages=64, host_pages=12, page_size=2, max_slots=4,
                             max_pages=8, host_max_pages=10)
        sides.append((p, pc, cache))
    heads = [rng.integers(1, 6, 16).tolist() for _ in range(4)]
    hits, pins = [], []
    kinds = [0] * 7
    for step in range(200):
        kind = int(rng.integers(7))
        ids = list(heads[rng.integers(4)][:int(rng.integers(5, 17))])
        ids += rng.integers(1, 6, int(rng.integers(0, 6))).tolist()
        out = []
        if kind == 0:
            slot = int(rng.integers(4))
            drop = rng.random() < 0.6
            for p, pc, cache in sides:
                pc.pool.free(slot)
                pc.pool.allocate(slot, len(ids))
                cache.store_pages(ids, 0, pc.pool.slot_pages(slot))
                if drop:
                    pc.pool.free(slot)
        elif kind == 1:
            got = [cache.lookup_pages(ids, 0) for _, _, cache in sides]
            out = [g and (g["len"], g["pages"], g["tier"]) for g in got]
            if got[0]:
                hits.append(got)
        elif kind == 2 and hits:
            pair = hits.pop(int(rng.integers(len(hits))))
            uncount = rng.random() < 0.3
            for (_, _, cache), hit in zip(sides, pair):
                if uncount:
                    cache.uncount_hit(hit)
                cache.release(hit)
        elif kind == 3:
            out = [cache.match_len(ids) for _, _, cache in sides]
        elif kind == 4:
            pair = [cache.pin_run(ids, 0) for _, _, cache in sides]
            out = [h and (h["len"], h["host_nodes"]) for h in pair]
            pins.append(pair)
        elif kind == 5 and pins:
            pair = pins.pop(int(rng.integers(len(pins))))
            for (_, _, cache), handle in zip(sides, pair):
                cache.unpin_run(handle)
        elif kind == 6:
            target = int(rng.integers(0, 6))
            out = [cache.spill(target) for _, _, cache in sides]
        kinds[kind] += 1
        assert out[:1] == out[1:2] or not out, (step, out)
        (pj, pcj, cj), (pp, pcp, cp) = sides
        assert cp.stats() == cj.stats(), step
        assert pcp.pool.snapshot() == pcj.pool.snapshot(), step
        assert pcp.host_tier.used_pages == pcj.host_tier.used_pages, step
        assert cp.page_refs() == cj.page_refs(), step
        if step % 20 == 0:
            for p, pc, cache in sides:
                p.audit(pc, cache, "step {}".format(step))
    s = sides[1][2].stats()
    assert s["demotions"] > 0 and s["promotions"] > 0 and s["evictions"] > 0
    assert s["hits_by_tier"]["host"] > 0 and min(kinds) > 0
    for _, pc, _ in sides:
        pc.reap_promotions(force=True)


def test_threads_share_one_tiered_cache_without_losing_a_page():
    """Twelve threads (more than the cores here), each on its own slot,
    store, look up, release and spill on one tiered cache under a short
    switch interval, as the loop thread and the admission workers do.
    Afterwards every page and host id is accounted for: the armed
    sanitizer's conservation and two-tier checks pass, every page comes
    back once the cache is emptied, and the tier's ids all return."""
    import sys
    import threading

    p = Pkg("port")
    pc, cache = p.tiered(num_pages=200, host_pages=40, page_size=2, max_slots=12,
                         max_pages=24, host_max_pages=30)
    heads = [[(h * 7 + i) % 5 + 1 for i in range(16)] for h in range(4)]
    errors = []

    def worker(slot):
        rng = np.random.default_rng(slot)
        try:
            for _ in range(60):
                ids = heads[rng.integers(4)][:int(rng.integers(5, 17))] + [slot + 10]
                pc.pool.free(slot)
                hit = cache.lookup_pages(ids, 0)
                if hit is not None:
                    pc.pool.map_shared(slot, list(hit["pages"]), hit["len"])
                    cache.release(hit)
                pc.pool.allocate(slot, len(ids))
                cache.store_pages(ids, 0, pc.pool.slot_pages(slot))
                if rng.random() < 0.2:
                    cache.spill(int(rng.integers(0, 8)))
            pc.pool.free(slot)
        except Exception as ex:   # reported below: a thread's failure fails the test
            errors.append(ex)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(slot,)) for slot in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    pc.reap_promotions(force=True)
    p.audit(pc, cache, "threads", drained=True)
    s = cache.stats()
    assert s["demotions"] > 0 and s["promotions"] > 0 and s["hits_by_tier"]["host"] > 0
    cache.max_nodes, cache.host_max_pages = 0, 0
    with cache._lock:
        cache._evict_over_budget()
    assert pc.pool.free_pages == pc.pool.num_pages - 1
    assert pc.host_tier.used_pages == 0 and len(cache) == 0


# -- the knobs ---------------------------------------------------------------------------


def _jax_engine(tiny_np, **kw):
    kw = dict(dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 32, 64],
                   eos_token_id=None, decode_steps=2, cache_mode="paged", page_size=16,
                   prefix_cache=64, prefix_block=16), **kw)
    return JaxEngine(models.build_model("llama", QCFG), tiny_np, **kw)


def _port_engine(tiny_np, **kw):
    kw = dict(dict(max_batch=2, max_seq_len=96, prefill_buckets=[16, 32, 64],
                   eos_token_id=None, decode_steps=2, cache_mode="paged", page_size=16,
                   prefix_cache=64, prefix_block=16), **kw)
    return LLMEngineCore(Llama(QCFG, convert_params(tiny_np, device="cpu")), **kw)


def _raised(fn):
    """(error class name, message) of what ``fn`` raised; the reference's
    pointer to its own documentation is left out of the message."""
    try:
        fn()
    except (ValueError, HostTierAutoSizeError, JaxAutoSizeError) as ex:
        return type(ex).__name__, str(ex).replace("; docs/kv_tiering.md", "")
    return None


@pytest.mark.parametrize("knobs", [
    dict(prefix_cache_host_bytes=1 << 20),
    dict(prefix_cache_host_pages=16, cache_mode="dense"),
    dict(prefix_cache_host_pages=16, prefix_cache=None),
    dict(prefix_cache_host_bytes="lots"),
    dict(prefix_cache_host_bytes="auto", prefix_cache_host_pages=8),
    dict(prefix_cache_host_bytes="auto", prefix_cache=None),
], ids=["bytes_without_pages", "dense", "no_prefix_cache", "bad_size", "auto_and_pages",
        "auto_without_cache"])
def test_host_tier_knob_validation(tiny_np, knobs):
    """Inert or contradictory host-tier knobs fail at construction with the
    reference's message, naming the knob."""
    want = _raised(lambda: _jax_engine(tiny_np, **knobs))
    got = _raised(lambda: _port_engine(tiny_np, **knobs))
    assert want is not None and got == want


def _meminfo(tmp_path, text):
    path = tmp_path / "meminfo"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("avail_kb", [1 << 20, 4 << 20, 1 << 10, 64 << 20],
                         ids=["1GiB", "4GiB", "1MiB_clamped_up", "64GiB_clamped_down"])
def test_auto_sizes_the_tier_from_a_fake_meminfo(tiny_np, monkeypatch, tmp_path, avail_kb):
    """``prefix_cache_host_bytes="auto"``: half of MemAvailable (clamped to
    64 MiB-16 GiB, split between co-hosted processes) in pages, the same
    count as the reference's, from the same fake /proc/meminfo."""
    path = _meminfo(tmp_path, "MemTotal: 99 kB\nMemAvailable: {} kB\n".format(avail_kb))
    for module in (jax_kv_cache, kv_cache):
        monkeypatch.setattr(module, "available_host_memory_bytes",
                            functools.partial(module.available_host_memory_bytes, path))
    monkeypatch.setenv("TPUSERVE_COHOSTED_PROCS", "2")
    # the page count is recorded and a one-page tier built: no test
    # allocates gigabytes of slabs
    counts = {}
    for name, module in (("jax", jax_kv_cache), ("port", kv_cache)):
        made = []
        real = module.HostKVTier

        def fake(num_pages, *args, _real=real, _made=made, **kw):
            _made.append(num_pages)
            return _real(1, *args, **kw)

        monkeypatch.setattr(module, "HostKVTier", fake)
        build = _jax_engine if name == "jax" else _port_engine
        engine = build(tiny_np, prefix_cache_host_bytes="auto")
        counts[name] = (made, engine._prefix.host_max_pages is not None)
        if name == "port":
            page_bytes = engine.lifecycle_stats()["kv_tier"]["page_bytes"]
        engine.stop()
    assert counts["port"] == counts["jax"]
    budget = min(max(avail_kb * 1024 // 2 // 2, 64 << 20), 16 << 30)
    assert counts["port"][0] == [budget // page_bytes]


def test_auto_without_memavailable_raises_naming_the_knob(tiny_np, monkeypatch, tmp_path):
    path = _meminfo(tmp_path, "MemTotal: 99 kB\n")
    outcomes = []
    for module, build in ((jax_kv_cache, _jax_engine), (kv_cache, _port_engine)):
        monkeypatch.setattr(module, "available_host_memory_bytes",
                            functools.partial(module.available_host_memory_bytes, path))
        raised = _raised(lambda: build(tiny_np, prefix_cache_host_bytes="auto"))
        outcomes.append((raised[0], raised[1].replace(path, "<path>")))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] == "HostTierAutoSizeError" and "prefix_cache_host_mb" in outcomes[1][1]


def test_aux_keys_are_served_by_build_engine(monkeypatch, tmp_path):
    """The OpenAI route's aux keys map as the reference maps them: host
    pages, a MiB budget, "auto"; a budget without pages raises naming
    ``prefix_cache_host_pages``."""
    cfg = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "cache": "paged",
           "max_batch": 2, "max_seq_len": 96, "prefill_buckets": [32, 64],
           "prefix_cache": 16, "prefix_block": 16}
    engine, _ = build_engine(dict(cfg, prefix_cache_host_pages=8, prefix_cache_host_mb=1),
                             device="cpu")
    assert engine.paged_cache.host_tier.num_pages == 8
    assert engine._prefix.host_max_bytes == 1 << 20
    assert engine.health()["kv_tier"]["host_pages_capacity"] == 8
    engine.stop()
    with pytest.raises(ValueError, match="prefix_cache_host_pages"):
        build_engine(dict(cfg, prefix_cache_host_mb=64), device="cpu")
    path = _meminfo(tmp_path, "MemAvailable: 262144 kB\n")
    monkeypatch.setattr(kv_cache, "available_host_memory_bytes",
                        functools.partial(kv_cache.available_host_memory_bytes, path))
    engine, _ = build_engine(dict(cfg, prefix_cache_host_mb="auto"), device="cpu")
    page_bytes = engine.lifecycle_stats()["kv_tier"]["page_bytes"]
    assert engine.paged_cache.host_tier.num_pages == (128 << 20) // page_bytes
    engine.stop()


# -- the sanitizer's two-tier checks -------------------------------------------------------


def _spilled(p):
    pc, cache = p.tiered()
    ids = list(range(9))
    p.fill(pc, 0, 9)
    cache.store_pages(ids, 0, pc.pool.slot_pages(0))
    cache.spill(0)
    return pc, cache


def _corruption_outcome(p, corrupt, drained=False):
    pc, cache = _spilled(p)
    if drained:
        pc.pool.free(0)
    corrupt(pc, cache)
    try:
        p.audit(pc, cache, "corrupt", drained=drained)
    except p.SanitizerError as ex:
        return str(ex), sorted(ex.pages)
    return None


def _dual(pc, cache):
    next(iter(cache._leaf_nodes)).pages = [1]


def _orphan(pc, cache):
    pc.host_tier.allocate(1)


def _dupe(pc, cache):
    pc.host_tier._free.append(pc.host_tier._free[-1])


def _lost_free(pc, cache):
    next(iter(cache._leaf_nodes)).host_pages = None


@pytest.mark.parametrize("corrupt,drained,match", [
    (_dual, False, "exactly one tier"),
    (_orphan, False, "ownership"),
    (_dupe, False, "duplicates"),
    (_lost_free, True, "ownership"),
], ids=["dual_payload", "orphaned_host_page", "host_free_list_duplicate", "lost_host_free"])
def test_sanitizer_catches_host_tier_corruption(corrupt, drained, match):
    outcomes = [_corruption_outcome(Pkg(name), corrupt, drained) for name in PACKAGES]
    assert outcomes[1] is not None and match in outcomes[1][0]
    # the same failure, naming the same host ids (the allocations before
    # the corruption are ascending in both packages)
    assert outcomes[1] == outcomes[0]


# -- the engine ----------------------------------------------------------------------------


def _gen(engine, request_cls, prompt, n=8):
    async def run():
        out = [t async for t in engine.generate(request_cls(prompt_ids=list(prompt),
                                                            max_new_tokens=n))]
        await engine.wait_drained()
        return out

    return asyncio.run(asyncio.wait_for(run(), 120))


PROMPT = [(7 * i + 3) % 100 + 1 for i in range(40)]   # 2 cached blocks
OTHER = [(11 * i + 5) % 100 + 1 for i in range(40)]


def _tier_view(engine):
    t = engine.lifecycle_stats()["kv_tier"]
    return {k: t[k] for k in t if k not in ("promo_wait_ms", "promo_total_ms",
                                           "promo_overlap_ratio")}


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_demoted_warm_hit_streams_equal_the_reference(tiny_np, scheduler, depth):
    """A demoted-then-promoted prefix run gives the stream of an always
    resident warm hit and the JAX engine's, int8 KV, armed sanitizer; the
    tier's counters equal the reference's."""
    kw = dict(scheduler=scheduler, pipeline_depth=depth)
    control = _port_engine(tiny_np, **kw)
    _gen(control, GenRequest, PROMPT)
    resident = _gen(control, GenRequest, PROMPT)
    control.stop()
    out = {}
    for name, build, req in (("jax", _jax_engine, JaxGenRequest),
                             ("port", _port_engine, GenRequest)):
        engine = build(tiny_np, prefix_cache_host_pages=16, **kw)
        cold = _gen(engine, req, PROMPT)
        spilled = engine._prefix.spill(0)
        promoted = _gen(engine, req, PROMPT)
        out[name] = dict(cold=cold, spilled=spilled, promoted=promoted,
                         tier=_tier_view(engine), stats=engine._prefix.stats(),
                         clean=engine._sanitizer.stats()["failures"] == 0)
        engine.stop()
    assert out["port"] == out["jax"]
    got = out["port"]
    assert got["promoted"] == resident and got["spilled"] == 2 and got["clean"]
    assert got["tier"]["hits_by_tier"]["host"] == 1
    assert got["tier"]["demoted_pages_total"] == got["tier"]["promoted_pages_total"] == 2
    assert got["tier"]["reaps"] == 1


def _chaos(tiny_np, point, times, scenario_kw, run):
    out = {}
    for name, build, req, fmod in (("jax", _jax_engine, JaxGenRequest, jax_faults),
                                   ("port", _port_engine, GenRequest, faults)):
        engine = build(tiny_np, prefix_cache_host_pages=16, **scenario_kw)
        out[name] = run(engine, req, lambda: fmod.configure(
            [{"point": point, "action": "raise", "times": times}]), fmod.clear)
        out[name]["clean"] = engine._sanitizer.stats()["failures"] == 0
        out[name]["free"] = engine.paged_cache.pool.free_pages
        engine.stop()
    assert out["port"] == out["jax"]
    return out["port"]


def test_chaos_promote_fault_falls_back_to_recompute(tiny_np):
    """``engine.kv.promote`` on the warm hit: the demoted run drops, the
    prompt recomputes, the stream is unchanged, nothing leaks."""
    def run(engine, req, arm, clear):
        cold = _gen(engine, req, PROMPT)
        engine._prefix.spill(0)
        arm()
        try:
            warm = _gen(engine, req, PROMPT)
        finally:
            clear()
        return dict(cold=cold, warm=warm, stats=engine._prefix.stats())

    got = _chaos(tiny_np, "engine.kv.promote", 1, {}, run)
    assert got["warm"] == got["cold"] and got["clean"]
    assert got["stats"]["host_pages"] == 0 and got["stats"]["hits_by_tier"]["host"] == 0


def test_chaos_demote_fault_drops_for_real(tiny_np):
    """``engine.kv.demote`` under device-budget pressure: eviction drops
    instead of demoting; the next visit recomputes with a clean audit."""
    def run(engine, req, arm, clear):
        cold = _gen(engine, req, PROMPT)
        arm()
        try:
            _gen(engine, req, OTHER)
        finally:
            clear()
        s = engine._prefix.stats()
        warm = _gen(engine, req, PROMPT)
        return dict(cold=cold, warm=warm, stats=s)

    got = _chaos(tiny_np, "engine.kv.demote", -1, dict(prefix_cache_pages=2), run)
    s = got["stats"]
    assert s["host_pages"] == 0 and s["demotions"] == 0 and s["evictions"] >= 1
    assert got["warm"] == got["cold"] and got["clean"]


# -- chip_smoke.py phase 9's sequence through both caches ----------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_phase9", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _phase9_replay(cs, name, tiered, kv):
    """Phase 9's lookups and stores (the warmup sweep, then the two rounds)
    through one package's cache at the arms' budgets and page bytes, over
    a pool of the engine's page count (small rows: only the ids count)."""
    p = Pkg(name)
    pc = p.paged(num_pages=8 * 129 + 1, page_size=16, kv_quant="", max_slots=8)
    knobs = cs.TIER_TIERED if tiered else cs.TIER_UNTIERED
    if tiered:
        pc.enable_host_tier(knobs["prefix_cache_host_pages"])
    cache = p.Radix(knobs["prefix_cache"], knobs["prefix_block"],
                    max_pages=knobs["prefix_cache_pages"], pool=pc.pool,
                    page_bytes=cs.TIER_PAGE_BYTES[kv], backend=pc if tiered else None)
    _heads, rounds = cs.tier_traffic(0)
    return cs.tier_replay(pc.pool, cache, cs.tier_warmup_prompts(), rounds[0] + rounds[1])


@pytest.mark.parametrize("kv", ["", "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("tiered", [False, True], ids=["untiered", "tiered"])
def test_phase9_sequence_counts_are_the_reference_caches(tiered, kv):
    """``chip_smoke.py`` phase 9 holds the card's engines to
    ``TIER_EXPECTED``: the reference's cache gives those numbers for the
    phase's sequence, and so does the port's. Round 1 misses every head;
    round 2 hits every head whole, from HBM without a tier and from host
    RAM with one."""
    cs = _chip_smoke()
    want = _phase9_replay(cs, "jax", tiered, kv)
    got = _phase9_replay(cs, "port", tiered, kv)
    assert got == want == cs.TIER_EXPECTED["tiered" if tiered else "untiered"]
    heads = cs.TIER_HEADS
    assert got["traffic"][:heads] == [["miss", 0]] * heads
    assert got["traffic"][heads:] == [["host" if tiered else "hbm", cs.TIER_HEAD]] * heads
