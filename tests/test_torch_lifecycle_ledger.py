"""The port's ownership ledger (clearml_serving_tpu_torch/llm/
lifecycle_ledger.py) against the reference's, scenario by scenario of
``tests/test_lifecycle_ledger.py``:

- the pairing semantics of ``OwnershipLedger`` (balance, release of a whole
  key, double frees, the drain audit naming resource and site, domains,
  cache-scoped resources, owner attribution, shared keys, leaks counted
  once, count mode, unknown resources, arming), run against both classes
  with the outcomes compared;
- the primitives' records (pool, radix cache, host tier) when armed;
- the engine: a strict clean run with zero leaks and the ``ledger`` block
  in ``lifecycle_stats()``/``health()``, no ledger without the env, the
  ``engine.ledger.leak`` seam named at drain, and the ragged job failure's
  slot reclaim, each on the JAX engine and the port.

The leak seam sits where each package tears a preempted request down: the
reference's resume pin on its stored run (``prefix.resume_pin``), the
port's parked pages (``pages.pin``, acquired in ``_preempt_slot``).
Counts and names are compared exactly.
"""

import asyncio
import inspect
import time

import jax
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.llm import lifecycle_ledger as jax_ledger
from clearml_serving_tpu.llm.engine import GenRequest as JaxGenRequest
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.llm.kv_cache import HostKVTier as JaxHostKVTier
from clearml_serving_tpu.llm.kv_cache import PagePool as JaxPagePool
from clearml_serving_tpu.llm.prefix_cache import RadixPrefixCache as JaxRadix
from clearml_serving_tpu_torch.llm import faults, lifecycle_ledger
from clearml_serving_tpu_torch.llm import engine as port_engine_module
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import HostKVTier, PagePool
from clearml_serving_tpu_torch.llm.prefix_cache import RadixPrefixCache
from clearml_serving_tpu_torch.models.llama import Llama, convert_params

TINY = {"preset": "llama-tiny", "dtype": "float32"}
LEDGERS = {"jax": jax_ledger, "port": lifecycle_ledger}
# the resources the port tracks, with the reference's policies: the KV
# primitives', the transport's, the socket wire's and the process fleet's
PORT_RESOURCES = ("pages.slot", "pages.pin", "pages.ref", "prefix.hit", "prefix.resume_pin",
                  "host.pages", "slot.quarantine", "kv.promotion", "guided.ref",
                  "transport.shipment", "transport.wire.conn", "replica.worker_proc")


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


@pytest.fixture(autouse=True)
def clean_state():
    for mod in LEDGERS.values():
        mod.get().reset(strict=False)
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()
    for mod in LEDGERS.values():
        mod.get().reset(strict=False)
        mod.disarm()


def _both(scenario):
    """``scenario(ledger module)`` on both packages; equal outcomes."""
    want, got = (scenario(LEDGERS[name]) for name in ("jax", "port"))
    assert got == want
    return got


def _outcome(fn):
    """(error class, resource, message) of a LedgerError ``fn`` raised, or
    None."""
    try:
        fn()
    except AssertionError as ex:
        return type(ex).__name__, getattr(ex, "resource", None), str(ex)
    return None


# -- the pairing semantics ---------------------------------------------------------------


def test_resources_are_the_reference_policies_of_what_the_port_holds():
    assert tuple(lifecycle_ledger.RESOURCES) == PORT_RESOURCES
    for name, policy in lifecycle_ledger.RESOURCES.items():
        assert jax_ledger.RESOURCES[name] == policy


def test_acquire_release_balances():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        ledger.acquire("pages.slot", key=0, n=3, domain="pool")
        out = [ledger.outstanding()["pages.slot"]]
        ledger.release("pages.slot", key=0, n=3, domain="pool")
        out.append(ledger.outstanding()["pages.slot"])
        ledger.check("drain", drained=True)
        out.append({k: v for k, v in ledger.stats().items() if k != "outstanding"})
        return out

    got = _both(scenario)
    assert got[:2] == [3, 0] and got[2]["leaks"] == 0


def test_release_all_of_key():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        ledger.acquire("pages.slot", key=1, n=2, domain="pool")
        ledger.acquire("pages.slot", key=1, n=4, domain="pool")
        ledger.release("pages.slot", key=1, domain="pool", all_of_key=True)
        out = [ledger.outstanding()["pages.slot"]]
        # a second release of an empty key is a defensive free, not a
        # violation
        ledger.release("pages.slot", key=1, domain="pool", all_of_key=True)
        return out + [ledger.stats()["double_releases"], ledger.stats()["releases"]]

    assert _both(scenario) == [0, 0, 6]


def test_double_release_is_a_violation():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        ledger.acquire("pages.pin", key=(1, 2), n=2, domain="pool")
        ledger.release("pages.pin", key=(1, 2), n=2, domain="pool")
        ledger.release("pages.pin", key=(1, 2), n=2, domain="pool")
        kind, resource, message = _outcome(lambda: ledger.check("step"))
        return ledger.stats()["double_releases"], kind, resource, "double free" in message

    assert _both(scenario) == (1, "LedgerError", "pages.pin", True)


def test_drain_audit_names_resource_and_site():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        ledger.acquire("prefix.resume_pin", key=7, domain="cache")
        try:
            ledger.check("drain", drained=True)
        except mod.LedgerError as ex:
            return (ex.resource, ex.site.split(":")[0], ex.where,
                    "still outstanding at the drained boundary" in str(ex))
        return None

    assert _both(scenario) == ("prefix.resume_pin", "test_torch_lifecycle_ledger.py", "drain",
                               True)


def test_drain_audit_respects_domains():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        ledger.acquire("pages.slot", key=0, n=1, domain="other-engine-pool")
        ledger.check("drain", drained=True, domains=["my-pool"])
        return _outcome(lambda: ledger.check("drain", drained=True,
                                             domains=["other-engine-pool", "my-pool"]))[:2]

    assert _both(scenario) == ("LedgerError", "pages.slot")


def test_cache_scoped_resources_exempt_from_drain_zero():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        ledger.acquire("pages.ref", n=4, domain="pool")
        ledger.acquire("host.pages", n=2, domain="tier")
        ledger.check("drain", drained=True)
        out = ledger.outstanding()
        return out["pages.ref"], out["host.pages"]

    assert _both(scenario) == (4, 2)


def test_request_audit_owner_attribution():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        with ledger.owner("req:a"):
            ledger.acquire("prefix.hit", key=1, domain="cache")
        with ledger.owner("req:b"):
            ledger.acquire("prefix.hit", key=2, domain="cache")
        ledger.release("prefix.hit", key=2, domain="cache")
        ledger.audit_request("req:b", "emit-finish")
        kind, resource, message = _outcome(lambda: ledger.audit_request("req:a", "emit-finish"))
        return kind, resource, "req:a" in message

    assert _both(scenario) == ("LedgerError", "prefix.hit", True)


def test_shared_key_release_discharges_the_releasers_slab():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=True)
        with ledger.owner("req:a"):
            ledger.acquire("prefix.hit", key="k", domain="cache")
        with ledger.owner("req:b"):
            ledger.acquire("prefix.hit", key="k", domain="cache")
        ledger.release("prefix.hit", key="k", domain="cache", owner="req:a")
        ledger.audit_request("req:a", "emit-finish")
        ledger.release("prefix.hit", key="k", domain="cache", owner="req:b")
        ledger.audit_request("req:b", "emit-finish")
        with ledger.owner("req:c"):
            ledger.acquire("pages.pin", key=(1, 2), n=2, domain="pool")
        with ledger.owner("req:d"):
            ledger.acquire("pages.pin", key=(1, 2), n=2, domain="pool")
        with ledger.owner("req:c"):
            ledger.release("pages.pin", key=(1, 2), n=2, domain="pool")
        ledger.audit_request("req:c", "emit-finish")
        kind, _resource, message = _outcome(lambda: ledger.audit_request("req:d", "emit-finish"))
        return ledger.outstanding()["prefix.hit"], kind, "req:d" in message

    assert _both(scenario) == (0, "LedgerError", True)


def test_leak_counted_once_across_repeated_audits():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=False)
        with ledger.owner("req:x"):
            ledger.acquire("prefix.resume_pin", key=1, domain="cache")
        for _ in range(5):
            ledger.check("drain", drained=True)
        out = [ledger.stats()["leaks"], ledger.stats()["violations"]]
        ledger.audit_request("req:x", "fail")
        return out + [ledger.stats()["leaks"]]

    assert _both(scenario) == [1, 1, 1]


def test_count_mode_records_without_raising():
    def scenario(mod):
        ledger = mod.OwnershipLedger(strict=False)
        ledger.acquire("pages.pin", key=(3,), domain="pool")
        ledger.audit_request("req:x", "fail")
        with ledger.owner("req:y"):
            ledger.acquire("pages.pin", key=(4,), domain="pool")
        ledger.audit_request("req:y", "fail")
        ledger.check("drain", drained=True)
        stats = ledger.stats()
        return stats["leaks"], stats["violations"]

    leaks, violations = _both(scenario)
    assert leaks >= 2 and violations >= 2


def test_unknown_resource_rejected():
    def scenario(mod):
        ledger = mod.OwnershipLedger()
        out = []
        for fn in (ledger.acquire, ledger.release):
            with pytest.raises(ValueError, match="unknown ledger resource") as info:
                fn("nope", key=1)
            out.append(str(info.value))
        return out

    _both(scenario)


def test_env_arming(monkeypatch):
    def scenario(mod):
        out = []
        for value in (None, "1", "strict", "0"):
            if value is None:
                monkeypatch.delenv(mod.ENV, raising=False)
            else:
                monkeypatch.setenv(mod.ENV, value)
            out.append((mod.enabled(), mod.strict_enabled()))
        return mod.ENV, out

    assert _both(scenario) == ("TPUSERVE_LEDGER", [(False, False), (True, False), (True, True),
                                                   (False, False)])


def test_module_helpers_noop_when_disarmed():
    def scenario(mod):
        mod.disarm()
        before = mod.get().stats()["acquires"]
        mod.acquire("pages.slot", key=0, n=5, domain="p")
        mod.release("pages.slot", key=0, n=5, domain="p")
        with mod.owner("req:z"):
            pass
        return mod.get().stats()["acquires"] - before, mod.request_tag(None).startswith("req:")

    assert _both(scenario) == (0, True)


# -- the primitives record through the module seam ------------------------------------------


def _pool_and_cache_records(mod, Pool, Radix):
    ledger = mod.arm(strict=True)
    pool = Pool(9, 4, 2)
    cache = Radix(block=4, pool=pool, page_bytes=8)
    ids = list(range(9))   # 9 tokens: 8 storable (2 blocks, 2 pages)
    out = []
    pool.allocate(0, 9)
    out.append(ledger.outstanding()["pages.slot"])
    cache.store_pages(ids, 0, pool.slot_pages(0))
    out.append(ledger.outstanding()["pages.ref"])
    hit = cache.lookup_pages(ids)
    out.append((ledger.outstanding()["prefix.hit"], ledger.outstanding()["pages.pin"]))
    cache.release(hit)
    pool.free(0)
    out.append({r: ledger.outstanding()[r] for r in PORT_RESOURCES})
    ledger.check("drain", drained=True, domains=[pool, cache])
    return out


def test_pool_and_cache_record_when_armed():
    want = _pool_and_cache_records(jax_ledger, JaxPagePool, JaxRadix)
    got = _pool_and_cache_records(lifecycle_ledger, PagePool, RadixPrefixCache)
    assert got == want
    assert got[:3] == [3, 2, (1, 2)]


def test_parked_pages_move_between_slot_and_pin():
    """The port's parking (``detach``/``attach``/``release``) moves a slot's
    references to pins and back in the ledger: ``pages.slot`` to
    ``pages.pin`` keyed by the page run, and back (pages past the resume's
    tokens drop with the pin)."""
    ledger = lifecycle_ledger.arm(strict=True)
    pool = PagePool(16, 4, 2)
    pool.allocate(0, 10)
    with lifecycle_ledger.owner("req:v"):
        pages = pool.detach(0)
    out = ledger.outstanding()
    assert (out["pages.slot"], out["pages.pin"]) == (0, 3)
    (entry,) = ledger.outstanding_entries()
    assert (entry["resource"], entry["key"], entry["n"], entry["owner"]) == (
        "pages.pin", tuple(pages), 3, "req:v")
    pool.attach(1, pages, 7)
    out = ledger.outstanding()
    assert (out["pages.slot"], out["pages.pin"]) == (2, 0)
    parked = pool.detach(1)
    pool.release(parked)
    assert ledger.outstanding()["pages.pin"] == 0 and ledger.outstanding()["pages.slot"] == 0
    assert pool.free_pages == pool.num_pages - 1
    ledger.check("drain", drained=True, domains=[pool])


def test_host_tier_records_when_armed():
    def scenario(mod, Tier, dtype):
        ledger = mod.arm(strict=True)
        tier = Tier(4, 4, 1, 1, 2, dtype=dtype, quantized=False)
        ids = tier.allocate(3)
        out = [ledger.outstanding()["host.pages"]]
        tier.free(ids)
        return out + [ledger.outstanding()["host.pages"]]

    want = scenario(jax_ledger, JaxHostKVTier, np.int8)
    assert scenario(lifecycle_ledger, HostKVTier, torch.int8) == want == [3, 0]


def test_promotions_record_kv_promotion_until_reaped():
    """A promotion in flight is a ``kv.promotion`` entry (drain-zero) until
    ``reap_promotions`` sees it done; the tier's ids are ``host.pages``."""
    from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache

    ledger = lifecycle_ledger.arm(strict=True)
    pc = PagedKVCache(2, 2, 8, num_pages=9, page_size=4, max_slots=2, dtype=torch.float32,
                      device="cpu")
    pc.enable_host_tier(4)
    cache = RadixPrefixCache(block=4, pool=pc.pool, page_bytes=64, backend=pc)
    pc.pool.allocate(0, 9)
    cache.store_pages(list(range(9)), 0, pc.pool.slot_pages(0))
    pc.pool.free(0)
    cache.spill(0)
    assert ledger.outstanding()["host.pages"] == 2
    hit = cache.lookup_pages(list(range(9)))
    assert ledger.outstanding()["kv.promotion"] == 1
    with pytest.raises(lifecycle_ledger.LedgerError, match="kv.promotion"):
        ledger.check("drain", drained=True, domains=[pc, pc.pool, pc.host_tier, cache])
    ledger.reset(strict=True)
    cache.release(hit)
    assert pc.reap_promotions() == 1


# -- the engine ------------------------------------------------------------------------------


def _jax_engine(tiny_np, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("prefill_buckets", [16, 32])
    kw.setdefault("eos_token_id", 257)
    kw.setdefault("pipeline_depth", 2)
    return JaxEngine(models.build_model("llama", TINY), tiny_np, **kw)


def _port_engine(tiny_np, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_seq_len", 128)
    kw.setdefault("prefill_buckets", [16, 32])
    kw.setdefault("eos_token_id", 257)
    kw.setdefault("pipeline_depth", 2)
    kw.pop("cache_mode", None)
    return LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **kw)


SIDES = (("jax", _jax_engine, JaxGenRequest, jax_faults),
         ("port", _port_engine, GenRequest, faults))


async def _collect(engine, req):
    return [t async for t in engine.generate(req)]


@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
@pytest.mark.parametrize("host_pages", [None, 8], ids=["untiered", "tiered"])
def test_engine_clean_run_is_leak_free_strict(tiny_np, monkeypatch, scheduler, host_pages):
    """A strict-armed paged engine with the prefix cache (and the host tier)
    serves and drains with zero leaks; ``lifecycle_stats()``/``health()``
    carry the ledger block; the request-scoped and drain-zero resources end
    at zero, as the reference's."""
    monkeypatch.setenv("TPUSERVE_LEDGER", "strict")
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    out = {}
    for name, build, Req, _f in SIDES:
        async def run():
            kw = dict(cache_mode="paged", page_size=16, prefix_cache=64, prefix_block=16,
                      scheduler=scheduler, prefix_cache_host_pages=host_pages)
            engine = build(tiny_np, **kw)
            assert engine._ledger is not None, "TPUSERVE_LEDGER did not arm"
            engine._ledger.reset(strict=True)
            streams = []
            for seed in (1, 2, 1):
                streams.append(await _collect(engine, Req(
                    prompt_ids=[256, seed] + list(range(2, 18)), max_new_tokens=4)))
                if host_pages:
                    engine._prefix.spill(0)
            await engine.wait_drained()
            return engine, streams

        engine, streams = asyncio.run(asyncio.wait_for(run(), 120))
        block = engine.lifecycle_stats()["ledger"]
        out[name] = dict(streams=streams, strict=block["strict"], leaks=block["leaks"],
                         double=block["double_releases"],
                         outstanding={r: block["outstanding"][r] for r in PORT_RESOURCES},
                         health=engine.health()["ledger"]["leaks"],
                         host_hits=engine._prefix.stats()["hits_by_tier"]["host"])
        engine.stop()
    assert out["port"] == out["jax"]
    got = out["port"]
    assert got["strict"] is True and got["leaks"] == 0 and got["double"] == 0
    for resource in PORT_RESOURCES:
        if lifecycle_ledger.RESOURCES[resource]["drain_zero"]:
            assert got["outstanding"][resource] == 0, resource
    assert got["health"] == 0 and (got["host_hits"] >= 1) == bool(host_pages)


def test_engine_without_env_has_no_ledger(tiny_np, monkeypatch):
    monkeypatch.delenv("TPUSERVE_LEDGER", raising=False)
    for _name, build, _req, _f in SIDES:
        engine = build(tiny_np, cache_mode="paged")
        assert engine._ledger is None
        assert engine.lifecycle_stats()["ledger"] is None
        engine.stop()


def _leak_scenario(tiny_np, build, Req, fmod, monkeypatch):
    """max_batch 1: a batch chat decodes, an interactive chat preempts it,
    the preempted request is cancelled while it waits in the queue, and
    the ``engine.ledger.leak`` seam eats the release of what its preemption
    holds when the cancelled request leaves the queue."""
    engine = build(tiny_np, max_batch=1, decode_steps=2, cache_mode="paged", page_size=16,
                   prefix_cache=64, prefix_block=16, prefill_buckets=[32, 64],
                   eos_token_id=None)
    assert engine._ledger is not None
    engine._ledger.reset(strict=True)
    real_preempt = engine._preempt_slot

    def preempt_then_cancel(slot):
        victim = engine._slot_req[slot]
        done = real_preempt(slot)
        if done:
            victim.cancel()   # the client leaves while its request waits
        return done

    monkeypatch.setattr(engine, "_preempt_slot", preempt_then_cancel)

    async def run():
        batch = Req(prompt_ids=[256] + [(i * 3 + 1) % 250 for i in range(16)],
                    max_new_tokens=24, priority="batch")
        b_task = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 4:
            await asyncio.sleep(0.005)
        fmod.configure([{"point": "engine.ledger.leak", "times": 1, "message": "lost release"}])
        out_hi = await asyncio.wait_for(_collect(engine, Req(prompt_ids=[256, 9],
                                                             max_new_tokens=2)), 60)
        out_b = await asyncio.wait_for(b_task, 60)
        t0 = time.monotonic()
        while not engine._loop_task.done() and time.monotonic() - t0 < 15.0:
            await asyncio.sleep(0.01)
        assert engine._loop_task.done(), "the loop should fail at the drain audit"
        return len(out_hi), len(out_b), engine._loop_task.exception()

    n_hi, n_b, exc = asyncio.run(run())
    fired = sum(s.fired for s in fmod.injector._specs)
    fmod.clear()
    out = dict(preemptions=engine.counters["preemptions"], fired=fired, n_hi=n_hi,
               batch_cut=n_b < 24, error=type(exc).__name__, resource=exc.resource,
               site=exc.site, where=exc.where)
    engine.stop()
    return out


def test_ledger_leak_seam_caught_at_drain_strict(tiny_np, monkeypatch):
    """The seam loses one release on each package's preemption teardown;
    the strict ledger fails the drain audit naming the resource and its
    acquire site: the reference's resume pin (``prefix.resume_pin``,
    ``pin_run`` in its ``_preempt_slot``), the port's parked pages
    (``pages.pin``, ``detach`` in its ``_preempt_slot``)."""
    monkeypatch.setenv("TPUSERVE_LEDGER", "strict")
    monkeypatch.delenv("TPUSERVE_SANITIZE", raising=False)
    want = _leak_scenario(tiny_np, _jax_engine, JaxGenRequest, jax_faults, monkeypatch)
    got = _leak_scenario(tiny_np, _port_engine, GenRequest, faults, monkeypatch)
    for out in (want, got):
        assert out["preemptions"] >= 1 and out["fired"] == 1 and out["n_hi"] == 2
        assert out["batch_cut"] and out["error"] == "LedgerError" and out["where"] == "drain"
        assert out["site"].startswith("engine.py:")
    assert want["resource"] == "prefix.resume_pin"
    assert got["resource"] == "pages.pin"
    # the port's acquire site is the detach inside _preempt_slot
    lines, first = inspect.getsourcelines(port_engine_module.LLMEngineCore._preempt_slot)
    line = int(got["site"].split(":")[1])
    assert first <= line < first + len(lines)
    assert "detach" in lines[line - first]


def test_port_leak_seam_is_also_a_page_leak(tiny_np, monkeypatch):
    """The port's parked pages are pool pins, so the same lost release is
    also a page leak the armed KV sanitizer names at drain (the reference's
    lost resume pin holds no page)."""
    from clearml_serving_tpu_torch.llm.kv_sanitizer import KVSanitizerError

    monkeypatch.setenv("TPUSERVE_LEDGER", "strict")
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    engine = _port_engine(tiny_np, max_batch=1, decode_steps=2, cache_mode="paged",
                          page_size=16, prefix_cache=64, prefix_block=16,
                          prefill_buckets=[32, 64], eos_token_id=None)
    engine._ledger.reset(strict=True)
    real_preempt = engine._preempt_slot

    def preempt_then_cancel(slot):
        victim = engine._slot_req[slot]
        done = real_preempt(slot)
        if done:
            victim.cancel()
        return done

    monkeypatch.setattr(engine, "_preempt_slot", preempt_then_cancel)

    async def run():
        batch = GenRequest(prompt_ids=[256] + [(i * 3 + 1) % 250 for i in range(16)],
                           max_new_tokens=24, priority="batch")
        b_task = asyncio.ensure_future(_collect(engine, batch))
        while batch.produced < 4:
            await asyncio.sleep(0.005)
        faults.configure([{"point": "engine.ledger.leak", "times": 1}])
        await asyncio.wait_for(_collect(engine, GenRequest(prompt_ids=[256, 9],
                                                           max_new_tokens=2)), 60)
        await asyncio.wait_for(b_task, 60)
        t0 = time.monotonic()
        while not engine._loop_task.done() and time.monotonic() - t0 < 15.0:
            await asyncio.sleep(0.01)
        return engine._loop_task.exception()

    exc = asyncio.run(run())
    assert isinstance(exc, KVSanitizerError) and "pins outlived drain" in str(exc)
    engine.stop()


def _ragged_reclaim(tiny_np, build, Req, monkeypatch):
    engine = build(tiny_np, cache_mode="paged", page_size=16, prefix_cache=64,
                   prefix_block=16, scheduler="ragged", eos_token_id=None)
    assert engine._ledger is not None
    engine._ledger.reset(strict=True)
    shared = [256] + list(range(1, 32))

    async def run():
        assert await _collect(engine, Req(prompt_ids=shared + [40], max_new_tokens=2))
        await engine.wait_drained()
        # the failure arm loses the slot's mapped pages
        monkeypatch.setattr(engine, "_free_ragged_slot", lambda slot: None)
        real_release = engine._prefix.release
        state = {"armed": True}

        def exploding_release(hit):
            result = real_release(hit)
            if state["armed"]:
                state["armed"] = False
                raise RuntimeError("post-map_shared failure")
            return result

        monkeypatch.setattr(engine._prefix, "release", exploding_release)
        with pytest.raises(RuntimeError, match="post-map_shared failure"):
            await _collect(engine, Req(prompt_ids=shared + [41], max_new_tokens=2))
        monkeypatch.setattr(engine._prefix, "release", real_release)
        t0 = time.monotonic()
        while not engine._loop_task.done() and time.monotonic() - t0 < 15.0:
            await asyncio.sleep(0.01)
        assert engine._loop_task.done()
        return engine._loop_task.exception()

    exc = asyncio.run(run())
    engine.stop()
    return type(exc).__name__, exc.resource


def test_ragged_job_failure_arm_reclaim_is_load_bearing(tiny_np, monkeypatch):
    """With the ragged admission's failure arm losing its slot reclaim, a
    raise after a hit's ``map_shared`` strands the mapped pages on a slot
    no job owns, and the strict ledger's drain audit names ``pages.slot``
    (sanitizer off: the ledger alone finds it), in both packages."""
    monkeypatch.setenv("TPUSERVE_LEDGER", "strict")
    monkeypatch.setenv("TPUSERVE_SANITIZE", "0")
    want = _ragged_reclaim(tiny_np, _jax_engine, JaxGenRequest, monkeypatch)
    got = _ragged_reclaim(tiny_np, _port_engine, GenRequest, monkeypatch)
    assert got == want == ("LedgerError", "pages.slot")
