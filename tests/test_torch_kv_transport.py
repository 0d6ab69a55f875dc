"""Disaggregated prefill/decode in the port (clearml_serving_tpu_torch/llm/
kv_transport.py, ``PagedKVCache.import_pages``,
``RadixPrefixCache.store_shipped``, the engine's ship and receive seams and
``ReplicaGroup``'s roles) against the JAX package, the shared-backend
scenarios of the reference's ``tests/test_kv_transport.py``.

Held: the shared-slab mailbox's semantics and content keys (equal to the
reference's); the export/import round trip bit for bit on bf16 and int8
pools; ``store_shipped``'s attach, geometry and pool-pressure contracts;
role-aware routing on both routers; and on llama-tiny float32 with int8
paged KV, under the armed KV sanitizer and ownership ledger, a
two-replica disaggregated fleet's streams (greedy and seeded, both
schedulers, draft-ahead frames under ``ragged``) equal a monolithic
engine's and the JAX fleet's, with the ship, partial and receive faults,
a failed prefill replica, and a receive racing live admissions. The
draft-ahead, ship-fault, receive-fault and failed-prefill contracts run
again over the socket transport (``llm/kv_wire.py``) on both packages, as
the reference runs them on both backends.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from clearml_serving_tpu import models
from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.llm import kv_transport as jax_transport
from clearml_serving_tpu.llm import lifecycle_ledger as jax_ledger
from clearml_serving_tpu.llm.engine import GenRequest as JaxGenRequest
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.llm.replica import ReplicaGroup as JaxGroup
from clearml_serving_tpu.serving import replica_router as jax_router
from clearml_serving_tpu_torch.llm import faults, lifecycle_ledger
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import PagedKVCache
from clearml_serving_tpu_torch.llm.kv_sanitizer import KVSanitizer
from clearml_serving_tpu_torch.llm.kv_transport import (
    KVShipment,
    SharedSlabTransport,
    shipment_key,
)
from clearml_serving_tpu_torch.llm.kv_wire import SocketSlabFabric
from clearml_serving_tpu_torch.llm.prefix_cache import RadixPrefixCache
from clearml_serving_tpu_torch.llm.replica import ReplicaGroup
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.serving import replica_router as port_router

QCFG = {"preset": "llama-tiny", "dtype": "float32", "kv_quant": "int8"}
GROUP_CFG = dict(max_batch=2, max_seq_len=128, prefill_buckets=[16, 32, 64], eos_token_id=None,
                 decode_steps=1, cache_mode="paged", page_size=16, prefix_cache=64,
                 prefix_block=16, num_pages=65, pipeline_depth=1)
RAGGED = dict(scheduler="ragged", step_token_budget=16)


@pytest.fixture(autouse=True)
def armed(monkeypatch):
    """The KV sanitizer and the ownership ledger armed on both packages."""
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    monkeypatch.setenv("TPUSERVE_LEDGER", "1")
    for mod in (lifecycle_ledger, jax_ledger):
        mod.get().reset(strict=False)
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()
    for mod in (lifecycle_ledger, jax_ledger):
        mod.get().reset(strict=False)
        mod.disarm()


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", QCFG)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


# -- shipment keys and the mailbox ----------------------------------------------


def _ship(key=b"k", pages=2, prefix_len=None, **kw):
    z = torch.zeros((pages, 2, 2, 4, 8), dtype=torch.int8)
    s = torch.zeros((pages, 2, 2, 4), dtype=torch.float32)
    return KVShipment(key=key, src="r0", prefix_len=prefix_len or pages * 4, page_size=4,
                      lora=0, hk=z, hv=z.clone(), hk_scale=s, hv_scale=s.clone(), **kw)


def test_shipment_key_equals_the_reference_and_is_block_aligned():
    rng = np.random.default_rng(1)
    for _ in range(100):
        ids = [int(t) for t in rng.integers(1, 300, int(rng.integers(1, 120)))]
        block, lora = int(rng.choice([4, 16])), int(rng.integers(0, 3))
        assert shipment_key(ids, block, lora) == jax_transport.shipment_key(ids, block, lora)
    ids = list(range(1, 34))            # 33 tokens -> 32 storable at block 16
    assert shipment_key(ids, 16) == shipment_key(ids[:32] + [999], 16)
    assert shipment_key(ids, 16) != shipment_key(ids, 16, lora=1)
    assert shipment_key(ids, 16) != shipment_key(ids[:16] + [7] * 17, 16)


def test_transport_send_recv_is_consume_once_and_drops_oldest():
    t = SharedSlabTransport(capacity_pages=5)
    ep = t.register("r1")
    assert ep.send("r1", _ship(b"a"))
    assert ep.recv(b"a") is not None and ep.recv(b"a") is None
    assert ep.send("r1", _ship(b"a")) and ep.send("r1", _ship(b"b"))
    assert ep.send("r1", _ship(b"c"))          # 6 pages > 5: "a" ages out
    assert ep.recv(b"a") is None and ep.recv(b"b") is not None
    assert not ep.send("r1", _ship(b"big", pages=6))
    stats = t.stats()
    assert stats["dropped"] == 2 and stats["sent"] == 4 and stats["received"] == 2
    ep.send("r1", _ship(b"c", pages=1))       # a re-ship replaces the payload
    assert ep.recv(b"c").pages == 1 and t.stats()["queued"]["r1"]["pages"] == 0
    with pytest.raises(ValueError):
        SharedSlabTransport(capacity_pages=0)


def test_partial_frames_assemble_in_order_and_drop_on_a_gap():
    t = SharedSlabTransport(capacity_pages=16)
    ep = t.register("r1")
    assert ep.send("r1", _ship(b"k", 2, final=False))
    assert ep.recv(b"k") is None                # unsealed: invisible
    assert ep.send("r1", _ship(b"k", 1, page_offset=2, final=False))
    assert ep.send("r1", _ship(b"k", 2, prefix_len=20, page_offset=3))
    whole = ep.recv(b"k")
    assert whole.pages == 5 and whole.prefix_len == 20 and whole.final
    assert ep.send("r1", _ship(b"g", 2, final=False))
    assert not ep.send("r1", _ship(b"g", 2, page_offset=3))    # a gap
    assert ep.recv(b"g") is None
    s = t.stats()
    assert (s["partial_frames"], s["assembled"], s["assembly_drops"]) == (3, 1, 1)


# -- export / import -------------------------------------------------------------


def _paged(num_pages=9, page_size=4, kv_quant="int8"):
    return PagedKVCache(2, 2, 8, num_pages=num_pages, page_size=page_size, max_slots=2,
                        dtype=torch.bfloat16 if not kv_quant else torch.float32,
                        kv_quant=kv_quant, device="cpu")


def _fill_slot(pc, slot, tokens, seed=0):
    gen = torch.Generator().manual_seed(seed)
    pc.pool.allocate(slot, tokens)
    shape = (2, tokens, 2, 8)
    if pc.kv_quant:
        k = torch.randint(-100, 100, shape, generator=gen, dtype=torch.int8)
        v = torch.randint(-100, 100, shape, generator=gen, dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen)
        vs = torch.rand(shape[:-1], generator=gen)
        pc.write_prompt(slot, k, v, tokens, ks, vs)
    else:
        k = torch.rand(shape, generator=gen).to(torch.bfloat16)
        v = torch.rand(shape, generator=gen).to(torch.bfloat16)
        pc.write_prompt(slot, k, v, tokens)


@pytest.mark.parametrize("kv_quant", ["int8", ""])
def test_export_import_roundtrip_bits(kv_quant):
    src, dst = _paged(kv_quant=kv_quant), _paged(kv_quant=kv_quant)
    _fill_slot(src, 0, 8, seed=3)
    pages = src.pool.slot_pages(0)
    slabs = src.export_pages(pages)
    assert slabs["hk"].shape[0] == len(pages) == 2
    fresh = dst.pool.allocate_cache_pages(len(pages))
    dst.import_pages(slabs["hk"], slabs["hv"], fresh, slabs.get("hk_scale"),
                     slabs.get("hv_scale"))
    assert dst.reap_promotions(force=True) == 1
    out = dst.export_pages(fresh)
    for name in slabs:
        assert slabs[name] is not None
        assert torch.equal(slabs[name], out[name]), name
    dst.pool.unref_pages(fresh)
    src.pool.free(0)


def test_import_pages_validates_scales_rows_and_geometry():
    dst = _paged(kv_quant="int8")
    rows = torch.zeros((2, 2, 2, 4, 8), dtype=torch.int8)
    scales = torch.zeros((2, 2, 2, 4))
    with pytest.raises(ValueError):
        dst.import_pages(rows, rows, [1, 2])                  # int8 pool, no scales
    with pytest.raises(ValueError):
        dst.import_pages(rows, rows, [1, 2, 3], scales, scales)   # 2 rows != 3
    with pytest.raises(ValueError):
        dst.import_pages(rows[..., :4], rows[..., :4], [1, 2], scales, scales)
    assert not dst._promotions


def _export_shipment(pc, slot, ids, block):
    p = ((len(ids) - 1) // block) * block
    slabs = pc.export_pages(pc.pool.slot_pages(slot)[:p // pc.pool.page_size])
    return KVShipment(key=shipment_key(ids, block, 0), src="r0", prefix_len=p,
                      page_size=pc.pool.page_size, lora=0, hk=slabs["hk"], hv=slabs["hv"],
                      hk_scale=slabs.get("hk_scale"), hv_scale=slabs.get("hv_scale"))


def test_store_shipped_attaches_only_missing_blocks():
    block = 4
    src = _paged()
    ids = list(range(10, 23))    # 13 tokens -> 12 storable = 3 blocks
    _fill_slot(src, 0, 13, seed=5)
    shipment = _export_shipment(src, 0, ids, block)
    assert shipment.pages == 3
    dst = _paged(num_pages=17)
    cache = RadixPrefixCache(block=block, pool=dst.pool, page_bytes=64)
    _fill_slot(dst, 0, 5, seed=6)
    cache.store_pages(ids[:5], 0, dst.pool.slot_pages(0))
    assert cache.match_len(ids) == block
    assert cache.store_shipped(ids, 0, shipment, dst) == 2
    assert dst.reap_promotions(force=True) == 1
    assert cache.match_len(ids) == 12
    assert cache.store_shipped(ids, 0, shipment, dst) == 0
    hit = cache.lookup_pages(ids)
    assert hit is not None and hit["len"] == 12
    # the imported pages hold the shipment's rows 1 and 2, bit for bit
    got = dst.export_pages(hit["pages"][1:])
    for name in ("hk", "hv", "hk_scale", "hv_scale"):
        assert torch.equal(got[name], getattr(shipment, name)[1:])
    cache.release(hit)
    dst.pool.free(0)
    KVSanitizer(dst.pool, prefix_cache=cache).check("shipped", drained=True)


def test_store_shipped_validates_geometry_and_pool_pressure():
    src = _paged()
    ids = list(range(13))
    _fill_slot(src, 0, 13, seed=1)
    shipment = _export_shipment(src, 0, ids, 4)
    wrong = _paged(page_size=8)
    with pytest.raises(ValueError):
        RadixPrefixCache(block=8, pool=wrong.pool, page_bytes=64).store_shipped(
            ids, 0, shipment, wrong)
    bare = KVShipment(key=shipment.key, src="r0", prefix_len=shipment.prefix_len, page_size=4,
                      lora=0, hk=shipment.hk, hv=shipment.hv)
    dst = _paged()
    with pytest.raises(ValueError):
        RadixPrefixCache(block=4, pool=dst.pool, page_bytes=64).store_shipped(ids, 0, bare, dst)
    small = _paged(num_pages=3)    # 2 usable pages < the 3-page shipment
    cache = RadixPrefixCache(block=4, pool=small.pool, page_bytes=64)
    with pytest.raises(MemoryError):
        cache.store_shipped(ids, 0, shipment, small)
    assert cache.match_len(ids) == 0 and small.pool.free_pages == 2
    KVSanitizer(small.pool, prefix_cache=cache).check("pressure", drained=True)


# -- role-aware routing, both routers --------------------------------------------


class StubReplica:
    def __init__(self, index):
        self.index = index
        self.name = "r{}".format(index)
        self.engine_ready = True
        self.warmed = True
        self.queue_depth = 0
        self.brownout_stage = 0
        self.warming = False

    def invalidate_warm(self):
        self.warmed = False

    def begin_warm(self):
        self.warmed = True


ROUTERS = {"jax": (jax_router, JaxGenRequest), "port": (port_router, GenRequest)}


def _role_router(pkg, roles):
    stubs = [StubReplica(i) for i in range(len(roles))]
    mod = ROUTERS[pkg][0]
    return mod.ReplicaRouter(stubs, roles={s.name: r for s, r in zip(stubs, roles)}), stubs


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_role_routing(pkg):
    Req = ROUTERS[pkg][1]
    router, stubs = _role_router(pkg, ["prefill", "decode", "hybrid"])
    for seed in range(8):
        ids = [(seed * 31 + i) % 97 + 1 for i in range(40)]
        assert router.role_of(router.pick(Req(prompt_ids=ids))[0].name) in ("decode", "hybrid")
    assert router.pick_prefill(Req(prompt_ids=list(range(40))), exclude="r1").name == "r0"
    stubs[0].brownout_stage = 2
    assert router.pick_prefill(Req(prompt_ids=list(range(40))), exclude="r1").name == "r2"
    stubs[2].engine_ready = False
    router.sweep()
    assert router.pick_prefill(Req(prompt_ids=list(range(40))), exclude="r1") is None
    assert router.stats()["roles"] == {"r0": "prefill", "r1": "decode", "r2": "hybrid"}
    router, stubs = _role_router(pkg, ["prefill", "decode"])
    stubs[1].engine_ready = False
    router.sweep()
    replica, route = router.pick(Req(prompt_ids=list(range(40))))
    assert replica.name == "r0" and route in ("affine", "rebalance")
    with pytest.raises(ValueError, match="role"):
        ROUTERS[pkg][0].ReplicaRouter([StubReplica(0), StubReplica(1)],
                                      roles={"r0": "decoder", "r1": "decode"})
    with pytest.raises(ValueError, match="unknown replica"):
        ROUTERS[pkg][0].ReplicaRouter([StubReplica(0), StubReplica(1)], roles={"rX": "decode"})


# -- fleets over real engines ------------------------------------------------------


class Side:
    def __init__(self, name, tiny_np):
        self.name = name
        self.tiny_np = tiny_np
        self.Req = JaxGenRequest if name == "jax" else GenRequest
        self.faults = jax_faults if name == "jax" else faults
        self.ledger = jax_ledger if name == "jax" else lifecycle_ledger

    def group(self, n=2, roles=None, kv_backend="shared", **overrides):
        kw = dict(GROUP_CFG, **overrides)
        if self.name == "jax":
            bundle = models.build_model("llama", QCFG)
            engines = [JaxEngine(bundle, self.tiny_np, replica="r{}".format(i), **kw)
                       for i in range(n)]
            return JaxGroup(engines, roles=roles, kv_transport_backend=kv_backend)
        model = Llama(QCFG, convert_params(self.tiny_np, device="cpu"))
        engines = [LLMEngineCore(model, replica="r{}".format(i), **kw) for i in range(n)]
        return ReplicaGroup(engines, roles=roles, kv_transport_backend=kv_backend)


def _conv(seed, n=44):
    return [(seed * 29 + i * 7) % 200 + 1 for i in range(n)]


async def _collect(side, group, ids, n=5, **kw):
    request = side.Req(prompt_ids=list(ids), max_new_tokens=n, **kw)
    out = [int(t) async for t in group.generate(request)]
    return out, request


def _drained_clean(side, group, replicas=None):
    async def drain():
        await group.wait_drained()

    asyncio.run(drain())
    for replica in replicas or group.replicas:
        assert replica.engine._sanitizer.stats()["failures"] == 0
    stats = side.ledger.get().stats()
    assert stats["leaks"] == 0 and stats["double_releases"] == 0, stats


def _mono(side, prompts, **overrides):
    """The streams of a monolithic single engine (a group of one)."""
    async def run():
        group = side.group(n=1, **overrides)
        out = [(await _collect(side, group, ids, **kw))[0] for ids, kw in prompts]
        await group.wait_drained()
        group.stop()
        return out

    return asyncio.run(run())


def _both(tiny_np, scenario):
    return scenario(Side("jax", tiny_np)), scenario(Side("port", tiny_np))


SCHEDULERS = [{}, RAGGED]


@pytest.mark.parametrize("sched", SCHEDULERS, ids=["two_dispatch", "ragged"])
def test_disagg_streams_equal_monolithic_and_the_reference(tiny_np, sched):
    """A two-replica disaggregated fleet's streams (greedy and seeded)
    equal a monolithic engine's and the JAX fleet's; the decode replica's
    admissions hit every shipped prefix."""
    prompts = [(_conv(1), {}), (_conv(2, n=60), {}), (_conv(3, n=33), {}),
               (_conv(1), {"seed": 77, "temperature": 0.8})]

    def scenario(side):
        expected = _mono(side, prompts, **sched)

        async def run():
            group = side.group(roles=["prefill", "decode"], **sched)
            got = [(await _collect(side, group, ids, **kw))[0] for ids, kw in prompts[:3]]
            # the seeded turn repeats conversation 1: the decode side is warm
            got.append((await _collect(side, group, prompts[3][0], **prompts[3][1]))[0])
            await group.wait_drained()
            return group, got

        group, got = asyncio.run(run())
        decode = group.replicas[1].engine._kv_ship_snapshot()
        prefill = group.replicas[0].engine._kv_ship_snapshot()
        summary = (got == expected, decode["role"], decode["receives"], decode["hits"],
                   decode["recomputes"], decode["hit_rate"], prefill["ships"],
                   prefill["ship_pages"], group._disagg_snapshot()["ship_leg_failures"],
                   group.ship_warm_skips)
        _drained_clean(side, group)
        group.stop()
        return got, summary

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert port[1][:6] == (True, "decode", 3, 3, 0, 1.0)
    assert port[1][6] == 3 and port[1][7] > 0 and port[1][8] == 0 and port[1][9] == 1


def test_draft_ahead_frames_ship_under_ragged(tiny_np):
    """A ragged prefill replica ships whole storable pages at its chunk
    boundaries (unsealed frames) and seals at the commit; the decode
    replica hits the shipped prefix and the stream equals a monolithic
    engine's and the JAX fleet's."""
    _draft_ahead_case(tiny_np, "shared")


def test_draft_ahead_frames_ship_under_ragged_over_the_socket_wire(tiny_np):
    """The same over the socket transport (``llm/kv_wire.py``) on both
    packages: the partial frames cross a real byte boundary."""
    _draft_ahead_case(tiny_np, "socket")


def _draft_ahead_case(tiny_np, kv_backend):
    ids = _conv(21, n=60)

    def scenario(side):
        expected = _mono(side, [(ids, {})], **RAGGED)

        async def run():
            group = side.group(roles=["prefill", "decode"], kv_backend=kv_backend, **RAGGED)
            got = (await _collect(side, group, ids))[0]
            await group.wait_drained()
            return group, got

        group, got = asyncio.run(run())
        p = group.replicas[0].engine._kv_ship_snapshot()
        d = group.replicas[1].engine._kv_ship_snapshot()
        tr = d["transport"]
        out = (got, got == expected[0], p["draft_ships"], p["draft_pages"], p["draft_aborts"],
               p["ships"], p["ship_pages"], p["overlap_ratio"], tr["partial_frames"],
               tr["assembled"], tr["assembly_drops"], d["hits"], d["recomputes"])
        _drained_clean(side, group)
        group.stop()
        return out

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert port[1] and port[2] >= 1 and port[4] == 0 and port[7] > 0
    assert port[8] >= 1 and port[9] == port[5] and port[10] == 0
    assert port[11] == 1 and port[12] == 0


def test_warm_turns_skip_the_ship_leg(tiny_np):
    def scenario(side):
        async def run():
            group = side.group(roles=["prefill", "decode"])
            ids = _conv(9)
            await _collect(side, group, ids)
            legs0 = group.ship_legs
            await _collect(side, group, ids)
            await group.wait_drained()
            return group, (group.ship_warm_skips, group.ship_legs - legs0)

        group, out = asyncio.run(run())
        _drained_clean(side, group)
        group.stop()
        return out

    ref, port = _both(tiny_np, scenario)
    assert port == ref == (1, 0)


SHIP_FAULTS = [("engine.kv.ship", {}), ("engine.kv.ship", RAGGED), ("kv.ship.partial", RAGGED)]


@pytest.mark.parametrize("point,sched", SHIP_FAULTS)
def test_ship_faults_fall_back_to_decode_recompute(tiny_np, point, sched):
    """An injected ``engine.kv.ship`` (at the commit) or ``kv.ship.partial``
    (at a ragged chunk boundary) drops the shipment with nothing leaked;
    the decode replica recomputes and the stream is unchanged."""
    _ship_fault_case(tiny_np, point, sched, "shared")


@pytest.mark.parametrize("point,sched", SHIP_FAULTS)
def test_ship_faults_fall_back_to_decode_recompute_over_the_socket_wire(tiny_np, point, sched):
    _ship_fault_case(tiny_np, point, sched, "socket")


def _ship_fault_case(tiny_np, point, sched, kv_backend):
    ids = _conv(11, n=60)

    def scenario(side):
        expected = _mono(side, [(ids, {})], **sched)

        async def run():
            group = side.group(roles=["prefill", "decode"], kv_backend=kv_backend, **sched)
            side.faults.configure([{"point": point, "action": "raise", "times": 1}])
            try:
                got = (await _collect(side, group, ids))[0]
            finally:
                side.faults.clear()
            await group.wait_drained()
            return group, got

        group, got = asyncio.run(run())
        p = group.replicas[0].engine._kv_ship_snapshot()
        d = group.replicas[1].engine._kv_ship_snapshot()
        out = (got == expected[0], p["ships"], p["ship_drops"] >= 1, p["draft_aborts"],
               d["receives"], d["recomputes"], d["hits"])
        _drained_clean(side, group)
        group.stop()
        return out

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert port[0] and port[1] == 0 and port[2] and port[4:] == (0, 1, 0)
    assert port[3] == (1 if point == "kv.ship.partial" else 0)


def test_receive_fault_reroutes_to_hybrid(tiny_np):
    _receive_fault_case(tiny_np, "shared")


def test_receive_fault_reroutes_to_hybrid_over_the_socket_wire(tiny_np):
    _receive_fault_case(tiny_np, "socket")


def _receive_fault_case(tiny_np, kv_backend):
    ids = _conv(13)

    def scenario(side):
        expected = _mono(side, [(ids, {})])

        async def run():
            group = side.group(n=3, roles=["prefill", "decode", "hybrid"],
                               kv_backend=kv_backend)
            side.faults.configure([{"point": "engine.kv.receive", "action": "raise",
                                    "times": 1}])
            try:
                request = side.Req(prompt_ids=list(ids), max_new_tokens=5)
                request._replica_name = "r1"
                got = [int(t) async for t in group.generate(request)]
            finally:
                side.faults.clear()
            await group.wait_drained()
            return group, got, request._replica_name

        group, got, home = asyncio.run(run())
        out = (got == expected[0], group.receive_reroutes, group.router.role_of(home),
               group.replicas[1].engine._kv_ship_snapshot()["receive_failures"])
        _drained_clean(side, group)
        group.stop()
        return out

    ref, port = _both(tiny_np, scenario)
    assert port == ref == (True, 1, "hybrid", 1)


def test_failed_prefill_replica_degrades_to_decode_side_prefill(tiny_np):
    """The prefill replica fails mid-leg: the stream completes on the
    decode replica, which prefills for itself; once the prefill replica is
    stopped, later requests run no leg at all."""
    _failed_prefill_case(tiny_np, "shared")


def test_failed_prefill_replica_degrades_to_decode_side_prefill_over_the_socket_wire(tiny_np):
    _failed_prefill_case(tiny_np, "socket")


def _failed_prefill_case(tiny_np, kv_backend):
    ids = _conv(17)

    def scenario(side):
        expected = _mono(side, [(ids, {})])

        async def run():
            group = side.group(roles=["prefill", "decode"], kv_backend=kv_backend)
            side.faults.configure([{"point": "engine.prefill", "action": "raise",
                                    "times": 1}])
            try:
                got = (await _collect(side, group, ids))[0]
            finally:
                side.faults.clear()
            failures = group.ship_leg_failures
            group.replicas[0].engine.stop()
            group.router.sweep()
            legs0 = group.ship_legs
            got2 = (await _collect(side, group, _conv(18)))[0]
            await group.replicas[1].engine.wait_drained()
            return group, (got == expected[0], failures, len(got2), group.ship_legs - legs0)

        group, out = asyncio.run(run())
        assert group.replicas[1].engine._sanitizer.stats()["failures"] == 0
        group.stop()
        return out

    ref, port = _both(tiny_np, scenario)
    assert port == ref == (True, 1, 5, 0)


def test_receive_races_live_admissions(tiny_np):
    """A shipment imported into the decode replica while two admissions
    prefill there (their workers in flight, their commits pending): the
    import allocates its pages on the loop thread the commits allocate
    on, so every stream equals a monolithic engine's, the shipped prompt
    then hits, and the sanitizer and the ledger stay clean."""
    side = Side("port", tiny_np)
    live = [_conv(31, n=60), _conv(32, n=50)]
    shipped = _conv(33, n=49)
    expected = _mono(side, [(p, {}) for p in live + [shipped]])

    async def run():
        model = Llama(QCFG, convert_params(tiny_np, device="cpu"))
        pre = LLMEngineCore(model, replica="r0", **GROUP_CFG)
        dec = LLMEngineCore(model, replica="r1", **GROUP_CFG)
        transport = SharedSlabTransport(capacity_pages=64)
        pre.attach_kv_transport(transport.register("r0"), role="prefill")
        dec.attach_kv_transport(transport.register("r1"), role="decode")
        leg = GenRequest(prompt_ids=list(shipped), max_new_tokens=1)
        leg._ship_to = "r1"
        [t async for t in pre.generate(leg)]
        await pre.wait_drained()
        tasks = [asyncio.ensure_future(_collect(side, dec, p)) for p in live]
        while len(dec._admitting) + len(dec._ready) + dec.active_slots < 2:
            await asyncio.sleep(0)
        receipt = dec.receive_shipment(shipped)
        outs = [o for o, _ in await asyncio.gather(*tasks)]
        req = GenRequest(prompt_ids=list(shipped), max_new_tokens=5)
        req._shipped = True
        outs.append([int(t) async for t in dec.generate(req)])
        await dec.wait_drained()
        pre.stop()
        return dec, receipt, outs

    dec, receipt, outs = asyncio.run(run())
    assert receipt == {"status": "imported", "pages": 3}
    assert outs == expected
    ship = dec._kv_ship_snapshot()
    assert ship["hits"] == 1 and ship["recomputes"] == 0
    assert dec._sanitizer.stats()["failures"] == 0
    stats = lifecycle_ledger.get().stats()
    assert stats["leaks"] == 0 and stats["outstanding"].get("kv.promotion", 0) == 0
    dec.stop()


def test_group_roles_and_backends_are_validated(tiny_np):
    model = Llama(QCFG, convert_params(tiny_np, device="cpu"))
    small = dict(max_batch=1, max_seq_len=32, prefill_buckets=[16], page_size=16)
    engines = [LLMEngineCore(model, prefix_cache=16, prefix_block=16, **small)
               for _ in range(2)]
    with pytest.raises(ValueError, match="replica_roles"):
        ReplicaGroup(list(engines), roles=["prefill"])
    with pytest.raises(ValueError, match="prefill/decode/hybrid"):
        ReplicaGroup(list(engines), roles=["prefill", "decoder"])
    with pytest.raises(ValueError, match="decode-capable"):
        ReplicaGroup(list(engines), roles=["prefill", "prefill"])
    with pytest.raises(ValueError, match="kv_transport_backend"):
        ReplicaGroup(list(engines), roles=["prefill", "decode"],
                     kv_transport_backend="carrier-pigeon")
    # the socket backend wires every engine to an endpoint of one fabric
    group = ReplicaGroup(list(engines), roles=["prefill", "decode"],
                         kv_transport_backend="socket")
    assert isinstance(group.transport, SocketSlabFabric)
    assert [e._kv_transport for e in engines] == [group.transport.register("r0"),
                                                  group.transport.register("r1")]
    group.stop()
    bare = [LLMEngineCore(model, **small) for _ in range(2)]
    with pytest.raises(ValueError, match="paged"):
        ReplicaGroup(bare, roles=["prefill", "decode"])
