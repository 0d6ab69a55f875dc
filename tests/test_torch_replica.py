"""The port's replica fleet (clearml_serving_tpu_torch/llm/replica.py and
serving/replica_router.py) against the JAX package's, the scenarios of the
reference's ``tests/test_replica.py`` run on both.

Router units run on both routers over the same stub replicas, and the
port's affinity keys and HRW orders equal the reference's. The engine
scenarios build each package's group on llama-tiny at float32 over the
same weights (``convert_params``; the port's replicas share ONE ``Llama``),
with the KV sanitizer armed: a conversation sticks to one replica and hits
its cache, a watchdog-tripped replica's streams resume on the sibling
byte-identically, a forced eject re-admits through the warmup gate, health
aggregates, a resume carries the remaining deadline budget, a failover
never overshoots ``max_new_tokens`` and penalty requests do not fail over.
Greedy and seeded fleet streams equal the JAX group's.
"""

import asyncio
import time

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.errors import EngineStuckError as JaxStuck
from clearml_serving_tpu.llm import faults as jax_faults
from clearml_serving_tpu.llm import warmup as jax_warmup
from clearml_serving_tpu.llm.engine import GenRequest as JaxGenRequest
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.llm.replica import ReplicaGroup as JaxGroup
from clearml_serving_tpu.serving import replica_router as jax_router
from clearml_serving_tpu_torch.errors import (
    EngineOverloadedError,
    EngineStuckError,
    EngineUnavailableError,
)
from clearml_serving_tpu_torch.llm import faults
from clearml_serving_tpu_torch.llm import warmup
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.replica import ReplicaGroup
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.serving import replica_router as port_router

pytestmark = pytest.mark.chaos

TINY = {"preset": "llama-tiny", "dtype": "float32"}
CFG = dict(max_batch=2, max_seq_len=128, prefill_buckets=[16, 32, 64], eos_token_id=None,
           decode_steps=1, cache_mode="paged", page_size=16, prefix_cache=64,
           prefix_block=16, max_pending=8)
ROUTERS = {"jax": jax_router, "port": port_router}


@pytest.fixture(autouse=True)
def armed(monkeypatch):
    """Every engine runs with the KV sanitizer armed: failover resumes and
    ejection drains must keep page accounting balanced."""
    monkeypatch.setenv("TPUSERVE_SANITIZE", "1")
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


class Side:
    """One package under test: its group, request and fault registry."""

    def __init__(self, name, tiny_np):
        self.name = name
        self.tiny_np = tiny_np
        self.Req = JaxGenRequest if name == "jax" else GenRequest
        self.faults = jax_faults if name == "jax" else faults
        self.Stuck = JaxStuck if name == "jax" else EngineStuckError
        self.Group = JaxGroup if name == "jax" else ReplicaGroup

    def engines(self, n=2, **overrides):
        kw = dict(CFG, **overrides)
        if self.name == "jax":
            bundle = models.build_model("llama", TINY)
            return [JaxEngine(bundle, self.tiny_np, replica="r{}".format(i), **kw)
                    for i in range(n)]
        # ONE Llama for every replica
        model = Llama(TINY, convert_params(self.tiny_np, device="cpu"))
        return [LLMEngineCore(model, replica="r{}".format(i), **kw) for i in range(n)]

    def group(self, n=2, warmup_mode="off", **overrides):
        return self.Group(self.engines(n, **overrides), warmup_mode=warmup_mode)


def _both(tiny_np, scenario):
    out = {}
    for name in ("jax", "port"):
        out[name] = scenario(Side(name, tiny_np))
    return out["jax"], out["port"]


def _conv(seed, n=48):
    return [(seed * 29 + i * 7) % 200 + 1 for i in range(n)]


async def _collect(side, group, ids, n=4, **kw):
    request = side.Req(prompt_ids=list(ids), max_new_tokens=n, **kw)
    out = []
    async for token in group.generate(request):
        out.append(int(token))
    return out, request


def _sanitizers_clean(group):
    for replica in group.replicas:
        stats = replica.engine._sanitizer.stats()
        assert stats["failures"] == 0, (replica.name, stats)


# -- routing math --------------------------------------------------------------


def test_affinity_keys_and_hrw_orders_equal_the_reference():
    rng = np.random.default_rng(0)
    names = ["r{}".format(i) for i in range(5)]
    for _ in range(200):
        ids = [int(t) for t in rng.integers(1, 500, int(rng.integers(1, 300)))]
        block = int(rng.choice([4, 16, 64]))
        blocks = int(rng.integers(1, 6))
        key = port_router.affinity_key(ids, block, blocks)
        assert key == jax_router.affinity_key(ids, block, blocks)
        assert port_router.hrw_order(key, names) == jax_router.hrw_order(key, names)


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_affinity_key_stable_as_conversation_grows(pkg):
    affinity_key = ROUTERS[pkg].affinity_key
    base = [(7 + i * 13) % 200 + 1 for i in range(80)]
    keys = {affinity_key(base, block=16), affinity_key(base + [5] * 16, block=16),
            affinity_key(base + [5] * 40 + [9, 9], block=16)}
    assert len(keys) == 1


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_affinity_key_caps_short_and_differs(pkg):
    affinity_key = ROUTERS[pkg].affinity_key
    ids = list(range(1, 200))
    assert affinity_key(ids, 16, max_blocks=2) == affinity_key(ids[:33] + [0] * 50, 16,
                                                               max_blocks=2)
    assert affinity_key(_conv(1), 16) != affinity_key(_conv(2), 16)
    # shorter than a block: hashes whole
    assert affinity_key([1, 2, 3], 16) != affinity_key([1, 2, 4], 16)


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_hrw_order_is_deterministic_and_minimally_disruptive(pkg):
    hrw_order = ROUTERS[pkg].hrw_order
    names = ["r0", "r1", "r2", "r3"]
    moved = 0
    for seed in range(200):
        key = ROUTERS[pkg].affinity_key(_conv(seed), 16)
        order = hrw_order(key, names)
        assert order == hrw_order(key, names)
        survivors = [n for n in names if n != "r2"]
        first = names[order[0]]
        new_first = survivors[hrw_order(key, survivors)[0]]
        if first != "r2":
            assert new_first == first
        else:
            moved += 1
    assert 0 < moved < 200


class StubReplica:
    def __init__(self, index, ready=True, warmed=True, depth=0, stage=0, warm_delay_sweeps=0):
        self.index = index
        self.name = "r{}".format(index)
        self.engine_ready = ready
        self.warmed = warmed
        self.queue_depth = depth
        self.brownout_stage = stage
        self.warm_calls = 0
        self._warm_delay = warm_delay_sweeps
        self.warming = False

    def invalidate_warm(self):
        self.warmed = False

    def begin_warm(self):
        self.warm_calls += 1
        if self._warm_delay > 0:
            self._warm_delay -= 1
            self.warming = True
        else:
            self.warming = False
            self.warmed = True


def _router(pkg, stubs, **kw):
    return ROUTERS[pkg].ReplicaRouter(stubs, block=16, **kw)


def _req(pkg, ids, priority="interactive"):
    cls = JaxGenRequest if pkg == "jax" else GenRequest
    return cls(prompt_ids=list(ids), priority=priority)


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_pick_is_affine_sticky_and_rebalances(pkg):
    stubs = [StubReplica(0), StubReplica(1)]
    router = _router(pkg, stubs)
    ids = _conv(3)
    first, route = router.pick(_req(pkg, ids))
    assert route == "affine"
    for _ in range(3):
        assert router.pick(_req(pkg, ids)) == (first, "affine")
    first.engine_ready = False
    other, route = router.pick(_req(pkg, ids))
    assert other is not first and route == "rebalance"
    assert router.stats()["ejections"][first.name] == 1


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_pick_spills_on_pressure_gap_and_queue_bound(pkg):
    stubs = [StubReplica(0), StubReplica(1)]
    router = _router(pkg, stubs, spill_queue_depth=4)
    ids = _conv(5)
    home, _ = router.pick(_req(pkg, ids))
    other = stubs[1 - stubs.index(home)]
    home.brownout_stage = 2
    other.brownout_stage = 2
    assert router.pick(_req(pkg, ids)) == (home, "affine")   # a tie never spills
    other.brownout_stage = 0
    assert router.pick(_req(pkg, ids)) == (other, "spill")
    home.brownout_stage = 0
    home.queue_depth = 4
    assert router.pick(_req(pkg, ids)) == (other, "spill")


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_fleet_brownout_sheds_best_effort_and_empty_ring_raises(pkg):
    stubs = [StubReplica(0, stage=3), StubReplica(1, stage=3)]
    router = _router(pkg, stubs)
    errors = {"jax": jax_router, "port": port_router}[pkg]
    with pytest.raises(errors.EngineOverloadedError):
        router.pick(_req(pkg, _conv(1), "best_effort"))
    assert router.pick(_req(pkg, _conv(1)))[0] in stubs   # interactive still routes
    assert router.stats()["fleet_sheds"]["best_effort"] == 1
    for s in stubs:
        s.engine_ready = False
    with pytest.raises(errors.EngineUnavailableError):
        router.pick(_req(pkg, _conv(1)))


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_injected_pick_fault_falls_to_next_member(pkg):
    fl = jax_faults if pkg == "jax" else faults
    stubs = [StubReplica(0), StubReplica(1)]
    router = _router(pkg, stubs)
    ids = _conv(7)
    home, _ = router.pick(_req(pkg, ids))
    fl.configure([{"point": "router.pick", "times": 1}])
    chosen, route = router.pick(_req(pkg, ids))
    assert chosen is not home and route == "rebalance"


@pytest.mark.parametrize("pkg", sorted(ROUTERS))
def test_forced_eject_gates_readmission_through_warmup(pkg):
    fl = jax_faults if pkg == "jax" else faults
    a = StubReplica(0)
    b = StubReplica(1, warm_delay_sweeps=2)
    router = _router(pkg, [a, b])
    assert router.ring_size == 2
    fl.configure([{"point": "router.eject", "match_token": 1, "times": -1}])
    router.sweep()
    assert router.ring() == ["r0"]
    assert router.stats()["ejections"]["r1"] == 1
    fl.clear()
    ring = []
    for _ in range(4):
        router.sweep()
        ring.append(router.ring())
    assert ring == [["r0"], ["r0"], ["r0"], ["r0", "r1"]] and b.warm_calls == 3
    assert router.stats()["readmissions"]["r1"] == 1


def test_port_router_refuses_what_the_reference_refuses():
    stubs = [StubReplica(0), StubReplica(0)]
    for pkg in ROUTERS:
        with pytest.raises(ValueError, match="unique"):
            ROUTERS[pkg].ReplicaRouter(stubs)


# -- real engines ----------------------------------------------------------------


def test_conversation_sticks_to_one_replica_and_hits_its_cache(tiny_np):
    def scenario(side):
        group = side.group()
        try:
            async def run():
                conv = _conv(11, 40)
                homes, streams = set(), []
                for turn in range(3):
                    out, req = await _collect(side, group, conv + [3 + turn] * (turn + 1))
                    homes.add(req._replica_name)
                    streams.append(out)
                await group.wait_drained()
                return homes, streams

            homes, streams = asyncio.run(run())
            home = next(r for r in group.replicas if r.name in homes)
            other = next(r for r in group.replicas if r is not home)
            _sanitizers_clean(group)
            return (sorted(homes), streams, home.engine._prefix.hits,
                    other.engine._prefix.hits, group.router.stats()["requests"])
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    homes, _streams, home_hits, other_hits, routes = port
    assert len(homes) == 1 and home_hits >= 2 and other_hits == 0
    assert routes[homes[0]]["affine"] == 3


def test_fleet_streams_equal_the_reference_greedy_and_seeded(tiny_np):
    """Several conversations at once through each package's fleet, greedy
    and seeded: every stream and every home equals the JAX group's."""
    def scenario(side):
        group = side.group()
        try:
            async def run():
                jobs = []
                for seed in range(4):
                    jobs.append(_collect(side, group, _conv(seed, 36), 6))
                    jobs.append(_collect(side, group, _conv(seed + 10, 30), 6,
                                         temperature=0.8, seed=100 + seed))
                results = await asyncio.gather(*jobs)
                await group.wait_drained()
                return [(out, req._replica_name) for out, req in results]

            res = asyncio.run(run())
            _sanitizers_clean(group)
            return res
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert {home for _, home in port} == {"r0", "r1"}


def test_watchdog_trip_drains_streams_to_sibling_byte_identically(tiny_np):
    """A stalled replica trips its watchdog mid-stream; its stream resumes
    on the sibling with no error, byte-identical (greedy, float32); the
    untouched conversation never notices; the tripped replica recovers,
    re-warms and rejoins the ring."""
    def scenario(side):
        # a 1 s watchdog and a 3 s stall: wide enough that the untouched
        # replica never trips on a busy host (the reference's test: 0.3/1.2)
        group = side.group(watchdog_interval=1.0)
        try:
            async def run():
                prompts, seed = {}, 0
                while len(prompts) < 2:
                    p = _conv(seed, 40)
                    prompts.setdefault(group.router.order_for(p)[0].name, p)
                    seed += 1
                victim_prompt = prompts["r1"][:-1] + [251]
                base_victim, _ = await _collect(side, group, victim_prompt, 12)
                base_other, _ = await _collect(side, group, prompts["r0"], 12)
                await group.wait_drained()
                side.faults.configure([{"point": "engine.decode.stall", "action": "delay",
                                        "delay": 3.0, "times": 1, "match_token": 251}])
                (v_out, v_req), (u_out, _) = await asyncio.gather(
                    _collect(side, group, victim_prompt, 12),
                    _collect(side, group, prompts["r0"], 12))
                side.faults.clear()
                t0 = time.monotonic()
                while time.monotonic() - t0 < 30:
                    group.router.sweep()
                    if group.router.ring_size == 2:
                        break
                    await asyncio.sleep(0.02)
                await group.wait_drained()
                return base_victim, base_other, v_out, u_out, v_req._replica_name

            out = asyncio.run(run())
            stats = group.router.stats()
            _sanitizers_clean(group)
            return out + (group.failovers >= 1, group.router.ring_size,
                          stats["ejections"]["r1"] >= 1, stats["readmissions"]["r1"] >= 1,
                          group.replicas[1].engine.counters["watchdog_trips"] >= 1)
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    base_victim, base_other, v_out, u_out, home = port[:5]
    assert v_out == base_victim and u_out == base_other and home == "r0"
    assert port[5:] == (True, 2, True, True, True)


def test_forced_eject_reroutes_and_rewarms_through_gate(tiny_np, monkeypatch):
    """``router.eject`` forces a replica out: its conversation rebalances to
    the sibling with identical tokens; clearing the fault re-admits it
    through the warmup gate (``run_warmup`` called on its engine)."""
    calls = {"jax": [], "port": []}

    async def jax_fake(engine, full=True, extra_prompts=None, fence=True):
        calls["jax"].append(engine)
        return {"requests": 0, "cow_buckets": 0, "fenced": False}

    async def port_fake(engine, full=False):
        calls["port"].append(engine)
        return {"requests": 0, "graph_captures": 0}

    monkeypatch.setattr(jax_warmup, "run_warmup", jax_fake)
    monkeypatch.setattr(warmup, "run_warmup", port_fake)

    def scenario(side):
        group = side.group(warmup_mode="startup")
        for replica in group.replicas:   # gates start closed under startup
            replica.warmed = True
        group.router.sweep()
        try:
            async def run():
                seed = 0
                while group.router.order_for(_conv(seed, 40))[0].name != "r1":
                    seed += 1
                p = _conv(seed, 40)
                base, _ = await _collect(side, group, p, 6)
                await group.wait_drained()
                side.faults.configure([{"point": "router.eject", "match_token": 1,
                                        "times": -1}])
                out, req = await _collect(side, group, p, 6)
                ring_during = group.router.ring()
                side.faults.clear()
                t0 = time.monotonic()
                while time.monotonic() - t0 < 10:
                    group.router.sweep()
                    if group.router.ring_size == 2:
                        break
                    await asyncio.sleep(0.01)
                await group.wait_drained()
                return base, out, req._replica_name, ring_during

            base, out, home, ring_during = asyncio.run(run())
            rewarmed = any(e is group.replicas[1].engine for e in calls[side.name])
            return (base, out, home, ring_during, group.router.ring_size, rewarmed,
                    group.router.stats()["requests"]["r0"]["rebalance"] >= 1)
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    base, out, home, ring_during, ring_size, rewarmed, rebalanced = port
    assert out == base and home == "r0" and ring_during == ["r0"]
    assert ring_size == 2 and rewarmed and rebalanced


def test_group_health_aggregates_ready_iff_ring_nonempty(tiny_np):
    def scenario(side):
        group = side.group()
        seen = []
        h = group.health()
        seen.append((h["ready"], h["ring_size"], sorted(h["replicas"]),
                     h["replicas"]["r0"]["replica"], h["router"]["replicas"]))
        group.replicas[1].engine.stop()
        h = group.health()
        seen.append((h["ready"], h["ring_size"], h["replicas"]["r1"]["ring_state"]))
        group.replicas[0].engine.stop()
        h = group.health()
        seen.append((h["ready"], h["ring_size"]))
        stats = group.lifecycle_stats()
        seen.append((stats["ready"], sorted(stats["replicas"]),
                     stats["replicas"]["r0"]["replica"]))
        return seen

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert port == [(True, 2, ["r0", "r1"], "r0", 2), (True, 1, "ejected"), (False, 0),
                    (0, ["r0", "r1"], "r0")]


def test_check_admission_pins_route_for_generate(tiny_np):
    def scenario(side):
        group = side.group()
        try:
            async def run():
                request = side.Req(prompt_ids=_conv(21, 40), max_new_tokens=2)
                group.validate(request)
                group.check_admission(request)
                pinned = request._replica_name
                out = [t async for t in group.generate(request)]
                await group.wait_drained()
                return pinned, request._replica_name, out

            return asyncio.run(run())
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert port[0] == port[1] and len(port[2]) == 2


def test_resume_clone_carries_remaining_deadline_budget():
    for Group, Req in ((JaxGroup, JaxGenRequest), (ReplicaGroup, GenRequest)):
        request = Req(prompt_ids=[1, 2, 3], max_new_tokens=8, total_timeout=10.0,
                      ttft_timeout=5.0, queue_timeout=2.0, min_tokens=3)
        now = time.monotonic()
        request._deadline = now + 1.0
        request._ttft_deadline = now + 0.5
        request._queue_deadline = now + 0.2
        clone = Group._resume_clone(request, [7, 8])
        assert clone.prompt_ids == [1, 2, 3, 7, 8] and clone.max_new_tokens == 6
        assert clone.min_tokens == 1
        assert clone.total_timeout is not None and clone.total_timeout <= 1.1
        assert clone.ttft_timeout is None and clone.queue_timeout is None
        clone0 = Group._resume_clone(request, [])
        assert clone0.ttft_timeout is not None and clone0.ttft_timeout <= 0.6
        assert clone0.queue_timeout is not None and clone0.queue_timeout <= 0.3
        request._deadline = now - 5.0
        assert Group._resume_clone(request, [7]).total_timeout == 0.05


def test_failover_does_not_overshoot_max_new_tokens(tiny_np):
    def scenario(side):
        group = side.group()
        try:
            async def run():
                ids = _conv(31, 40)
                home = group.router.order_for(ids)[0]
                orig = home.engine.generate

                async def flaky(req):
                    async for token in orig(req):
                        yield token
                    raise side.Stuck("tripped after the last token")

                home.engine.generate = flaky
                try:
                    out = [t async for t in group.generate(
                        side.Req(prompt_ids=ids, max_new_tokens=4))]
                finally:
                    home.engine.generate = orig
                await group.wait_drained()
                return out

            return asyncio.run(run()), group.failovers
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert len(port[0]) == 4 and port[1] == 0


def test_penalty_requests_do_not_fail_over(tiny_np):
    def scenario(side):
        group = side.group()
        try:
            async def run():
                ids = _conv(33, 40)
                home = group.router.order_for(ids)[0]
                orig = home.engine.generate

                async def dead(req):
                    raise side.Stuck("tripped")
                    yield  # pragma: no cover - an async generator

                home.engine.generate = dead
                try:
                    with pytest.raises(side.Stuck):
                        async for _ in group.generate(side.Req(
                                prompt_ids=ids, max_new_tokens=4, frequency_penalty=0.5)):
                            pass
                    plain = side.Req(prompt_ids=ids, max_new_tokens=4)
                    out = [t async for t in group.generate(plain)]
                finally:
                    home.engine.generate = orig
                await group.wait_drained()
                return out, plain.prompt_len

            out, prompt_len = asyncio.run(run())
            return out, prompt_len, group.failovers >= 1
        finally:
            group.stop()

    ref, port = _both(tiny_np, scenario)
    assert port == ref
    assert len(port[0]) == 4 and port[1] == 40 and port[2]


def test_unavailable_replica_fails_over_and_stop_raises_unavailable(tiny_np):
    """A replica stopped under a stream (``EngineUnavailableError``) hands
    it to the sibling; a group with every replica stopped refuses with
    ``EngineUnavailableError``."""
    side = Side("port", tiny_np)
    group = side.group()
    try:
        async def run():
            ids = _conv(41, 40)
            base, _ = await _collect(side, group, ids, 8)
            await group.wait_drained()
            home = group.router.order_for(ids)[0]
            request = GenRequest(prompt_ids=ids, max_new_tokens=8)
            out = []
            async for token in group.generate(request):
                out.append(int(token))
                if len(out) == 3:
                    home.engine.stop()
            await group.wait_drained()
            for replica in group.replicas:
                replica.engine.stop()
            with pytest.raises(EngineUnavailableError):
                group.check_admission(GenRequest(prompt_ids=ids))
            return base, out, request._replica_name, home.name

        base, out, final, home = asyncio.run(run())
        assert out == base and final != home and group.failovers == 1
    finally:
        group.stop()


def test_port_group_shares_one_model_and_isolates_pools(tiny_np):
    side = Side("port", tiny_np)
    group = side.group()
    try:
        a, b = (r.engine for r in group.replicas)
        assert a.model is b.model and group.model is a.model
        assert a.paged_cache is not b.paged_cache
        assert a.paged_cache.k.data_ptr() != b.paged_cache.k.data_ptr()
        assert a.replica_id == "r0" and b.replica_id == "r1"
        assert a._cohosted and b._cohosted
        assert a.health()["replica"] == "r0" and b.lifecycle_stats()["replica"] == "r1"
    finally:
        group.stop()


def test_overloaded_fleet_door_is_structured(tiny_np):
    """The fleet brownout door on real engines: every replica at stage 3
    sheds a best-effort request with the structured 429."""
    side = Side("port", tiny_np)
    group = side.group()
    try:
        for replica in group.replicas:
            replica.engine._brownout_snapshot = lambda: {"stage": 3, "score": 1.5}
        with pytest.raises(EngineOverloadedError) as err:
            group.check_admission(GenRequest(prompt_ids=_conv(2), priority="best_effort"))
        assert err.value.shed_class == "best_effort"
    finally:
        group.stop()


# -- the fleet endpoint ------------------------------------------------------------


FLEET_AUX = {"preset": "llama-tiny", "config": {"dtype": "float32"}, "max_batch": 2,
             "max_seq_len": 128, "prefill_buckets": [32, 64], "cache": "paged",
             "prefix_cache": 32, "prefix_block": 16, "pipeline_depth": 1, "seed": 0,
             "replicas": 2}


@pytest.mark.parametrize("knobs,words", [
    ({"replicas": 0}, "engine.replicas must be in 1..16"),
    ({"replicas": 17}, "engine.replicas must be in 1..16"),
    ({"replicas": 2.5}, "engine.replicas must be an integer"),
    ({"replicas": "two"}, "engine.replicas must be an integer"),
    ({"replicas": 1, "replica_roles": "prefill,decode"}, "replica_roles needs engine.replicas"),
    ({"replica_roles": 3}, "replica_roles must be a list"),
    ({"replica_backend": "threads"}, "replica_backend must be inprocess/process"),
    ({"kv_transport_backend": "rdma"}, "kv_transport_backend must be shared/socket"),
    ({"replica_roles": ["prefill", "decoder"]}, "prefill/decode/hybrid"),
])
def test_fleet_knobs_are_refused_at_load_as_the_reference_refuses_them(knobs, words):
    """Each bad fleet knob raises a ``ValueError`` naming it on both
    packages, with the reference's words."""
    from clearml_serving_tpu_torch.llm.openai_api import build_engine

    aux = dict(FLEET_AUX, **knobs)
    with pytest.raises(ValueError, match=words):
        build_engine(aux, device="cpu")
    with pytest.raises(ValueError, match=words):
        _jax_fleet_processor(aux)


@pytest.mark.parametrize("knobs,words", [
    ({"replica_backend": "process", "replicas": 1},
     "replica_backend=process needs engine.replicas >= 2"),
    ({"replica_backend": "process", "replica_roles": ["prefill", "decoder"]},
     "prefill/decode/hybrid"),
], ids=["process_one_replica", "process_bad_role"])
def test_process_backend_and_socket_transport_raise_by_name(knobs, words, monkeypatch):
    """The ``process`` backend is validated at load, refused by name before
    any worker starts or any weight is made; nothing falls back. One
    replica raises the reference's words on both packages; a bad role the
    port refuses before it spawns, where the reference spawns its workers
    first (they exit, and its build fails on that instead). (Served
    fleets: ``test_torch_process_replica.py``; the ``socket`` transport:
    ``test_torch_kv_transport.py``.)"""
    from clearml_serving_tpu_torch.llm import openai_api
    from clearml_serving_tpu_torch.serving import process_replica

    monkeypatch.setattr(openai_api, "init_params", lambda *a, **k: pytest.fail("weights made"))
    monkeypatch.setattr(process_replica, "build_process_fleet",
                        lambda *a, **k: pytest.fail("workers started"))
    with pytest.raises(ValueError, match=words):
        openai_api.build_engine(dict(FLEET_AUX, **knobs), device="cpu")
    if "replica_roles" not in knobs:
        with pytest.raises(ValueError, match=words):
            _jax_fleet_processor(dict(FLEET_AUX, **knobs))


def test_replicas_build_one_llama(monkeypatch):
    from clearml_serving_tpu_torch.llm import openai_api

    built = []
    real = openai_api.Llama

    def counting(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(openai_api, "Llama", counting)
    group, _tok = openai_api.build_engine(dict(FLEET_AUX, replicas=3,
                                               replica_roles="prefill,decode,hybrid"),
                                          device="cpu")
    try:
        assert len(built) == 1
        assert [r.engine.model for r in group.replicas] == [built[0]] * 3
        assert [r.engine.replica_id for r in group.replicas] == ["r0", "r1", "r2"]
        assert group.router.stats()["roles"] == {"r0": "prefill", "r1": "decode",
                                                 "r2": "hybrid"}
        assert group.transport is not None
    finally:
        group.stop()


def _jax_fleet_processor(aux, root=None):
    """The reference's processor with a fleet endpoint ``chat``, its engine
    built (a bad knob raises here)."""
    import tempfile

    from clearml_serving_tpu.llm.openai_api import LLMEngineRequest as JaxRequest
    from clearml_serving_tpu.serving.endpoints import ModelEndpoint as JaxEndpoint
    from clearml_serving_tpu.serving.model_request_processor import (
        ModelRequestProcessor as JaxProcessor,
    )

    mrp = JaxProcessor(state_root=str(root or tempfile.mkdtemp(prefix="ref-fleet-")),
                       force_create=True, name="ref")
    endpoint = JaxEndpoint(engine_type="llm", serving_url="chat",
                           auxiliary_cfg={"engine": aux})
    proc = JaxRequest(endpoint)
    mrp.add_endpoint(endpoint)
    mrp.serialize()
    mrp.deserialize(skip_sync=True)
    mrp._engine_processor_lookup["chat"] = proc
    return mrp


CHAT_PATH = "/serve/openai/v1/chat/completions"


@pytest.mark.parametrize("roles", [None, "prefill,decode"], ids=["affine", "disagg"])
def test_fleet_endpoint_serves_what_the_reference_fleet_serves(roles, tmp_path):
    """A fleet endpoint behind each package's processor and router: the
    same chats (a conversation's two turns, streamed and not) answer the
    same content; ``/ready`` and ``/health`` carry the same fleet blocks."""
    import json

    from aiohttp.test_utils import TestClient, TestServer

    from clearml_serving_tpu.serving.main import build_app as jax_build_app
    from clearml_serving_tpu_torch.llm.openai_api import build_engine
    from clearml_serving_tpu_torch.serving.main import build_app
    from torch_serving import port_processor

    aux = dict(FLEET_AUX, **({"replica_roles": roles} if roles else {}))
    first = [{"role": "user", "content": "describe the sea in a few words please, calmly"}]
    bodies = [{"model": "chat", "messages": first, "max_tokens": 8},
              {"model": "chat", "max_tokens": 8, "stream": True, "messages": first + [
                  {"role": "assistant", "content": "blue"},
                  {"role": "user", "content": "and the sky?"}]}]

    async def calls(client):
        out = []
        for body in bodies:
            r = await client.post(CHAT_PATH, json=body)
            assert r.status == 200, await r.text()
            if body.get("stream"):
                text = ""
                async for raw in r.content:
                    line = raw.decode().strip()
                    if line.startswith("data: {"):
                        choice = json.loads(line[6:])["choices"][0]
                        text += choice["delta"].get("content") or ""
                out.append(text)
            else:
                out.append((await r.json())["choices"][0]["message"]["content"])
        ready = await (await client.get("/ready")).json()
        health = await (await client.get("/health")).json()
        return out, ready["fleet"], health["fleet"]

    def serve(app):
        async def runner():
            client = TestClient(TestServer(app))
            await client.start_server()
            try:
                return await calls(client)
            finally:
                await client.close()
        return asyncio.run(runner())

    ref = _jax_fleet_processor(aux, tmp_path / "ref")
    want = serve(jax_build_app(ref))
    jgroup = ref._engine_processor_lookup["chat"].engine
    params = jax.tree.map(np.asarray, jgroup.replicas[0].engine.params)
    jgroup.stop()
    group, tok = build_engine(aux, device="cpu", params=convert_params(params, device="cpu"))
    got = serve(build_app(port_processor(group, tok, "chat", state_root=tmp_path / "port")))
    assert got[0] == want[0] and all(got[0])
    for blocks in (got[1:], want[1:]):
        for fleet in blocks:
            assert fleet["chat"]["ring"] == ["r0", "r1"] and fleet["chat"]["ready"]
            assert set(fleet["chat"]["per_replica"]) == {"r0", "r1"}
    # the same routing, brownout and per-replica state
    for g, w in zip(got[1:], want[1:]):
        assert {k: v for k, v in g["chat"].items() if k != "per_replica"} == \
            {k: v for k, v in w["chat"].items() if k != "per_replica"}
        assert g["chat"]["per_replica"] == w["chat"]["per_replica"]
