"""The port's Prometheus exporter (clearml_serving_tpu_torch/statistics/
metrics.py and main.py) against the JAX package's, the scenarios of the
reference's ``tests/test_statistics.py`` run on both.

Every scenario feeds both packages the same events and holds the two
registries' exports equal: the controller's broker-driven collectors
(scalar, enum, value and counter specs, reserved variables, unknown
endpoints); the scrape-time collectors over the same provider payloads
(request lifecycle with every block the engines report, the ``replica``
label split, the router's ring, routes and roles, pruning); the prefix
cache's collector over the same cache operations; and, for the same
traffic on real fleets (llama-tiny float32, affine and disaggregated), the
families and label sets each package's engines export. The port's device
gauges read ``torch.cuda`` only in a process that already holds a CUDA
context, and ``LLMEngineRequest`` registers a fleet's providers weakly and
drops them when its engine is released.
"""

import asyncio
import gc
import weakref

import jax
import numpy as np
import pytest
import torch
from prometheus_client import CollectorRegistry, generate_latest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm.engine import GenRequest as JaxGenRequest
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.llm.kv_cache import PagePool as JaxPagePool
from clearml_serving_tpu.llm.prefix_cache import RadixPrefixCache as JaxRadix
from clearml_serving_tpu.llm.replica import ReplicaGroup as JaxGroup
from clearml_serving_tpu.serving.endpoints import EndpointMetricLogging as JaxLogging
from clearml_serving_tpu.serving.endpoints import MetricType as JaxMetricType
from clearml_serving_tpu.serving.model_request_processor import (
    ModelRequestProcessor as JaxProcessor,
)
from clearml_serving_tpu.statistics import metrics as jax_metrics
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_cache import PagePool
from clearml_serving_tpu_torch.llm.prefix_cache import RadixPrefixCache
from clearml_serving_tpu_torch.llm.replica import ReplicaGroup
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.serving.endpoints import EndpointMetricLogging, MetricType
from clearml_serving_tpu_torch.serving.model_request_processor import ModelRequestProcessor
from clearml_serving_tpu_torch.statistics import metrics as port_metrics

TINY = {"preset": "llama-tiny", "dtype": "float32"}
PKGS = {"jax": jax_metrics, "port": port_metrics}


def export(registry):
    """Every sample of a registry: (family, type, sample, labels, value),
    but the ``_created`` timestamps."""
    out = set()
    for fam in registry.collect():
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            out.add((fam.name, fam.type, s.name, tuple(sorted(s.labels.items())), s.value))
    return out


# -- the controller ---------------------------------------------------------------


def _controller(pkg, tmp_path, name, metrics):
    Proc, Logging, Metric = ((JaxProcessor, JaxLogging, JaxMetricType) if pkg == "jax"
                             else (ModelRequestProcessor, EndpointMetricLogging, MetricType))
    mrp = Proc(state_root=str(tmp_path / pkg / "state"), force_create=True, name=name)
    if metrics:
        mrp.add_metric_logging(Logging(endpoint="ep", metrics={
            k: Metric(**v) for k, v in metrics.items()}))
    mrp.serialize()
    registry = CollectorRegistry()
    ctl = PKGS[pkg].StatisticsController("file://{}".format(tmp_path / pkg / "b"), processor=mrp,
                                         registry=registry)
    ctl.sync_specs()
    return ctl, registry


CONTROLLER_CASES = {
    "typed_specs": ({"x0": {"type": "scalar", "buckets": [0, 1, 2, 3]},
                     "label": {"type": "enum", "buckets": ["cat", "dog"]},
                     "conf": {"type": "value"}, "hits": {"type": "counter"}},
                    [{"_url": "ep", "_latency": 0.05, "_count": 10, "x0": 1.5, "label": "cat",
                      "conf": 0.9, "hits": 3},
                     {"_url": "ep", "_latency": 0.2, "_count": 10, "x0": [0.5, 2.5],
                      "label": "dog", "conf": 0.4, "hits": 2}]),
    "enum_semantics": ({"cls": {"type": "enum", "buckets": ["a", "b", "c"]},
                        "free": {"type": "enum", "buckets": ["only"]}},
                       [{"_url": "ep", "cls": "b", "free": "anything"},
                        {"_url": "ep", "cls": ["b", "zzz"], "free": "other"}]),
    "unknown_endpoint": ({}, [{"_url": "mystery", "_latency": 0.1, "_count": 1, "custom": 5},
                              {"_url": "ep", "_latency": 2.0, "_count": 3}]),
}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_exports_equal_the_reference(tmp_path, case):
    metrics, batch = CONTROLLER_CASES[case]
    out = {}
    for pkg in PKGS:
        ctl, registry = _controller(pkg, tmp_path, "s-" + case, metrics)
        assert ctl.process_batch([dict(p) for p in batch]) == len(batch)
        out[pkg] = export(registry)
    assert out["port"] == out["jax"]
    if case == "typed_specs":
        values = {(s, labels): v for _f, _t, s, labels, v in out["port"]}
        assert values[("ep__count_total", ())] == 20.0
        assert values[("ep_label_bucket", (("enum", "dog"),))] == 1.0
        assert values[("ep_hits_total", ())] == 5.0


def test_device_gauges_make_no_cuda_context_on_the_cpu():
    registry = CollectorRegistry()
    ctl = port_metrics.StatisticsController("", registry=registry)
    ctl.update_device_gauges()
    assert not torch.cuda.is_initialized()
    assert registry.get_sample_value("tpu_hbm_bytes_in_use", {"device": "0"}) is None


def test_device_gauges_read_torch_cuda_where_a_context_exists(monkeypatch):
    """With a context (faked here), the gauges keep the reference's names
    and ``device`` label, from ``memory_stats`` and ``mem_get_info``."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda i: {"allocated_bytes.all.current": 1000 + i})
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (5, 80 << 30))
    registry = CollectorRegistry()
    port_metrics.StatisticsController("", registry=registry).update_device_gauges()
    for i in range(2):
        assert registry.get_sample_value("tpu_hbm_bytes_in_use", {"device": str(i)}) == 1000 + i
        assert registry.get_sample_value("tpu_hbm_bytes_limit", {"device": str(i)}) == 80 << 30


# -- scrape-time collectors over the same payloads ---------------------------------


def _hist(counts, total, buckets=(1.0, 2.5, 5.0)):
    return {"buckets": list(buckets), "counts": list(counts), "sum_ms": total,
            "count": sum(counts)}


LIFECYCLE_CASES = {
    "basics": {"m1": {"queue_depth": 3, "active_slots": 2, "ready": 1,
                      "sheds": {"queue": 4, "pool": 1},
                      "deadlines": {"queue": 2, "ttft": 1, "total": 5},
                      "watchdog_trips": 1, "step_failures": 2}},
    "slo": {"m1": {"queue_depth": 3, "queue_depths": {"interactive": 1, "batch": 2,
                                                      "best_effort": 0},
                   "sheds_by_class": {"queue": {"batch": 2}, "brownout": {"best_effort": 1}},
                   "preemptions": 4, "brownout": {"stage": 2, "score": 1.25}}},
    "pipeline": {"m1": {"pipeline": {"depth": 2, "inflight": 1,
                                     "dispatch_ms": _hist([2, 1, 0, 3], 40.0),
                                     "retire_ms": _hist([5, 0, 0, 0], 2.5)}}},
    "ragged": {"m1": {"ragged": {
        "step_token_budget": 16, "effective_budget": 16, "prefill_jobs": 1, "steps": 3,
        "budget_utilization": _hist([1, 1, 1, 0], 1.5, (0.25, 0.5, 1.0)),
        "step_rows": {"prefill": 2, "decode": 5, "spec_verify": 3},
        "tokens_per_launch": _hist([0, 2, 1, 0], 9.0, (1, 2, 4)),
        "spec_acceptance": _hist([1, 0, 2, 0], 1.4, (0.2, 0.6, 1.0)),
        "spec_tree_depth": _hist([1, 0, 2, 1], 7.0, (0, 1, 2)),
        "spec_proposer": {"name": "ngram-forest", "proposed": 9, "hit": 6, "branched": 4}}}},
    "kv_pool_tier_ledger": {"m1": {
        "kv_pool": {"kv": 4096, "scale": 256, "dtype": "int8", "num_pages": 9, "page_size": 4},
        "kv_tier": {"pages": {"hbm": 3, "host": 5}, "bytes": {"hbm": 30, "host": 50},
                    "demotions": 2, "promotions": 1},
        "ledger": {"outstanding": {"pages.ref": 3, "pages.slot": 0}, "leaks": 0}}},
    "kv_ship": {"m1": {"model": "m", "replica": "r1", "ready": 1, "kv_ship": {
        "role": "decode", "ships": 0, "ship_pages": 0, "receives": 4, "receive_pages": 9,
        "hits": 4, "recomputes": 1, "hit_rate": 0.8, "overlap_ratio": 0.0,
        "ship_ms": _hist([0, 0, 0, 0], 0.0), "receive_ms": _hist([2, 1, 1, 0], 12.5)}}},
    "replica_labels": {
        "m@r0": {"model": "m", "replica": "r0", "queue_depth": 2, "active_slots": 1, "ready": 1},
        "m@r1": {"model": "m", "replica": "r1", "queue_depth": 5, "ready": 0,
                 "sheds": {"queue": 3}, "watchdog_trips": 1},
        "legacy": {"queue_depth": 1, "ready": 1}},
}


@pytest.mark.parametrize("case", sorted(LIFECYCLE_CASES))
def test_lifecycle_collector_exports_equal_the_reference(case):
    out = {}
    for pkg, mod in PKGS.items():
        registry = CollectorRegistry()
        for key, stats in LIFECYCLE_CASES[case].items():
            mod.register_engine_lifecycle(lambda stats=stats: stats, registry=registry, key=key)
        out[pkg] = generate_latest(registry)
    assert out["port"] == out["jax"]
    assert out["port"]


ROUTER_CASES = {
    "hybrid": {"replicas": 2, "ring_size": 1, "replica_backend": "inprocess",
               "requests": {"r0": {"affine": 5, "spill": 1, "rebalance": 2},
                            "r1": {"affine": 3, "spill": 0, "rebalance": 0}},
               "ejections": {"r0": 0, "r1": 1}, "readmissions": {"r0": 0, "r1": 1},
               "fleet_sheds": {"best_effort": 4},
               "fleet_brownout": {"stage": 2, "stages": {"r0": 2, "r1": 3}}},
    "roles": {"replicas": 2, "ring_size": 2, "ring": ["r0", "r1"],
              "roles": {"r0": "prefill", "r1": "decode"},
              "requests": {"r0": {"affine": 1, "spill": 0, "rebalance": 0},
                           "r1": {"affine": 7, "spill": 0, "rebalance": 1}},
              "ejections": {"r0": 2, "r1": 0}, "readmissions": {"r0": 2, "r1": 0},
              "fleet_sheds": {"best_effort": 0},
              "fleet_brownout": {"stage": 0, "stages": {"r0": 0, "r1": 0}}},
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_collector_exports_equal_the_reference(case):
    out = {}
    for pkg, mod in PKGS.items():
        registry = CollectorRegistry()
        mod.register_replica_router(lambda: ROUTER_CASES[case], registry=registry, key="m1")
        out[pkg] = generate_latest(registry)
    assert out["port"] == out["jax"]
    assert b'router_requests_total{model="m1",replica="r0"' in out["port"]


def test_prune_entries_equal_the_reference():
    out = {}
    for pkg, mod in PKGS.items():
        registry = CollectorRegistry()
        for key in ("m@r0", "m@r1", "m@r2", "m", "m2@r0", "m2"):
            mod.register_engine_lifecycle(lambda key=key: {"queue_depth": 1},
                                          registry=registry, key=key)
        mod.prune_engine_lifecycle("m", {"m@r0", "m@r1"}, registry=registry)
        first = export(registry)
        mod.register_engine_lifecycle(lambda: {"queue_depth": 3}, registry=registry, key="m")
        mod.prune_engine_lifecycle("m", {"m"}, registry=registry)
        out[pkg] = (first, export(registry))
    assert out["port"] == out["jax"]
    models_left = {dict(labels)["model"] for _f, _t, _s, labels, _v in out["port"][1]}
    assert models_left == {"m", "m2@r0", "m2"}


def test_remove_entry_only_drops_its_own_value():
    registry = CollectorRegistry()
    mine, theirs = (lambda: {"ready": 1}), (lambda: {"ready": 0})
    collector = port_metrics.register_engine_lifecycle(mine, registry=registry, key="m")
    port_metrics.register_engine_lifecycle(theirs, registry=registry, key="m")
    collector.remove_entry("m", only=mine)
    assert registry.get_sample_value("engine_ready", {"model": "m"}) == 0
    collector.remove_entry("m", only=theirs)
    assert registry.get_sample_value("engine_ready", {"model": "m"}) is None


def test_prefix_cache_collector_exports_equal_the_reference():
    """The same cache operations on each package's pool and radix cache:
    the hit, miss, token, node, page and sharing series are equal, with
    and without the fleet's ``model``/``replica`` split."""
    out = {}
    for pkg, (Pool, Radix) in {"jax": (JaxPagePool, JaxRadix),
                               "port": (PagePool, RadixPrefixCache)}.items():
        registry = CollectorRegistry()
        mod = PKGS[pkg]
        pool = Pool(num_pages=16, page_size=2, max_slots=2)
        cache = Radix(block=4, pool=pool, page_bytes=32)
        mod.register_prefix_cache(cache, pool, registry=registry, key="m1")
        pool2 = Pool(num_pages=16, page_size=2, max_slots=2)
        cache2 = Radix(block=4, pool=pool2, page_bytes=32)
        mod.register_prefix_cache(cache2, pool2, registry=registry, key="fleet@r1",
                                  model="fleet", replica="r1")
        ids = [1, 2, 3, 4, 5, 6]
        assert cache.lookup_pages(ids, 0) is None
        pool.allocate(0, 6)
        cache.store_pages(ids, 0, pool.slot_pages(0))
        cache.release(cache.lookup_pages(ids, 0))
        pool2.allocate(1, 6)
        cache2.store_pages(ids, 0, pool2.slot_pages(1))
        out[pkg] = export(registry)
    assert out["port"] == out["jax"]
    values = {(s, labels): v for _f, _t, s, labels, v in out["port"]}
    assert values[("llm_prefix_cache_hits_total",
                   (("model", "m1"), ("tier", "hbm")))] == 1
    # the slot's first two pages, referenced by the cache too
    assert values[("kv_pool_shared_pages", (("model", "fleet"), ("replica", "r1")))] == 2


# -- real fleets: the same traffic, the same families -------------------------------


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


ENGINE_CFG = dict(max_batch=2, max_seq_len=128, prefill_buckets=[32, 64], eos_token_id=None,
                  cache_mode="paged", page_size=16, prefix_cache=64, prefix_block=16,
                  num_pages=65, max_pending=8)


def _fleet(pkg, tiny_np, roles, **kw):
    cfg = dict(ENGINE_CFG, **kw)
    if pkg == "jax":
        bundle = models.build_model("llama", TINY)
        engines = [JaxEngine(bundle, tiny_np, replica="r{}".format(i), **cfg) for i in range(2)]
        return JaxGroup(engines, roles=roles), JaxGenRequest
    model = Llama(TINY, convert_params(tiny_np, device="cpu"))
    engines = [LLMEngineCore(model, replica="r{}".format(i), **cfg) for i in range(2)]
    return ReplicaGroup(engines, roles=roles), GenRequest


def _wire(mod, group, registry, model="fleet"):
    """The reference's ``_register_metrics`` wiring of a fleet, on a
    registry of its own."""
    for replica in group.replicas:
        def provider(engine=replica.engine):
            s = engine.lifecycle_stats()
            s["model"] = model
            return s

        key = "{}@{}".format(model, replica.name)
        mod.register_engine_lifecycle(provider, registry=registry, key=key)
        mod.register_prefix_cache(replica.engine._prefix, replica.engine.paged_cache.pool,
                                  registry=registry, key=key, model=model, replica=replica.name)
    mod.register_replica_router(lambda: dict(group.router.stats(), model=model),
                                registry=registry, key=model)


# samples whose values depend on the host's timing (stage times, the
# brownout controller's rate-based score), or on how each package sizes
# what it holds (the JAX pools)
_TIMED = ("_ms", "_seconds", "brownout_score", "kv_pool_bytes", "kv_pool_free_pages",
          "prefix_cache_bytes", "engine_pipeline_depth", "engine_pipeline_inflight")


@pytest.mark.parametrize("roles", [None, ["prefill", "decode"]], ids=["affine", "disagg"])
@pytest.mark.parametrize("scheduler", ["two_dispatch", "ragged"])
def test_fleet_families_and_labels_equal_the_reference(tiny_np, roles, scheduler):
    """Two turns of a conversation and one other chat through each
    package's fleet: the exported families, their label sets (``model``
    and ``replica`` on every lifecycle and prefix series, ``role`` on the
    router's) and the counts that do not depend on timing are equal."""
    kw = {"scheduler": "ragged", "step_token_budget": 16} if scheduler == "ragged" else {}
    out = {}
    for pkg, mod in PKGS.items():
        group, Req = _fleet(pkg, tiny_np, roles, **kw)
        registry = CollectorRegistry()
        _wire(mod, group, registry)
        conv = [(5 + i * 3) % 90 + 1 for i in range(40)]

        async def run():
            for ids in (conv + [7], conv + [7, 7], [(9 + i * 5) % 80 + 1 for i in range(36)]):
                async for _ in group.generate(Req(prompt_ids=ids, max_new_tokens=3)):
                    pass
            await group.wait_drained()

        try:
            asyncio.run(run())
            out[pkg] = export(registry)
        finally:
            group.stop()
    assert {(f, t, s, labels) for f, t, s, labels, _v in out["port"]} == \
        {(f, t, s, labels) for f, t, s, labels, _v in out["jax"]}

    def counts(samples):
        return {(s, labels): v for _f, _t, s, labels, v in samples
                if not any(m in s for m in _TIMED)}

    assert counts(out["port"]) == counts(out["jax"])
    names = {s for _f, _t, s, _l, _v in out["port"]}
    assert {"engine_ready", "router_ring_size", "llm_prefix_cache_hits_total"} <= names
    if roles:
        assert "engine_kv_ship_pages_total" in names and "router_role_members" in names


def test_request_wiring_registers_weakly_and_drops_on_release(tiny_np):
    """``LLMEngineRequest`` over a fleet registers each replica's lifecycle
    and prefix entries and the router's on the process registry; the
    release of the evicted endpoint drops them, and nothing the registry
    holds keeps the engines alive."""
    from prometheus_client import REGISTRY

    from clearml_serving_tpu_torch.llm.openai_api import LLMEngineRequest
    from clearml_serving_tpu_torch.llm.tokenizer import ByteTokenizer

    group, _ = _fleet("port", tiny_np, None)
    url = "fleet-wiring-test"
    req = LLMEngineRequest.wrap(group, ByteTokenizer(512), url)
    assert REGISTRY.get_sample_value("engine_ready", {"model": url, "replica": "r1"}) == 1
    assert REGISTRY.get_sample_value("router_replicas", {"model": url}) == 2
    assert REGISTRY.get_sample_value("llm_prefix_cache_nodes",
                                     {"model": url, "replica": "r0"}) == 0
    refs = [weakref.ref(r.engine) for r in group.replicas] + [weakref.ref(group)]
    group.stop()
    del group
    req._release()
    assert REGISTRY.get_sample_value("engine_ready", {"model": url, "replica": "r1"}) is None
    assert REGISTRY.get_sample_value("router_replicas", {"model": url}) is None
    gc.collect()
    assert all(ref() is None for ref in refs)
