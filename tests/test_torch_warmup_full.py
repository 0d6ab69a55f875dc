"""Aux ``warmup: full`` in the port (clearml_serving_tpu_torch/llm/warmup.py)
against the reference's full sweep, on the CPU, llama-tiny in float32:

- ``warmup_plan(engine, full=True)`` equals the reference's
  ``warmup_plan(jax_engine, full=True)`` spec for spec: paged with and
  without the prefix cache, with and without speculation, a bucket past
  the last configured one;
- ``run_warmup(full=True)`` on a ragged engine with speculation and a KV
  transport returns the reference's ``requests``, ``cow_buckets`` and
  ``ship_buckets`` (both sides run their sweep), warms every plain ragged
  key, and the streams served afterwards equal an unwarmed engine's;
- ``EngineReplica`` and the process fleet accept ``full`` and warm with
  it (the worker's warmup RPC carries it), a typo still raises."""

import asyncio

import jax
import numpy as np
import pytest

from clearml_serving_tpu import models
from clearml_serving_tpu.llm import warmup as jax_warmup
from clearml_serving_tpu.llm.engine import LLMEngineCore as JaxEngine
from clearml_serving_tpu.llm.kv_transport import SharedSlabTransport as JaxTransport
from clearml_serving_tpu_torch.llm import warmup
from clearml_serving_tpu_torch.llm.engine import GenRequest, LLMEngineCore
from clearml_serving_tpu_torch.llm.kv_transport import SharedSlabTransport
from clearml_serving_tpu_torch.llm.ragged_graph import plain_variants
from clearml_serving_tpu_torch.llm.replica import EngineReplica
from clearml_serving_tpu_torch.models.llama import Llama, convert_params
from clearml_serving_tpu_torch.serving import process_replica

TINY = {"preset": "llama-tiny", "dtype": "float32"}
BASE = dict(max_batch=2, max_seq_len=80, prefill_buckets=[16, 32], eos_token_id=None,
            decode_steps=2, page_size=16)
PREFIX = dict(prefix_cache=16, prefix_block=16)
SPEC = dict(scheduler="ragged", step_token_budget=12, speculation="ngram", spec_k=4)

PLAN_CONFIGS = {
    "paged": {},
    "paged_ragged_spec": SPEC,
    "prefix": PREFIX,
    "prefix_spec": dict(PREFIX, **SPEC),
    "prefix_int8_pages32": dict(PREFIX, page_size=32, prefix_block=32),
    # the last configured bucket (16) far below max_seq_len: the implicit
    # max_seq_len bucket joins every part of the plan
    "bucket_past_the_last": dict(PREFIX, prefill_buckets=[16]),
}


@pytest.fixture(scope="module")
def tiny_np():
    bundle = models.build_model("llama", TINY)
    return jax.tree.map(np.asarray, bundle.init(jax.random.PRNGKey(0)))


def _jax(tiny_np, **kw):
    return JaxEngine(models.build_model("llama", TINY), tiny_np, cache_mode="paged",
                     pipeline_depth=1, **dict(BASE, **kw))


def _port(tiny_np, **kw):
    return LLMEngineCore(Llama(TINY, convert_params(tiny_np, device="cpu")), **dict(BASE, **kw))


@pytest.mark.parametrize("config", list(PLAN_CONFIGS))
def test_full_plan_equals_the_reference(tiny_np, config):
    kw = PLAN_CONFIGS[config]
    ref = _jax(tiny_np, **kw)
    port = _port(tiny_np, **kw)
    want = jax_warmup.warmup_plan(ref, full=True)
    ref.stop()
    assert warmup.warmup_plan(port, full=True) == want
    if kw.get("prefix_cache"):
        # the full plan is more than the startup pass
        assert len(want) > len(warmup.warmup_plan(port))
    port.stop()


def _collect_many(engine, prompts, n=8):
    async def one(ids):
        return [int(t) async for t in engine.generate(
            GenRequest(prompt_ids=list(ids), max_new_tokens=n))]

    async def go():
        outs = await asyncio.gather(*(one(p) for p in prompts))
        await engine.wait_drained()
        return outs

    return asyncio.run(go())


PROMPTS = [[5, 9, 2, 17, 5, 9, 2], [(i * 7 + 3) % 250 + 1 for i in range(40)]]


@pytest.mark.parametrize("tree", [False, True], ids=["chain", "tree"])
def test_run_warmup_full_returns_the_reference_counts(tiny_np, tree):
    kw = dict(PREFIX, **SPEC, spec_tree=tree, num_pages=48)
    ref = _jax(tiny_np, **kw)
    ref.attach_kv_transport(JaxTransport(capacity_pages=16).register("r0"), role="hybrid")
    want = asyncio.run(jax_warmup.run_warmup(ref, full=True, fence=False))
    ref.stop()
    port = _port(tiny_np, **kw)
    port.attach_kv_transport(SharedSlabTransport(capacity_pages=16).register("r0"),
                             role="hybrid")
    got = asyncio.run(port.warmup(full=True))
    assert {k: got[k] for k in ("requests", "cow_buckets", "ship_buckets")} == {
        k: want[k] for k in ("requests", "cow_buckets", "ship_buckets")}
    assert got["ship_buckets"] > 0 and got["cow_buckets"] > 0
    # no graphs on the CPU: the sweep captured nothing
    assert got["graph_captures"] == 0
    assert not port._warming and port.counters["serve_captures"] == 0
    pool = port.paged_cache.pool
    assert pool.free_pages + port._prefix.cached_pages == pool.num_pages - 1
    # streams after the sweep equal an unwarmed engine's
    warmed = _collect_many(port, PROMPTS)
    port.stop()
    cold_engine = _port(tiny_np, **kw)
    cold = _collect_many(cold_engine, PROMPTS)
    cold_engine.stop()
    assert warmed == cold


class _RecordingGraphs:
    """Stands for ``RaggedGraphs`` on the CPU: records the keys the engine
    asks it to capture, and the capture mode."""

    def __init__(self):
        self.keys, self.modes = [], []

    def captured(self, variant):
        return variant in self.keys

    def capture(self, variant, capture_error_mode):
        self.keys.append(variant)
        self.modes.append(capture_error_mode)


@pytest.mark.parametrize("verify", ["", "chain", "tree"])
def test_full_sweep_captures_every_plain_ragged_key_once(tiny_np, verify):
    kw = (dict(SPEC, spec_tree=verify == "tree") if verify
          else dict(scheduler="ragged", step_token_budget=12))
    port = _port(tiny_np, **kw)
    graphs = _RecordingGraphs()
    port._ragged_graphs = graphs
    port._warming = True
    try:
        port._capture_graphs(ragged=True)
        # a second sweep finds every key captured
        port._capture_graphs(ragged=True)
        # the startup sweep captures no ragged key
        port._capture_graphs()
    finally:
        port._warming = False
        port._ragged_graphs = None
    plain = plain_variants(port._ragged_steps_cap, verify)
    # windows 1 and 2 (decode_steps 2) x the verify kinds x greedy or not
    assert len(plain) == (12 if verify else 4)
    assert graphs.keys == plain and set(graphs.modes) == {"global"}
    assert port.counters["graph_captures"] == len(plain)
    assert port.counters["serve_captures"] == 0
    assert set(port.health()["graph_variants"]) == {v.label() for v in plain}
    port.stop()


async def _gate(replica):
    """One sweep of the replica's warmup gate, as the router's ring sweep
    starts it."""
    replica.begin_warm()
    await replica._warm_task


def test_engine_replica_accepts_full_and_warms_with_it(tiny_np, monkeypatch):
    calls = []

    async def fake(engine, full=False):
        calls.append(full)
        return {"requests": 1, "graph_captures": 0, "cow_buckets": 2, "ship_buckets": 0}

    monkeypatch.setattr(warmup, "run_warmup", fake)
    engine = _port(tiny_np)
    replica = EngineReplica(0, engine, warmup_mode="full")
    assert not replica.warmed
    asyncio.run(_gate(replica))
    assert calls == [True] and replica.warmed
    assert replica.warm_result["cow_buckets"] == 2
    replica.invalidate_warm()
    assert not replica.warmed
    asyncio.run(_gate(replica))
    assert calls == [True, True] and replica.warmed
    startup = EngineReplica(1, _port(tiny_np), warmup_mode="startup")
    asyncio.run(_gate(startup))
    assert calls == [True, True, False] and startup.warmed
    with pytest.raises(ValueError, match="replica warmup mode must be off/startup/full"):
        EngineReplica(2, engine, warmup_mode="sometimes")


def test_process_fleet_mode_check_accepts_full_and_the_rpc_carries_it(monkeypatch):
    # the mode check without a worker: the spawn is the constructor's last step
    monkeypatch.setattr(process_replica.ProcessEngineReplica, "_spawn", lambda self: None)
    monkeypatch.setattr(process_replica.ProcessEngineReplica, "engine_ready",
                        property(lambda self: True))
    control = process_replica.ProcessFleetControl.__new__(process_replica.ProcessFleetControl)
    replica = process_replica.ProcessEngineReplica(0, {"name": "r0"}, control,
                                                   warmup_mode="full")
    assert replica._warmup_mode == "full" and not replica.warmed
    with pytest.raises(ValueError, match="replica warmup mode must be off/startup/full"):
        process_replica.ProcessEngineReplica(0, {"name": "r0"}, control, warmup_mode="ful")
    rpcs = []

    async def warmup_rpc(full=False):
        rpcs.append(full)
        return {"requests": 3, "graph_captures": 2}

    replica.engine.warmup_rpc = warmup_rpc
    asyncio.run(_gate(replica))
    assert rpcs == [True] and replica.warmed
    # the worker's side: the frame's flag reaches engine.warmup
    seen, frames = [], []

    class Engine:
        async def warmup(self, full=False):
            seen.append(full)
            return {"requests": 0}

    async def send(writer, wlock, frame):
        frames.append(frame)

    orig = process_replica._send_frame_stream
    process_replica._send_frame_stream = send
    try:
        for flag in (True, False):
            asyncio.run(process_replica._warmup_task(Engine(), None, None, 7, flag))
    finally:
        process_replica._send_frame_stream = orig
    assert seen == [True, False] and [f["id"] for f in frames] == [7, 7]
