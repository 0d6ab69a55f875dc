"""Replica engine group: N ``LLMEngineCore`` replicas behind one
prefix-affine router.

The port's copy of ``clearml_serving_tpu/llm/replica.py``.
``ReplicaGroup`` presents the single-engine surface the OpenAI front and
the router consume
(``validate`` / ``check_admission`` / ``generate`` / ``score_prompt`` /
``warmup`` / ``health`` / ``lifecycle_stats`` / ``stop``), so a fleet drops
in wherever one engine stood. Routing is ``serving/replica_router.py``'s:
every request's block-aligned prompt prefix picks the replica whose KV
pages already hold its conversation, with health-aware rebalance and
load-aware spill.

Failure drain: when a replica fails a stream with a REPLICA-level error
(watchdog trip -> ``EngineStuckError``, stop/eject ->
``EngineUnavailableError``), the group resumes the request on a sibling,
the tokens generated so far riding as part of the resume prompt (the
preemptible lane's history-as-prompt), so the consumer only sees latency.
On the CPU's float32 a greedy stream continues byte-identically; in bf16 on
the card the re-prefilled history may change later greedy tokens (the
continuation is then a fresh request's on that history). Only
plain-sampling requests resume: guided or penalty-bearing ones would
resume WRONG (the resume resets the penalty histogram and the DFA state)
and propagate their error instead, as do request-attributable errors
(deadlines, sheds, per-request step failures).

In-process replicas share one ``Llama`` (read-only for compute) and each
has its own KV pool, stream and CUDA graphs (``llm/openai_api.py`` builds
them). With replica roles, a prefill replica ships each stream's prefix
pages to its decode replica before the stream runs there
(``_disagg_preamble``), through ``llm/kv_transport.py``'s shared slabs or
``llm/kv_wire.py``'s sockets (``kv_transport_backend``). The process
backend (``serving/process_replica.py``) assembles the same group from
supervised worker processes through ``_finish_init``.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, List, Optional

from ..errors import EngineStuckError, EngineUnavailableError
from ..serving.replica_router import ReplicaRouter

logger = logging.getLogger(__name__)


class EngineReplica:
    """One ring member: an engine plus its warmup gate and identity.

    The warmup gate (``llm/warmup.py``) gates RING ENTRY: a cold replica
    never takes serve traffic, and an ejected replica re-warms before
    re-admission (a fast pass when its graphs survived: nothing is
    captured again).
    """

    def __init__(self, index: int, engine, *, warmup_mode: str = "off"):
        if warmup_mode not in ("off", "startup", "full"):
            raise ValueError(
                "replica warmup mode must be off/startup/full: got {!r}".format(warmup_mode)
            )
        self.index = int(index)
        self.name = "r{}".format(index)
        self.engine = engine
        # one replica identity across every surface (metrics labels, ring
        # names, registry keys, /ready blocks): default-fill the engine's
        # id with the ring name when the caller left it unset
        if getattr(engine, "replica_id", None) is None:
            engine.replica_id = self.name
        self._warmup_mode = warmup_mode
        # gate open from birth when warmup is off — the legacy lazy-compile
        # behavior, byte-identical to a single engine without warmup
        self.warmed = warmup_mode == "off"
        # last warmup sweep's run_warmup result (group.warmup aggregates)
        self.warm_result = {"requests": 0, "graph_captures": 0}
        # the seconds each sweep of the gate took (the first at startup,
        # then one per re-admission)
        self.warm_seconds: List[float] = []
        self._warm_task: Optional[asyncio.Task] = None

    # -- state the router consumes ------------------------------------------

    @property
    def engine_ready(self) -> bool:
        return bool(self.engine.is_ready)

    @property
    def serving_ready(self) -> bool:
        return self.engine_ready and self.warmed

    @property
    def warming(self) -> bool:
        return self._warm_task is not None and not self._warm_task.done()

    @property
    def queue_depth(self) -> int:
        return int(self.engine._pending.qsize())

    @property
    def brownout_stage(self) -> int:
        snap = self.engine._brownout_snapshot()
        return int((snap or {}).get("stage", 0))

    # -- warmup gate --------------------------------------------------------

    def invalidate_warm(self) -> None:
        """Close the gate on ejection so re-admission re-warms (no-op when
        warmup is disabled — then the gate never closes)."""
        if self._warmup_mode != "off":
            self.warmed = False

    def begin_warm(self) -> None:
        """Schedule the shared warmup task (event loop only). The gate
        reopens when it finishes; a FAILED warmup logs and reopens the
        gate anyway — serving then compiles lazily, the same best-effort
        contract as the endpoint-level warmup knob."""
        if self.warmed or self.warming or not self.engine_ready:
            return
        if self._warmup_mode == "off":
            self.warmed = True
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no running loop (construction-time sweep): defer — the next
            # sweep from a loop context schedules the task; scheduling on
            # a never-running loop would leave the gate closed forever
            return
        self._warm_task = loop.create_task(self.ensure_warm(self._warmup_mode == "full"))

    async def ensure_warm(self, full: bool) -> None:
        """One sweep of the gate (``full``: the reference's full sweep)."""
        from . import warmup

        t0 = time.perf_counter()
        try:
            self.warm_result = await warmup.run_warmup(self.engine, full=full)
        except Exception as ex:  # best-effort: a variant not captured is captured at first use
            logger.warning(
                "replica %s warmup failed (will capture at first use): %s",
                self.name, ex,
            )
        self.warm_seconds.append(time.perf_counter() - t0)
        self.warmed = True

    # -- observability ------------------------------------------------------

    def health(self) -> dict:
        out = self.engine.health()
        out["replica"] = self.name
        out["ring_state"] = (
            "ready" if self.serving_ready
            else ("warming" if self.warming else "ejected")
        )
        return out


class ReplicaGroup:
    """Engine-group facade: routes the single-engine API over N replicas."""

    def __init__(
        self,
        engines: List[Any],
        *,
        warmup_mode: str = "off",
        affinity_blocks: int = 4,
        spill_queue_depth: Optional[int] = None,
        spill_brownout_stage: int = 2,
        fleet_shed_stage: int = 3,
        # disaggregated prefill/decode: one role per engine ("prefill" | "decode" | "hybrid"); None/all-hybrid =
        # the legacy every-replica-does-both fleet. Any non-hybrid role
        # builds the in-process KV transport and wires every engine into
        # it (aux engine.replica_roles).
        roles: Optional[List[str]] = None,
        # per-replica receive-slab capacity in pages (aux
        # engine.kv_transport_pages); default: four full-prefix shipments
        kv_transport_pages: Optional[int] = None,
        # KV transport backend (aux engine.kv_transport_backend): "shared"
        # = in-heap slab mailboxes, "socket" = the wire-framed socket
        # backend (llm/kv_wire.py): the same mailbox semantics, with the
        # shipments crossing a real byte boundary
        kv_transport_backend: str = "shared",
    ):
        if not engines:
            raise ValueError("a replica group needs at least one engine")
        if kv_transport_backend not in ("shared", "socket"):
            raise ValueError(
                "engine.kv_transport_backend must be shared/socket: got "
                "{!r}".format(kv_transport_backend)
            )
        self.replicas = [
            EngineReplica(i, engine, warmup_mode=warmup_mode)
            for i, engine in enumerate(engines)
        ]
        prefix = engines[0]._prefix
        block = prefix.block if prefix is not None else 64
        # -- replica roles + KV transport --------------------------------------
        role_map = None
        self._disaggregated = False
        self.transport = None
        if roles is not None:
            roles = [str(r) for r in roles]
            if len(roles) != len(engines):
                raise ValueError(
                    "engine.replica_roles lists {} roles for {} replicas"
                    .format(len(roles), len(engines))
                )
            for role in roles:
                if role not in ("prefill", "decode", "hybrid"):
                    raise ValueError(
                        "engine.replica_roles entries must be prefill/"
                        "decode/hybrid: got {!r}".format(role)
                    )
            self._disaggregated = any(r != "hybrid" for r in roles)
            if self._disaggregated:
                if not any(r in ("decode", "hybrid") for r in roles):
                    raise ValueError(
                        "engine.replica_roles needs at least one decode-"
                        "capable (decode/hybrid) replica to serve streams"
                    )
                if not any(r in ("prefill", "hybrid") for r in roles):
                    raise ValueError(
                        "engine.replica_roles needs at least one prefill-"
                        "capable (prefill/hybrid) replica"
                    )
                if prefix is None or engines[0].paged_cache is None:
                    raise ValueError(
                        "disaggregated replica roles need cache='paged' "
                        "and a prefix_cache (the shipped payload is the "
                        "radix-storable prefix)"
                    )
                if kv_transport_pages is None:
                    per_seq = engines[0].paged_cache.pool.pages_needed(
                        engines[0].max_seq_len
                    )
                    kv_transport_pages = max(64, 4 * per_seq)
                if kv_transport_backend == "socket":
                    from .kv_wire import SocketSlabFabric

                    self.transport = SocketSlabFabric(
                        capacity_pages=int(kv_transport_pages)
                    )
                else:
                    from .kv_transport import SharedSlabTransport

                    self.transport = SharedSlabTransport(
                        capacity_pages=int(kv_transport_pages)
                    )
            role_map = {
                replica.name: role
                for replica, role in zip(self.replicas, roles)
            }
            for replica, role in zip(self.replicas, roles):
                replica.engine.attach_kv_transport(
                    self.transport.register(replica.name)
                    if self.transport is not None else None,
                    role=role,
                )
        self._finish_init(
            self.replicas,
            block=block,
            role_map=role_map,
            disaggregated=self._disaggregated,
            transport=self.transport,
            spill_queue_depth=spill_queue_depth,
            spill_brownout_stage=spill_brownout_stage,
            fleet_shed_stage=fleet_shed_stage,
            affinity_blocks=affinity_blocks,
            replica_backend="inprocess",
            max_pending_hint=engines[0].max_pending,
            runtime=None,
        )
        # co-hosted engines: every capture runs in the thread-local mode
        # (a sibling may serve while one re-warms)
        if len(engines) > 1:
            for engine in engines:
                engine._cohosted = True

    def _finish_init(self, replicas, *, block, role_map, disaggregated,
                     transport, spill_queue_depth, spill_brownout_stage,
                     fleet_shed_stage, affinity_blocks, replica_backend,
                     max_pending_hint, runtime):
        """The construction's shared tail: router and counters. Called by
        ``__init__`` (in-process engines) and by ``build_process_fleet``
        (``serving/process_replica.py``), which assembles its ring from
        worker processes and has no engine objects in hand: each proxy
        replica arrives built."""
        self.replicas = replicas
        self._disaggregated = bool(disaggregated)
        self.transport = transport
        # which replica backend runs this fleet ("inprocess" | "process");
        # exported on the router's stats for the info-gauge metric
        self.replica_backend = str(replica_backend)
        self._process_runtime = runtime
        # spill bound defaults to half the admission bound: deep enough
        # that transient bursts stay affine, shallow enough to redirect
        # before the affine member starts shedding. An EXPLICIT 0 disables
        # queue-depth spill (maps to the router's None spelling).
        if spill_queue_depth is None and max_pending_hint:
            spill_queue_depth = max(2, int(max_pending_hint) // 2)
        elif spill_queue_depth is not None and int(spill_queue_depth) <= 0:
            spill_queue_depth = None
        self.router = ReplicaRouter(
            replicas,
            block=block,
            affinity_blocks=affinity_blocks,
            spill_queue_depth=spill_queue_depth,
            spill_brownout_stage=spill_brownout_stage,
            fleet_shed_stage=fleet_shed_stage,
            roles=role_map,
            replica_backend=self.replica_backend,
        )
        self.failovers = 0
        # disaggregation counters (mirrored in health()/lifecycle_stats())
        self.ship_legs = 0          # prefill legs run
        self.ship_leg_failures = 0  # leg failed -> decode-side recompute
        self.ship_warm_skips = 0    # decode already held the prefix
        self.receive_reroutes = 0   # receive failed -> hybrid re-route

    # -- single-engine surface (config/readonly) ----------------------------

    def _first_engine(self):
        return self.replicas[0].engine

    @property
    def model(self):
        # the replicas share one Llama
        return self._first_engine().model

    @property
    def max_seq_len(self) -> int:
        return self._first_engine().max_seq_len

    @property
    def max_batch(self) -> int:
        return self._first_engine().max_batch

    @property
    def logprobs_k(self) -> int:
        return self._first_engine().logprobs_k

    @property
    def _prefix(self):
        # replica 0's cache stands in for "the" prefix cache on config
        # probes; metrics register EVERY replica's cache separately
        return self._first_engine()._prefix

    @property
    def paged_cache(self):
        return self._first_engine().paged_cache

    @property
    def is_ready(self) -> bool:
        """Fleet readiness: at least one ring member serves."""
        self.router.sweep()
        return self.router.ring_size >= 1

    # -- request path -------------------------------------------------------

    def validate(self, request) -> None:
        # replicas are identically configured: validation is config-only,
        # and a ring member answers it (a process replica's worker may be
        # down while its sibling serves)
        replica = self._replica_by_name(next(iter(self.router.ring()), None))
        engine = replica.engine if replica is not None else self._first_engine()
        engine.validate(request)

    def check_admission(self, request, reserve: int = 0) -> None:
        """Route and pre-admit: the chosen replica is pinned on the request
        so the later ``generate`` lands on the engine whose admission
        state this check consulted (streaming callers run this before
        response headers, exactly like the single-engine contract)."""
        replica, route = self.router.pick(request)
        request._replica_name = replica.name
        replica.engine.check_admission(request, reserve=reserve)

    def _replica_by_name(self, name: Optional[str]):
        for replica in self.replicas:
            if replica.name == name:
                return replica
        return None

    @staticmethod
    def _resume_clone(request, emitted: List[int]):
        """A fresh request continuing ``request`` after ``emitted`` tokens:
        history rides as prompt (the radix cache replays its KV on the
        sibling when warm; recompute when not). Greedy continuations are
        byte-identical; seeded sampling replays its stream from the resume
        point (documented failover approximation).

        Deadline budgets carry REMAINING time, not fresh values: the
        original request's resolved monotonic deadlines bound the clone —
        a 10s-budget request 9s in when its replica trips gets ~1s on the
        sibling, not a fresh 10s (the 408 contract survives failover).
        The TTFT budget only still applies when no token was emitted; the
        queue budget likewise covered the ORIGINAL admission wait, so a
        mid-stream resume is bounded by the total budget alone."""
        from .engine import GenRequest

        done = len(emitted)
        now = time.monotonic()

        def _remaining(deadline):
            # floor, not fail-fast: an exactly-elapsed budget still gets
            # one admission attempt and fails there with a structured 408
            return None if deadline is None else max(0.05, deadline - now)

        return GenRequest(
            prompt_ids=list(request.prompt_ids) + list(emitted),
            max_new_tokens=max(1, request.max_new_tokens - done),
            temperature=request.temperature,
            top_k=request.top_k,
            top_p=request.top_p,
            stop_token_ids=list(request.stop_token_ids or []) or None,
            presence_penalty=request.presence_penalty,
            frequency_penalty=request.frequency_penalty,
            repetition_penalty=request.repetition_penalty,
            seed=request.seed,
            logit_bias=dict(request.logit_bias) if request.logit_bias else None,
            logprobs=request.logprobs,
            min_tokens=max(0, request.min_tokens - done),
            priority=request.priority,
            queue_timeout=(
                _remaining(request._queue_deadline) if done == 0 else None
            ),
            ttft_timeout=(
                _remaining(request._ttft_deadline) if done == 0 else None
            ),
            total_timeout=_remaining(request._deadline),
        )

    @staticmethod
    def _resumable(request) -> bool:
        """Failover eligibility, matching the engine's own preemption-lane
        rule (engine._preempt_slot): history-as-prompt resume resets the
        device penalty histogram and guided DFA state, so requests using
        either must propagate their error instead of resuming WRONG.
        (Seeded sampling resumes with a replayed RNG stream — an explicit,
        documented approximation; greedy resumes byte-identically.)"""
        return (
            request.guided is None
            and request.presence_penalty == 0.0
            and request.frequency_penalty == 0.0
            and request.repetition_penalty == 1.0
        )

    async def _disagg_preamble(self, request, decode_replica):
        """Disaggregated prefill/decode, the ship lifecycle's group half:

        1. Skip when the decode replica already holds the whole storable
           prefix (repeat conversation turn — its radix cache is warm).
        2. Run the PREFILL LEG: a plain one-token clone of the request on
           a prefill-capable replica with ``_ship_to`` set — at its
           commit, that engine exports the prefix pages into a transport
           shipment addressed to the decode replica. KV does not depend
           on sampling, so the clone strips guided/penalty state; its
           single discarded token is the cost of role specialization.
        3. RECEIVE on the decode replica, on the loop thread its commits
           allocate pages on: pop the shipment, allocate fresh pages,
           enqueue their upload on its stream, attach them to its prefix
           cache. The stream's admission then hits the shipped prefix and
           prefills only the unshipped tail.

        Every failure degrades, never fails the request: a failed leg or
        empty shipment means decode-side recompute, a failed RECEIVE
        re-routes the stream to a hybrid-capable sibling (counted).
        Returns the (possibly re-routed) replica the stream must run on."""
        engine = decode_replica.engine
        prefix = getattr(engine, "_prefix", None)
        if prefix is None or engine.paged_cache is None:
            return decode_replica
        ids = request.prompt_ids
        storable = prefix.longest_prefix_len(len(ids))
        if storable < prefix.block:
            return decode_replica  # nothing shippable: too short
        lora = 0
        if prefix.match_len(ids, lora) >= storable:
            self.ship_warm_skips += 1
            return decode_replica
        pre = self.router.pick_prefill(request, exclude=decode_replica.name)
        if pre is None:
            # prefill class empty/browned out: hybrid degradation — the
            # decode replica prefills for itself
            return decode_replica
        from .engine import GenRequest

        # the leg is bounded by the ORIGINAL request's total budget (the
        # _resume_clone convention): a wedged prefill replica must not
        # stall the stream past its deadline. The deadline is usually
        # UNRESOLVED here (the engine resolves it at its own generate),
        # so fall back to the raw body budget when no monotonic deadline
        # exists yet.
        if request._deadline is not None:
            leg_budget = max(0.05, request._deadline - time.monotonic())
        else:
            leg_budget = request.total_timeout
        ship_req = GenRequest(
            prompt_ids=list(ids),
            max_new_tokens=1,
            priority=request.priority,
            total_timeout=leg_budget,
        )
        ship_req._ship_to = decode_replica.name
        self.ship_legs += 1
        try:
            async for _ in pre.engine.generate(ship_req):
                pass  # the leg's one token is discarded by design
        except asyncio.CancelledError:
            ship_req.cancel()
            raise
        except Exception as ex:  # noqa: BLE001 - the leg is best-effort
            self.ship_leg_failures += 1
            logger.warning(
                "prefill replica %s failed a ship leg (%s); decode-side "
                "recompute on %s", pre.name, type(ex).__name__,
                decode_replica.name,
            )
            return decode_replica
        request._shipped = True
        # on the loop thread, where the decode replica's commits allocate
        # pages: the import's allocation never races them
        res = engine.receive_shipment(ids, lora)
        if res.get("status") != "failed":
            return decode_replica
        # receive failure (injected engine.kv.receive fault, pool
        # pressure, geometry mismatch): re-route the stream to a HYBRID
        # sibling — a replica that can do both jobs takes it cold
        self.receive_reroutes += 1
        self.router.sweep()
        for r in self.router.order_for(ids):
            if (
                r.name in self.router._ring_members
                and r.name != decode_replica.name
                and self.router.role_of(r.name) == "hybrid"
            ):
                logger.warning(
                    "decode replica %s failed a shipment receive; "
                    "re-routing the stream to hybrid %s",
                    decode_replica.name, r.name,
                )
                return r
        return decode_replica  # no hybrid available: recompute in place

    async def generate(self, request) -> AsyncIterator[int]:
        """Routed generation with failure drain: replica-level failures
        (stuck/unavailable) resume the stream on the next-choice sibling;
        request-attributable errors propagate unchanged."""
        replica = self._replica_by_name(getattr(request, "_replica_name", None))
        if replica is None or replica.name not in self.router._ring_members:
            replica, _ = self.router.pick(request)
            request._replica_name = replica.name
        # set before the engine does: a pre-admission failover must not
        # leave the caller's usage accounting reading prompt_len == 0
        request.prompt_len = len(request.prompt_ids)
        if self._disaggregated:
            # disaggregated prefill/decode: run the prefill leg + shipment receive first; may re-route the
            # stream to a hybrid sibling on a receive failure
            replica = await self._disagg_preamble(request, replica)
            request._replica_name = replica.name
        emitted: List[int] = []
        base_lp = 0  # caller-side logprob entries at the last failover
        active = request
        tried = set()
        try:
            while True:
                tried.add(replica.name)
                failed: Optional[BaseException] = None
                try:
                    async for token in replica.engine.generate(active):
                        emitted.append(int(token))
                        if active is not request:
                            # mirror progress onto the caller's request:
                            # usage/TTFT/logprobs read from it post-stream
                            request.produced = len(emitted)
                            if request.first_token_at is None:
                                request.first_token_at = active.first_token_at
                            if request.logprobs is not None:
                                request.logprob_entries.extend(
                                    active.logprob_entries[
                                        len(request.logprob_entries) - base_lp:
                                    ]
                                )
                        yield token
                except (EngineStuckError, EngineUnavailableError) as ex:
                    failed = ex
                if failed is None:
                    return
                if len(emitted) >= request.max_new_tokens:
                    # the stream already delivered everything the caller
                    # asked for (the replica failed between the last token
                    # and the finish marker): finish normally — a resume
                    # would overshoot max_new_tokens by at least one
                    return
                if not self._resumable(request):
                    raise failed
                self.router.sweep()
                candidates = [
                    r for r in self.router.order_for(request.prompt_ids)
                    if r.name in self.router._ring_members
                    and r.name not in tried
                ]
                # role-split fleets: resume on a decode-capable sibling
                # when one exists; a lone prefill replica still beats a 503
                candidates.sort(
                    key=lambda r: self.router.role_of(r.name) == "prefill"
                )
                if not candidates:
                    raise failed
                failed_name = replica.name
                replica = candidates[0]
                self.failovers += 1
                logger.warning(
                    "replica %s failed a stream (%s); resuming %d-token "
                    "history on %s", failed_name, type(failed).__name__,
                    len(emitted), replica.name,
                )
                active = self._resume_clone(request, emitted)
                base_lp = len(request.logprob_entries)
                request._replica_name = replica.name
        finally:
            # consumer stopped early (GeneratorExit lands here): flag the
            # LIVE request so its engine frees the slot/pages promptly —
            # closing the wrapper does not synchronously close a resumed
            # clone's inner generator. Redundant after a normal finish.
            active.cancelled = True

    def score_prompt(self, prompt_ids):
        # stateless readonly compute: any ring member serves it
        replica = self._replica_by_name(next(iter(self.router.ring()), None))
        engine = replica.engine if replica is not None else self._first_engine()
        return engine.score_prompt(prompt_ids)

    # -- lifecycle ----------------------------------------------------------

    async def warmup(self, full: bool = False) -> dict:
        """Warm every replica not warmed yet through its gate (``full``:
        the endpoint's mode, the one its replicas were built with, and so
        the sweep their own gates run). Every sweep runs AS the
        replica's own gate task (``_warm_task``): a concurrent ring sweep
        (a /ready probe mid-warmup) sees ``warming`` and never schedules a
        second run_warmup on the same engine; a gate task already in flight
        is awaited instead. In-process replicas warm one after another (their
        captures share the process); a process fleet's workers at once."""
        results, started = [], []
        for replica in self.replicas:
            if replica.warming:
                try:
                    await asyncio.shield(replica._warm_task)
                except Exception:  # the gate task logs its own failure
                    pass
            if replica.warmed:
                continue
            replica._warm_task = asyncio.get_running_loop().create_task(
                replica.ensure_warm(full=full)
            )
            started.append(replica)
            if self.replica_backend == "process":
                continue  # worker processes warm at once, each on its own
            try:
                await asyncio.shield(replica._warm_task)
            except Exception:  # ensure_warm logs its own failure
                pass
        for replica in started:
            try:
                await asyncio.shield(replica._warm_task)
            except Exception:  # ensure_warm logs its own failure
                pass
            results.append(replica.warm_result)
        self.router.sweep()
        return {
            "replicas": len(self.replicas),
            "requests": sum(r.get("requests", 0) for r in results),
            "cow_buckets": sum(r.get("cow_buckets", 0) for r in results),
            "ship_buckets": sum(r.get("ship_buckets", 0) for r in results),
            "graph_captures": sum(r.get("graph_captures", 0) for r in results),
        }

    def stop(self) -> None:
        for replica in self.replicas:
            replica.engine.stop()
        self._close_resources()
        self.router.sweep()

    def _close_resources(self) -> None:
        """The OS resources a fleet holds beyond its engines: the socket
        fabric's listeners, unix paths and directory, and the process
        backend's runtime (it joins the supervisors, reaps every worker and
        drops the control listener and the spec directory)."""
        if self.transport is not None and hasattr(self.transport, "close"):
            self.transport.close()
        runtime = getattr(self, "_process_runtime", None)
        if runtime is not None:
            runtime.close()

    async def stop_when_idle(self) -> None:
        """Each replica's ``stop_when_idle`` (the eviction's retire), then
        the fleet's OS resources close (a process fleet's workers are
        reaped), then the ring sweep that ejects them all."""
        for replica in self.replicas:
            await replica.engine.stop_when_idle()
        for replica in self.replicas:
            if replica._warm_task is not None and not replica._warm_task.done():
                await asyncio.wait([replica._warm_task])
        await asyncio.to_thread(self._close_resources)
        self.router.sweep()

    @property
    def _loop_task(self):
        # the eviction's handle on the serving loop: any replica's task
        return next((r.engine._loop_task for r in self.replicas
                     if r.engine._loop_task is not None), None)

    @property
    def _watchdog_task(self):
        return next((r.engine._watchdog_task for r in self.replicas
                     if r.engine._watchdog_task is not None), None)

    async def wait_drained(self, timeout: float = 30.0) -> None:
        for replica in self.replicas:
            await replica.engine.wait_drained(timeout=timeout)

    # -- observability ------------------------------------------------------

    def health(self) -> dict:
        """Fleet-aggregated health: ready iff the ring has >= 1 member;
        per-replica blocks + the router's ring/route state ride along so
        /ready can show WHICH replica is out and why."""
        self.router.sweep()
        stats = self.router.stats()
        return {
            "ready": stats["ring_size"] >= 1,
            "ring_size": stats["ring_size"],
            "replicas": {r.name: r.health() for r in self.replicas},
            "router": stats,
            "brownout": {"stage": stats["fleet_brownout"]["stage"]},
            "queue_depth": sum(r.queue_depth for r in self.replicas),
            "active_slots": sum(r.engine.active_slots for r in self.replicas),
            "failovers": self.failovers,
            "disaggregation": self._disagg_snapshot(),
        }

    def _disagg_snapshot(self) -> Optional[dict]:
        """Group-level ship-lifecycle counters; None on a hybrid-only
        fleet. Engine-level movement/hit counters
        live in each replica's ``kv_ship`` lifecycle block."""
        if not self._disaggregated:
            return None
        return {
            "roles": dict(self.router._roles),
            "ship_legs": self.ship_legs,
            "ship_leg_failures": self.ship_leg_failures,
            "ship_warm_skips": self.ship_warm_skips,
            "receive_reroutes": self.receive_reroutes,
            "transport": (
                self.transport.stats() if self.transport is not None else None
            ),
        }

    def lifecycle_stats(self) -> dict:
        """Fleet view for dashboards: the router block plus per-replica
        engine snapshots (each replica ALSO registers its own provider so
        the Prometheus series carry the ``replica`` label)."""
        stats = self.router.stats()
        return {
            "ready": int(stats["ring_size"] >= 1),
            "ring_size": stats["ring_size"],
            "router": stats,
            "failovers": self.failovers,
            "disaggregation": self._disagg_snapshot(),
            "replicas": {
                r.name: r.engine.lifecycle_stats() for r in self.replicas
            },
        }
