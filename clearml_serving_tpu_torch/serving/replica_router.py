"""Prefix-affine replica router.

The port's copy of ``clearml_serving_tpu/serving/replica_router.py``, with
its routing math, ring lifecycle and counters unchanged. N engine replicas
(in-process ``LLMEngineCore`` instances over one shared ``Llama``,
``llm/replica.py``) sit behind one rendezvous-hashed ring, and every
request routes by the BLOCK-ALIGNED radix prefix of its prompt (the block
math ``llm/prefix_cache.py`` keys its trie on), so repeated conversations
land on the replica whose KV pages already hold their prefix.

Routing contract, in order:

1. **Affinity**: HRW/rendezvous order of the ring by
   ``blake2b(affinity_key || replica_name)`` — deterministic, minimally
   disruptive (removing a member only moves that member's keys).
2. **Health**: a replica that is not serving-ready (engine stopped,
   watchdog recovery in progress, warmup gate still closed, or
   fault-forced ejection via the ``router.eject`` seam) is not in the
   ring; its keys fall to their next HRW choice (route ``rebalance``).
3. **Load**: when the affine member is overloaded (queue depth or
   brownout stage over the spill bounds) and its next choice is strictly
   less pressured, the request spills (route ``spill``) — prefix warmth
   loses to a meaningful pressure gap, never to a tie.
4. **Fleet brownout**: when EVERY ring member is at the shed stage,
   best-effort work sheds at the router door (structured 429) before any
   replica queues it — one replica's stage-3 pressure already redirected
   its admissions at step 3; this is the whole fleet saying no.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from typing import Any, Dict, List, Optional, Sequence

from ..errors import EngineOverloadedError, EngineUnavailableError
from ..llm import faults

# conversation anchor depth: the affinity key hashes at most this many
# prefix blocks, so a growing conversation (each turn appends to its
# history) keeps ONE key for its whole life instead of re-keying per turn
DEFAULT_AFFINITY_BLOCKS = 4


def affinity_key(prompt_ids: Sequence[int], block: int,
                 max_blocks: int = DEFAULT_AFFINITY_BLOCKS) -> bytes:
    """Stable conversation anchor for a prompt: a digest of its first
    block-aligned prefix blocks (``block`` = the radix cache's block size,
    so the key space is exactly the trie's top levels). The final token
    never contributes (mirroring ``RadixPrefixCache.longest_prefix_len``:
    it always computes live), and prompts shorter than one block hash
    whole — short one-shot work spreads uniformly over the ring."""
    ids = list(prompt_ids)
    depth = ((len(ids) - 1) // max(1, int(block))) * max(1, int(block))
    depth = min(depth, max(1, int(max_blocks)) * max(1, int(block)))
    head = ids[:depth] if depth > 0 else ids
    digest = hashlib.blake2b(digest_size=8)
    digest.update(struct.pack("<I", len(head)))
    for token in head:
        digest.update(struct.pack("<q", int(token)))
    return digest.digest()


def hrw_order(key: bytes, names: Sequence[str]) -> List[int]:
    """Rendezvous (highest-random-weight) ranking of ``names`` for ``key``:
    indices sorted by score descending. Deterministic across processes
    (blake2b, not the seeded builtin hash)."""
    scored = []
    for i, name in enumerate(names):
        h = hashlib.blake2b(key, digest_size=8)
        h.update(str(name).encode("utf-8"))
        scored.append((h.digest(), i))
    scored.sort(reverse=True)
    return [i for _, i in scored]


class _ReplicaShim:
    """Carrier for fault matching on router seams: ``match_token`` against
    a replica INDEX selects which replica a ``router.eject`` spec forces
    out of the ring (the fault machinery matches on ``prompt_ids``)."""

    def __init__(self, index: int):
        self.prompt_ids = [int(index)]


class ReplicaRouter:
    """Prefix-affine HRW ring over replica handles.

    ``replicas``: objects exposing ``name``/``index``, liveness
    (``engine_ready``), the warmup gate (``warmed``/``warming``/
    ``begin_warm()``/``invalidate_warm()``), and pressure signals
    (``queue_depth``/``brownout_stage``) — ``llm/replica.py``'s
    ``EngineReplica`` in production, light stubs in tests.
    """

    # the route/event counter maps are written on the serving loop and
    # read by the Prometheus scrape thread (statistics/metrics.py) under
    # _lock; ring membership is the loop's, rebound (never mutated in
    # place) so a scrape reads a whole snapshot by reference

    def __init__(
        self,
        replicas: Sequence[Any],
        *,
        block: int = 64,
        affinity_blocks: int = DEFAULT_AFFINITY_BLOCKS,
        # spill when the affine member's queue depth reaches this bound
        # (None = queue depth never spills) ...
        spill_queue_depth: Optional[int] = None,
        # ... or its brownout stage reaches this bound — stage >= 2 means
        # the member is already degrading batch work; redirect BEFORE it
        # has to shed 
        spill_brownout_stage: int = 2,
        # fleet-wide brownout: every ring member at this stage sheds
        # best-effort at the router door
        fleet_shed_stage: int = 3,
        # replica roles: name -> "prefill" |
        # "decode" | "hybrid" (missing = hybrid). Streams route to
        # decode-capable members; the group's ship leg asks pick_prefill
        # for a prefill-capable one. An empty role class degrades to
        # hybrid routing (any ring member serves) instead of failing.
        roles: Optional[Dict[str, str]] = None,
        # which replica backend the fleet runs on ("inprocess" = N engines
        # on this heap, the port's only one); exported in stats() for the
        # router_replica_backend info gauge
        replica_backend: str = "inprocess",
    ):
        self.replica_backend = str(replica_backend)
        self._replicas = list(replicas)
        self._names = [r.name for r in self._replicas]
        if len(set(self._names)) != len(self._names):
            raise ValueError("replica names must be unique: {}".format(self._names))
        self._roles = {name: "hybrid" for name in self._names}
        for name, role in (roles or {}).items():
            if name not in self._roles:
                raise ValueError(
                    "role for unknown replica {!r} (replicas: {})".format(
                        name, self._names
                    )
                )
            if role not in ("prefill", "decode", "hybrid"):
                raise ValueError(
                    "replica role must be prefill/decode/hybrid: got {!r} "
                    "for {}".format(role, name)
                )
            self._roles[name] = role
        self.block = int(block)
        self.affinity_blocks = int(affinity_blocks)
        self.spill_queue_depth = spill_queue_depth
        self.spill_brownout_stage = int(spill_brownout_stage)
        self.fleet_shed_stage = int(fleet_shed_stage)
        self._lock = threading.Lock()
        self._ring_members: frozenset = frozenset()
        self._route_counts: Dict[str, Dict[str, int]] = {
            name: {"affine": 0, "spill": 0, "rebalance": 0}
            for name in self._names
        }
        self._router_events: Dict[str, Dict[str, int]] = {
            "ejections": {name: 0 for name in self._names},
            "readmissions": {name: 0 for name in self._names},
            "fleet_sheds": {"best_effort": 0},
        }
        self.sweep()

    # -- ring maintenance ---------------------------------------------------

    def _force_ejected(self, replica) -> bool:
        """``router.eject`` fault seam: an armed spec whose ``match_token``
        equals the replica INDEX forces that replica out of the ring — the
        chaos suite's handle for ejection without a real engine failure."""
        try:
            faults.fire("router.eject", request=_ReplicaShim(replica.index))
        except faults.InjectedFault:
            return True
        return False

    def sweep(self) -> None:
        """Refresh ring membership from live replica state. Runs on the
        serving event loop (every pick, cheap) and from tests.

        Ejection: a member that stops being serving-ready (engine not
        ready, or fault-forced) leaves the ring immediately and its warmup
        gate closes — re-admission must re-warm (a recovered engine's
        caches survive, so the re-warm is a fast no-compile pass, but a
        replaced process would compile here instead of under traffic).
        Re-admission: a non-member whose engine is ready re-enters only
        once the warmup gate reopens; ``begin_warm()`` schedules the gate's
        shared warmup task when one is needed."""
        for replica in self._replicas:
            forced = self._force_ejected(replica)
            healthy = bool(replica.engine_ready) and not forced
            member = replica.name in self._ring_members
            if member and not (healthy and replica.warmed):
                self._ring_members = self._ring_members - {replica.name}
                replica.invalidate_warm()
                with self._lock:
                    self._router_events["ejections"][replica.name] += 1
            elif not member and healthy:
                if replica.warmed:
                    self._ring_members = self._ring_members | {replica.name}
                    with self._lock:
                        # cold-start entry is not a READ-mission: only a
                        # previously ejected member counts here
                        if self._router_events["ejections"][replica.name]:
                            self._router_events["readmissions"][replica.name] += 1
                else:
                    replica.begin_warm()

    def ring(self) -> List[str]:
        return sorted(self._ring_members)

    @property
    def ring_size(self) -> int:
        return len(self._ring_members)

    # -- pressure -----------------------------------------------------------

    def _overloaded(self, replica) -> bool:
        if (
            self.spill_queue_depth is not None
            and replica.queue_depth >= self.spill_queue_depth
        ):
            return True
        return replica.brownout_stage >= self.spill_brownout_stage

    @staticmethod
    def _pressure(replica) -> tuple:
        return (replica.brownout_stage, replica.queue_depth)

    def fleet_stage(self) -> int:
        """Fleet brownout stage: the MINIMUM stage over ring members — the
        least-pressured member defines what the fleet can still absorb
        (one healthy replica at stage 0 means redirect, not shed)."""
        stages = [
            r.brownout_stage
            for r in self._replicas
            if r.name in self._ring_members
        ]
        return min(stages) if stages else 0

    # -- roles -------------------------------------

    def role_of(self, name: str) -> str:
        return self._roles.get(name, "hybrid")

    def _decode_capable(self, replica) -> bool:
        return self.role_of(replica.name) in ("decode", "hybrid")

    def _prefill_capable(self, replica) -> bool:
        return self.role_of(replica.name) in ("prefill", "hybrid")

    def pick_prefill(self, request,
                     exclude: Optional[str] = None) -> Optional[Any]:
        """The prefill replica for a disaggregated request's ship leg:
        prefill-ROLE ring members first (specialization is the point),
        then hybrids, each set in HRW order for the prompt; browned-out
        members (stage >= the spill bound) are skipped — a degrading
        prefill replica must not slow every stream's TTFT. Returns None
        when nothing suitable remains (the caller degrades to hybrid:
        the decode replica prefills for itself)."""
        self.sweep()
        order = [
            r for r in self.order_for(request.prompt_ids)
            if r.name in self._ring_members
            and r.name != exclude
            and self._prefill_capable(r)
            and r.brownout_stage < self.spill_brownout_stage
        ]
        dedicated = [r for r in order if self.role_of(r.name) == "prefill"]
        return (dedicated or order or [None])[0]

    # -- routing ------------------------------------------------------------

    def order_for(self, prompt_ids: Sequence[int]) -> List[Any]:
        """Full HRW preference order (healthy or not) for a prompt."""
        key = affinity_key(prompt_ids, self.block, self.affinity_blocks)
        return [self._replicas[i] for i in hrw_order(key, self._names)]

    def pick(self, request) -> tuple:
        """Route one request: returns ``(replica, route)`` with ``route``
        in ``affine`` (HRW first choice), ``rebalance`` (first choice out
        of the ring — health/eject reroute), ``spill`` (first choice
        overloaded, second strictly less pressured). With replica roles,
        streams prefer DECODE-capable members (decode/hybrid); an empty
        decode class degrades to any ring member (route ``rebalance``).
        Raises structured errors when the fleet itself cannot take the
        request."""
        self.sweep()
        order = self.order_for(request.prompt_ids)
        candidates = [r for r in order if self._decode_capable(r)]
        ring = [r for r in candidates if r.name in self._ring_members]
        if not ring:
            # decode class empty/ejected: hybrid degradation — any ring
            # member takes the stream rather than shedding it
            candidates = order
            ring = [r for r in order if r.name in self._ring_members]
        if not ring:
            if any(r.warming for r in self._replicas):
                raise EngineUnavailableError(
                    "all replicas are warming up", retry_after=1.0
                )
            raise EngineUnavailableError("no ready replicas in the ring")
        if (
            getattr(request, "priority", "interactive") == "best_effort"
            and self.fleet_stage() >= self.fleet_shed_stage
        ):
            with self._lock:
                self._router_events["fleet_sheds"]["best_effort"] += 1
            raise EngineOverloadedError(
                "fleet brownout (every ring member at stage >= {}): "
                "best-effort shed at the router".format(self.fleet_shed_stage),
                shed_class="best_effort",
            )
        # "affine" = HRW first choice AMONG role-eligible members: on a
        # role-split fleet every stream would otherwise count rebalance
        affine = candidates[0] if candidates else order[0]
        chosen = ring[0]
        route = "affine" if chosen is affine else "rebalance"
        if route == "affine" and len(ring) > 1:
            alt = ring[1]
            if self._overloaded(chosen) and (
                self._pressure(alt) < self._pressure(chosen)
            ):
                chosen, route = alt, "spill"
        try:
            faults.fire("router.pick", request=request)
        except faults.InjectedFault:
            # injected pick failure: structured fallback to the next ring
            # member (never a 500) — counted as a rebalance
            if len(ring) > 1:
                chosen = ring[(ring.index(chosen) + 1) % len(ring)]
            route = "rebalance"
        with self._lock:
            self._route_counts[chosen.name][route] += 1
        return chosen, route

    # -- observability ------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Scrape-time snapshot (statistics/metrics.py
        ReplicaRouterCollector; mirrored in the group's health() /
        lifecycle_stats())."""
        with self._lock:
            requests = {
                name: dict(routes) for name, routes in self._route_counts.items()
            }
            events = {
                kind: dict(per) for kind, per in self._router_events.items()
            }
        stages = {r.name: r.brownout_stage for r in self._replicas}
        return {
            "replicas": len(self._replicas),
            "replica_backend": self.replica_backend,
            "ring_size": len(self._ring_members),
            "ring": self.ring(),
            "roles": dict(self._roles),
            "requests": requests,
            "ejections": events["ejections"],
            "readmissions": events["readmissions"],
            "fleet_sheds": events["fleet_sheds"],
            "fleet_brownout": {
                "stage": self.fleet_stage(),
                "stages": stages,
            },
        }
