"""Fault-injection seams for request-lifecycle chaos testing.

A trimmed copy of ``clearml_serving_tpu/llm/faults.py``: the same spec
format, matching and ``TPUSERVE_FAULTS`` parsing, over the seams the port's
engine fires. With no spec armed, :func:`fire` is one attribute read.

Points (the context each carries):

- ``engine.admit``        inside ``check_admission`` (``request``); a raise
                          becomes a 429 shed booked under ``queue``.
- ``engine.admit.class``  inside ``check_admission``'s class-aware path
                          (``request``); a raise forces a class-policy 429
                          carrying the request's class.
- ``engine.pool``         inside ``check_admission``'s pool-headroom check
                          with ``max_pending`` set (``request``); a raise
                          reads the pool as saturated: a 429 booked under
                          ``pool``.
- ``engine.prefill``      at the start of an admission (``request``): in the
                          two-dispatch prefill worker, or on the loop
                          thread as a ragged job opens; a raise fails that
                          admission only, ``delay`` is a slow one.
- ``engine.release``      on the loop thread where a finished request's
                          slot gives its pages back (``request``); a raise
                          skips the free, a lost release that the armed KV
                          sanitizer names at drain.
- ``engine.decode``       in the decode-chunk dispatch worker, before the
                          device call (``requests``); ``match_token`` fails
                          only the matched request, ``delay`` is a slow
                          dispatch (the watchdog's first-use grace covers it).
- ``engine.decode.stall`` in the retire worker, before it waits for the
                          chunk's tokens (``requests``); ``delay`` wedges
                          the retire leg, where no grace applies: the
                          watchdog's view of a stalled replay.
- ``engine.decode.retire`` on the loop thread at a chunk's retirement, after
                          its tokens landed and before emission
                          (``requests``); a matched raise fails that request
                          only, an unmatched one the batch.
- ``engine.dispatch.prepare`` on the loop thread at the end of
                          ``_prepare_dispatch`` (``requests``).
- ``engine.watchdog``     at the top of a watchdog trip (``requests``).
- ``engine.drain``        on the loop thread at the drained boundary.
- ``engine.preempt``      on the loop thread mid-preemption, before the
                          victim's slot is freed and the request requeued
                          (``request``); a raise aborts the preemption and
                          the victim keeps decoding.
- ``engine.spec.tree``    in the ragged planner after verify-row eligibility
                          and before drafting (``requests``); a matched raise
                          demotes that row to plain decode, an unmatched one
                          every verify row of the step.
- ``engine.kv.demote``    in the radix prefix cache as device-budget eviction
                          is about to demote a cached run's pages to the
                          host-RAM tier (``pages``); a raise aborts the
                          demotion and the run drops for real.
- ``engine.kv.promote``   as a lookup on a demoted run is about to allocate
                          device pages and enqueue the host-to-device copy
                          (``pages``); a raise aborts the promotion: the
                          demoted suffix drops, the hit shortens to the
                          resident prefix and the tail recomputes.
- ``engine.ledger.leak``  in the teardown of a preempted request's parked
                          pages (``_release_parked``), after they left the
                          request and before their pins drop (``request``);
                          a raise loses that release, which the armed
                          ownership ledger (``TPUSERVE_LEDGER``) names at
                          drain.
- ``engine.admit.budget`` in the ragged planner as an admission job is about
                          to take its share of the step token budget
                          (``request``); a raise aborts that admission only
                          (a structured ``EngineStepError``), the step
                          carries on.
- ``engine.kv.ship``      at a prefill replica's commit, before the prefix
                          pages export into a transport shipment
                          (``request``); a raise drops the shipment (counted
                          in ``ship_drops``): the decode replica recomputes.
- ``kv.ship.partial``     at a ragged chunk boundary, before a draft-ahead
                          frame exports (``request``); a raise aborts the
                          request's whole draft-ahead stream and skips the
                          seal: the decode replica recomputes.
- ``engine.kv.receive``   on the decode replica as a popped shipment is
                          about to import (``request``: a shim whose
                          ``prompt_ids`` are the prompt's); a raise fails
                          the receive, and the group re-routes the stream.
- ``transport.wire.send`` in the socket KV transport (``llm/kv_wire.py``)
                          before a shipment is framed and written to the
                          destination's listener; a raise drops the
                          shipment sender-side (a counted wire send failure,
                          ``send`` returns False) and the decode replica
                          recomputes, as after a full receive slab.
- ``transport.wire.recv`` on the receiving endpoint's listener thread before
                          a received frame is decoded and validated; a raise
                          drops the frame leak-free (nothing was attached:
                          the slabs are views into the frame's buffer),
                          nacks the sender, and the stream falls back to
                          recompute, the path a truncated or lying frame
                          takes through ``WireFormatError``.
- ``replica.proc.crash``  in a process replica's supervisor tick
                          (``serving/process_replica.py``), with the replica
                          INDEX as the shim's ``prompt_ids`` (the
                          ``router.eject`` convention): ``match_token:
                          <index>`` SIGKILLs exactly that worker process,
                          a real worker death (end of file mid-stream, then
                          failover on history-as-prompt, ejection and the
                          bounded restart with re-warm).
- ``router.pick``         in the replica router as a pick is about to
                          return (``request``); a raise falls to the next
                          ring member, counted as a ``rebalance``.
- ``router.eject``        per replica at each ring sweep; the shim's
                          ``prompt_ids`` holds the replica INDEX, so
                          ``match_token: <index>`` force-ejects exactly that
                          replica while the spec stays armed.
- ``grpc.call``           before each attempt of the ``jax_grpc`` client
                          (``engines/grpc_client.py``; ``attempt``); the
                          spec's ``grpc_code`` ("UNAVAILABLE",
                          "DEADLINE_EXCEEDED", "NOT_FOUND") stands for the
                          upstream's status, so the retry policy runs
                          without a server.

:func:`configure` rejects specs naming any other point: a typo'd point would
arm a fault that never fires.

Env format (``TPUSERVE_FAULTS``), a JSON list of spec dicts::

    TPUSERVE_FAULTS='[{"point": "engine.decode.stall", "action": "delay",
                       "delay": 5, "times": 1}]'
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

KNOWN_POINTS = frozenset({
    "engine.admit",
    "engine.admit.class",
    "engine.pool",
    "engine.prefill",
    "engine.release",
    "engine.decode",
    "engine.decode.stall",
    "engine.decode.retire",
    "engine.dispatch.prepare",
    "engine.watchdog",
    "engine.drain",
    "engine.preempt",
    "engine.spec.tree",
    "engine.kv.demote",
    "engine.kv.promote",
    "engine.ledger.leak",
    "engine.admit.budget",
    "engine.kv.ship",
    "kv.ship.partial",
    "engine.kv.receive",
    "transport.wire.send",
    "transport.wire.recv",
    "replica.proc.crash",
    "router.pick",
    "router.eject",
    "grpc.call",
})


@dataclass
class FaultSpec:
    point: str
    action: str = "raise"          # "raise" | "delay"
    times: int = -1                # firings before the spec disarms (-1 = inf)
    delay: float = 0.0             # seconds slept before acting
    match_token: Optional[int] = None  # only fire when a request's prompt has it
    grpc_code: Optional[str] = None    # fake upstream status for grpc points
    message: str = "injected fault"
    fired: int = field(default=0, compare=False)

    def exhausted(self) -> bool:
        return 0 <= self.times <= self.fired


class InjectedFault(Exception):
    """Raised by an armed ``action="raise"`` spec. Carries the spec and the
    matched request (when ``match_token`` selected one), so the engine can
    fail that request only."""

    def __init__(self, spec: FaultSpec, request: Any = None):
        super().__init__("{} [{}]".format(spec.message, spec.point))
        self.spec = spec
        self.request = request

    @property
    def grpc_code(self) -> Optional[str]:
        return self.spec.grpc_code


class FaultInjector:
    def __init__(self):
        self._specs: List[FaultSpec] = []
        self._lock = threading.Lock()
        self.load_env()

    def configure(self, specs) -> None:
        """Arm ``specs`` (FaultSpec or dicts), replacing the armed set."""
        armed = []
        for s in specs or []:
            spec = s if isinstance(s, FaultSpec) else FaultSpec(**s)
            if spec.point not in KNOWN_POINTS:
                raise ValueError("unknown fault point {!r} (known: {})".format(
                    spec.point, ", ".join(sorted(KNOWN_POINTS))))
            armed.append(spec)
        with self._lock:
            self._specs = armed

    def clear(self) -> None:
        with self._lock:
            self._specs = []

    def load_env(self) -> None:
        raw = os.environ.get("TPUSERVE_FAULTS")
        if not raw:
            return
        try:
            specs = json.loads(raw)
        except ValueError as ex:
            raise ValueError("unparseable TPUSERVE_FAULTS: {}".format(ex))
        self.configure(specs)

    def active(self) -> bool:
        return bool(self._specs)

    @staticmethod
    def _match(spec: FaultSpec, request, requests) -> Any:
        """The request a spec applies to, or None when ``match_token``
        filters everything out (specs without it apply unconditionally)."""
        if spec.match_token is None:
            return request
        candidates = list(requests or [])
        if request is not None:
            candidates.append(request)
        for r in candidates:
            if spec.match_token in (getattr(r, "prompt_ids", None) or []):
                return r
        return None

    def fire(self, point: str, request: Any = None, requests=None, **ctx) -> None:
        """Run every armed spec of ``point``: sleep for ``delay``, then
        raise :class:`InjectedFault` for ``raise`` actions. ``ctx`` is the
        seam's context (``pages`` of the tier seams), which no spec
        matches on."""
        with self._lock:
            specs = [s for s in self._specs if s.point == point]
        for spec in specs:
            target = self._match(spec, request, requests)
            if spec.match_token is not None and target is None:
                continue
            with self._lock:
                # claim one firing atomically: the loop thread and the
                # workers race here, and a bounded spec fires no more
                if spec.exhausted():
                    continue
                spec.fired += 1
            if spec.delay:
                time.sleep(spec.delay)
            if spec.action == "raise":
                raise InjectedFault(spec, target)


# module singleton: the engine's call sites and the tests share it
injector = FaultInjector()


def active() -> bool:
    return injector.active()


def fire(point: str, request: Any = None, requests=None, **ctx) -> None:
    if injector.active():
        injector.fire(point, request=request, requests=requests, **ctx)


def configure(specs) -> None:
    injector.configure(specs)


def clear() -> None:
    injector.clear()
