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
    "engine.decode",
    "engine.decode.stall",
    "engine.decode.retire",
    "engine.dispatch.prepare",
    "engine.watchdog",
    "engine.drain",
    "engine.preempt",
    "engine.spec.tree",
})


@dataclass
class FaultSpec:
    point: str
    action: str = "raise"          # "raise" | "delay"
    times: int = -1                # firings before the spec disarms (-1 = inf)
    delay: float = 0.0             # seconds slept before acting
    match_token: Optional[int] = None  # only fire when a request's prompt has it
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

    def fire(self, point: str, request: Any = None, requests=None) -> None:
        """Run every armed spec of ``point``: sleep for ``delay``, then
        raise :class:`InjectedFault` for ``raise`` actions."""
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


def fire(point: str, request: Any = None, requests=None) -> None:
    if injector.active():
        injector.fire(point, request=request, requests=requests)


def configure(specs) -> None:
    injector.configure(specs)


def clear() -> None:
    injector.clear()
