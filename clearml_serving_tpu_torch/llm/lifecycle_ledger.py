"""Runtime ownership ledger: prove acquire/release pairing, don't assume it.

A copy of ``clearml_serving_tpu/llm/lifecycle_ledger.py`` with ``RESOURCES``
trimmed to what the port holds. Armed with ``TPUSERVE_LEDGER=1`` (count) or
``=strict`` (raise), every acquire and release of the KV primitives
(``llm/kv_cache.py``, ``llm/prefix_cache.py``) and of the engine records an
entry with its **owner** (the request the engine attributed it to, when
known), its **acquire site** (the first caller frame outside the
instrumented primitives) and a count. The engine then audits:

- **per request**, at emit-finish, fail and cancel: every request-scoped
  entry owned by the exiting request must be gone; a survivor is a lost
  release, reported with the resource and the acquire site;
- **at drain** (where the KV sanitizer audits): every ``drain_zero``
  resource must have no outstanding entry in the auditing engine's
  domains (slot pages, pins, hits, quarantine entries, promotions in
  flight, grammar-registry references);
- **always**: a release with nothing outstanding is a double free.

In strict mode :meth:`OwnershipLedger.check` raises :class:`LedgerError`
(an AssertionError) at the next loop boundary, naming the leaked resource
and its acquire site; in count mode violations accumulate in ``stats()``.
Entries carry the id of the primitive that recorded them (the *domain*),
so engines sharing the process audit only their own pools and caches.
Cache-scoped resources (the radix cache's page references, host-tier ids)
are counted but exempt from drain-zero: the cache holds them across
requests.

The chaos seam ``engine.ledger.leak`` (``llm/faults.py``) suppresses one
release on the teardown of a preempted request's parked pages, proving
that a real lost free surfaces here.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "ENV",
    "RESOURCES",
    "LedgerError",
    "OwnershipLedger",
    "enabled",
    "strict_enabled",
    "armed",
    "arm",
    "disarm",
    "get",
    "acquire",
    "release",
    "owner",
    "request_tag",
]

ENV = "TPUSERVE_LEDGER"

# resource -> policy. "scope" documents the natural owner; "drain_zero"
# resources must have zero outstanding entries at an engine drain audit.
RESOURCES: Dict[str, Dict[str, Any]] = {
    "pages.slot": {"scope": "engine", "drain_zero": True},
    "pages.pin": {"scope": "request", "drain_zero": True},
    "pages.ref": {"scope": "cache", "drain_zero": False},
    "prefix.hit": {"scope": "request", "drain_zero": True},
    "prefix.resume_pin": {"scope": "request", "drain_zero": True},
    "host.pages": {"scope": "cache", "drain_zero": False},
    "slot.quarantine": {"scope": "engine", "drain_zero": True},
    "kv.promotion": {"scope": "engine", "drain_zero": True},
    "guided.ref": {"scope": "request", "drain_zero": True},
    # a KV shipment sent and not yet consumed: the receiving replica's
    # mailbox holds it (cache-like, never drain-zero)
    "transport.shipment": {"scope": "cache", "drain_zero": False},
    # a socket KV wire's cached peer connection (llm/kv_wire.py) and a
    # process replica's worker process (serving/process_replica.py)
    "transport.wire.conn": {"scope": "cache", "drain_zero": False},
    "replica.worker_proc": {"scope": "engine", "drain_zero": False},
}

# frames whose code lives in these basenames are the instrumented
# primitives themselves: the interesting acquire site is their caller
_SKIP_BASENAMES = frozenset({
    "lifecycle_ledger.py", "kv_cache.py", "prefix_cache.py",
})


def enabled() -> bool:
    """Armed via ``TPUSERVE_LEDGER`` (1/true/yes/strict; 0/empty disarms)."""
    return os.environ.get(ENV, "").lower() in ("1", "true", "yes", "strict")


def strict_enabled() -> bool:
    return os.environ.get(ENV, "").lower() == "strict"


class LedgerError(AssertionError):
    """An ownership invariant failed. Carries the resource and the acquire
    site (``resource``, ``site``) for programmatic triage."""

    def __init__(self, message: str, *, resource: str = "",
                 site: str = "", where: str = ""):
        super().__init__(message)
        self.resource = resource
        self.site = site
        self.where = where


def _call_site() -> str:
    """file:line of the first frame outside the instrumented primitives."""
    frame = sys._getframe(2)
    for _ in range(8):
        if frame is None:
            break
        name = os.path.basename(frame.f_code.co_filename)
        if name not in _SKIP_BASENAMES:
            return "{}:{}".format(name, frame.f_lineno)
        frame = frame.f_back
    return "<unknown>"


class OwnershipLedger:
    """Process-wide acquire/release bookkeeping (one per process: engines
    sharing a process, and the primitives they share, record here).
    Thread-safe; owner attribution is thread-local so admission workers tag
    the acquires their own requests trigger."""

    def __init__(self, strict: bool = False):
        self.strict = bool(strict)
        self._lock = threading.Lock()
        self._tls = threading.local()
        # (resource, domain, key) -> list of {owner, site, n, t}
        self._entries: Dict[Tuple[str, int, Any], List[Dict[str, Any]]] = {}
        self.acquires = 0
        self.releases = 0
        self.leaks = 0              # leak violations found (monotonic)
        self.double_releases = 0
        self.violations: List[Dict[str, Any]] = []

    # -- owner attribution -------------------------------------------------

    @contextmanager
    def owner(self, tag: Optional[str]):
        """Attribute acquires on THIS thread to ``tag`` (the engine wraps
        its per-request admission/preemption paths)."""
        prev = getattr(self._tls, "owner", None)
        self._tls.owner = tag
        try:
            yield
        finally:
            self._tls.owner = prev

    def _owner(self) -> Optional[str]:
        return getattr(self._tls, "owner", None)

    # -- recording ---------------------------------------------------------

    def acquire(self, resource: str, key: Any = None, n: int = 1,
                domain: Any = None, owner: Optional[str] = None,
                site: Optional[str] = None) -> None:
        if n <= 0:
            return
        if resource not in RESOURCES:
            raise ValueError("unknown ledger resource {!r}".format(resource))
        entry = {
            "owner": owner if owner is not None else self._owner(),
            "site": site if site is not None else _call_site(),
            "n": int(n),
            "t": time.time(),
        }
        slot_key = (resource, id(domain), key)
        with self._lock:
            self.acquires += int(n)
            self._entries.setdefault(slot_key, []).append(entry)

    def release(self, resource: str, key: Any = None, n: int = 1,
                domain: Any = None, all_of_key: bool = False,
                owner: Optional[str] = None) -> None:
        """Discharge ``n`` units. Slabs owned by ``owner`` (explicit, else
        the thread-local owner context) discharge FIRST, then newest-first
        — two requests sharing one resource key (the same grammar, the
        same pinned page run) must not discharge each other's entries, or
        the survivor's request-exit audit reports a phantom leak."""
        if resource not in RESOURCES:
            raise ValueError("unknown ledger resource {!r}".format(resource))
        slot_key = (resource, id(domain), key)
        who = owner if owner is not None else self._owner()
        with self._lock:
            slabs = self._entries.get(slot_key)
            if all_of_key:
                n = sum(s["n"] for s in slabs) if slabs else 0
                if slabs:
                    del self._entries[slot_key]
                    self.releases += n
                return
            remaining = int(n)
            self.releases += remaining
            if slabs:
                order = (
                    [s for s in reversed(slabs) if s["owner"] == who]
                    + [s for s in reversed(slabs) if s["owner"] != who]
                )
            else:
                order = []
            for slab in order:
                if remaining <= 0:
                    break
                take = min(slab["n"], remaining)
                slab["n"] -= take
                remaining -= take
            if slabs is not None:
                slabs[:] = [s for s in slabs if s["n"] > 0]
                if not slabs:
                    del self._entries[slot_key]
            if remaining > 0:
                self.double_releases += 1
                self.violations.append({
                    "kind": "double_release",
                    "resource": resource,
                    "key": key,
                    "n": remaining,
                    "site": _call_site(),
                    "where": "release",
                })

    # -- audits ------------------------------------------------------------

    def audit_request(self, tag: str, where: str = "request-exit") -> None:
        """Every request-scoped entry owned by ``tag`` must be gone. In
        strict mode the first survivor raises immediately (the engine's
        emit/fail/cancel boundaries run on the loop thread — the structured
        step-failure path handles it, like a sanitizer violation)."""
        found: List[Dict[str, Any]] = []
        with self._lock:
            for (resource, _domain, key), slabs in self._entries.items():
                if RESOURCES[resource]["scope"] != "request":
                    continue
                for slab in slabs:
                    if (
                        slab["owner"] == tag
                        and slab["n"] > 0
                        and not slab.get("reported")
                    ):
                        slab["reported"] = True  # count each lost free ONCE
                        found.append({
                            "kind": "request_leak",
                            "resource": resource,
                            "key": key,
                            "n": slab["n"],
                            "site": slab["site"],
                            "owner": tag,
                            "where": where,
                        })
            if found:
                self.leaks += len(found)
                self.violations.extend(found)
        if found and self.strict:
            v = found[0]
            raise LedgerError(
                "ownership ledger [{}]: request {} exited holding {} x "
                "{} acquired at {} — a lost release on a request exit "
                "path".format(
                    where, tag, v["n"], v["resource"], v["site"]
                ),
                resource=v["resource"], site=v["site"], where=where,
            )

    def check(self, where: str = "step", drained: bool = False,
              domains: Optional[List[Any]] = None) -> None:
        """Loop-boundary audit (the engine calls this where it calls the KV
        sanitizer). Raises the first pending strict violation; at a drained
        boundary additionally requires zero outstanding entries for every
        ``drain_zero`` resource within ``domains`` (None = everywhere)."""
        domain_ids = (
            None if domains is None else {id(d) for d in domains}
        )
        leaked: List[Dict[str, Any]] = []
        with self._lock:
            pending = list(self.violations) if self.strict else []
            if drained:
                for (resource, domain, key), slabs in self._entries.items():
                    if not RESOURCES[resource]["drain_zero"]:
                        continue
                    if domain_ids is not None and domain not in domain_ids:
                        continue
                    for slab in slabs:
                        # a leaked entry survives in the books until
                        # reset(); count it ONCE, not once per drained
                        # boundary (the counter is lost frees, not drains
                        # that observed them; the violations list must
                        # not grow unboundedly on a long-lived server)
                        if slab["n"] > 0 and not slab.get("reported"):
                            slab["reported"] = True
                            leaked.append({
                                "kind": "drain_leak",
                                "resource": resource,
                                "key": key,
                                "n": slab["n"],
                                "site": slab["site"],
                                "owner": slab["owner"],
                                "where": where,
                            })
                if leaked:
                    self.leaks += len(leaked)
                    self.violations.extend(leaked)
        if not self.strict:
            return
        for v in pending + leaked:
            if v["kind"] == "double_release":
                raise LedgerError(
                    "ownership ledger [{}]: released {} x {} that was "
                    "never acquired (double free / release-after-free) at "
                    "{}".format(where, v["n"], v["resource"], v["site"]),
                    resource=v["resource"], site=v["site"], where=where,
                )
            raise LedgerError(
                "ownership ledger [{}]: {} x {} still outstanding at the "
                "drained boundary (owner {}), acquired at {} — a leaked "
                "resource the exception paths never released".format(
                    where, v["n"], v["resource"], v.get("owner"), v["site"]
                ),
                resource=v["resource"], site=v["site"], where=where,
            )

    # -- introspection -----------------------------------------------------

    def outstanding(self) -> Dict[str, int]:
        """resource -> total outstanding count (all domains)."""
        out: Dict[str, int] = {r: 0 for r in RESOURCES}
        with self._lock:
            for (resource, _domain, _key), slabs in self._entries.items():
                out[resource] += sum(s["n"] for s in slabs)
        return out

    def outstanding_entries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [
                {"resource": resource, "key": key, "n": slab["n"],
                 "owner": slab["owner"], "site": slab["site"]}
                for (resource, _d, key), slabs in self._entries.items()
                for slab in slabs if slab["n"] > 0
            ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            violations = len(self.violations)
            leaks = self.leaks
            double = self.double_releases
            acquires = self.acquires
            releases = self.releases
        return {
            "strict": self.strict,
            "acquires": acquires,
            "releases": releases,
            "leaks": leaks,
            "double_releases": double,
            "violations": violations,
            "outstanding": self.outstanding(),
        }

    def reset(self, strict: Optional[bool] = None) -> None:
        with self._lock:
            self._entries.clear()
            self.acquires = 0
            self.releases = 0
            self.leaks = 0
            self.double_releases = 0
            self.violations = []
            if strict is not None:
                self.strict = bool(strict)


# -- module singleton ---------------------------------------------------------

_ledger: Optional[OwnershipLedger] = None
_armed = False
_guard = threading.Lock()


def get() -> OwnershipLedger:
    """The process-wide ledger (created on first use; strictness from the
    env at creation — tests flip ``.strict`` / call ``.reset()``)."""
    global _ledger
    with _guard:
        if _ledger is None:
            _ledger = OwnershipLedger(strict=strict_enabled())
        return _ledger


def armed() -> bool:
    """Fast hot-path gate: one module-global read when disarmed."""
    return _armed


def arm(strict: Optional[bool] = None) -> OwnershipLedger:
    """Start recording (idempotent: co-hosted engines arm at construction
    and share the ledger; arming never resets accumulated state)."""
    global _armed
    ledger = get()
    if strict is not None:
        ledger.strict = bool(strict)
    _armed = True
    return ledger


def disarm() -> None:
    global _armed
    _armed = False


def acquire(resource: str, key: Any = None, n: int = 1, domain: Any = None,
            owner: Optional[str] = None) -> None:
    """Record an acquire when armed (no-op otherwise). Call sites guard
    with ``armed()`` so the disarmed cost is one global read."""
    if _armed:
        get().acquire(resource, key=key, n=n, domain=domain, owner=owner)


def release(resource: str, key: Any = None, n: int = 1, domain: Any = None,
            all_of_key: bool = False) -> None:
    if _armed:
        get().release(
            resource, key=key, n=n, domain=domain, all_of_key=all_of_key
        )


@contextmanager
def owner(tag: Optional[str]):
    """Attribute this thread's acquires to ``tag`` while armed (no-op
    context otherwise)."""
    if not _armed:
        yield
        return
    with get().owner(tag):
        yield


def request_tag(request: Any) -> str:
    """Stable owner tag for a request object."""
    return "req:{:x}".format(id(request))
