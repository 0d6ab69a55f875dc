"""Process-backend engine replicas: one worker OS process per ring member.

The port's copy of ``clearml_serving_tpu/serving/process_replica.py``. The
in-process fleet (``llm/replica.py``) runs N ``LLMEngineCore`` instances in
one Python process: one GIL, one CUDA context and one blast radius. Here
each replica is a **supervised worker subprocess** that owns its engine,
its ``Llama``, its KV pool and its CUDA graphs, in a CUDA context of its
own (on the device its spec names: ``"cuda"`` unless the caller names the
CPU, as the tests do). The parent holds no weights.

``ProcessEngineReplica`` has the ``EngineReplica`` surface the router and
the group consume (begin_warm/health/generate/stop/wait_drained, streamed
tokens, lifecycle stats) and proxies it over length-prefixed JSON control
channels on a UNIX socket:

- an **async channel**: id-multiplexed request frames; ``generate``
  streams ``{"id", "tok"}`` frames back, ``warmup``/``drain``/``ping`` are
  single request/reply exchanges. The parent demultiplexes on a reader
  thread into per-call queues, so a stream may be consumed from any event
  loop.
- a **sync channel**: blocking request/reply for the engine's synchronous
  surface (check_admission, validate, receive_shipment, health, lifecycle
  stats, score_prompt), one call at a time under ``_sync_lock``. Calls the
  engine makes on its loop thread (admission, validation, the prefix
  cache's match and a shipment's receive, whose import allocates pages
  where the commits do) are run on the worker's event loop
  (``run_coroutine_threadsafe``).

Liveness is a supervisor THREAD per replica: heartbeat pings on the async
channel feed ``is_ready``; a missed-heartbeat budget or a dead process
marks the proxy not ready, the router's next sweep ejects it, its streams
fail with ``EngineUnavailableError`` and the group resumes them on a
sibling with the history as prompt. A dead worker gets a bounded
**restart with re-warm**: respawn, a fresh handshake, and
``invalidate_warm()``, so the warmup gate certifies it again before the
router takes it back.

Errors cross the boundary BY NAME: the worker sends ``type(ex).__name__``,
the message and the structured fields (retry_after, stage, shed_class),
and the parent rebuilds the class from ``errors.py``: a 429 keeps its
Retry-After across the hop.

Chaos seam: ``replica.proc.crash`` (``llm/faults.py``) fires in the
supervisor's tick with the replica INDEX as the shim prompt: ``match_token:
1`` SIGKILLs exactly worker r1.

A worker is a fresh interpreter (``sys.executable -m
clearml_serving_tpu_torch.serving.process_replica --spec ...``), never a
fork: a CUDA context does not survive ``fork``. Its environment puts this
package's parent directory on ``PYTHONPATH``, and its standard output goes
to the parent's standard error. A worker exits when its control socket
closes, so no decode loop outlives its parent.

Known limits, refused by name as in the reference: guided decoding (the
grammar compiler needs the tokenizer, which stays in the parent); the port
has no LoRA adapters.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import os
import queue as _queue
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple

from .. import errors as _errors
from ..errors import EngineUnavailableError
from ..llm import faults
from ..llm import lifecycle_ledger as _ledger

logger = logging.getLogger(__name__)

# handshake budget: a worker imports torch, draws or loads the model and
# builds the engine (and, on a cold tree, the kernels) before it connects
_DEFAULT_STARTUP_TIMEOUT = 300.0
_SYNC_CALL_TIMEOUT = 60.0
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# -- framing (both sides) ------------------------------------------------------
#
# [u32 little-endian frame length][UTF-8 JSON payload]: the KV wire's
# length-prefixed discipline (llm/kv_wire.py) without its binary body.


def _send_frame_sock(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame_sock(sock: socket.socket) -> Optional[dict]:
    """One frame, or None on end of file, a timeout or a closed socket (a
    truncated frame is a dead peer)."""
    head = _read_exact(sock, 4)
    if head is None:
        return None
    (length,) = struct.unpack("<I", head)
    body = _read_exact(sock, length)
    if body is None:
        return None
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON sanitizer for health and lifecycle payloads:
    tensors and numpy scalars, bytes, sets and non-string dict keys appear
    in engine snapshots and must not kill the control channel."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set, frozenset)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj).hex()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    for name in ("item", "tolist"):
        fn = getattr(obj, name, None)
        if callable(fn):
            try:
                return _jsonable(fn())
            except (TypeError, ValueError, RuntimeError):
                pass
    return repr(obj)


# -- errors over the wire -----------------------------------------------------------


def _err_to_dict(ex: BaseException) -> dict:
    out = {"name": type(ex).__name__, "message": str(ex)}
    for field in ("retry_after", "stage", "shed_class"):
        val = getattr(ex, field, None)
        if val is not None:
            out[field] = val
    return out


def _err_from_dict(d: dict) -> BaseException:
    """Rebuild a worker-side error by class name against ``errors.py``: the
    structured fields (Retry-After, deadline stage, shed class) survive the
    hop, so the front's HTTP mapping is the in-process backend's. Unknown
    names degrade to RuntimeError."""
    name = str(d.get("name", ""))
    message = str(d.get("message", ""))
    cls = getattr(_errors, name, None)
    if isinstance(cls, type) and issubclass(cls, Exception):
        kwargs = {}
        if issubclass(cls, _errors.RequestError) and d.get("retry_after") is not None:
            kwargs["retry_after"] = d["retry_after"]
        if name == "DeadlineExceededError" and d.get("stage"):
            kwargs["stage"] = d["stage"]
        if name == "EngineOverloadedError" and d.get("shed_class"):
            kwargs["shed_class"] = d["shed_class"]
        try:
            return cls(message, **kwargs)
        except TypeError:
            try:
                return cls(message)
            except TypeError:
                pass
    if name in ("InjectedFault", "MemoryError", "ValueError"):
        # receive/admission fault classes the group's degradation paths
        # catch by type: keep the category without the module
        return {"MemoryError": MemoryError, "ValueError": ValueError}.get(
            name, RuntimeError)(message)
    return RuntimeError("{}: {}".format(name, message) if name else message)


# -- request serialization ------------------------------------------------------------

_REQ_FIELDS = (
    "max_new_tokens", "temperature", "top_k", "top_p", "stop_token_ids",
    "presence_penalty", "frequency_penalty", "repetition_penalty", "seed",
    "logprobs", "min_tokens", "priority",
)


def _req_to_wire(request) -> dict:
    """A GenRequest as a JSON dict of REMAINING budgets (the group's
    ``_resume_clone`` deadline convention: monotonic deadlines do not cross
    process clocks, so the wire carries what is left of each)."""
    if getattr(request, "guided", None) is not None:
        raise ValueError(
            "guided decoding is not supported on process-backend replicas "
            "yet (the grammar compiler needs the tokenizer, which lives in "
            "the parent; docs/replication.md)"
        )
    d = {f: getattr(request, f) for f in _REQ_FIELDS}
    d["prompt_ids"] = [int(t) for t in request.prompt_ids]
    if request.logit_bias:
        d["logit_bias"] = {str(k): float(v) for k, v in request.logit_bias.items()}
    now = time.monotonic()

    def _remaining(deadline, fallback):
        if deadline is not None:
            return max(0.05, deadline - now)
        return fallback

    d["queue_timeout"] = _remaining(request._queue_deadline, request.queue_timeout)
    d["ttft_timeout"] = _remaining(request._ttft_deadline, request.ttft_timeout)
    d["total_timeout"] = _remaining(request._deadline, request.total_timeout)
    d["ship_to"] = request._ship_to
    # the group's post-ship marker: the decode worker's admission judges
    # the ship's outcome (hit or recompute) from it
    d["shipped"] = bool(request._shipped)
    return d


def _req_from_wire(d: dict):
    from ..llm.engine import GenRequest

    bias = d.get("logit_bias")
    request = GenRequest(
        prompt_ids=[int(t) for t in d["prompt_ids"]],
        logit_bias={int(k): float(v) for k, v in bias.items()} if bias else None,
        queue_timeout=d.get("queue_timeout"),
        ttft_timeout=d.get("ttft_timeout"),
        total_timeout=d.get("total_timeout"),
        **{f: d.get(f) for f in _REQ_FIELDS if f in d},
    )
    request._ship_to = d.get("ship_to")
    request._shipped = bool(d.get("shipped"))
    return request


# -- parent-side channels ----------------------------------------------------------------


class _AsyncChannel:
    """Parent half of the id-multiplexed channel. A daemon reader thread
    demultiplexes reply frames into per-call queues; consumers poll them
    from whatever event loop is current (``asyncio.to_thread``). Channel
    death fails every outstanding call with ``EngineUnavailableError``; the
    group's failover then resumes the streams on a sibling."""

    def __init__(self, sock: socket.socket, name: str):
        self._sock = sock
        self._name = name
        self._send_lock = threading.Lock()
        self._calls_lock = threading.Lock()
        self._calls: Dict[int, "_queue.Queue"] = {}
        self._ids = itertools.count(1)
        self.dead = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="proc-replica-{}-reader".format(name))
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            frame = _recv_frame_sock(self._sock)
            if frame is None:
                break
            with self._calls_lock:
                q = self._calls.get(frame.get("id"))
            if q is not None:
                q.put(frame)
        self.dead = True
        with self._calls_lock:
            pending = list(self._calls.values())
        fail = {"err": {"name": "EngineUnavailableError",
                        "message": "worker control channel lost"}}
        for q in pending:
            q.put(dict(fail))

    def submit(self, op: str, **fields) -> Tuple[int, "_queue.Queue"]:
        if self.dead:
            raise EngineUnavailableError(
                "replica {} worker control channel lost".format(self._name))
        fid = next(self._ids)
        q: "_queue.Queue" = _queue.Queue()
        with self._calls_lock:
            self._calls[fid] = q
        try:
            with self._send_lock:
                _send_frame_sock(self._sock, {"id": fid, "op": op, **fields})
        except OSError:
            self.dead = True
            with self._calls_lock:
                self._calls.pop(fid, None)
            raise EngineUnavailableError(
                "replica {} worker control channel lost".format(self._name))
        return fid, q

    def finish(self, fid: int) -> None:
        with self._calls_lock:
            self._calls.pop(fid, None)

    def notify(self, op: str, **fields) -> None:
        """Fire-and-forget (cancel/exit): a send error only marks the
        channel dead; the supervisor owns escalation."""
        try:
            with self._send_lock:
                _send_frame_sock(self._sock, {"op": op, **fields})
        except OSError:
            self.dead = True

    def call_blocking(self, op: str, timeout: float, **fields) -> dict:
        fid, q = self.submit(op, **fields)
        try:
            frame = q.get(True, timeout)
        except _queue.Empty:
            raise EngineUnavailableError("replica {} worker {} timed out after {:.1f}s".format(
                self._name, op, timeout))
        finally:
            self.finish(fid)
        if "err" in frame:
            raise _err_from_dict(frame["err"])
        return frame

    async def call(self, op: str, timeout: float, **fields) -> dict:
        return await asyncio.to_thread(self.call_blocking, op, timeout, **fields)

    def close(self) -> None:
        self.dead = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


class _SyncChannel:
    """Parent half of the blocking request/reply channel: one call at a
    time (the serving loop's pre-admission checks, receive calls and the
    Prometheus scrape thread share it)."""

    def __init__(self, sock: socket.socket, name: str):
        self._sync_lock = threading.Lock()
        self._sync_sock: Optional[socket.socket] = sock
        self._name = name
        self.dead = False

    def call(self, op: str, timeout: float = _SYNC_CALL_TIMEOUT, **fields) -> dict:
        with self._sync_lock:
            sock = self._sync_sock
            if self.dead or sock is None:
                raise EngineUnavailableError(
                    "replica {} worker sync channel lost".format(self._name))
            try:
                sock.settimeout(timeout)
                _send_frame_sock(sock, {"id": 0, "op": op, **fields})
                frame = _recv_frame_sock(sock)
            except OSError:
                frame = None
            if frame is None:
                self.dead = True
                try:
                    sock.close()
                except OSError:
                    pass
                self._sync_sock = None
                raise EngineUnavailableError(
                    "replica {} worker sync channel lost during {}".format(self._name, op))
        if "err" in frame:
            raise _err_from_dict(frame["err"])
        return frame

    def close(self) -> None:
        with self._sync_lock:
            self.dead = True
            if self._sync_sock is not None:
                try:
                    self._sync_sock.close()
                except OSError:
                    pass
                self._sync_sock = None


class ProcessFleetControl:
    """The parent's control listener: workers connect back to it twice
    (async and sync channel), name themselves in one handshake frame, and
    ``wait_for`` hands the paired sockets to the owning replica. The accept
    loop runs for the fleet's life: a restarted worker handshakes through
    the same path."""

    def __init__(self, base_dir: str):
        self.path = os.path.join(base_dir, "control.sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.path)
        self._listener.listen(32)
        self._cond = threading.Condition()
        self._pending: Dict[str, Dict[str, Tuple[socket.socket, dict]]] = {}
        self._closing = False
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True,
                                               name="proc-fleet-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # the handshake frame is the first thing a worker writes
            conn.settimeout(30.0)
            frame = _recv_frame_sock(conn)
            if (not frame or frame.get("channel") not in ("sync", "async")
                    or not frame.get("name")):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            conn.settimeout(None)
            with self._cond:
                slot = self._pending.setdefault(str(frame["name"]), {})
                slot[str(frame["channel"])] = (conn, frame)
                self._cond.notify_all()

    def wait_for(self, name: str, timeout: float) -> Dict[str, Tuple[socket.socket, dict]]:
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                slot = self._pending.get(name)
                if slot and "sync" in slot and "async" in slot:
                    return self._pending.pop(name)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or self._closing:
                    raise EngineUnavailableError(
                        "replica {} worker did not handshake within {:.0f}s".format(
                            name, timeout))
                self._cond.wait(min(remaining, 1.0))

    def close(self) -> None:
        with self._cond:
            self._closing = True
            self._cond.notify_all()
            leftovers = list(self._pending.values())
            self._pending.clear()
        try:
            self._listener.close()
        except OSError:
            pass
        try:
            os.unlink(self.path)
        except OSError:
            pass
        for slot in leftovers:
            for sock, _ in slot.values():
                try:
                    sock.close()
                except OSError:
                    pass


# -- the engine proxy ---------------------------------------------------------------------


class _QueueDepthShim:
    """Duck-typed ``engine._pending``: the router reads ``qsize()`` only."""

    def __init__(self, proxy: "ProcessEngineProxy"):
        self._proxy = proxy

    def qsize(self) -> int:
        return int(self._proxy._stats.get("queue_depth", 0))


class _PrefixProbe:
    """Duck-typed ``engine._prefix`` for the group's disaggregation
    preamble: ``block``/``longest_prefix_len`` are the radix cache's config
    math, ``match_len`` is a sync call; a lost channel reads as a cold
    cache (0), which degrades to recompute."""

    def __init__(self, proxy: "ProcessEngineProxy", block: int):
        self._proxy = proxy
        self.block = int(block)

    def longest_prefix_len(self, n_tokens: int) -> int:
        return ((int(n_tokens) - 1) // self.block) * self.block

    def match_len(self, ids, lora: int = 0) -> int:
        try:
            frame = self._proxy._require_sync().call(
                "match_len", ids=[int(t) for t in ids], lora=int(lora))
            return int(frame.get("n", 0))
        except Exception:  # an unreachable worker ships nothing and recomputes
            return 0


class _ModelShim:
    """The slice of ``engine.model`` the serving front reads through the
    group (the vocabulary's size for token-id range checks, the depth);
    the real model stays in the worker."""

    def __init__(self, hello: dict):
        self.vocab_size = int(hello.get("vocab_size", 0))
        self.n_layers = int(hello.get("n_layers", 0))


class _PagedMarker:
    """Truthy stand-in for ``engine.paged_cache`` in the parent: the group
    and the router only None-check it; the pool lives in the worker."""

    pool = None

    def __bool__(self) -> bool:
        return True


class ProcessEngineProxy:
    """The engine surface ``EngineReplica``, the group and the router
    consume, served over the worker's control channels. Built cold;
    ``attach`` wires the channels and the hello after the handshake."""

    # a stopped proxy has no loop task here: the eviction stops the group
    # at once (stop() reaps every worker)
    _loop_task = None
    _watchdog_task = None

    def __init__(self, name: str, spec: dict):
        self.replica_id = name
        self._name = name
        self._spec = spec
        self._sync: Optional[_SyncChannel] = None
        self._async: Optional[_AsyncChannel] = None
        self._hello: dict = {}
        self._stats: dict = {}
        self._alive = False
        self._stopped = False
        self._pending = _QueueDepthShim(self)
        self._prefix: Optional[_PrefixProbe] = None
        self.paged_cache = None
        self.max_seq_len = 0
        self.max_batch = 0
        self.logprobs_k = 0
        self.max_pending: Optional[int] = None
        self.pid: Optional[int] = None
        self.model: Optional[_ModelShim] = None

    # -- wiring ---------------------------------------------------------------

    def attach(self, sync_chan: _SyncChannel, async_chan: _AsyncChannel, hello: dict) -> None:
        self._sync = sync_chan
        self._async = async_chan
        self._hello = dict(hello)
        self.max_seq_len = int(hello.get("max_seq_len", 0))
        self.max_batch = int(hello.get("max_batch", 0))
        self.logprobs_k = int(hello.get("logprobs_k", 0))
        self.max_pending = hello.get("max_pending")
        block = hello.get("prefix_block")
        self._prefix = _PrefixProbe(self, int(block)) if block else None
        self.paged_cache = _PagedMarker() if hello.get("paged") else None
        self.model = _ModelShim(hello)
        self.pid = hello.get("pid")
        self._stats = {}
        self._alive = True

    def _require_sync(self) -> _SyncChannel:
        chan = self._sync
        if chan is None:
            raise EngineUnavailableError("replica {} worker is not connected".format(self._name))
        return chan

    def _require_async(self) -> _AsyncChannel:
        chan = self._async
        if chan is None:
            raise EngineUnavailableError("replica {} worker is not connected".format(self._name))
        return chan

    def _note_pong(self, pong: dict) -> None:
        self._stats = dict(pong)
        self._alive = True

    # -- readiness and the router's state -------------------------------------

    @property
    def is_ready(self) -> bool:
        chan = self._async
        return not self._stopped and self._alive and chan is not None and not chan.dead

    @property
    def active_slots(self) -> int:
        return int(self._stats.get("active_slots", 0))

    def _brownout_snapshot(self) -> dict:
        return {"stage": int(self._stats.get("brownout_stage", 0))}

    # -- request path -----------------------------------------------------------

    def validate(self, request) -> None:
        payload = _req_to_wire(request)  # raises the named guided error
        self._require_sync().call("validate", req=payload)

    def check_admission(self, request, reserve: int = 0) -> None:
        payload = _req_to_wire(request)
        self._require_sync().call("check_admission", req=payload, reserve=int(reserve))

    async def generate(self, request) -> AsyncIterator[int]:
        payload = _req_to_wire(request)
        chan = self._require_async()
        fid, q = chan.submit("generate", req=payload)
        request.prompt_len = len(request.prompt_ids)
        cancel_sent = False
        finished = False
        try:
            while True:
                try:
                    frame = await asyncio.to_thread(q.get, True, 0.5)
                except _queue.Empty:
                    if request.cancelled and not cancel_sent:
                        chan.notify("cancel", gen=fid)
                        cancel_sent = True
                    if chan.dead:
                        finished = True
                        raise EngineUnavailableError(
                            "replica {} worker lost mid-stream".format(self._name))
                    continue
                if "tok" in frame:
                    if frame.get("first"):
                        request.first_token_at = time.time()
                    if "lp" in frame:
                        # entry i before token i, as the engine's contract
                        request.logprob_entries.append(frame["lp"])
                    request.produced += 1
                    yield int(frame["tok"])
                elif "end" in frame:
                    end = frame.get("end") or {}
                    request.produced = int(end.get("produced", request.produced))
                    finished = True
                    return
                elif "err" in frame:
                    finished = True
                    raise _err_from_dict(frame["err"])
        finally:
            chan.finish(fid)
            if not finished and not cancel_sent:
                # the consumer stopped early: free the worker's slot and KV
                # pages promptly, as request.cancel does
                chan.notify("cancel", gen=fid)

    def receive_shipment(self, prompt_ids, lora: int = 0) -> dict:
        try:
            frame = self._require_sync().call(
                "receive_shipment", ids=[int(t) for t in prompt_ids], lora=int(lora))
            return dict(frame.get("result") or {})
        except EngineUnavailableError as ex:
            # the group treats a failed receive as re-route-or-recompute; a
            # dead worker degrades the same way
            return {"status": "failed", "reason": str(ex)}

    def score_prompt(self, prompt_ids):
        frame = self._require_sync().call("score_prompt", ids=[int(t) for t in prompt_ids])
        return frame.get("result")

    # -- lifecycle -----------------------------------------------------------------

    async def warmup_rpc(self, full: bool = False) -> dict:
        frame = await self._require_async().call("warmup", timeout=900.0, full=bool(full))
        return dict(frame.get("result") or {})

    async def wait_drained(self, timeout: float = 30.0) -> None:
        chan = self._async
        if chan is None or chan.dead:
            return
        try:
            await chan.call("drain", timeout=timeout + 10.0, timeout_s=timeout)
        except EngineUnavailableError:
            return

    async def stop_when_idle(self) -> None:
        await self.wait_drained()
        self.stop()

    def stop(self) -> None:
        self._stopped = True
        chan = self._async
        if chan is not None and not chan.dead:
            chan.notify("exit")

    # -- observability --------------------------------------------------------------

    def launch_counts(self, reset: bool = False) -> dict:
        """The worker's kernel launch counts (its wrappers' ``launches``);
        ``reset`` zeroes them and the engine's counters after reading."""
        frame = self._require_sync().call("launches", reset=bool(reset))
        return dict(frame.get("launches") or {})

    def device_memory(self) -> dict:
        """The worker's ``memory_allocated`` and ``memory_reserved`` on its
        card (empty on the CPU)."""
        frame = self._require_sync().call("memory")
        return dict(frame.get("memory") or {})

    def _process_block(self) -> dict:
        return {
            "backend": "process",
            "pid": self.pid,
            "alive": self._alive,
            "heartbeat": dict(self._stats),
        }

    def health(self) -> dict:
        try:
            frame = self._require_sync().call("health")
            out = dict(frame.get("health") or {})
        except Exception as ex:  # a dead worker still gets a health row: the row IS the diagnostic
            out = {"ready": False, "error": str(ex)}
        out["process"] = self._process_block()
        return out

    def lifecycle_stats(self) -> dict:
        try:
            frame = self._require_sync().call("lifecycle")
            out = dict(frame.get("stats") or {})
        except Exception:  # scrape path: a dead worker exports an empty block
            out = {}
        out["process"] = self._process_block()
        return out


# -- the supervised replica -------------------------------------------------------------


class _ReplicaShim:
    """Fault-match carrier for the ``replica.proc.crash`` seam: the
    supervisor has no request in hand, so the replica INDEX rides as the
    shim prompt (the router ejection seam's convention)."""

    def __init__(self, index: int):
        self.prompt_ids = [int(index)]


class ProcessEngineReplica:
    """An ``EngineReplica``-shaped ring member whose engine is a supervised
    worker subprocess. It does not subclass ``EngineReplica``: the surface
    is small and duck-typed everywhere (the router and the group read
    properties only), and ``tests/test_torch_process_replica.py`` pins it."""

    def __init__(
        self,
        index: int,
        spec: dict,
        control: ProcessFleetControl,
        *,
        warmup_mode: str = "off",
        heartbeat_interval: float = 0.5,
        heartbeat_misses: int = 4,
        max_restarts: int = 1,
        startup_timeout: float = _DEFAULT_STARTUP_TIMEOUT,
    ):
        if warmup_mode not in ("off", "startup", "full"):
            raise ValueError(
                "replica warmup mode must be off/startup/full: got {!r}".format(warmup_mode))
        self.index = int(index)
        self.name = "r{}".format(index)
        if spec.get("name") != self.name:
            raise ValueError("worker spec name {!r} does not match ring slot {!r}".format(
                spec.get("name"), self.name))
        self._spec = dict(spec)
        self._control = control
        self._warmup_mode = warmup_mode
        self.warmed = warmup_mode == "off"
        self.warm_result = {"requests": 0, "graph_captures": 0}
        # the seconds each sweep of the gate took (the first at startup,
        # then one per re-admission)
        self.warm_seconds: List[float] = []
        self._warm_task: Optional[asyncio.Task] = None
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None
        self._restarts_left = int(max_restarts)
        self._hb_misses = 0
        self._hb_interval = float(heartbeat_interval)
        self._hb_limit = int(heartbeat_misses)
        self._startup_timeout = float(startup_timeout)
        self.restarts = 0
        # the longest heartbeat round trip (ms) of each worker incarnation
        self.ping_ms_max: List[float] = [0.0]
        self.engine = ProcessEngineProxy(self.name, self._spec)
        self._supervisor: Optional[threading.Thread] = None
        self._spawn()

    # -- the process ------------------------------------------------------------------

    def _spawn(self) -> None:
        env = dict(os.environ)
        env.update({str(k): str(v) for k, v in (self._spec.get("env") or {}).items()})
        # the package need not be installed: its checkout is on the path
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_PARENT, env.get("PYTHONPATH", "")) if p)
        proc = subprocess.Popen(
            [sys.executable, "-m", "clearml_serving_tpu_torch.serving.process_replica",
             "--spec", self._spec["spec_path"]],
            env=env, stdin=subprocess.DEVNULL, stdout=2,
        )
        if _ledger.armed():
            _ledger.acquire("replica.worker_proc", key=self.name, domain=self)
        with self._lock:
            self._proc = proc

    def complete_startup(self) -> None:
        """Block until the worker handshakes, then start supervision. Apart
        from ``__init__`` so that ``build_process_fleet`` spawns every worker first
        and their bootstraps overlap."""
        self._attach_worker()
        self._supervisor = threading.Thread(
            target=self._supervise, daemon=True,
            name="proc-replica-{}-supervisor".format(self.name))
        self._supervisor.start()

    def _attach_worker(self) -> None:
        # a chunked wait, so that a worker that dies during its bootstrap
        # fails the fleet's build in about a second, not at the startup timeout
        deadline = time.monotonic() + self._startup_timeout
        while True:
            with self._lock:
                proc = self._proc
            if proc is not None and proc.poll() is not None:
                raise EngineUnavailableError(
                    "replica {} worker exited with rc={} before handshaking".format(
                        self.name, proc.returncode))
            remaining = max(0.001, deadline - time.monotonic())
            try:
                slot = self._control.wait_for(self.name, min(1.0, remaining))
                break
            except EngineUnavailableError:
                if deadline - time.monotonic() <= 0:
                    raise
        sync_sock, _ = slot["sync"]
        async_sock, aframe = slot["async"]
        self.engine.attach(_SyncChannel(sync_sock, self.name),
                           _AsyncChannel(async_sock, self.name), aframe.get("hello") or {})

    def _reap(self) -> None:
        with self._lock:
            proc = self._proc
            self._proc = None
        for chan in (self.engine._sync, self.engine._async):
            if chan is not None:
                chan.close()
        if proc is None:
            return
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        if _ledger.armed():
            _ledger.release("replica.worker_proc", key=self.name, domain=self)

    def _supervise(self) -> None:
        """Heartbeat and crash supervision (a daemon thread): liveness feeds
        ``is_ready`` (the router's ejection input), a dead or wedged worker
        gets the bounded restart with re-warm, and the
        ``replica.proc.crash`` seam SIGKILLs for real."""
        while True:
            time.sleep(self._hb_interval)
            if self.engine._stopped:
                self._shutdown_worker()
                return
            with self._lock:
                proc = self._proc
            if proc is not None and proc.poll() is not None:
                if not self._maybe_restart("exit code {}".format(proc.returncode)):
                    return
                continue
            try:
                faults.fire("replica.proc.crash", _ReplicaShim(self.index))
            except faults.InjectedFault:
                logger.warning("replica %s: injected crash, SIGKILLing worker pid %s",
                               self.name, self.engine.pid)
                if proc is not None and proc.poll() is None:
                    proc.kill()
                continue  # the next tick takes the dead-process branch
            chan = self.engine._async
            if chan is None or chan.dead:
                self._hb_misses += 1
            else:
                t0 = time.perf_counter()
                try:
                    frame = chan.call_blocking("ping", timeout=max(2.0, 4 * self._hb_interval))
                except Exception:  # a failed ping IS the signal: counted against the budget
                    self._hb_misses += 1
                else:
                    ms = (time.perf_counter() - t0) * 1e3
                    self.ping_ms_max[-1] = max(self.ping_ms_max[-1], ms)
                    self.engine._note_pong(frame.get("pong") or {})
                    self._hb_misses = 0
                    continue
            if self._hb_misses >= self._hb_limit:
                self.engine._alive = False
                if proc is not None and proc.poll() is None:
                    logger.error("replica %s: %d missed heartbeats, killing wedged worker "
                                 "pid %s", self.name, self._hb_misses, self.engine.pid)
                    proc.kill()
                if not self._maybe_restart("missed heartbeats"):
                    return

    def _maybe_restart(self, why: str) -> bool:
        """Bounded restart with re-warm. Returns False when supervision ends
        (budget spent, stop asked, restart failed): the proxy stays not
        ready and the router keeps the slot ejected."""
        self.engine._alive = False
        self._reap()
        if self.engine._stopped:
            return False
        with self._lock:
            budget = self._restarts_left
            if budget > 0:
                self._restarts_left = budget - 1
        if budget <= 0:
            logger.error("replica %s worker died (%s); restart budget spent: ejected for good",
                         self.name, why)
            return False
        logger.warning("replica %s worker died (%s); restarting (%d restart(s) left)",
                       self.name, why, budget - 1)
        # the warmup gate closes BEFORE the new worker serves: re-admission
        # to the ring runs the same gate as the first entry
        self.invalidate_warm()
        try:
            self._spawn()
            self._attach_worker()
        except Exception as ex:  # a failed restart ends supervision, the slot ejected
            logger.error("replica %s restart failed: %s", self.name, ex)
            return False
        self._hb_misses = 0
        self.ping_ms_max.append(0.0)
        self.restarts += 1
        return True

    def _shutdown_worker(self) -> None:
        with self._lock:
            proc = self._proc
        if proc is not None:
            try:
                proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                proc.terminate()
        self._reap()

    # -- the EngineReplica surface (the router and the group) -----------------------

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

    def invalidate_warm(self) -> None:
        if self._warmup_mode != "off":
            self.warmed = False

    def begin_warm(self) -> None:
        if self.warmed or self.warming or not self.engine_ready:
            return
        if self._warmup_mode == "off":
            self.warmed = True
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        self._warm_task = loop.create_task(self.ensure_warm(self._warmup_mode == "full"))

    async def ensure_warm(self, full: bool) -> None:
        """The warmup gate over the channel: the worker runs the engine's
        warmup sweep (``full``: the full one); the gate's state machine here
        is ``EngineReplica``'s."""
        t0 = time.perf_counter()
        try:
            self.warm_result = await self.engine.warmup_rpc(full=full)
        except Exception as ex:  # best-effort: a variant not captured is captured at first use
            logger.warning("replica %s process warmup failed (will capture at first use): %s",
                           self.name, ex)
        self.warm_seconds.append(time.perf_counter() - t0)
        self.warmed = True

    def health(self) -> dict:
        out = self.engine.health()
        out["process"]["restarts"] = self.restarts
        out["replica"] = self.name
        out["ring_state"] = (
            "ready" if self.serving_ready else ("warming" if self.warming else "ejected"))
        return out


# -- fleet construction -------------------------------------------------------------------


class _FleetRuntime:
    """What the parent tears down after the workers: the control listener,
    the supervisor threads, and the socket, spec and weights directory."""

    def __init__(self, base_dir: str, control: ProcessFleetControl,
                 replicas: List[ProcessEngineReplica]):
        self.base_dir = base_dir
        self.control = control
        self.replicas = replicas

    def close(self) -> None:
        # the group stopped every proxy: each supervisor reaps its worker
        deadline = time.monotonic() + 20.0
        for replica in self.replicas:
            thread = replica._supervisor
            if thread is not None and thread.is_alive():
                thread.join(timeout=max(0.1, deadline - time.monotonic()))
            # a supervisor that already ended (its restart budget spent)
            # leaves the reap to us
            replica._reap()
        self.control.close()
        shutil.rmtree(self.base_dir, ignore_errors=True)


def build_process_fleet(
    model: dict,
    engine_cfg: dict,
    n_replicas: int,
    *,
    roles: Optional[List[str]] = None,
    warmup_mode: str = "startup",
    affinity_blocks: int = 4,
    spill_queue_depth: Optional[int] = None,
    spill_brownout_stage: int = 2,
    fleet_shed_stage: int = 3,
    kv_transport_pages: Optional[int] = None,
    device: str = "cuda",
    params: Optional[Dict[str, Any]] = None,
    heartbeat_interval: float = 0.5,
    heartbeat_misses: int = 4,
    max_restarts: int = 1,
    startup_timeout: float = _DEFAULT_STARTUP_TIMEOUT,
    env: Optional[dict] = None,
):
    """A ``ReplicaGroup`` whose members are worker subprocesses.

    ``model`` is what each worker builds its model from (``{"config",
    "seed", "weight_quant"}``; ``config`` a preset config, resolved in the
    worker): the same seed on the same kind of device gives every worker
    the same weights. ``params`` (``convert_params``/``init_params``
    output) is instead written once into the fleet's directory and loaded
    by every worker. ``engine_cfg`` is the JSON-safe ``LLMEngineCore``
    kwargs. ``device`` is each worker's (``"cuda"`` unless the caller
    names the CPU). Disaggregated ``roles`` wire the workers' KV endpoints
    together over the socket transport (``llm/kv_wire.py``), with the
    in-process fleet's ship and receive seams and mailbox semantics."""
    from ..llm.replica import ReplicaGroup

    n_replicas = int(n_replicas)
    if n_replicas < 1:
        raise ValueError("a process fleet needs at least one replica")
    if roles is not None and len(roles) != n_replicas:
        raise ValueError("engine.replica_roles lists {} roles for {} replicas".format(
            len(roles), n_replicas))
    names = ["r{}".format(i) for i in range(n_replicas)]
    base_dir = tempfile.mkdtemp(prefix="tpuserve-proc-")
    replicas: List[ProcessEngineReplica] = []
    control = None
    try:
        control = ProcessFleetControl(base_dir)
        model = dict(model)
        if params is not None:
            import torch

            path = os.path.join(base_dir, "weights.pt")
            torch.save(params, path)
            model["weights"] = path
        disaggregated = roles is not None and any(r != "hybrid" for r in roles)
        wire_addrs: Dict[str, str] = {}
        wire_capacity = 0
        if disaggregated:
            page_size = int(engine_cfg.get("page_size") or 16)
            per_seq = -(-int(engine_cfg.get("max_seq_len", 2048)) // page_size)
            wire_capacity = int(kv_transport_pages or max(64, 4 * per_seq))
            wire_addrs = {name: "unix:{}".format(os.path.join(base_dir, name + ".kv.sock"))
                          for name in names}
        for i, name in enumerate(names):
            spec = {
                "name": name,
                "index": i,
                "role": roles[i] if roles is not None else "hybrid",
                "control": control.path,
                "cohosted_procs": n_replicas,
                "device": str(device),
                "model": model,
                "engine": dict(engine_cfg),
                "kv_wire": ({"bind": wire_addrs[name], "peers": wire_addrs,
                             "capacity_pages": wire_capacity} if disaggregated else None),
                "env": dict(env or {}),
            }
            path = os.path.join(base_dir, name + ".spec.json")
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(spec, fh)
            spec["spec_path"] = path
            replicas.append(ProcessEngineReplica(
                i, spec, control, warmup_mode=warmup_mode,
                heartbeat_interval=heartbeat_interval, heartbeat_misses=heartbeat_misses,
                max_restarts=max_restarts, startup_timeout=startup_timeout))
        # every worker boots at once; the handshakes complete in ring order
        for replica in replicas:
            replica.complete_startup()
    except BaseException:
        for replica in replicas:
            replica.engine._stopped = True
            replica._reap()
        if control is not None:
            control.close()
        shutil.rmtree(base_dir, ignore_errors=True)
        raise
    hello = replicas[0].engine._hello
    role_map = {name: role for name, role in zip(names, roles)} if roles is not None else None
    group = ReplicaGroup.__new__(ReplicaGroup)
    group._finish_init(
        replicas,
        block=int(hello.get("prefix_block") or 64),
        role_map=role_map,
        disaggregated=disaggregated,
        transport=None,  # the workers own their socket endpoints
        spill_queue_depth=spill_queue_depth,
        spill_brownout_stage=spill_brownout_stage,
        fleet_shed_stage=fleet_shed_stage,
        affinity_blocks=affinity_blocks,
        replica_backend="process",
        max_pending_hint=hello.get("max_pending"),
        runtime=_FleetRuntime(base_dir, control, replicas),
    )
    return group


# =========================================================================================
# worker side
# =========================================================================================


def _worker_hello(engine) -> dict:
    prefix = getattr(engine, "_prefix", None)
    return {
        "pid": os.getpid(),
        "device": str(engine.device),
        "vocab_size": int(engine.model.vocab_size),
        "n_layers": int(engine.model.n_layers),
        "max_seq_len": int(engine.max_seq_len),
        "max_batch": int(engine.max_batch),
        "logprobs_k": int(engine.logprobs_k),
        "max_pending": engine.max_pending,
        "prefix_block": int(prefix.block) if prefix is not None else None,
        "paged": engine.paged_cache is not None,
    }


def _on_loop(loop, fn, *args):
    """``fn(*args)`` on the worker's event loop (the engine's loop thread),
    waited for from the sync channel's thread."""
    async def call():
        return fn(*args)

    return asyncio.run_coroutine_threadsafe(call(), loop).result(timeout=_SYNC_CALL_TIMEOUT)


def _launch_counts(engine, reset: bool) -> dict:
    from ..ops.fused_matmul import fused_int4_matmul
    from ..ops.paged_attention import paged_attention, ragged_paged_attention

    out = {"paged": paged_attention.launches, "ragged": ragged_paged_attention.launches,
           "tree": ragged_paged_attention.tree_launches, "int4": fused_int4_matmul.launches}
    if reset:
        paged_attention.launches = ragged_paged_attention.launches = 0
        ragged_paged_attention.tree_launches = fused_int4_matmul.launches = 0
        for key, value in engine.counters.items():
            engine.counters[key] = 0 if isinstance(value, int) else 0.0
    return out


def _sync_dispatch(engine, frame: dict, loop) -> dict:
    """One sync-channel call against the live engine."""
    op = frame.get("op")
    if op == "check_admission":
        request = _req_from_wire(frame["req"])
        _on_loop(loop, engine.check_admission, request, int(frame.get("reserve", 0)))
        return {"ok": 1}
    if op == "validate":
        _on_loop(loop, engine.validate, _req_from_wire(frame["req"]))
        return {"ok": 1}
    if op == "match_len":
        prefix = getattr(engine, "_prefix", None)
        n = 0
        if prefix is not None:
            n = _on_loop(loop, prefix.match_len, [int(t) for t in frame.get("ids") or []],
                         int(frame.get("lora", 0)))
        return {"n": int(n)}
    if op == "receive_shipment":
        res = _on_loop(loop, engine.receive_shipment, [int(t) for t in frame.get("ids") or []],
                       int(frame.get("lora", 0)))
        return {"result": _jsonable(res)}
    if op == "health":
        return {"health": _jsonable(engine.health())}
    if op == "lifecycle":
        return {"stats": _jsonable(engine.lifecycle_stats())}
    if op == "score_prompt":
        return {"result": _jsonable(engine.score_prompt(
            [int(t) for t in frame.get("ids") or []]))}
    if op == "launches":
        return {"launches": _launch_counts(engine, bool(frame.get("reset")))}
    if op == "memory":
        if engine.device.type != "cuda":
            return {"memory": {}}
        import torch

        return {"memory": {"allocated": torch.cuda.memory_allocated(engine.device),
                           "reserved": torch.cuda.memory_reserved(engine.device)}}
    raise ValueError("unknown sync op {!r}".format(op))


def _sync_serve(engine, sock: socket.socket, loop) -> None:
    while True:
        frame = _recv_frame_sock(sock)
        if frame is None:
            return
        try:
            out = _sync_dispatch(engine, frame, loop)
        except BaseException as ex:  # noqa: BLE001 - every error crosses the wire by name
            out = {"err": _err_to_dict(ex)}
        out["id"] = frame.get("id", 0)
        try:
            _send_frame_sock(sock, out)
        except OSError:
            return


async def _recv_frame_stream(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        head = await reader.readexactly(4)
        (length,) = struct.unpack("<I", head)
        body = await reader.readexactly(length)
    except (asyncio.IncompleteReadError, ConnectionError, OSError):
        return None
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        return None


async def _send_frame_stream(writer: asyncio.StreamWriter, wlock: asyncio.Lock,
                             obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    async with wlock:
        writer.write(struct.pack("<I", len(payload)) + payload)
        await writer.drain()


async def _gen_task(engine, writer, wlock, fid: int, payload: dict, live: dict) -> None:
    try:
        request = _req_from_wire(payload)
    except Exception as ex:  # noqa: BLE001 - a bad frame is the caller's error, on its id
        await _send_frame_stream(writer, wlock, {"id": fid, "err": _err_to_dict(ex)})
        return
    live[fid] = request
    try:
        n = 0
        async for token in engine.generate(request):
            frame = {"id": fid, "tok": int(token), "first": n == 0}
            if request.logprobs is not None and n < len(request.logprob_entries):
                # the engine appends entry i before it queues token i
                frame["lp"] = _jsonable(request.logprob_entries[n])
            await _send_frame_stream(writer, wlock, frame)
            n += 1
        end = {"produced": request.produced, "prompt_len": request.prompt_len}
        await _send_frame_stream(writer, wlock, {"id": fid, "end": end})
    except BaseException as ex:  # noqa: BLE001 - stream errors cross the wire by name
        try:
            await _send_frame_stream(writer, wlock, {"id": fid, "err": _err_to_dict(ex)})
        except (ConnectionError, OSError):
            pass
    finally:
        live.pop(fid, None)


async def _warmup_task(engine, writer, wlock, fid: int, full: bool) -> None:
    try:
        result = await engine.warmup(full=full)
        await _send_frame_stream(writer, wlock, {"id": fid, "result": _jsonable(result)})
    except BaseException as ex:  # noqa: BLE001 - the parent's gate logs and degrades
        await _send_frame_stream(writer, wlock, {"id": fid, "err": _err_to_dict(ex)})


async def _drain_task(engine, writer, wlock, fid: int, timeout: float) -> None:
    try:
        await engine.wait_drained(timeout=timeout)
        await _send_frame_stream(writer, wlock, {"id": fid, "ok": 1})
    except BaseException as ex:  # noqa: BLE001
        await _send_frame_stream(writer, wlock, {"id": fid, "err": _err_to_dict(ex)})


async def _worker_serve(engine, spec: dict) -> None:
    loop = asyncio.get_running_loop()
    control_path = spec["control"]
    reader, writer = await asyncio.open_unix_connection(control_path)
    wlock = asyncio.Lock()
    await _send_frame_stream(writer, wlock, {"channel": "async", "name": spec["name"],
                                             "hello": _worker_hello(engine)})
    sync_sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sync_sock.connect(control_path)
    _send_frame_sock(sync_sock, {"channel": "sync", "name": spec["name"]})
    threading.Thread(target=_sync_serve, args=(engine, sync_sock, loop), daemon=True,
                     name="worker-sync-serve").start()
    live: Dict[int, Any] = {}
    tasks = set()

    def spawn(coro) -> None:
        task = asyncio.ensure_future(coro)
        tasks.add(task)
        task.add_done_callback(tasks.discard)

    while True:
        frame = await _recv_frame_stream(reader)
        if frame is None:
            break  # the parent is gone: no orphaned decode loop
        op = frame.get("op")
        fid = frame.get("id")
        if op == "ping":
            snap = engine._brownout_snapshot()
            pong = {
                "ready": bool(engine.is_ready),
                "queue_depth": int(engine._pending.qsize()),
                "brownout_stage": int((snap or {}).get("stage", 0)),
                "active_slots": int(engine.active_slots),
            }
            await _send_frame_stream(writer, wlock, {"id": fid, "pong": pong})
        elif op == "generate":
            spawn(_gen_task(engine, writer, wlock, fid, frame.get("req") or {}, live))
        elif op == "cancel":
            request = live.get(frame.get("gen"))
            if request is not None:
                request.cancel()
        elif op == "warmup":
            spawn(_warmup_task(engine, writer, wlock, fid, bool(frame.get("full"))))
        elif op == "drain":
            spawn(_drain_task(engine, writer, wlock, fid, float(frame.get("timeout_s", 30.0))))
        elif op == "exit":
            break
        elif fid is not None:
            await _send_frame_stream(writer, wlock, {"id": fid, "err": {
                "name": "ValueError", "message": "unknown op {!r}".format(op)}})
    engine.stop()
    try:
        writer.close()
    except OSError:
        pass


def _build_worker_engine(spec: dict):
    """The worker's engine, as ``llm/openai_api.build_engine`` builds a
    single one: the model drawn from the seed on the spec's device (or
    loaded from the weights file the parent wrote), its tokenizer, and the
    JSON-safe kwargs."""
    import torch

    from ..device import resolve_device
    from ..llm.engine import LLMEngineCore
    from ..llm.openai_api import make_llama, make_tokenizer
    from ..models.llama import resolve_config

    dev = resolve_device(spec.get("device") or "cuda")
    if dev.type == "cuda":
        # the kernels build (or load) before the handshake, under the
        # build directory's lock, inside the startup budget
        from ..ops import _build

        _build.load_library()
    model = spec["model"]
    cfg = resolve_config(dict(model["config"]))
    params = None
    if model.get("weights"):
        params = torch.load(model["weights"], map_location=dev, weights_only=True)
    llama = make_llama(cfg, dev, int(model.get("seed", 0)), model.get("weight_quant"), params)
    return LLMEngineCore(llama, replica=spec["name"], tokenizer=make_tokenizer(cfg),
                         **dict(spec.get("engine") or {}))


def _worker_main(spec_path: str) -> int:
    with open(spec_path, "r", encoding="utf-8") as fh:
        spec = json.load(fh)
    for key, value in (spec.get("env") or {}).items():
        os.environ[str(key)] = str(value)
    # the host tier's "auto" size divides MemAvailable by the co-hosted
    # worker count
    os.environ.setdefault("TPUSERVE_COHOSTED_PROCS", str(spec.get("cohosted_procs", 1)))
    engine = _build_worker_engine(spec)
    wire = spec.get("kv_wire")
    role = spec.get("role", "hybrid")
    if wire:
        from ..llm.kv_wire import SocketSlabTransport

        endpoint = SocketSlabTransport(spec["name"], wire["bind"], dict(wire["peers"]),
                                       capacity_pages=int(wire.get("capacity_pages", 1024)))
        engine.attach_kv_transport(endpoint, role=role)
    elif role != "hybrid":
        engine.attach_kv_transport(None, role=role)
    asyncio.run(_worker_serve(engine, spec))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        description="tpu-serving-torch process-replica worker (spawned by "
                    "ProcessEngineReplica)")
    parser.add_argument("--spec", required=True, help="worker spec JSON path")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s worker %(name)s %(levelname)s %(message)s")
    return _worker_main(args.spec)


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: the engine's threads, pools and CUDA objects
    # go with the process
    os._exit(rc)
