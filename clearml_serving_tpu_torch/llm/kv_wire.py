"""Wire-format KV transport: KV shipments over real sockets.

The port's copy of ``clearml_serving_tpu/llm/kv_wire.py``. The in-process
:class:`~.kv_transport.SharedSlabTransport` moves :class:`~.kv_transport.KVShipment`
payloads between replicas by reference, which holds only while every replica
lives in one process. :class:`SocketSlabTransport` is the same
``TransportEndpoint`` surface over a real wire: it frames a shipment
(:func:`shipment_to_wire` / :func:`shipment_from_wire`) and pushes it over a
UNIX or TCP socket into the destination replica's bounded receive slab, so
disaggregated prefill/decode crosses process boundaries without the engine
or the router noticing.

Frame layout, the reference's byte for byte::

    [ u32 frame_len ][ b"KVW1" ][ u8 version ][ u8 flags ][ u16 hdr_len ]
    [ hdr_len bytes JSON header ][ body: hk | hv | hk_scale | hv_scale ]

The JSON header carries everything needed to validate BEFORE touching the
pool: content key, sender, geometry (prefix_len / page_size / lora), the
optional draft-ahead framing keys (``page_offset`` / ``final``, omitted for a
whole-prefix shipment) and one ``{dtype, shape}`` descriptor per body
section. The body is the raw page slabs as ``PagedKVCache.export_pages`` laid
them out: page-major ``[N, L, Hkv, P, D]`` int8/bf16 planes plus, on
quantized pools, the f32 scale rows. A tensor travels as its raw bytes
(``t.contiguous().view(torch.uint8)``) under the reference's dtype names, so
bf16 needs no numpy type. Decoding is ZERO-COPY: the receiver's tensors are
``torch.frombuffer`` views into the one received buffer.

Delivery contract (the in-process backend's, by construction: the receive
side IS a ``SharedSlabTransport`` mailbox):

- ``send`` is best-effort with a DEADLINE: connect/write/ack failures,
  timeouts, injected ``transport.wire.send`` faults and receiver-side decode
  failures (a nack) all drop the shipment, counted and never raised. The
  decode replica recomputes, as after an in-process drop.
- the receive slab keeps the mailbox semantics: overflow drops the OLDEST
  shipment, a re-ship of the same key replaces the stale payload, and
  ``recv`` is consume-once by content key.
- a truncated or garbled frame (``transport.wire.recv`` fault, partial
  write, geometry/dtype/key lies) is rejected by the frame validator before
  any attach: the named :class:`WireFormatError` drops it leak-free and the
  sender sees a nack.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from . import faults
from . import lifecycle_ledger as _ledger
from .kv_transport import KVShipment, SharedSlabTransport

logger = logging.getLogger(__name__)

MAGIC = b"KVW1"
WIRE_VERSION = 1
_FLAG_QUANTIZED = 0x01
# frames above this are rejected before allocation (a lying length prefix
# must not make the receiver allocate gigabytes)
MAX_FRAME_BYTES = 1 << 31

# wire dtype names (the reference's numpy names) <-> torch dtypes
_WIRE_DTYPES: Dict[str, torch.dtype] = {
    "int8": torch.int8,
    "uint8": torch.uint8,
    "float16": torch.float16,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}
_WIRE_NAMES = {dtype: name for name, dtype in _WIRE_DTYPES.items()}


class WireFormatError(ValueError):
    """A frame failed validation (truncated, bad magic/version, geometry/
    dtype/key inconsistency). Raised BEFORE any pool or cache attach, so
    dropping the frame is the complete cleanup: the receive path maps it to
    drop-to-recompute."""


def _dtype_name(dtype: torch.dtype) -> str:
    name = _WIRE_NAMES.get(dtype)
    if name is None:
        raise WireFormatError(
            "kv wire cannot carry dtype {!r} (supported: {})".format(
                str(dtype).replace("torch.", ""), ", ".join(sorted(_WIRE_DTYPES))
            )
        )
    return name


def shipment_to_wire(shipment: KVShipment) -> bytearray:
    """Encode a shipment into one self-validating frame (without the socket
    layer's u32 length prefix). The sections are copied once, straight into
    the frame's buffer."""
    sections: List[Tuple[str, torch.Tensor]] = [("hk", shipment.hk), ("hv", shipment.hv)]
    if shipment.quantized:
        sections += [("hk_scale", shipment.hk_scale), ("hv_scale", shipment.hv_scale)]
    header = {
        "key": shipment.key.hex(),
        "src": str(shipment.src),
        "prefix_len": int(shipment.prefix_len),
        "page_size": int(shipment.page_size),
        "lora": int(shipment.lora),
        "sections": [
            {"name": name, "dtype": _dtype_name(t.dtype), "shape": [int(d) for d in t.shape]}
            for name, t in sections
        ],
    }
    # draft-ahead framing: the keys are OMITTED for the whole-prefix
    # shipment, so its frame keeps the single-frame layout
    if shipment.page_offset or not shipment.final:
        header["page_offset"] = int(shipment.page_offset)
        header["final"] = bool(shipment.final)
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    flags = _FLAG_QUANTIZED if shipment.quantized else 0
    head = MAGIC + struct.pack("<BBH", WIRE_VERSION, flags, len(hdr)) + hdr
    sizes = [t.numel() * t.element_size() for _, t in sections]
    frame = bytearray(len(head) + sum(sizes))
    frame[:len(head)] = head
    offset = len(head)
    for (_, t), n in zip(sections, sizes):
        if n:
            dst = torch.frombuffer(frame, dtype=torch.uint8, count=n, offset=offset)
            dst.copy_(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8))
        offset += n
    return frame


def _view(buf, dtype: torch.dtype, offset: int, shape: Tuple[int, ...]) -> torch.Tensor:
    numel = 1
    for d in shape:
        numel *= d
    if numel == 0:
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        # a bytes frame is read-only: its views are only ever read
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(buf, dtype=torch.uint8, count=numel * _itemsize(dtype),
                                offset=offset)
    return flat.view(dtype).reshape(shape)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def shipment_from_wire(frame) -> KVShipment:
    """Decode and validate one frame into a shipment whose tensors are
    ZERO-COPY views into ``frame`` (a ``bytearray`` from the socket, or any
    bytes-like object). Every inconsistency (truncation, bad magic, unknown
    dtype, geometry that disagrees with itself or with the body length)
    raises :class:`WireFormatError` before anything is attached anywhere."""
    buf = memoryview(frame)
    if len(buf) < len(MAGIC) + 4:
        raise WireFormatError(
            "truncated kv wire frame ({} bytes: shorter than the fixed "
            "prefix)".format(len(buf))
        )
    if bytes(buf[:4]) != MAGIC:
        raise WireFormatError(
            "bad kv wire magic {!r} (want {!r})".format(bytes(buf[:4]), MAGIC)
        )
    version, flags, hdr_len = struct.unpack("<BBH", buf[4:8])
    if version != WIRE_VERSION:
        raise WireFormatError(
            "kv wire version {} unsupported (speak {})".format(version, WIRE_VERSION)
        )
    if len(buf) < 8 + hdr_len:
        raise WireFormatError(
            "truncated kv wire frame (header says {} bytes, {} remain)"
            .format(hdr_len, len(buf) - 8)
        )
    try:
        header = json.loads(bytes(buf[8:8 + hdr_len]).decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as ex:
        raise WireFormatError("unparseable kv wire header: {}".format(ex))
    try:
        key = bytes.fromhex(header["key"])
        src = str(header["src"])
        prefix_len = int(header["prefix_len"])
        page_size = int(header["page_size"])
        lora = int(header["lora"])
        page_offset = int(header.get("page_offset", 0))
        final = bool(header.get("final", True))
        sections = list(header["sections"])
    except (KeyError, TypeError, ValueError) as ex:
        raise WireFormatError("malformed kv wire header: {!r}".format(ex))
    if page_offset < 0:
        raise WireFormatError(
            "kv wire page_offset must be >= 0 (got {})".format(page_offset)
        )
    if len(key) != 16:
        raise WireFormatError(
            "kv wire content key must be 16 bytes (got {})".format(len(key))
        )
    want_names = ["hk", "hv"]
    if flags & _FLAG_QUANTIZED:
        want_names += ["hk_scale", "hv_scale"]
    if [s.get("name") for s in sections] != want_names:
        raise WireFormatError(
            "kv wire sections {} disagree with flags (want {})".format(
                [s.get("name") for s in sections], want_names
            )
        )
    tensors: Dict[str, torch.Tensor] = {}
    offset = 8 + hdr_len
    for sec in sections:
        dtype_name = str(sec.get("dtype"))
        if dtype_name not in _WIRE_DTYPES:
            raise WireFormatError(
                "kv wire dtype {!r} unsupported (supported: {})".format(
                    dtype_name, ", ".join(sorted(_WIRE_DTYPES))
                )
            )
        dtype = _WIRE_DTYPES[dtype_name]
        shape = tuple(int(d) for d in sec["shape"])
        if any(d < 0 for d in shape):
            raise WireFormatError(
                "kv wire section {!r} has a negative dim: {}".format(sec["name"], shape)
            )
        numel = 1
        for d in shape:
            numel *= d
        nbytes = numel * _itemsize(dtype)
        if offset + nbytes > len(buf):
            raise WireFormatError(
                "truncated kv wire frame (section {!r} wants {} bytes, "
                "{} remain)".format(sec["name"], nbytes, len(buf) - offset)
            )
        tensors[sec["name"]] = _view(frame, dtype, offset, shape)
        offset += nbytes
    if offset != len(buf):
        raise WireFormatError(
            "kv wire frame carries {} trailing bytes past its sections"
            .format(len(buf) - offset)
        )
    hk, hv = tensors["hk"], tensors["hv"]
    if hk.dim() != 5 or hk.shape != hv.shape:
        raise WireFormatError(
            "kv wire geometry mismatch: hk {} vs hv {} (want matching "
            "[N, L, Hkv, P, D])".format(tuple(hk.shape), tuple(hv.shape))
        )
    if hk.dtype != hv.dtype:
        raise WireFormatError(
            "kv wire dtype mismatch: hk {} vs hv {}".format(
                _WIRE_NAMES[hk.dtype], _WIRE_NAMES[hv.dtype]
            )
        )
    if hk.shape[3] != page_size:
        raise WireFormatError(
            "kv wire geometry mismatch: header page_size {} vs slab page "
            "dim {}".format(page_size, hk.shape[3])
        )
    pages = int(hk.shape[0])
    if pages < 1:
        raise WireFormatError("kv wire frame carries no pages (empty slab)")
    if final:
        # final frame: prefix_len is the AUTHORITATIVE full prefix and its
        # tail must land inside this frame's pages
        if not (page_offset * page_size < prefix_len <= (page_offset + pages) * page_size):
            raise WireFormatError(
                "kv wire geometry mismatch: prefix_len {} outside pages "
                "[{}, {}) x {} tokens".format(
                    prefix_len, page_offset, page_offset + pages, page_size
                )
            )
    elif prefix_len != (page_offset + pages) * page_size:
        # unsealed draft-ahead frame: covers WHOLE pages exactly
        raise WireFormatError(
            "kv wire geometry mismatch: partial frame prefix_len {} != "
            "({} + {} pages) x {} tokens".format(prefix_len, page_offset, pages, page_size)
        )
    hk_scale = hv_scale = None
    if flags & _FLAG_QUANTIZED:
        hk_scale, hv_scale = tensors["hk_scale"], tensors["hv_scale"]
        for name, scale in (("hk_scale", hk_scale), ("hv_scale", hv_scale)):
            if scale.shape != hk.shape[:4]:
                raise WireFormatError(
                    "kv wire geometry mismatch: {} {} vs page planes {}"
                    .format(name, tuple(scale.shape), tuple(hk.shape[:4]))
                )
            if scale.dtype != torch.float32:
                raise WireFormatError(
                    "kv wire scale rows must be float32 (got {} for {})"
                    .format(_WIRE_NAMES[scale.dtype], name)
                )
    return KVShipment(
        key=key, src=src, prefix_len=prefix_len, page_size=page_size,
        lora=lora, hk=hk, hv=hv, hk_scale=hk_scale, hv_scale=hv_scale,
        page_offset=page_offset, final=final,
    )


def _parse_addr(addr: str):
    """``unix:<path>`` or ``tcp:<host>:<port>`` -> (family, sockaddr)."""
    if addr.startswith("unix:"):
        return socket.AF_UNIX, addr[len("unix:"):]
    if addr.startswith("tcp:"):
        host, _, port = addr[len("tcp:"):].rpartition(":")
        return socket.AF_INET, (host or "127.0.0.1", int(port))
    raise ValueError(
        "kv wire address must be unix:<path> or tcp:<host>:<port>: got {!r}".format(addr)
    )


class _WireHistogram:
    """Fixed-bucket ms histogram in the engine's snapshot shape (``{buckets,
    counts, sum_ms, count}``), so ``statistics/metrics.py`` exports it like
    any other lifecycle histogram."""

    BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 100.0, 1000.0)

    def __init__(self):
        self.counts = [0] * (len(self.BUCKETS) + 1)
        self.total_ms = 0.0
        self.n = 0

    def observe(self, ms: float) -> None:
        for i, edge in enumerate(self.BUCKETS):
            if ms <= edge:
                break
        else:
            i = len(self.BUCKETS)
        self.counts[i] += 1
        self.total_ms += float(ms)
        self.n += 1

    def snapshot(self) -> dict:
        return {
            "buckets": list(self.BUCKETS),
            "counts": list(self.counts),
            "sum_ms": self.total_ms,
            "count": self.n,
        }


def _read_exact(conn: socket.socket, n: int) -> Optional[bytearray]:
    """``n`` bytes into one preallocated buffer, or None (end of file or
    a timeout mid-read: a truncated frame)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = conn.recv_into(view[got:], min(1 << 22, n - got))
        except (socket.timeout, OSError):
            return None
        if not k:
            return None
        got += k
    return buf


class SocketSlabTransport:
    """One replica's socket-backed ``TransportEndpoint``: a listener thread
    feeds decoded frames into a local :class:`SharedSlabTransport` mailbox
    (so every bounded-slab semantic, overflow drops oldest, re-ship
    replaces, consume-once recv, ledger pairing, is the SAME CODE as the
    in-process backend), and ``send`` frames shipments to a peer's listener
    with a deadline and a one-byte ack.

    ``peers`` is a live name -> address map shared with the fabric (or the
    process replica's spec): destinations registered after this endpoint
    are visible at send time."""

    def __init__(
        self,
        name: str,
        bind: str,
        peers: Dict[str, str],
        *,
        capacity_pages: int = 1024,
        max_shipments: int = 64,
        send_deadline_s: float = 5.0,
        recv_deadline_s: float = 5.0,
    ):
        self.name = str(name)
        self.bind = str(bind)
        self._peers = peers
        self.send_deadline_s = float(send_deadline_s)
        self.recv_deadline_s = float(recv_deadline_s)
        # the receive slab IS the in-process backend, scoped to one
        # destination: bounded-mailbox behaviour cannot drift between them
        self._mailbox = SharedSlabTransport(capacity_pages=capacity_pages,
                                            max_shipments=max_shipments)
        self._mailbox.register(self.name)
        self._lock = threading.Lock()
        self._conns: Dict[str, socket.socket] = {}
        # connections this endpoint's listener serves (shut at close)
        self._served = set()
        self._closing = False
        # wire observability (GIL-atomic bumps; surfaced through stats())
        self.wire_bytes_sent = 0
        self.wire_bytes_received = 0
        self.wire_frames_sent = 0
        self.wire_frames_received = 0
        self.wire_send_failures = 0
        self.wire_recv_failures = 0
        self._hist_rtt_ms = _WireHistogram()
        family, sockaddr = _parse_addr(self.bind)
        self._listener = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(sockaddr)
        if family == socket.AF_INET and sockaddr[1] == 0:
            # ephemeral TCP port: publish the real one
            self.bind = "tcp:{}:{}".format(*self._listener.getsockname())
        self._listener.listen(8)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="kvwire-accept-{}".format(self.name), daemon=True,
        )
        self._accept_thread.start()

    # -- receive side (listener threads) -------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                name="kvwire-recv-{}".format(self.name), daemon=True,
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """One peer connection's frames. The deadline bounds a frame once
        its length prefix arrived; between frames the connection waits for
        the next one however long it idles (the reference closes an idle
        connection after ``recv_deadline_s``, so the sender's next shipment
        on its cached connection reads no ack and drops)."""
        with self._lock:
            self._served.add(conn)
        try:
            while not self._closing:
                conn.settimeout(None)
                head = _read_exact(conn, 4)
                if head is None:
                    return  # peer closed between frames: clean
                (frame_len,) = struct.unpack("<I", head)
                if not (0 < frame_len < MAX_FRAME_BYTES):
                    self.wire_recv_failures += 1
                    return  # lying length prefix: drop the connection
                conn.settimeout(self.recv_deadline_s)
                frame = _read_exact(conn, frame_len)
                if frame is None:
                    # truncated mid-frame (sender died / deadline):
                    # drop-to-recompute, nothing was attached
                    self.wire_recv_failures += 1
                    return
                self.wire_frames_received += 1
                self.wire_bytes_received += 4 + frame_len
                ok = self._ingest(frame)
                try:
                    conn.sendall(b"\x01" if ok else b"\x00")
                except OSError:
                    return
        finally:
            with self._lock:
                self._served.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _ingest(self, frame: bytearray) -> bool:
        """Decode one frame into the receive slab. Every failure (an
        injected ``transport.wire.recv`` fault, a wire-format violation)
        drops the frame leak-free (the slabs are views into ``frame``;
        nothing was attached) and nacks the sender."""
        try:
            faults.fire("transport.wire.recv")
            shipment = shipment_from_wire(frame)
        except (faults.InjectedFault, WireFormatError) as ex:
            self.wire_recv_failures += 1
            logger.warning("kv wire frame into %s dropped (%s); sender nacked -> "
                           "decode-side recompute", self.name, ex)
            return False
        return self._mailbox.send(self.name, shipment)

    # -- send side (the sender replica's loop thread) -------------------------

    def _connect(self, dst: str) -> socket.socket:
        addr = self._peers.get(dst)
        if addr is None:
            raise OSError("no kv wire address for peer {!r}".format(dst))
        family, sockaddr = _parse_addr(addr)
        conn = socket.socket(family, socket.SOCK_STREAM)
        conn.settimeout(self.send_deadline_s)
        try:
            conn.connect(sockaddr)
        except OSError:
            conn.close()
            raise
        if _ledger.armed():
            _ledger.acquire("transport.wire.conn", key=id(conn), domain=self)
        return conn

    def _close_conn(self, conn: socket.socket) -> None:
        if _ledger.armed():
            _ledger.release("transport.wire.conn", key=id(conn), domain=self)
        try:
            conn.close()
        except OSError:
            pass

    def _drop_conn(self, dst: str, conn: socket.socket) -> None:
        with self._lock:
            if self._conns.get(dst) is conn:
                del self._conns[dst]
        self._close_conn(conn)

    def send(self, dst: str, shipment: KVShipment) -> bool:
        """Frame and ship with a deadline. EVERY failure path (an injected
        fault, an unknown or unreachable peer, a timeout, a truncated ack, a
        receiver's nack) is a counted drop returning False; the decode
        replica recomputes. One shipment is in flight per peer connection
        (the ack doubles as backpressure and the round-trip sample)."""
        if self._closing:
            self.wire_send_failures += 1
            return False
        if shipment.pages > self._mailbox.capacity_pages:
            # oversized outright: the receiver would evict its whole slab
            # and still fail; drop sender-side like the shared backend
            self._mailbox.dropped += 1
            self._mailbox.dropped_pages += shipment.pages
            return False
        try:
            faults.fire("transport.wire.send")
            frame = shipment_to_wire(shipment)
        except (faults.InjectedFault, WireFormatError):
            self.wire_send_failures += 1
            return False
        with self._lock:
            conn = self._conns.pop(dst, None)
        t0 = time.perf_counter()
        try:
            if conn is None:
                conn = self._connect(dst)
            conn.sendall(struct.pack("<I", len(frame)))
            conn.sendall(frame)
            ack = _read_exact(conn, 1)
        except OSError:
            if conn is not None:
                self._drop_conn(dst, conn)
            self.wire_send_failures += 1
            return False
        if not ack:
            self._drop_conn(dst, conn)
            self.wire_send_failures += 1
            return False
        surplus = True
        with self._lock:
            if not self._closing and self._conns.get(dst) is None:
                self._conns[dst] = conn
                surplus = False
        if surplus:
            # a racing send already cached a connection (or we are
            # closing): this one is extra, release it now
            self._close_conn(conn)
        self._hist_rtt_ms.observe((time.perf_counter() - t0) * 1e3)
        self.wire_frames_sent += 1
        self.wire_bytes_sent += 4 + len(frame)
        if ack != b"\x01":
            self.wire_send_failures += 1
            return False
        self._mailbox.sent += 1
        self._mailbox.sent_pages += shipment.pages
        return True

    # -- endpoint surface -----------------------------------------------------

    def recv(self, key: bytes) -> Optional[KVShipment]:
        return self._mailbox.recv(self.name, key)

    def stats(self) -> Dict[str, object]:
        out = self._mailbox.stats()
        out["backend"] = "socket_slab"
        out["bind"] = self.bind
        out["wire"] = {
            "bytes_sent": self.wire_bytes_sent,
            "bytes_received": self.wire_bytes_received,
            "frames_sent": self.wire_frames_sent,
            "frames_received": self.wire_frames_received,
            "send_failures": self.wire_send_failures,
            "recv_failures": self.wire_recv_failures,
            "rtt_ms": self._hist_rtt_ms.snapshot(),
        }
        return out

    def close(self) -> None:
        self._closing = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            served = list(self._served)
        for conn in conns:
            self._close_conn(conn)
        for conn in served:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        family, sockaddr = _parse_addr(self.bind)
        if family == socket.AF_UNIX:
            try:
                os.unlink(sockaddr)
            except OSError:
                pass


class SocketSlabFabric:
    """In-process broker for socket endpoints: one listener address per
    replica and a shared live peer map, behind the ``register``/``stats``
    surface ``ReplicaGroup`` drives for the shared-slab backend. The
    process backend builds the peer map in the worker specs instead."""

    def __init__(self, capacity_pages: int = 1024, max_shipments: int = 64,
                 base_dir: Optional[str] = None):
        self.capacity_pages = int(capacity_pages)
        self.max_shipments = int(max_shipments)
        if base_dir is None:
            import tempfile

            self._tmp = tempfile.TemporaryDirectory(prefix="kvwire-")
            base_dir = self._tmp.name
        else:
            self._tmp = None
        self._base_dir = base_dir
        self._addrs: Dict[str, str] = {}
        self._endpoints: Dict[str, SocketSlabTransport] = {}

    def register(self, name: str) -> SocketSlabTransport:
        if name in self._endpoints:
            return self._endpoints[name]
        bind = "unix:{}".format(os.path.join(self._base_dir, "{}.sock".format(name)))
        endpoint = SocketSlabTransport(name, bind, self._addrs,
                                       capacity_pages=self.capacity_pages,
                                       max_shipments=self.max_shipments)
        self._addrs[name] = endpoint.bind
        self._endpoints[name] = endpoint
        return endpoint

    def stats(self) -> Dict[str, object]:
        per = {name: ep.stats() for name, ep in self._endpoints.items()}
        agg = {
            "backend": "socket_slab",
            "capacity_pages": self.capacity_pages,
            "queued": {},
            "endpoints": per,
        }
        for key in ("sent", "sent_pages", "received", "received_pages",
                    "dropped", "dropped_pages", "partial_frames",
                    "assembled", "assembly_drops"):
            agg[key] = sum(int(s[key]) for s in per.values())
        for s in per.values():
            agg["queued"].update(s["queued"])
        return agg

    def close(self) -> None:
        for endpoint in self._endpoints.values():
            endpoint.close()
        if self._tmp is not None:
            self._tmp.cleanup()
