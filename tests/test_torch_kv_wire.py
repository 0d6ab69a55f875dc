"""The port's socket KV wire (clearml_serving_tpu_torch/llm/kv_wire.py)
against the JAX package's (``clearml_serving_tpu/llm/kv_wire.py``).

Every case of the reference's ``tests/test_kv_wire.py`` runs on the port:
the codec's round trips (bf16, int8 with scale rows, strided slabs), each
header, geometry, dtype, key and scale-row lie raising the named
``WireFormatError``, truncation and trailing bytes, and the socket
endpoint's mailbox (consume-once, overflow drops the oldest, send failures
and the receive fault with its nack drop to recompute leak-free, a frame
cut mid-body, draft-ahead partial frames). Beside them, the bytes: the
port's frame equals the reference's for the same pages (bf16, int8 with
scales, partial frames), and each package decodes the other's frame.
"""

import json
import socket
import struct
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from clearml_serving_tpu.llm import kv_transport as ref_transport
from clearml_serving_tpu.llm import kv_wire as ref_wire
from clearml_serving_tpu_torch.llm import faults, lifecycle_ledger
from clearml_serving_tpu_torch.llm.kv_transport import KVShipment
from clearml_serving_tpu_torch.llm.kv_wire import (
    MAGIC,
    SocketSlabFabric,
    WireFormatError,
    shipment_from_wire,
    shipment_to_wire,
)

BF16 = np.dtype(ml_dtypes.bfloat16)


@pytest.fixture(autouse=True)
def _clean_state():
    faults.clear()
    lifecycle_ledger.get().reset(strict=False)
    yield
    faults.clear()
    lifecycle_ledger.get().reset(strict=False)
    lifecycle_ledger.disarm()


def _torch(a: np.ndarray) -> torch.Tensor:
    """The same bytes as a torch tensor (bf16 through its 16-bit pattern)."""
    if a.dtype == BF16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_slabs(pages=2, page_size=4, dtype=np.int8, quantized=False, seed=7):
    shape = (pages, 3, 2, page_size, 8)
    rng = np.random.default_rng(seed)
    if dtype == BF16:
        hk = rng.standard_normal(shape).astype(BF16)
        hv = rng.standard_normal(shape).astype(BF16)
    else:
        hk = rng.integers(-100, 100, size=shape).astype(dtype)
        hv = rng.integers(-100, 100, size=shape).astype(dtype)
    out = {"hk": hk, "hv": hv}
    if quantized:
        out["hk_scale"] = rng.random(shape[:-1]).astype(np.float32)
        out["hv_scale"] = rng.random(shape[:-1]).astype(np.float32)
    return out


def _shipment(pages=2, page_size=4, dtype=np.int8, quantized=False, **kw):
    slabs = {k: _torch(v) for k, v in _np_slabs(pages, page_size, dtype, quantized).items()}
    kwargs = dict(key=kw.pop("key", b"k" * 16), src="r0", prefix_len=pages * page_size,
                  page_size=page_size, lora=0, **slabs)
    kwargs.update(kw)
    return KVShipment(**kwargs)


def _ref_shipment(pages=2, page_size=4, dtype=np.int8, quantized=False, **kw):
    kwargs = dict(key=kw.pop("key", b"k" * 16), src="r0", prefix_len=pages * page_size,
                  page_size=page_size, lora=0,
                  **_np_slabs(pages, page_size, dtype, quantized))
    kwargs.update(kw)
    return ref_transport.KVShipment(**kwargs)


def _bytes(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _assert_roundtrip(shipment):
    frame = shipment.to_wire()
    got = KVShipment.from_wire(frame)
    assert got.key == shipment.key
    assert got.src == shipment.src
    assert got.prefix_len == shipment.prefix_len
    assert got.page_size == shipment.page_size
    assert got.lora == shipment.lora
    # bytes, not just values: the slabs re-attach verbatim
    assert got.hk.dtype == shipment.hk.dtype
    assert _bytes(got.hk) == _bytes(shipment.hk)
    assert _bytes(got.hv) == _bytes(shipment.hv)
    if shipment.quantized:
        assert got.quantized
        assert _bytes(got.hk_scale) == _bytes(shipment.hk_scale)
        assert _bytes(got.hv_scale) == _bytes(shipment.hv_scale)
    else:
        assert not got.quantized
    return got


# -- codec round trips ------------------------------------------------------------


def test_roundtrip_bf16():
    got = _assert_roundtrip(_shipment(dtype=BF16))
    assert got.hk.dtype == torch.bfloat16


def test_roundtrip_int8_with_scale_rows():
    got = _assert_roundtrip(_shipment(quantized=True))
    assert got.hk_scale.dtype == torch.float32
    assert got.hk_scale.shape == got.hk.shape[:4]


def test_roundtrip_survives_non_contiguous_slabs():
    ship = _shipment(pages=4)
    view = KVShipment(key=ship.key, src=ship.src, prefix_len=2 * ship.page_size,
                      page_size=ship.page_size, lora=0, hk=ship.hk[::2], hv=ship.hv[::2])
    got = _assert_roundtrip(view)
    assert got.pages == 2


def test_decoded_slabs_are_views_into_the_received_buffer():
    frame = shipment_to_wire(_shipment(quantized=True))
    got = shipment_from_wire(frame)
    base = torch.frombuffer(frame, dtype=torch.uint8).data_ptr()
    for t in (got.hk, got.hv, got.hk_scale, got.hv_scale):
        assert base <= t.data_ptr() < base + len(frame)


def test_unsupported_dtype_rejected_at_encode():
    ship = _shipment()
    wide = KVShipment(key=ship.key, src="r0", prefix_len=8, page_size=4, lora=0,
                      hk=ship.hk.to(torch.float64), hv=ship.hv.to(torch.float64))
    with pytest.raises(WireFormatError, match="dtype"):
        shipment_to_wire(wide)


# -- the reference's bytes ------------------------------------------------------------


def _ref_split(pages=4, page_size=4, split=2, quantized=False, dtype=np.int8):
    whole = _ref_shipment(pages=pages, page_size=page_size, quantized=quantized, dtype=dtype)
    head = ref_transport.KVShipment(
        key=whole.key, src="r0", prefix_len=split * page_size, page_size=page_size, lora=0,
        hk=whole.hk[:split], hv=whole.hv[:split],
        hk_scale=whole.hk_scale[:split] if quantized else None,
        hv_scale=whole.hv_scale[:split] if quantized else None,
        page_offset=0, final=False)
    tail = ref_transport.KVShipment(
        key=whole.key, src="r0", prefix_len=pages * page_size, page_size=page_size, lora=0,
        hk=whole.hk[split:], hv=whole.hv[split:],
        hk_scale=whole.hk_scale[split:] if quantized else None,
        hv_scale=whole.hv_scale[split:] if quantized else None,
        page_offset=split, final=True)
    return head, tail


def _port_of(ref):
    return KVShipment(
        key=ref.key, src=ref.src, prefix_len=ref.prefix_len, page_size=ref.page_size,
        lora=ref.lora, hk=_torch(ref.hk), hv=_torch(ref.hv),
        hk_scale=_torch(ref.hk_scale) if ref.hk_scale is not None else None,
        hv_scale=_torch(ref.hv_scale) if ref.hv_scale is not None else None,
        page_offset=ref.page_offset, final=ref.final)


REF_CASES = {
    "bf16": lambda: [_ref_shipment(dtype=BF16)],
    "int8_scales": lambda: [_ref_shipment(quantized=True, lora=2)],
    "partial_int8": lambda: list(_ref_split(quantized=True)),
    "partial_bf16": lambda: list(_ref_split(dtype=BF16)),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_frames_equal_the_reference_byte_for_byte(case):
    for ref in REF_CASES[case]():
        port = _port_of(ref)
        frame = shipment_to_wire(port)
        assert bytes(frame) == ref_wire.shipment_to_wire(ref)


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_each_package_decodes_the_others_frame(case):
    for ref in REF_CASES[case]():
        port = _port_of(ref)
        got = shipment_from_wire(ref_wire.shipment_to_wire(ref))
        back = ref_wire.shipment_from_wire(bytes(shipment_to_wire(port)))
        for name in ("hk", "hv", "hk_scale", "hv_scale"):
            want = getattr(ref, name)
            if want is None:
                assert getattr(got, name) is None and getattr(back, name) is None
                continue
            assert _bytes(getattr(got, name)) == want.tobytes()
            assert getattr(back, name).tobytes() == want.tobytes()
            assert getattr(back, name).dtype == want.dtype
        for field in ("key", "src", "prefix_len", "page_size", "lora", "page_offset", "final"):
            assert getattr(got, field) == getattr(ref, field) == getattr(back, field)


# -- header and geometry validation ---------------------------------------------------


def _tamper(frame, **hdr_changes):
    """Re-frame with selected header fields overwritten (body verbatim)."""
    version, flags, hdr_len = struct.unpack("<BBH", frame[4:8])
    header = json.loads(bytes(frame[8:8 + hdr_len]).decode("utf-8"))
    header.update(hdr_changes)
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return (MAGIC + struct.pack("<BBH", version, flags, len(hdr)) + hdr
            + bytes(frame[8 + hdr_len:]))


def test_truncated_frame_rejected():
    frame = shipment_to_wire(_shipment())
    with pytest.raises(WireFormatError, match="truncated"):
        shipment_from_wire(frame[: len(frame) - 10])
    with pytest.raises(WireFormatError, match="truncated"):
        shipment_from_wire(frame[:6])


def test_bad_magic_and_version_rejected():
    frame = shipment_to_wire(_shipment())
    with pytest.raises(WireFormatError, match="magic"):
        shipment_from_wire(b"NOPE" + bytes(frame[4:]))
    with pytest.raises(WireFormatError, match="version"):
        shipment_from_wire(MAGIC + b"\x63" + bytes(frame[5:]))


def test_trailing_garbage_rejected():
    frame = shipment_to_wire(_shipment())
    with pytest.raises(WireFormatError, match="trailing"):
        shipment_from_wire(frame + b"\x00\x01")


def test_geometry_lies_rejected():
    frame = shipment_to_wire(_shipment(page_size=4))
    with pytest.raises(WireFormatError, match="page_size"):
        shipment_from_wire(_tamper(frame, page_size=8))
    with pytest.raises(WireFormatError, match="prefix_len"):
        shipment_from_wire(_tamper(frame, prefix_len=999))
    with pytest.raises(WireFormatError, match="prefix_len"):
        shipment_from_wire(_tamper(frame, prefix_len=0))


def test_dtype_lies_rejected():
    ship = _shipment()
    frame = shipment_to_wire(ship)
    version, flags, hdr_len = struct.unpack("<BBH", frame[4:8])
    header = json.loads(bytes(frame[8:8 + hdr_len]).decode("utf-8"))
    header["sections"][0]["dtype"] = "float64"
    with pytest.raises(WireFormatError, match="dtype"):
        shipment_from_wire(_tamper(frame, sections=header["sections"]))
    mixed = KVShipment(key=b"k" * 16, src="r0", prefix_len=8, page_size=4, lora=0,
                       hk=ship.hk.to(torch.float16), hv=ship.hv)
    with pytest.raises(WireFormatError, match="dtype mismatch"):
        shipment_from_wire(shipment_to_wire(mixed))


def test_key_lies_rejected():
    frame = shipment_to_wire(_shipment())
    with pytest.raises(WireFormatError, match="key"):
        shipment_from_wire(_tamper(frame, key="abcd"))
    with pytest.raises(WireFormatError, match="header"):
        shipment_from_wire(_tamper(frame, key="zz" * 16))


def test_scale_row_lies_rejected():
    ship = _shipment(quantized=True)
    bad = KVShipment(key=ship.key, src=ship.src, prefix_len=ship.prefix_len,
                     page_size=ship.page_size, lora=0, hk=ship.hk, hv=ship.hv,
                     hk_scale=ship.hk_scale[:1], hv_scale=ship.hv_scale)
    with pytest.raises(WireFormatError, match="hk_scale"):
        shipment_from_wire(shipment_to_wire(bad))
    f16 = KVShipment(key=ship.key, src=ship.src, prefix_len=ship.prefix_len,
                     page_size=ship.page_size, lora=0, hk=ship.hk, hv=ship.hv,
                     hk_scale=ship.hk_scale.to(torch.float16), hv_scale=ship.hv_scale)
    with pytest.raises(WireFormatError, match="float32"):
        shipment_from_wire(shipment_to_wire(f16))


def test_lies_raise_the_same_words_on_both_packages():
    """Each tampered frame fails on both decoders, each naming the same
    inconsistency."""
    frame = bytes(shipment_to_wire(_shipment()))
    for tampered, words in ((_tamper(frame, page_size=8), "page_size"),
                            (_tamper(frame, prefix_len=999), "prefix_len"),
                            (_tamper(frame, key="abcd"), "key"),
                            (frame + b"\x00", "trailing"),
                            (frame[:-3], "truncated")):
        for decode in (shipment_from_wire, ref_wire.shipment_from_wire):
            with pytest.raises(ValueError, match=words):
                decode(tampered)


# -- socket endpoint semantics ------------------------------------------------------------


def _fabric_pair(**kw):
    fabric = SocketSlabFabric(**kw)
    return fabric, fabric.register("r0"), fabric.register("r1")


def test_socket_send_recv_is_consume_once():
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        assert r1.recv(b"k" * 16) is None
        assert r0.send("r1", _shipment()) is True
        got = r1.recv(b"k" * 16)
        assert got is not None and got.pages == 2
        assert _bytes(got.hk) == _bytes(_shipment().hk)
        assert r1.recv(b"k" * 16) is None
        wire = r0.stats()["wire"]
        assert wire["frames_sent"] == 1 and wire["bytes_sent"] > 0
        assert wire["rtt_ms"]["count"] == 1
        rwire = r1.stats()["wire"]
        assert rwire["frames_received"] == 1 and rwire["bytes_received"] > 0
        assert rwire["bytes_received"] == wire["bytes_sent"]
    finally:
        fabric.close()


def test_socket_mailbox_overflow_drops_oldest():
    fabric, r0, r1 = _fabric_pair(capacity_pages=4)
    try:
        assert r0.send("r1", _shipment(key=b"a" * 16))
        assert r0.send("r1", _shipment(key=b"b" * 16))
        assert r0.send("r1", _shipment(key=b"c" * 16))
        assert r1.recv(b"a" * 16) is None
        assert r1.recv(b"b" * 16) is not None
        assert r1.recv(b"c" * 16) is not None
    finally:
        fabric.close()


def test_socket_reship_replaces_the_stale_payload():
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        assert r0.send("r1", _shipment(pages=2))
        assert r0.send("r1", _shipment(pages=1))
        got = r1.recv(b"k" * 16)
        assert got.pages == 1 and r1.recv(b"k" * 16) is None
        assert r1.stats()["queued"]["r1"]["pages"] == 0
    finally:
        fabric.close()


def test_socket_send_failure_paths_drop_to_recompute():
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        assert r0.send("rX", _shipment()) is False
        assert r0.stats()["wire"]["send_failures"] == 1
        faults.configure([{"point": "transport.wire.send", "action": "raise", "times": 1}])
        assert r0.send("r1", _shipment()) is False
        assert r0.stats()["wire"]["send_failures"] == 2
        assert r0.send("r1", _shipment()) is True
        # oversized outright: a sender-side drop, not a wire failure
        assert r0.send("r1", _shipment(pages=9)) is False
        assert r0.stats()["dropped"] == 1 and r0.stats()["wire"]["send_failures"] == 2
    finally:
        fabric.close()


def test_socket_recv_fault_nacks_sender_and_drops_leak_free():
    lifecycle_ledger.arm(strict=False)
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        faults.configure([{"point": "transport.wire.recv", "action": "raise", "times": 1}])
        assert r0.send("r1", _shipment()) is False
        assert r1.stats()["wire"]["recv_failures"] == 1
        assert r1.recv(b"k" * 16) is None
        assert r0.stats()["wire"]["send_failures"] == 1
        outstanding = lifecycle_ledger.get().outstanding()
        assert outstanding.get("transport.shipment", 0) == 0
        assert r0.send("r1", _shipment()) is True
        assert r1.recv(b"k" * 16) is not None
    finally:
        fabric.close()
    assert lifecycle_ledger.get().outstanding().get("transport.wire.conn", 0) == 0


def test_truncated_frame_on_the_wire_drops_to_recompute():
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        addr = r1.bind[len("unix:"):]
        r1.recv_deadline_s = 0.2
        raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        raw.connect(addr)
        frame = shipment_to_wire(_shipment())
        raw.sendall(struct.pack("<I", len(frame)) + frame[: len(frame) // 2])
        raw.close()
        deadline = time.monotonic() + 5.0
        while r1.stats()["wire"]["recv_failures"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r1.stats()["wire"]["recv_failures"] == 1
        assert r1.recv(b"k" * 16) is None
        assert r0.send("r1", _shipment()) is True
        assert r1.recv(b"k" * 16) is not None
    finally:
        fabric.close()


def test_a_stalled_frame_times_out_and_the_endpoint_recovers():
    """A sender that stops mid-body without hanging up: the receive
    deadline drops the frame (the mid-frame bound), nothing lands."""
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    raw = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        r1.recv_deadline_s = 0.2
        raw.connect(r1.bind[len("unix:"):])
        frame = shipment_to_wire(_shipment())
        raw.sendall(struct.pack("<I", len(frame)) + frame[:20])
        deadline = time.monotonic() + 5.0
        while r1.stats()["wire"]["recv_failures"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert r1.stats()["wire"]["recv_failures"] == 1
        assert r1.recv(b"k" * 16) is None
        assert r0.send("r1", _shipment()) is True
    finally:
        raw.close()
        fabric.close()


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_a_cached_connection_survives_an_idle_gap(pkg):
    """Two shipments further apart than the receive deadline, on the
    sender's cached connection. The port bounds a frame, not the wait
    between frames: the second shipment lands. The reference's receiver
    closes a connection idle past its deadline, so its second send reads
    no ack and drops (a reference fault, ROADMAP section 3)."""
    if pkg == "reference":
        fabric = ref_wire.SocketSlabFabric(capacity_pages=8)
        make = _ref_shipment
    else:
        fabric = SocketSlabFabric(capacity_pages=8)
        make = _shipment
    r0, r1 = fabric.register("r0"), fabric.register("r1")
    try:
        r1.recv_deadline_s = 0.2
        assert r0.send("r1", make(key=b"a" * 16)) is True
        time.sleep(0.6)
        second = r0.send("r1", make(key=b"b" * 16))
        assert second is (pkg == "port")
        assert (r1.recv(b"b" * 16) is not None) is (pkg == "port")
    finally:
        fabric.close()


# -- draft-ahead partial frames ------------------------------------------------------------


def _split_frames(pages=4, page_size=4, split=2, key=b"k" * 16):
    whole = _shipment(pages=pages, page_size=page_size, key=key)
    head = KVShipment(key=key, src="r0", prefix_len=split * page_size, page_size=page_size,
                      lora=0, hk=whole.hk[:split], hv=whole.hv[:split], page_offset=0,
                      final=False)
    tail = KVShipment(key=key, src="r0", prefix_len=pages * page_size, page_size=page_size,
                      lora=0, hk=whole.hk[split:], hv=whole.hv[split:], page_offset=split,
                      final=True)
    return whole, head, tail


def test_partial_wire_roundtrip_preserves_framing():
    whole, head, tail = _split_frames()
    got = shipment_from_wire(shipment_to_wire(head))
    assert got.page_offset == 0 and got.final is False
    assert _bytes(got.hk) == _bytes(head.hk)
    got = shipment_from_wire(shipment_to_wire(tail))
    assert got.page_offset == 2 and got.final is True
    frame = shipment_to_wire(whole)
    _, _, hdr_len = struct.unpack("<BBH", frame[4:8])
    header = json.loads(bytes(frame[8:8 + hdr_len]).decode("utf-8"))
    assert "page_offset" not in header and "final" not in header
    got = shipment_from_wire(frame)
    assert got.page_offset == 0 and got.final is True


def test_partial_frame_geometry_validated():
    _, head, tail = _split_frames()
    with pytest.raises(WireFormatError, match="partial frame"):
        shipment_from_wire(_tamper(shipment_to_wire(head), prefix_len=7))
    with pytest.raises(WireFormatError, match="page_offset"):
        shipment_from_wire(_tamper(shipment_to_wire(head), page_offset=-1))
    with pytest.raises(WireFormatError, match="prefix_len"):
        shipment_from_wire(_tamper(shipment_to_wire(tail), prefix_len=2 * 4))


def test_partial_frames_reassemble_and_seal_over_socket():
    whole, head, tail = _split_frames()
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        assert r0.send("r1", head) is True
        assert r1.recv(whole.key) is None
        assert r0.send("r1", tail) is True
        got = r1.recv(whole.key)
        assert got is not None and got.final and got.page_offset == 0
        assert got.pages == whole.pages
        assert got.prefix_len == whole.prefix_len
        assert _bytes(got.hk) == _bytes(whole.hk)
        assert _bytes(got.hv) == _bytes(whole.hv)
        stats = r1.stats()
        assert stats["partial_frames"] == 1
        assert stats["assembled"] == 1
        assert stats["assembly_drops"] == 0
    finally:
        fabric.close()


def test_partial_duplicate_and_gap_frames_drop_whole_assembly():
    pages, page_size = 4, 4
    whole = _shipment(pages=pages, page_size=page_size)

    def frame(lo, hi, final):
        return KVShipment(key=whole.key, src="r0",
                          prefix_len=(pages if final else hi) * page_size,
                          page_size=page_size, lora=0, hk=whole.hk[lo:hi],
                          hv=whole.hv[lo:hi], page_offset=lo, final=final)

    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        assert r0.send("r1", frame(0, 1, False)) is True
        assert r0.send("r1", frame(1, 2, False)) is True
        assert r0.send("r1", frame(1, 2, False)) is False
        assert r0.send("r1", frame(2, 4, True)) is False
        assert r1.recv(whole.key) is None
        assert r1.stats()["assembly_drops"] == 2
        assert r0.send("r1", frame(0, 1, False)) is True
        assert r0.send("r1", frame(2, 4, True)) is False
        assert r1.recv(whole.key) is None
        assert r0.send("r1", frame(2, 4, True)) is False
        assert r1.recv(whole.key) is None
        assert r1.stats()["assembled"] == 0
        assert r0.send("r1", frame(0, 2, False)) is True
        assert r0.send("r1", frame(2, 4, True)) is True
        got = r1.recv(whole.key)
        assert got is not None and _bytes(got.hk) == _bytes(whole.hk)
    finally:
        fabric.close()


def test_legacy_reship_supersedes_unsealed_assembly():
    whole, head, _ = _split_frames()
    fabric, r0, r1 = _fabric_pair(capacity_pages=8)
    try:
        assert r0.send("r1", head) is True
        assert r0.send("r1", whole) is True
        got = r1.recv(whole.key)
        assert got is not None and got.pages == whole.pages
        assert _bytes(got.hk) == _bytes(whole.hk)
        _, _, tail = _split_frames()
        assert r0.send("r1", tail) is False
        assert r1.recv(whole.key) is None
    finally:
        fabric.close()


def test_a_port_endpoint_and_a_reference_endpoint_talk():
    """The reference's sender ships into the port's listener and back: the
    wire is one protocol, and each side's mailbox holds the other's
    pages bit for bit."""
    port = SocketSlabFabric(capacity_pages=8)
    ref = ref_wire.SocketSlabFabric(capacity_pages=8)
    try:
        p1 = port.register("p1")
        r1 = ref.register("r1")
        r0 = ref.register("r0")
        p0 = port.register("p0")
        r0._peers["p1"] = p1.bind
        p0._peers["r1"] = r1.bind
        ship = _ref_shipment(quantized=True)
        assert r0.send("p1", ship) is True
        got = p1.recv(ship.key)
        assert _bytes(got.hk) == ship.hk.tobytes()
        assert _bytes(got.hv_scale) == ship.hv_scale.tobytes()
        assert p0.send("r1", _port_of(ship)) is True
        back = r1.recv(ship.key)
        assert back.hk.tobytes() == ship.hk.tobytes()
        assert back.hk_scale.tobytes() == ship.hk_scale.tobytes()
    finally:
        port.close()
        ref.close()
