"""KV transport: cross-replica shipping of prefilled KV pages.

The port's copy of ``clearml_serving_tpu/llm/kv_transport.py``: the
in-process shared-slab backend, and the shipment's wire codec
(``to_wire``/``from_wire``), whose socket backend is ``llm/kv_wire.py``.

Disaggregated prefill/decode splits the two jobs of a serving replica over
role-specialized replicas: PREFILL replicas run the admission, DECODE
replicas run the token loop, and the prefilled KV moves between them
through this module. The payload is what the host-RAM tier's demotion
copies out (``PagedKVCache.export_pages``): the prompt's block-aligned
prefix as PAGE-MAJOR host tensors (int8 or bf16 pages plus, on quantized
pools, the f32 scale rows that share each page's lifecycle). A
:class:`KVShipment` is that payload plus the metadata the receiver checks
before touching its pool.

A sender addresses a destination replica by name and pushes one bounded
message; a receiver pops by content key. :class:`SharedSlabTransport`
keeps one bounded receive slab (a page-capacity mailbox) per destination.

Delivery contract:

- ``send`` is BEST-EFFORT: a full receive slab drops the OLDEST shipment
  first (the sender never blocks a serving loop on backpressure), and a
  send that still does not fit is dropped and counted. A dropped shipment
  is never an error: the decode replica recomputes the prefix.
- ``recv`` is CONSUME-ONCE by content key: the decode replica pops the
  shipment, imports the pages (``PagedKVCache.import_pages``) and attaches
  them to its radix prefix cache (``RadixPrefixCache.store_shipped``). A
  shipment nobody consumes ages out of the bounded mailbox.

Content keys (:func:`shipment_key`) digest the storable block-aligned
prefix (the ``longest_prefix_len`` math of the radix trie and of the
router's affinity key), so sender and receiver derive the same key from
the same prompt with no handshake.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch

from . import lifecycle_ledger as _ledger


def shipment_key(prompt_ids: Sequence[int], block: int, lora: int = 0) -> bytes:
    """Deterministic content key for a prompt's storable block-aligned
    prefix: sender (at commit) and receiver (before admission) derive the
    same key from the same prompt with no coordination. Mirrors
    ``RadixPrefixCache.longest_prefix_len`` — the final token never ships
    (it always computes live to seed decoding)."""
    ids = list(prompt_ids)
    depth = ((len(ids) - 1) // max(1, int(block))) * max(1, int(block))
    digest = hashlib.blake2b(digest_size=16)
    digest.update(struct.pack("<iI", int(lora), depth))
    for token in ids[:depth]:
        digest.update(struct.pack("<q", int(token)))
    return digest.digest()


def _fuse(rows) -> torch.Tensor:
    """Frames' rows joined along the page axis into one buffer, pinned
    when the frames are (a card's export), so the receiver's
    ``import_pages`` reads it in place: the one host copy of an
    assembly."""
    out = torch.empty((sum(int(r.shape[0]) for r in rows),) + tuple(rows[0].shape[1:]),
                      dtype=rows[0].dtype, pin_memory=rows[0].is_pinned())
    return torch.cat(rows, dim=0, out=out)


@dataclass
class KVShipment:
    """One prompt's prefilled prefix KV, page-major.

    ``hk``/``hv`` are ``[N, L, Hkv, P, D]`` host tensors (one row per
    shipped page, ``export_pages``' layout); quantized pools add the
    ``[N, L, Hkv, P]`` f32 scale rows. ``prefix_len`` is the block-aligned
    token count the pages cover (``N * page_size``).

    DRAFT-AHEAD shipping splits one prefix
    across several frames sharing the same content key: a non-``final``
    frame carries pages ``[page_offset, page_offset + N)`` of the prefix
    (``prefix_len`` = tokens covered SO FAR, exactly page-aligned), and
    the ``final`` frame seals the assembly with the tail pages plus the
    authoritative full ``prefix_len``. The default ``page_offset=0,
    final=True`` is the single-frame shipment. The transport reassembles IN ORDER and only a sealed assembly ever
    becomes consumable; any gap/duplicate/out-of-order frame drops the
    whole assembly (drop-to-recompute)."""

    key: bytes
    src: str                       # sender replica name
    prefix_len: int                # storable prefix tokens covered
    page_size: int
    lora: int
    hk: torch.Tensor               # [N, L, Hkv, P, D]
    hv: torch.Tensor
    hk_scale: Optional[torch.Tensor] = None   # [N, L, Hkv, P] on int8 pools
    hv_scale: Optional[torch.Tensor] = None
    page_offset: int = 0           # first page's index within the prefix
    final: bool = True             # False = unsealed draft-ahead frame
    seq: int = field(default=0, compare=False)

    @property
    def pages(self) -> int:
        return int(self.hk.shape[0])

    @property
    def quantized(self) -> bool:
        return self.hk_scale is not None

    @property
    def nbytes(self) -> int:
        per = int(self.hk.nbytes) + int(self.hv.nbytes)
        if self.hk_scale is not None:
            per += int(self.hk_scale.nbytes) + int(self.hv_scale.nbytes)
        return per

    # -- wire codec (llm/kv_wire.py) -----------------------------------------

    def to_wire(self) -> bytearray:
        """One self-validating frame for the socket backend (header:
        geometry/dtype/lora/content key; body: the raw slabs)."""
        from .kv_wire import shipment_to_wire

        return shipment_to_wire(self)

    @staticmethod
    def from_wire(frame) -> "KVShipment":
        """Decode and validate a frame into a shipment whose slabs are
        zero-copy views; raises ``kv_wire.WireFormatError`` (before any
        attach) on truncation or geometry/dtype/key lies."""
        from .kv_wire import shipment_from_wire

        return shipment_from_wire(frame)


class TransportEndpoint:
    """One replica's handle on a transport: ``send`` addresses a peer by
    name, ``recv`` pops from this replica's own receive slab. The engine
    holds exactly one of these (``LLMEngineCore.attach_kv_transport``) —
    it never sees the broker or the peer set."""

    def __init__(self, transport: "SharedSlabTransport", name: str):
        self._transport = transport
        self.name = name

    def send(self, dst: str, shipment: KVShipment) -> bool:
        return self._transport.send(dst, shipment)

    def recv(self, key: bytes) -> Optional[KVShipment]:
        return self._transport.recv(self.name, key)

    def stats(self) -> Dict[str, object]:
        return self._transport.stats()


class SharedSlabTransport:
    """In-process KV transport backend: one bounded receive slab per
    destination replica.

    A "receive slab" is a page-capacity mailbox: shipments queue in
    arrival order keyed by content, capacity is counted in PAGES (the
    unit pool pressure is measured in everywhere else), and overflow
    drops the OLDEST shipment first — the decode replica it was addressed
    to simply recomputes, exactly like a failed host-tier promotion.
    Another backend replaces this class, not its callers: the engine's
    ship/receive paths and the router's role logic only consume the
    ``TransportEndpoint`` surface."""

    # mailbox state is mutated only under _lock: senders run on their
    # replica's loop thread, receivers on a worker of the group. A sent
    # shipment is the ledger's ``transport.shipment`` until the
    # consume-once recv pops it or capacity eviction drops it

    def __init__(self, capacity_pages: int = 1024,
                 max_shipments: int = 64):
        if capacity_pages <= 0:
            raise ValueError(
                "kv transport needs a positive receive-slab capacity "
                "(got {} pages)".format(capacity_pages)
            )
        self.capacity_pages = int(capacity_pages)
        self.max_shipments = int(max_shipments)
        self._lock = threading.Lock()
        # dst name -> OrderedDict[key, KVShipment] (arrival order)
        self._slabs: Dict[str, "OrderedDict[bytes, KVShipment]"] = {}
        self._slab_pages: Dict[str, int] = {}
        # dst name -> {key: [unsealed draft-ahead frames, in page order]}
        # — invisible to recv() until the final frame seals the assembly
        self._assemblies: Dict[str, Dict[bytes, list]] = {}
        self._ship_seq = 0
        # observability (GIL-atomic bumps; surfaced through stats())
        self.sent = 0
        self.sent_pages = 0
        self.received = 0
        self.received_pages = 0
        self.dropped = 0           # evicted/oversized shipments
        self.dropped_pages = 0
        self.partial_frames = 0    # draft-ahead frames accepted unsealed
        self.assembled = 0         # assemblies sealed into the mailbox
        self.assembly_drops = 0    # gap/dup/out-of-order/oversize drops

    def register(self, name: str) -> TransportEndpoint:
        with self._lock:
            self._slabs.setdefault(name, OrderedDict())
            self._slab_pages.setdefault(name, 0)
        return TransportEndpoint(self, name)

    def _drop_oldest(self, dst: str) -> None:  # lock held by the caller
        key, old = self._slabs[dst].popitem(last=False)
        self._slab_pages[dst] -= old.pages
        self.dropped += 1
        self.dropped_pages += old.pages
        if _ledger.armed():
            _ledger.release("transport.shipment", key=key, domain=self)

    def _assemble(self, dst: str, shipment: KVShipment):
        """In-order reassembly of one draft-ahead frame. Returns
        ``(accepted, complete)``: ``complete`` is the fused sealed
        shipment once the final frame lands (deliver it through the
        normal mailbox path); until then accepted frames queue unsealed
        — invisible to ``recv``. ANY ordering violation — a duplicate, a
        gap, a seal with no assembly, geometry drift between frames —
        drops the ENTIRE assembly: a prefix that cannot be proven
        contiguous must never attach (drop-to-recompute)."""
        key = shipment.key
        with self._lock:
            asm_map = self._assemblies.setdefault(dst, {})
            if shipment.page_offset == 0:
                # first frame (never final here): replaces a stale start
                if shipment.pages > self.capacity_pages:
                    asm_map.pop(key, None)
                    self.assembly_drops += 1
                    return False, None
                asm_map[key] = [shipment]
                self.partial_frames += 1
                return True, None
            parts = asm_map.get(key)
            have = sum(p.pages for p in parts) if parts else 0
            head = parts[0] if parts else None
            if (
                parts is None
                or shipment.page_offset != have
                or shipment.page_size != head.page_size
                or shipment.quantized != head.quantized
                or shipment.lora != head.lora
            ):
                asm_map.pop(key, None)
                self.assembly_drops += 1
                return False, None
            if have + shipment.pages > self.capacity_pages:
                asm_map.pop(key, None)
                self.assembly_drops += 1
                return False, None
            parts.append(shipment)
            if not shipment.final:
                self.partial_frames += 1
                return True, None
            del asm_map[key]
        # sealed: fuse OUTSIDE the lock (the concatenation is the heavy
        # part; the assembly is already detached from shared state)
        total = have + shipment.pages
        if not (0 < shipment.prefix_len <= total * shipment.page_size):
            self.assembly_drops += 1
            return False, None
        complete = KVShipment(
            key=key, src=shipment.src, prefix_len=shipment.prefix_len,
            page_size=shipment.page_size, lora=shipment.lora,
            hk=_fuse([p.hk for p in parts]),
            hv=_fuse([p.hv for p in parts]),
            hk_scale=_fuse([p.hk_scale for p in parts]) if shipment.quantized else None,
            hv_scale=_fuse([p.hv_scale for p in parts]) if shipment.quantized else None,
        )
        self.assembled += 1
        return True, complete

    def send(self, dst: str, shipment: KVShipment) -> bool:
        """Deliver ``shipment`` into ``dst``'s receive slab. Returns False
        (counted drop) when the shipment exceeds the slab outright;
        otherwise the oldest queued shipments age out until it fits. A
        re-ship of the same key replaces the stale payload. Draft-ahead
        frames (``final=False`` or ``page_offset > 0``) reassemble in
        order and only the SEALED whole enters the mailbox."""
        if not shipment.final or shipment.page_offset:
            accepted, complete = self._assemble(dst, shipment)
            if complete is None:
                return accepted
            shipment = complete
        if shipment.pages > self.capacity_pages:
            self.dropped += 1
            self.dropped_pages += shipment.pages
            return False
        with self._lock:
            # a full legacy re-ship supersedes any unsealed assembly
            asm_map = self._assemblies.get(dst)
            if asm_map is not None:
                asm_map.pop(shipment.key, None)
            slab = self._slabs.get(dst)
            if slab is None:
                slab = self._slabs[dst] = OrderedDict()
                self._slab_pages[dst] = 0
            stale = slab.pop(shipment.key, None)
            if stale is not None:
                self._slab_pages[dst] -= stale.pages
            while (
                slab
                and (
                    self._slab_pages[dst] + shipment.pages
                    > self.capacity_pages
                    or len(slab) >= self.max_shipments
                )
            ):
                self._drop_oldest(dst)
            self._ship_seq += 1
            shipment.seq = self._ship_seq
            slab[shipment.key] = shipment
            self._slab_pages[dst] += shipment.pages
            if _ledger.armed():
                if stale is not None:
                    _ledger.release("transport.shipment", key=shipment.key,
                                    domain=self)
                _ledger.acquire("transport.shipment", key=shipment.key,
                                domain=self)
        self.sent += 1
        self.sent_pages += shipment.pages
        return True

    def recv(self, dst: str, key: bytes) -> Optional[KVShipment]:
        """Consume-once pop of ``dst``'s shipment for ``key`` (None when
        nothing matching is queued — dropped, never sent, or already
        consumed)."""
        with self._lock:
            slab = self._slabs.get(dst)
            shipment = slab.pop(key, None) if slab is not None else None
            if shipment is not None:
                self._slab_pages[dst] -= shipment.pages
                if _ledger.armed():
                    _ledger.release("transport.shipment", key=key,
                                    domain=self)
        if shipment is not None:
            self.received += 1
            self.received_pages += shipment.pages
        return shipment

    def stats(self) -> Dict[str, object]:
        with self._lock:
            queued = {
                dst: {"shipments": len(slab),
                      "pages": self._slab_pages.get(dst, 0)}
                for dst, slab in self._slabs.items()
            }
        return {
            "backend": "shared_slab",
            "capacity_pages": self.capacity_pages,
            "sent": self.sent,
            "sent_pages": self.sent_pages,
            "received": self.received,
            "received_pages": self.received_pages,
            "dropped": self.dropped,
            "dropped_pages": self.dropped_pages,
            "partial_frames": self.partial_frames,
            "assembled": self.assembled,
            "assembly_drops": self.assembly_drops,
            "queued": queued,
        }
