"""Paged KV cache: refcounted host page allocator + per-layer device pools.

Counterpart of ``clearml_serving_tpu/llm/kv_cache.py`` (``PagePool`` and
``PagedKVCache``). The cache is a fixed pool of fixed-size pages per layer;
each sequence owns a list of pages (its page-table row), so device memory
holds only the tokens that exist. Allocation is host-side integer
bookkeeping; the device sees dense pools and int32 page tables, which feed
``ops.paged_attention``.

Pages are REFCOUNTED so that live slots and the radix prefix cache
(``llm/prefix_cache.py``) can share them: storing a prompt's prefix takes a
reference on the admitting slot's own pages, and a later admission sharing
that prefix maps the same pages into its page table (``map_shared``), with
no KV copy either way. A page returns to the free list when its last
reference (slot, cache node or pin) drops. A slot that must write into a
page referenced elsewhere gets a private replacement first (copy on write):
the pool swaps the page id host-side and records a (src, dst) pair, and
``PagedKVCache.apply_pending_cow`` copies the page on the device before the
write lands.

Device layout: ``k``/``v`` ``[L, Hkv, N, P, D]`` (head-major, the layout the
attention kernel reads), plus f32 scale pools ``[L, Hkv, N, P]`` under
``kv_quant="int8"``: a page id addresses its data plane and its scale row
alike, so every write, copy and share covers the scale row too. Page 0 is
the reserved null page: unused table entries point at it and idle batch
rows write their garbage K/V there; it is never allocated or refcounted.

The pools are updated in place (``index_put_``), where the JAX package
rebinds donated buffers.

Host-RAM tier (``HostKVTier``, ``PagedKVCache.enable_host_tier``): the
radix prefix cache demotes cached runs into preallocated host pages instead
of dropping them, and promotes them back on a hit. Its slabs are page-major
``[Nh, L, Hkv, P, D]`` (scale rows ``[Nh, L, Hkv, P]`` on int8 pools), pinned
when the cache lives on the card. Where the JAX package orders the copies
by data dependency on rebound pool handles, the port orders them by stream;
``PagedKVCache``'s docstring states the rules.

Every acquire and release of pages, pins and host pages records into the
ownership ledger (``llm/lifecycle_ledger.py``) when it is armed.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import lifecycle_ledger as _ledger


class PagePool:
    """Host-side refcounted page allocator for a fixed pool (the
    reference's ``PagePool``). Page 0 is never handed out.

    Besides the slot tables, references are held by the prefix cache's
    nodes (``ref_pages``) and by pins (``pin_pages``): transient
    references of in-flight admissions, and the pages a preempted request
    parks while it waits (``detach``). Pins are counted apart from the
    references so the KV sanitizer can prove conservation: refs == slot
    tables + cache nodes + pins. One re-entrant lock guards everything:
    the loop thread, the worker threads and the cache mutate refcounts."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self._slot_len: List[int] = [0] * max_slots
        self._refs: List[int] = [0] * num_pages
        self._lock = threading.RLock()
        # copy-on-write: host-side id swaps whose device copy is pending
        # (drained by PagedKVCache.apply_pending_cow)
        self._pending_cow: List[Tuple[int, int]] = []
        self.cow_events = 0
        # page -> references held as pins
        self._pins: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def can_allocate(self, tokens: int) -> bool:
        """Whether a fresh sequence of ``tokens`` fits the free pages."""
        with self._lock:
            return self.pages_needed(tokens) <= len(self._free)

    def _pop_free(self) -> int:  # lock held by the caller
        page = self._free.pop()
        self._refs[page] = 1
        return page

    def _unref(self, page: int) -> bool:  # lock held by the caller
        """Drop one reference; True when the page returned to the free list."""
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        if self._refs[page] < 0:
            raise RuntimeError("page {} refcount went negative".format(page))
        return False

    def allocate(self, slot: int, tokens: int) -> List[int]:
        """Give ``slot`` enough pages for ``tokens`` in total; returns the
        new page ids. Raises MemoryError when the pool is exhausted."""
        with self._lock:
            need = self.pages_needed(tokens) - len(self._slot_pages[slot])
            if need > len(self._free):
                raise MemoryError(
                    "page pool exhausted: need {} pages, {} free".format(
                        need, len(self._free)
                    )
                )
            new = [self._pop_free() for _ in range(max(0, need))]
            self._slot_pages[slot].extend(new)
            self._slot_len[slot] = tokens
            if new and _ledger.armed():
                _ledger.acquire("pages.slot", key=slot, n=len(new), domain=self)
            return new

    def extend(self, slot: int, extra_tokens: int = 1) -> List[int]:
        """Grow a sequence by ``extra_tokens``; returns the new page ids.

        Copy on write: when the write position falls inside a page that is
        also referenced elsewhere, the slot gets a private page in its
        place first (writing in place would change every other reader's
        tokens); the device copy waits for ``apply_pending_cow``."""
        with self._lock:
            length = self._slot_len[slot]
            if extra_tokens > 0 and length % self.page_size:
                idx = length // self.page_size
                page = self._slot_pages[slot][idx]
                if self._refs[page] > 1:
                    if not self._free:
                        raise MemoryError(
                            "page pool exhausted (copy-on-write of shared "
                            "page {})".format(page)
                        )
                    fresh = self._pop_free()
                    self._slot_pages[slot][idx] = fresh
                    self._refs[page] -= 1  # > 1, so never frees here
                    self._pending_cow.append((page, fresh))
                    self.cow_events += 1
            return self.allocate(slot, length + extra_tokens)

    def truncate(self, slot: int, tokens: int) -> None:
        """Shrink a sequence to ``tokens``, dropping this slot's references
        to its surplus pages (a verify row allocates its whole k+1 span,
        then keeps what the acceptance kept); a surplus page still
        referenced elsewhere stays allocated."""
        with self._lock:
            if tokens > self._slot_len[slot]:
                raise ValueError("truncate({}) past current length {}".format(
                    tokens, self._slot_len[slot]))
            keep = self.pages_needed(tokens)
            surplus = self._slot_pages[slot][keep:]
            self._slot_pages[slot] = self._slot_pages[slot][:keep]
            for page in reversed(surplus):
                self._unref(page)
            self._slot_len[slot] = tokens
            if surplus and _ledger.armed():
                _ledger.release("pages.slot", key=slot, n=len(surplus), domain=self)

    def free(self, slot: int) -> None:
        """Drop the slot's references; pages still referenced by the
        prefix cache, a pin or another slot stay allocated."""
        with self._lock:
            for page in reversed(self._slot_pages[slot]):
                self._unref(page)
            self._slot_pages[slot] = []
            self._slot_len[slot] = 0
            if _ledger.armed():
                _ledger.release("pages.slot", key=slot, domain=self, all_of_key=True)

    # -- parking a preempted request's pages ---------------------------------

    def detach(self, slot: int) -> List[int]:
        """Take ``slot``'s pages away from it without freeing them (the slot
        is left empty): its references become pins, which the caller owns
        until ``attach`` or ``release`` (the ledger moves them from
        ``pages.slot`` to ``pages.pin``, keyed by the page run)."""
        with self._lock:
            pages = self._slot_pages[slot]
            for page in pages:
                self._pins[page] = self._pins.get(page, 0) + 1
            self._slot_pages[slot] = []
            self._slot_len[slot] = 0
            if _ledger.armed():
                _ledger.release("pages.slot", key=slot, domain=self, all_of_key=True)
                if pages:
                    _ledger.acquire("pages.pin", key=tuple(pages), n=len(pages),
                                    domain=self)
            return pages

    def attach(self, slot: int, pages: List[int], tokens: int) -> None:
        """Give the empty ``slot`` detached pages holding ``tokens`` tokens:
        their pins become the slot's references, and pages past
        ``pages_needed(tokens)`` drop theirs."""
        with self._lock:
            if self._slot_pages[slot]:
                raise ValueError("slot {} still holds pages".format(slot))
            keep = self.pages_needed(tokens)
            if keep > len(pages):
                raise ValueError("{} tokens do not fit {} pages".format(tokens, len(pages)))
            self._unpin(pages)
            self._slot_pages[slot] = list(pages[:keep])
            self._slot_len[slot] = tokens
            for page in pages[keep:]:
                self._unref(page)
            if pages and _ledger.armed():
                _ledger.release("pages.pin", key=tuple(pages), n=len(pages), domain=self)
                if keep:
                    _ledger.acquire("pages.slot", key=slot, n=keep, domain=self)

    def release(self, pages: List[int]) -> int:
        """Drop detached pages' pins; returns how many pages were freed."""
        return self.unpin_pages(pages)

    # -- sharing (prefix cache) -----------------------------------------------

    def ref_pages(self, pages: List[int]) -> None:
        """Take one reference on each page (a cache store). Validates the
        whole batch before changing anything."""
        with self._lock:
            for page in pages:
                if self._refs[page] <= 0:
                    raise RuntimeError("ref_pages on unallocated page {}".format(page))
            for page in pages:
                self._refs[page] += 1
            if pages and _ledger.armed():
                _ledger.acquire("pages.ref", n=len(pages), domain=self)

    def unref_pages(self, pages: List[int]) -> int:
        """Drop one reference per page; returns how many were freed."""
        with self._lock:
            freed = sum(1 for page in pages if self._unref(page))
            if pages and _ledger.armed():
                _ledger.release("pages.ref", n=len(pages), domain=self)
            return freed

    def pin_pages(self, pages: List[int]) -> None:
        """Take one transient reference per page (a prefix-cache lookup's
        pin, held by an in-flight admission), counted apart from the other
        references."""
        with self._lock:
            for page in pages:
                if self._refs[page] <= 0:
                    raise RuntimeError("pin_pages on unallocated page {}".format(page))
            for page in pages:
                self._refs[page] += 1
                self._pins[page] = self._pins.get(page, 0) + 1
            if pages and _ledger.armed():
                # keyed by the exact page run: concurrent admissions' pins
                # must not discharge each other's entries
                _ledger.acquire("pages.pin", key=tuple(pages), n=len(pages), domain=self)

    def _unpin(self, pages: List[int]) -> None:  # lock held by the caller
        """Turn one pin per page back into a plain reference (validated
        before anything changes)."""
        counted: Dict[int, int] = {}
        for page in pages:
            counted[page] = counted.get(page, 0) + 1
            if self._pins.get(page, 0) < counted[page]:
                raise RuntimeError("unpin_pages on unpinned page {}".format(page))
        for page in pages:
            count = self._pins[page]
            if count == 1:
                self._pins.pop(page)
            else:
                self._pins[page] = count - 1

    def unpin_pages(self, pages: List[int]) -> int:
        """Drop one pin per page; returns how many pages were freed."""
        with self._lock:
            self._unpin(pages)
            freed = sum(1 for page in pages if self._unref(page))
            if pages and _ledger.armed():
                _ledger.release("pages.pin", key=tuple(pages), n=len(pages), domain=self)
            return freed

    def map_shared(self, slot: int, pages: List[int], tokens: int) -> None:
        """Map already-allocated (shared) pages as the empty slot's first
        pages, the zero-copy half of a prefix-cache hit: the slot takes its
        own reference on each; ``tokens`` must fill the pages exactly."""
        with self._lock:
            if self._slot_pages[slot]:
                raise RuntimeError("map_shared into non-empty slot {}".format(slot))
            if tokens != len(pages) * self.page_size:
                raise ValueError("shared prefix of {} tokens does not fill {} pages".format(
                    tokens, len(pages)))
            for page in pages:
                if self._refs[page] <= 0:
                    raise RuntimeError("map_shared of unallocated page {}".format(page))
            for page in pages:
                self._refs[page] += 1
            self._slot_pages[slot] = list(pages)
            self._slot_len[slot] = tokens
            if pages and _ledger.armed():
                _ledger.acquire("pages.slot", key=slot, n=len(pages), domain=self)

    def allocate_cache_pages(self, n: int) -> List[int]:
        """Pop ``n`` free pages with one reference each, owned by the
        caller (the prefix cache: a promotion's targets), who attaches them
        to nodes or unrefs them inside the same tree-lock window."""
        with self._lock:
            if n > len(self._free):
                raise MemoryError("page pool exhausted: promotion needs {} pages, {} "
                                  "free".format(n, len(self._free)))
            fresh = [self._pop_free() for _ in range(n)]
            if fresh and _ledger.armed():
                _ledger.acquire("pages.ref", n=len(fresh), domain=self)
            return fresh

    def drain_pending_cow(self) -> List[Tuple[int, int]]:
        with self._lock:
            out, self._pending_cow = self._pending_cow, []
            return out

    def page_refcount(self, page: int) -> int:
        with self._lock:
            return self._refs[page]

    @property
    def shared_pages(self) -> int:
        """Pages with more than one reference."""
        with self._lock:
            return sum(1 for r in self._refs[1:] if r > 1)

    def snapshot(self) -> Dict[str, object]:
        """A consistent copy of the bookkeeping (one lock hold) for the KV
        sanitizer."""
        with self._lock:
            return {
                "refs": list(self._refs),
                "free": list(self._free),
                "slot_pages": [list(p) for p in self._slot_pages],
                "slot_len": list(self._slot_len),
                "pins": dict(self._pins),
                "pending_cow": list(self._pending_cow),
            }

    # -- reads ------------------------------------------------------------------

    def slot_pages(self, slot: int) -> List[int]:
        with self._lock:
            return list(self._slot_pages[slot])

    def slot_length(self, slot: int) -> int:
        with self._lock:
            return self._slot_len[slot]

    def token_coords(self, slot: int, start: int, count: int):
        """(page_id, offset) for token positions [start, start+count)."""
        pages = self.slot_pages(slot)
        return [
            (pages[pos // self.page_size], pos % self.page_size)
            for pos in range(start, start + count)
        ]

    def page_table(self, pages_per_seq: int) -> np.ndarray:
        """Dense [max_slots, pages_per_seq] int32 table; unused entries point
        at page 0. Raises if a slot holds more pages than the table width."""
        with self._lock:
            table = np.zeros((self.max_slots, pages_per_seq), np.int32)
            for slot, pages in enumerate(self._slot_pages):
                if len(pages) > pages_per_seq:
                    raise ValueError(
                        "slot {} holds {} pages > table width {}".format(
                            slot, len(pages), pages_per_seq
                        )
                    )
                table[slot, : len(pages)] = pages
            return table

    def lengths(self) -> np.ndarray:
        with self._lock:
            return np.asarray(self._slot_len, np.int32)


def available_host_memory_bytes(path: str = "/proc/meminfo") -> int:
    """``MemAvailable`` from /proc/meminfo, in bytes: the input of the
    host tier's auto-sizing (aux ``prefix_cache_host_mb: "auto"``). Raises
    :class:`errors.HostTierAutoSizeError` on a platform without the file or
    the field: guessing a size would hide that the knob did nothing."""
    from ..errors import HostTierAutoSizeError

    try:
        with open(path) as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError as ex:
        raise HostTierAutoSizeError(
            "prefix_cache_host_mb='auto' needs {} (Linux); probe failed on "
            "this platform: {}".format(path, ex))
    raise HostTierAutoSizeError(
        "prefix_cache_host_mb='auto': {} has no MemAvailable field on this "
        "platform; set an explicit engine.prefix_cache_host_mb".format(path))


def cohosted_worker_processes() -> int:
    """How many engine worker processes share this host's RAM, the divisor
    of ``prefix_cache_host_mb: "auto"``: each process sizes its tier from
    the same ``MemAvailable``. ``TPUSERVE_COHOSTED_PROCS``; unset or
    malformed reads as 1."""
    try:
        return max(1, int(os.environ.get("TPUSERVE_COHOSTED_PROCS", "")))
    except ValueError:
        return 1


class HostKVTier:
    """Preallocated host-RAM pages behind the device pools (the reference's
    ``HostKVTier``).

    Page-major slabs ``hk``/``hv`` ``[Nh, L, Hkv, P, D]`` (and f32
    ``hk_scale``/``hv_scale`` ``[Nh, L, Hkv, P]`` on int8 pools), so one
    host page's bytes are contiguous and a run of ascending ids is one
    contiguous copy. Allocated once, pinned (``pin=True``, a cache on the
    card: its copies are asynchronous DMA) or plain (a CPU cache); a failed
    pin raises. Host page ids are an id space of their own: a cached node
    holds device page ids or host ids, never both. Only the radix prefix
    cache allocates them, one node per id, so the tier needs an allocator,
    not refcounts."""

    def __init__(self, num_pages: int, page_size: int, n_layers: int, n_kv_heads: int,
                 head_dim: int, dtype: torch.dtype, quantized: bool, pin: bool = False):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        if self.num_pages <= 0:
            raise ValueError("host tier needs at least one page")
        shape = (self.num_pages, n_layers, n_kv_heads, page_size, head_dim)
        t0 = time.perf_counter()
        self.hk = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        self.hv = torch.zeros(shape, dtype=dtype, pin_memory=pin)
        if quantized:
            self.hk_scale: Optional[torch.Tensor] = torch.zeros(
                shape[:-1], dtype=torch.float32, pin_memory=pin)
            self.hv_scale: Optional[torch.Tensor] = torch.zeros(
                shape[:-1], dtype=torch.float32, pin_memory=pin)
        else:
            self.hk_scale = None
            self.hv_scale = None
        # seconds the slabs took to allocate (and pin)
        self.alloc_seconds = time.perf_counter() - t0
        self.pinned = bool(pin)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._used: set = set()
        self._lock = threading.Lock()

    @property
    def quantized(self) -> bool:
        return self.hk_scale is not None

    def slabs(self) -> List[torch.Tensor]:
        """Every slab a host id addresses, in the device pools' order: data
        planes, then scale rows."""
        return [t for t in (self.hk, self.hv, self.hk_scale, self.hv_scale) if t is not None]

    @property
    def page_bytes(self) -> int:
        """Host bytes of one page: K and V, and the scale rows."""
        return sum(t[0].numel() * t.element_size() for t in self.slabs())

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_pages(self) -> int:
        with self._lock:
            return len(self._used)

    def allocate(self, n: int) -> List[int]:
        """``n`` free host ids, ascending (a run of pages then lands in as
        few contiguous copies as the free list allows). MemoryError when
        the tier is full."""
        with self._lock:
            if n > len(self._free):
                raise MemoryError("host KV tier exhausted: need {} pages, {} free".format(
                    n, len(self._free)))
            ids = sorted(self._free.pop() for _ in range(n))
            self._used.update(ids)
            if ids and _ledger.armed():
                _ledger.acquire("host.pages", n=len(ids), domain=self)
            return ids

    def free(self, ids: List[int]) -> None:
        with self._lock:
            for hid in ids:
                if hid not in self._used:
                    raise RuntimeError("free of unallocated host page {}".format(hid))
                self._used.discard(hid)
                self._free.append(hid)
            if ids and _ledger.armed():
                _ledger.release("host.pages", n=len(ids), domain=self)

    def snapshot(self) -> Dict[str, object]:
        """A consistent copy of the id bookkeeping for the KV sanitizer."""
        with self._lock:
            return {"free": list(self._free), "used": set(self._used),
                    "num_pages": self.num_pages}


def _id_runs(ids: List[int]) -> List[Tuple[int, int, int]]:
    """(first id, first position, count) of each run of consecutive ids."""
    runs: List[List[int]] = []
    for pos, hid in enumerate(ids):
        if runs and runs[-1][0] + runs[-1][2] == hid:
            runs[-1][2] += 1
        else:
            runs.append([hid, pos, 1])
    return [tuple(r) for r in runs]


class PagedKVCache:
    """Device pools for all layers + the host-side PagePool.

    ``stream`` is the engine's stream (the current stream when the cache is
    built on the card, None on the CPU): every write into the pools is
    enqueued on it. The host tier's copies keep these rules there:

    - Demotion (``demote_pages``): a side stream first waits on ``stream``,
      so the gather of the victims' rows and its device-to-host copies into
      the tier's pinned rows are ordered after every write already enqueued
      to those pages; its ``copy_done`` event is recorded on the side
      stream, and ``stream`` waits on it before the caller drops the
      cache's references, so a later write into a freed page (enqueued on
      ``stream``) cannot overtake the copy. Host code reads a host id's rows
      only once its ``copy_done`` has completed (``_await_demotions``). No
      call blocks the host on the engine's stream.
    - Promotion (``promote_pages``): the tier rows are staged on the host
      into private pinned buffers from PyTorch's caching host allocator,
      never read in place; the host-to-device copies and the scatter into
      the fresh pages are enqueued on ``stream`` before the caller sees the
      page ids, so every later launch that reads them (on ``stream``) is
      ordered after them. An event recorded after the scatter marks the
      promotion done; the record keeps the staging buffers alive until
      ``reap_promotions`` sees the event complete.
    - Nothing falls back: a failed pin, copy or scatter raises.
    """

    def __init__(self, n_layers: int, n_kv_heads: int, head_dim: int, *,
                 num_pages: int, page_size: int = 16, max_slots: int = 8,
                 dtype: torch.dtype = torch.bfloat16, kv_quant: str = "",
                 device="cuda"):
        if kv_quant not in ("", "int8"):
            raise ValueError("kv_quant must be '' or 'int8' (got {!r})".format(kv_quant))
        dev = resolve_device(device)
        self.kv_quant = kv_quant
        self.pool = PagePool(num_pages, page_size, max_slots)
        self.n_layers = n_layers
        shape = (n_layers, n_kv_heads, num_pages, page_size, head_dim)
        pool_dtype = torch.int8 if kv_quant else dtype
        self.k = torch.zeros(shape, dtype=pool_dtype, device=dev)
        self.v = torch.zeros(shape, dtype=pool_dtype, device=dev)
        if kv_quant:
            self.k_scale: Optional[torch.Tensor] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=dev)
            self.v_scale: Optional[torch.Tensor] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=dev)
        else:
            self.k_scale = None
            self.v_scale = None
        self.stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        # the host-RAM tier (None until enable_host_tier) and its copies: the
        # side stream demotions run on, the demotions whose host rows may
        # still be landing (host ids, copy_done) and the promotions in
        # flight; one lock over the lists (the loop thread and the workers
        # both demote and promote)
        self.host_tier: Optional[HostKVTier] = None
        self._tier_stream = None
        self._tier_lock = threading.Lock()
        self._demotions: List[Tuple[set, object]] = []
        self._promotions: List[dict] = []
        # pages moved each way; promotions seen complete, the host time the
        # reaps waited for them (ms), their issue-to-observed time (ms), and
        # promotions that had to wait for their rows to land
        self.demoted_pages = 0
        self.promoted_pages = 0
        self.promo_reaped = 0
        self.promo_wait_ms = 0.0
        self.promo_total_ms = 0.0
        self.promo_stage_waits = 0

    @property
    def device(self) -> torch.device:
        return self.k.device

    @property
    def has_scales(self) -> bool:
        return self.k_scale is not None

    @property
    def pool_dtype(self) -> str:
        return str(self.k.dtype).replace("torch.", "")

    def _pools(self) -> List[torch.Tensor]:
        """Every pool a page id addresses: data planes, then scale rows."""
        pools = [self.k, self.v]
        if self.kv_quant:
            pools += [self.k_scale, self.v_scale]
        return pools

    def pool_bytes(self) -> Dict[str, int]:
        """Device memory held by the pools, split by kind."""
        def nbytes(t):
            return t.numel() * t.element_size()

        scale = nbytes(self.k_scale) + nbytes(self.v_scale) if self.kv_quant else 0
        return {"kv": nbytes(self.k) + nbytes(self.v), "scale": scale}

    def apply_pending_cow(self) -> int:
        """Copy the pages of the pool's pending copy-on-write swaps on the
        device (data planes, and the scale rows of int8 pools), on the
        caller's current stream: it must run after the extensions that
        swapped them and before the writes into the fresh pages are
        enqueued. The sources are shared pages, which nobody writes.
        Returns the number of pages copied."""
        pairs = self.pool.drain_pending_cow()
        if not pairs:
            return 0
        srcs = self._page_index([s for s, _ in pairs])
        dsts = self._page_index([d for _, d in pairs])
        for pool in self._pools():
            pool[:, :, dsts] = pool[:, :, srcs]
        return len(pairs)

    # -- the host-RAM tier ---------------------------------------------------

    def enable_host_tier(self, num_pages: int) -> HostKVTier:
        """Preallocate a host tier of ``num_pages`` pages matching the pools'
        geometry, pinned when the pools are on the card. Returns it (also
        kept as ``host_tier``)."""
        _l, hkv, _n, p, d = self.k.shape
        self.host_tier = HostKVTier(num_pages, p, self.n_layers, hkv, d, dtype=self.k.dtype,
                                    quantized=bool(self.kv_quant),
                                    pin=self.device.type == "cuda")
        return self.host_tier

    def _page_index(self, pages) -> torch.Tensor:
        """``pages`` (ids or an int64 host tensor) as an int64 index on the
        pools' device, copied from a pinned buffer on the current stream:
        no host wait for the work queued on it (the caching host allocator
        keeps the buffer until the copy ran)."""
        idx = torch.as_tensor(pages, dtype=torch.long)
        if self.device.type != "cuda":
            return idx
        return idx.pin_memory().to(self.device, non_blocking=True)

    def _copy_out(self, pages: List[int], outs: List[torch.Tensor],
                  runs: List[Tuple[int, int, int]]):
        """Gather ``pages``' rows of every pool page-major into one
        contiguous device buffer per pool, then copy each run ``(first host
        row, first position, count)`` into ``outs`` (one host tensor per
        pool). On the card the work runs on the tier's side stream after
        everything enqueued on ``stream`` so far; returns its ``copy_done``
        event (None on the CPU, where it is done on return)."""
        if self.device.type != "cuda":
            idx = self._page_index(pages)
            for pool, out in zip(self._pools(), outs):
                rows = pool.movedim(2, 0).index_select(0, idx)
                for dst, src, n in runs:
                    out[dst:dst + n].copy_(rows[src:src + n])
            return None
        if self._tier_stream is None:
            self._tier_stream = torch.cuda.Stream(self.device)
        side = self._tier_stream
        side.wait_stream(self.stream)
        with torch.cuda.stream(side):
            idx = self._page_index(pages)
            for pool, out in zip(self._pools(), outs):
                # one gather into [n, L, Hkv, P(, D)], contiguous; buffers
                # made on the side stream are reused only by its later work
                rows = pool.movedim(2, 0).index_select(0, idx)
                for dst, src, n in runs:
                    out[dst:dst + n].copy_(rows[src:src + n], non_blocking=True)
            copy_done = torch.cuda.Event()
            copy_done.record(side)
        return copy_done

    def export_pages(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """Synchronous device-to-host readback of ``pages`` (and, on int8
        pools, their scale rows) into page-major host tensors ``hk``/``hv``
        ``[n, L, Hkv, P, D]`` (``hk_scale``/``hv_scale`` ``[n, L, Hkv, P]``),
        the tier's layout: the gather and copies of a demotion, into fresh
        (pinned, on the card) tensors, complete when it returns. It waits
        for the work enqueued on the engine's stream before it."""
        pin = self.device.type == "cuda"
        outs = [torch.empty((len(pages),) + tuple(pool.movedim(2, 0).shape[1:]),
                            dtype=pool.dtype, pin_memory=pin) for pool in self._pools()]
        copy_done = self._copy_out(pages, outs, [(0, 0, len(pages))])
        if copy_done is not None:
            copy_done.synchronize()
        return dict(zip(("hk", "hv", "hk_scale", "hv_scale"), outs))

    def demote_pages(self, pages: List[int]) -> List[int]:
        """Copy device pages (and their scale rows) into freshly allocated
        host-tier pages; returns the host ids, in ``pages``' order. Raises
        MemoryError when the tier is full (the cache then drops the run).
        On the card the copy is only enqueued: ``stream`` waits for it
        before anything later (a write into a page the caller frees next)."""
        tier = self.host_tier
        if tier is None:
            raise RuntimeError("demote_pages without an enabled host tier")
        host_ids = tier.allocate(len(pages))
        try:
            copy_done = self._copy_out(pages, tier.slabs(), _id_runs(host_ids))
        except BaseException:
            tier.free(host_ids)
            raise
        if copy_done is not None:
            self.stream.wait_event(copy_done)
            with self._tier_lock:
                # only the copies still landing are kept
                self._demotions = [(ids, ev) for ids, ev in self._demotions if not ev.query()]
                self._demotions.append((set(host_ids), copy_done))
        self.demoted_pages += len(pages)
        return host_ids

    def _await_demotions(self, host_ids: List[int]) -> None:
        """Wait for the demotions still copying into ``host_ids``' rows (a
        promotion right behind its demotion) and forget the finished ones.
        A host wait on the side stream's copy only, counted in
        ``promo_stage_waits``."""
        wanted = set(host_ids)
        with self._tier_lock:
            self._demotions = [(ids, ev) for ids, ev in self._demotions if not ev.query()]
            landing = [ev for ids, ev in self._demotions if ids & wanted]
        for ev in landing:
            self.promo_stage_waits += 1
            ev.synchronize()

    def promote_pages(self, host_ids: List[int], pages: List[int]) -> None:
        """Re-online host-tier pages into freshly allocated device pages
        (``pages``, from ``PagePool.allocate_cache_pages``): the rows are
        staged into private buffers and the host ids freed at once, then
        the copies and the scatter are enqueued on ``stream``
        (``_upload_pages``). Returns once they are enqueued."""
        tier = self.host_tier
        if tier is None:
            raise RuntimeError("promote_pages without an enabled host tier")
        if len(host_ids) != len(pages):
            raise ValueError("promotion of {} host pages into {} device pages".format(
                len(host_ids), len(pages)))
        if self.device.type == "cuda":
            self._await_demotions(host_ids)
        runs = _id_runs(host_ids)
        rows = []
        for slab in tier.slabs():
            staged = torch.empty((len(host_ids),) + tuple(slab.shape[1:]), dtype=slab.dtype,
                                 pin_memory=tier.pinned)
            for hid, pos, n in runs:   # one memcpy per run of consecutive ids
                staged[pos:pos + n].copy_(slab[hid:hid + n])
            rows.append(staged)
        tier.free(host_ids)
        self._upload_pages(rows, pages)
        self.promoted_pages += len(pages)

    def _upload_pages(self, rows: List[torch.Tensor], pages: List[int]) -> None:
        """Enqueue the host-to-device copy of staged page-major ``rows``
        (one per pool) and their scatter into ``pages`` on ``stream``, and
        record the promotion (its event, and its rows kept alive)."""
        t_issue = time.perf_counter()
        cuda = self.device.type == "cuda"
        with torch.cuda.stream(self.stream) if cuda else contextlib.nullcontext():
            idx = self._page_index(pages)
            for pool, staged in zip(self._pools(), rows):
                dev_rows = staged.to(self.device, non_blocking=True)
                pool.index_copy_(2, idx, dev_rows.movedim(0, 2))
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(self.stream)
        with self._tier_lock:
            self._promotions.append({"pages": len(pages), "t_issue": t_issue,
                                     "done": done, "rows": rows})
            if _ledger.armed():
                _ledger.acquire("kv.promotion", domain=self)

    def import_pages(self, hk, hv, pages: List[int], hk_scale=None, hv_scale=None) -> None:
        """Re-online shipped page slabs (``llm/kv_transport.py`` ``KVShipment``
        rows: ``[n, L, Hkv, P, D]`` page-major host tensors, with the
        ``[n, L, Hkv, P]`` scale rows on int8 pools) into ``pages``, freshly
        allocated device pages, through the promotion's path
        (``_upload_pages``): the copies and the scatter are enqueued on
        ``stream`` before this returns, and the record keeps the rows alive
        until ``reap_promotions`` sees them done. The rows are the
        receiver's alone (the transport's recv pops them), so they are read
        in place; rows that are not pinned are staged into pinned buffers
        on the card, so the copies stay asynchronous."""
        if len(pages) != int(hk.shape[0]):
            raise ValueError("import of {} slab rows into {} device pages".format(
                hk.shape[0], len(pages)))
        self._require_scales(hk_scale, hv_scale)
        slabs = [hk, hv] + ([hk_scale, hv_scale] if self.kv_quant else [])
        for slab, pool in zip(slabs, self._pools()):
            want = tuple(pool.movedim(2, 0).shape[1:])
            if tuple(slab.shape[1:]) != want or slab.dtype != pool.dtype or len(slab) != len(pages):
                raise ValueError("shipped rows {} {} do not fit the pool's {} {}".format(
                    tuple(slab.shape), slab.dtype, want, pool.dtype))
        staged = []
        for slab in slabs:
            if self.device.type == "cuda" and not slab.is_pinned():
                slab = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True).copy_(slab)
            staged.append(slab)
        self._upload_pages(staged, pages)

    def reap_promotions(self, force: bool = False) -> int:
        """Account the promotions whose copies completed (the engine's
        retire boundaries: ``query()``, no wait); ``force`` waits for every
        one still in flight (drain). Returns how many were reaped."""
        with self._tier_lock:
            if not self._promotions:
                return 0
            if force:
                records, self._promotions = self._promotions, []
            else:
                records = [r for r in self._promotions
                           if r["done"] is None or r["done"].query()]
                self._promotions = [r for r in self._promotions
                                    if not any(r is x for x in records)]
            if records and _ledger.armed():
                _ledger.release("kv.promotion", n=len(records), domain=self)
        for rec in records:
            t_reap = time.perf_counter()
            if rec["done"] is not None:
                rec["done"].synchronize()
            t_done = time.perf_counter()
            self.promo_wait_ms += (t_done - t_reap) * 1e3
            self.promo_total_ms += (t_done - rec["t_issue"]) * 1e3
            self.promo_reaped += 1
        return len(records)

    def tier_stats(self) -> Optional[Dict[str, object]]:
        """The host tier's occupancy and movement (the reference's keys;
        None without a tier). ``overlap_ratio``: the share of the
        promotions' issue-to-reap time the reaps did not wait."""
        tier = self.host_tier
        if tier is None:
            return None
        total = self.promo_total_ms
        hidden = max(0.0, total - self.promo_wait_ms)
        return {
            "host_pages_used": tier.used_pages,
            "host_pages_capacity": tier.num_pages,
            "host_page_bytes": tier.page_bytes,
            "demoted_pages_total": self.demoted_pages,
            "promoted_pages_total": self.promoted_pages,
            "promotions_reaped": self.promo_reaped,
            "promo_wait_ms": round(self.promo_wait_ms, 3),
            "promo_total_ms": round(self.promo_total_ms, 3),
            "overlap_ratio": round(hidden / total, 4) if total > 0 else None,
        }

    def gather_pages(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """The tokens of ``pages`` as a dense mini cache: ``k``/``v``
        ``[L, 1, len(pages) * P, Hkv, D]`` (stored dtype; int8 with f32
        ``k_scale``/``v_scale`` ``[L, 1, S, Hkv]`` on int8 pools), the
        layout ``Llama.prefill_chunk`` reads. A prefix-cache hit's compute
        input; the pages themselves are mapped by reference."""
        idx = self._page_index(pages)
        out = {}
        names = ("k", "v", "k_scale", "v_scale")
        for name, pool in zip(names, self._pools()):
            g = pool[:, :, idx]                                   # [L, H, NP, P(, D)]
            g = g.reshape(g.shape[:2] + (-1,) + g.shape[4:])      # [L, H, S(, D)]
            out[name] = g.transpose(1, 2).unsqueeze(1).contiguous()
        return out

    def _require_scales(self, k_scales, v_scales) -> None:
        if self.kv_quant and (k_scales is None or v_scales is None):
            raise ValueError("int8 KV pools need k_scales/v_scales alongside every write")
        if not self.kv_quant and (k_scales is not None or v_scales is not None):
            raise ValueError("scale operands given but the pools are not int8")

    def _scatter(self, pages: List[int], start: int, k_stack, v_stack,
                 k_scales=None, v_scales=None) -> None:
        """Write token K/V ``[L, S, Hkv, D]`` (scales ``[L, S, Hkv]``) at
        sequence positions start..start+S of a slot whose pages are
        ``pages``."""
        self._require_scales(k_scales, v_scales)
        s = k_stack.shape[1]
        pos = torch.arange(start, start + s)
        page_ids = torch.as_tensor(pages, dtype=torch.long)[pos // self.pool.page_size]
        offsets = pos % self.pool.page_size
        page_ids = self._page_index(page_ids)
        offsets = self._page_index(offsets)
        # (:, :, page, offset) with adjacent index tensors takes [L, Hkv, S, D]
        self.k[:, :, page_ids, offsets] = k_stack.permute(0, 2, 1, 3).to(self.k.dtype)
        self.v[:, :, page_ids, offsets] = v_stack.permute(0, 2, 1, 3).to(self.v.dtype)
        if self.kv_quant:
            self.k_scale[:, :, page_ids, offsets] = k_scales.permute(0, 2, 1).float()
            self.v_scale[:, :, page_ids, offsets] = v_scales.permute(0, 2, 1).float()

    def write_prompt(self, slot: int, k_stack, v_stack, length: int,
                     k_scales=None, v_scales=None) -> None:
        """Allocate the slot's pages and write a prefilled prompt's K/V
        (stacked ``[L, S, Hkv, D]``, S = length; scales ``[L, S, Hkv]`` on
        int8 pools)."""
        self.pool.free(slot)
        self.pool.allocate(slot, length)
        self._scatter(self.pool.slot_pages(slot), 0, k_stack, v_stack,
                      k_scales, v_scales)

    def write_prompt_shared(self, slot: int, shared_pages: List[int], prefix_len: int,
                            k_tail, v_tail, length: int,
                            k_scales_tail=None, v_scales_tail=None) -> None:
        """A prefix-cache hit's admission: map ``shared_pages`` (the first
        ``prefix_len`` tokens, page-aligned) into the slot's page table by
        reference (their scale rows come with the page ids), then write
        only the tail's K/V ``[L, length - prefix_len, Hkv, D]`` (and tail
        scales on int8 pools) into freshly allocated pages."""
        if prefix_len % self.pool.page_size:
            raise ValueError(
                "shared prefix length {} is not page-aligned".format(prefix_len))
        self._require_scales(k_scales_tail, v_scales_tail)
        self.pool.free(slot)
        self.pool.map_shared(slot, shared_pages, prefix_len)
        tail_pages = self.pool.allocate(slot, length)
        if tail_pages:
            self._scatter(tail_pages, 0, k_tail, v_tail, k_scales_tail, v_scales_tail)

    def append_token(self, slot: int, k_token, v_token,
                     k_scale=None, v_scale=None) -> None:
        """Append one token's K/V (``[L, Hkv, D]``; ``[L, Hkv]`` scales on
        int8 pools) to the slot."""
        length = self.pool.slot_length(slot)
        self.pool.extend(slot, 1)
        self.apply_pending_cow()
        self._scatter(
            self.pool.slot_pages(slot), length, k_token[:, None], v_token[:, None],
            None if k_scale is None else k_scale[:, None],
            None if v_scale is None else v_scale[:, None],
        )
