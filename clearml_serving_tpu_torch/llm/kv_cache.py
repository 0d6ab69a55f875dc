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
rebinds donated buffers. The host-RAM tier and the page export/import of
the reference arrive with later slices of the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


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

    def free(self, slot: int) -> None:
        """Drop the slot's references; pages still referenced by the
        prefix cache, a pin or another slot stay allocated."""
        with self._lock:
            for page in reversed(self._slot_pages[slot]):
                self._unref(page)
            self._slot_pages[slot] = []
            self._slot_len[slot] = 0

    # -- parking a preempted request's pages ---------------------------------

    def detach(self, slot: int) -> List[int]:
        """Take ``slot``'s pages away from it without freeing them (the slot
        is left empty): its references become pins, which the caller owns
        until ``attach`` or ``release``."""
        with self._lock:
            pages = self._slot_pages[slot]
            for page in pages:
                self._pins[page] = self._pins.get(page, 0) + 1
            self._slot_pages[slot] = []
            self._slot_len[slot] = 0
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

    def unref_pages(self, pages: List[int]) -> int:
        """Drop one reference per page; returns how many were freed."""
        with self._lock:
            return sum(1 for page in pages if self._unref(page))

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
            return sum(1 for page in pages if self._unref(page))

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

    def allocate_cache_pages(self, n: int) -> List[int]:
        """Pop ``n`` free pages with one reference each, owned by the
        caller (the prefix cache), who attaches them to nodes or unrefs
        them."""
        with self._lock:
            if n > len(self._free):
                raise MemoryError("page pool exhausted: need {} pages, {} free".format(
                    n, len(self._free)))
            return [self._pop_free() for _ in range(n)]

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


class PagedKVCache:
    """Device pools for all layers + the host-side PagePool."""

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
        srcs = torch.as_tensor([s for s, _ in pairs], dtype=torch.long).to(self.device)
        dsts = torch.as_tensor([d for _, d in pairs], dtype=torch.long).to(self.device)
        for pool in self._pools():
            pool[:, :, dsts] = pool[:, :, srcs]
        return len(pairs)

    def gather_pages(self, pages: List[int]) -> Dict[str, torch.Tensor]:
        """The tokens of ``pages`` as a dense mini cache: ``k``/``v``
        ``[L, 1, len(pages) * P, Hkv, D]`` (stored dtype; int8 with f32
        ``k_scale``/``v_scale`` ``[L, 1, S, Hkv]`` on int8 pools), the
        layout ``Llama.prefill_chunk`` reads. A prefix-cache hit's compute
        input; the pages themselves are mapped by reference."""
        idx = torch.as_tensor(pages, dtype=torch.long).to(self.device)
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
        page_ids = page_ids.to(self.device)
        offsets = offsets.to(self.device)
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
