"""Paged KV cache: host page allocator + per-layer device pools.

Counterpart of ``clearml_serving_tpu/llm/kv_cache.py`` (``PagePool`` and
``PagedKVCache``). The cache is a fixed pool of fixed-size pages per layer;
each sequence owns a list of pages (its page-table row), so device memory
holds only the tokens that exist. Allocation is host-side integer
bookkeeping; the device sees dense pools and int32 page tables, which feed
``ops.paged_attention``.

Device layout: ``k``/``v`` ``[L, Hkv, N, P, D]`` (head-major, the layout the
attention kernel reads), plus f32 scale pools ``[L, Hkv, N, P]`` under
``kv_quant="int8"``: a page id addresses its data plane and its scale row
alike. Page 0 is the reserved null page: unused table entries point at it
and idle batch rows write their garbage K/V there.

The pools are updated in place (``index_put_``), where the JAX package
rebinds donated buffers. Page sharing (the radix prefix cache, copy on
write) and the host-RAM tier arrive with later slices of the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device


class PagePool:
    """Host-side page allocator for a fixed pool (the reference's
    ``PagePool`` without sharing). Page 0 is never handed out."""

    def __init__(self, num_pages: int, page_size: int, max_slots: int):
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_slots = int(max_slots)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
        self._slot_len: List[int] = [0] * max_slots
        self._lock = threading.Lock()

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
            new = [self._free.pop() for _ in range(max(0, need))]
            self._slot_pages[slot].extend(new)
            self._slot_len[slot] = tokens
            return new

    def extend(self, slot: int, extra_tokens: int = 1) -> List[int]:
        """Grow a sequence by ``extra_tokens``; returns the new page ids."""
        return self.allocate(slot, self.slot_length(slot) + extra_tokens)

    def truncate(self, slot: int, tokens: int) -> None:
        """Shrink a sequence to ``tokens``, freeing its surplus pages (a
        verify row allocates its whole k+1 span, then keeps what the
        acceptance kept)."""
        with self._lock:
            if tokens > self._slot_len[slot]:
                raise ValueError("truncate({}) past current length {}".format(
                    tokens, self._slot_len[slot]))
            keep = self.pages_needed(tokens)
            surplus = self._slot_pages[slot][keep:]
            self._slot_pages[slot] = self._slot_pages[slot][:keep]
            self._free.extend(reversed(surplus))
            self._slot_len[slot] = tokens

    def free(self, slot: int) -> None:
        with self._lock:
            self._free.extend(reversed(self._slot_pages[slot]))
            self._slot_pages[slot] = []
            self._slot_len[slot] = 0

    def detach(self, slot: int) -> List[int]:
        """Take ``slot``'s pages away from it without freeing them (the slot
        is left empty): the caller owns them until ``attach`` or
        ``release``."""
        with self._lock:
            pages = self._slot_pages[slot]
            self._slot_pages[slot] = []
            self._slot_len[slot] = 0
            return pages

    def attach(self, slot: int, pages: List[int], tokens: int) -> None:
        """Give the empty ``slot`` detached pages holding ``tokens`` tokens."""
        with self._lock:
            if self._slot_pages[slot]:
                raise ValueError("slot {} still holds pages".format(slot))
            self._slot_pages[slot] = list(pages)
            self._slot_len[slot] = tokens

    def release(self, pages: List[int]) -> None:
        """Free detached pages."""
        with self._lock:
            self._free.extend(reversed(pages))

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
    def pool_dtype(self) -> str:
        return str(self.k.dtype).replace("torch.", "")

    def pool_bytes(self) -> Dict[str, int]:
        """Device memory held by the pools, split by kind."""
        def nbytes(t):
            return t.numel() * t.element_size()

        scale = nbytes(self.k_scale) + nbytes(self.v_scale) if self.kv_quant else 0
        return {"kv": nbytes(self.k) + nbytes(self.v), "scale": scale}

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

    def append_token(self, slot: int, k_token, v_token,
                     k_scale=None, v_scale=None) -> None:
        """Append one token's K/V (``[L, Hkv, D]``; ``[L, Hkv]`` scales on
        int8 pools) to the slot."""
        length = self.pool.slot_length(slot)
        self.pool.extend(slot, 1)
        self._scatter(
            self.pool.slot_pages(slot), length, k_token[:, None], v_token[:, None],
            None if k_scale is None else k_scale[:, None],
            None if v_scale is None else v_scale[:, None],
        )
