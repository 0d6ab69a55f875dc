"""Radix-tree prefix caching over shared, refcounted KV pages.

A copy of ``clearml_serving_tpu/llm/prefix_cache.py``'s
``RadixPrefixCache`` for the paged backend, without the host-RAM tier.
Chat traffic shares system prompts, multi-turn histories and few-shot
templates: the KV of a shared prompt head is computed once and reused.

- Each tree edge carries one ``block`` of tokens (a multiple of the page
  size); children are keyed by the block's token tuple, so a probe walks
  the tree block by block and any shared run of blocks matches (partial
  prefix hits).
- A node's payload is the page ids of its block, with one cache-held
  reference apiece in the engine's ``PagePool``: storing a prompt takes
  references on the admitting slot's own pages, and a hit maps those pages
  into the new slot's page table. No KV is copied either way; a page is
  freed once the last slot and the cache let go.
- Eviction is LRU at leaf granularity (a node is evictable once no longer
  prefix depends on it) under three budgets: node count, bytes and pages.
  Evicting a node only drops the cache's references: a page a live slot
  still maps keeps its data until that slot frees it.
- Trees are namespaced per LoRA adapter index (0 while the port has no
  LoRA).

The prompt's final token is never cached: it computes live to produce the
first token's logits (``longest_prefix_len``).

Lookups pin the returned pages (a pool pin under the tree lock), so an
eviction cannot free them between the lookup and the slot's mapping; the
engine releases the pin once the pages are mapped or the admission failed.
One mutex guards the tree: admissions run in worker threads.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class _Node:
    """One block-granular edge of the radix tree."""

    __slots__ = ("parent", "edge", "children", "pages", "nbytes", "last_used", "pinned")

    def __init__(self, parent: Optional["_Node"], edge: Tuple[int, ...]):
        self.parent = parent
        self.edge = edge          # this node's block of tokens
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.pages: Optional[List[int]] = None
        self.nbytes = 0
        self.last_used = 0
        # pin_run() holds: eviction must not drop this node
        self.pinned = 0


class RadixPrefixCache:
    """Radix tree of block-aligned prompt-prefix KV pages, bounded by node
    count, bytes (default 2 GiB) and optionally pages.

    ``pool`` is the engine's ``PagePool``; ``page_bytes`` the device bytes
    of one page (K and V, and the scale rows on int8 pools). ``backend``
    names the reference's host-RAM tier, which the port does not have: it
    must stay None."""

    def __init__(self, max_nodes: int = 512, block: int = 64,
                 max_bytes: Optional[int] = None, *, max_pages: Optional[int] = None,
                 pool=None, page_bytes: int = 0, backend=None):
        if backend is not None:
            raise ValueError(
                "prefix_cache_host_pages: the host-RAM KV tier behind the prefix cache "
                "is not supported by the PyTorch port yet")
        if pool is None:
            raise ValueError(
                "RadixPrefixCache needs the paged backend's pool: the dense-cache "
                "prefix path is not supported by the PyTorch port yet")
        self.block = int(block)
        if self.block % pool.page_size:
            raise ValueError("prefix block {} is not a multiple of the page size {}".format(
                self.block, pool.page_size))
        self.max_nodes = int(max_nodes)
        self.max_bytes = int(max_bytes) if max_bytes else 2 << 30
        self.max_pages = int(max_pages) if max_pages else None
        self._pool = pool
        self._page_bytes = int(page_bytes)
        self._roots: Dict[int, _Node] = {}
        # leaves (nodes without children), maintained as nodes come and go
        self._leaf_nodes: set = set()
        self._bytes = 0
        self._pages = 0
        self._n_nodes = 0
        self._clock = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0     # prompt tokens served from the cache
        self.evictions = 0

    # -- shared helpers -------------------------------------------------------

    def longest_prefix_len(self, n_tokens: int) -> int:
        """Largest storable prefix of a prompt of ``n_tokens``: the final
        token always computes live."""
        return ((n_tokens - 1) // self.block) * self.block

    def _root(self, lora: int) -> _Node:  # lock held by the caller
        root = self._roots.get(lora)
        if root is None:
            root = _Node(None, ())
            self._roots[lora] = root
        return root

    def _tick(self) -> int:  # lock held by the caller
        self._clock += 1
        return self._clock

    def _walk(self, ids: List[int], lora: int) -> Tuple[_Node, int]:
        """Descend matching blocks; returns (deepest node, depth tokens).
        Touches every node on the path (LRU). Lock held by the caller."""
        node = self._roots.get(lora)
        if node is None:
            return self._root(lora), 0
        depth = 0
        limit = self.longest_prefix_len(len(ids))
        now = self._tick()
        while depth + self.block <= limit:
            child = node.children.get(tuple(ids[depth:depth + self.block]))
            if child is None:
                break
            child.last_used = now
            node = child
            depth += self.block
        return node, depth

    @staticmethod
    def _path_nodes(node: _Node) -> List[_Node]:
        """Root-exclusive path from the root down to ``node``."""
        path: List[_Node] = []
        while node is not None and node.parent is not None:
            path.append(node)
            node = node.parent
        path.reverse()
        return path

    def _attach(self, parent: _Node, child: _Node) -> None:  # lock held by the caller
        parent.children[child.edge] = child
        self._leaf_nodes.discard(parent)
        self._leaf_nodes.add(child)
        self._n_nodes += 1

    def uncount_hit(self, hit: Optional[Dict[str, Any]]) -> None:
        """The engine could not use a returned hit and recomputed the
        prompt cold: count it as a miss."""
        if not hit:
            return
        with self._lock:
            self.hits -= 1
            self.misses += 1
            self.hit_tokens -= int(hit.get("len", 0))

    # -- lookups ----------------------------------------------------------------

    def match_len(self, ids: List[int], lora: int = 0) -> int:
        """Tokens a lookup for ``ids`` would serve from the cache, without
        pinning pages or counting a hit or a miss (admission control's pool
        headroom: a cached prefix needs no fresh pages)."""
        with self._lock:
            return self._walk(ids, lora)[1]

    def lookup_pages(self, ids: List[int], lora: int = 0) -> Optional[Dict[str, Any]]:
        """Longest stored block run of ``ids``: ``{"len": P, "pages":
        [ids], "tier": "hbm"}`` with the pages PINNED for the caller, who
        must ``release()`` the hit; None on a miss."""
        with self._lock:
            node, depth = self._walk(ids, lora)
            if depth < self.block:
                self.misses += 1
                return None
            self.hits += 1
            self.hit_tokens += depth
            pages: List[int] = []
            for n in self._path_nodes(node):
                pages.extend(n.pages)
            self._pool.pin_pages(pages)
        return {"len": depth, "pages": pages, "tier": "hbm"}

    def release(self, hit: Optional[Dict[str, Any]]) -> None:
        """Drop a ``lookup_pages`` pin (after the slot mapping took its own
        references, or the admission failed). Releasing twice is a no-op."""
        pages = hit.pop("pages", None) if hit else None
        if pages:
            self._pool.unpin_pages(pages)

    # -- storing ------------------------------------------------------------------

    def store_pages(self, ids: List[int], lora: int, slot_pages: List[int]) -> None:
        """Store the prompt's block-aligned prefix by REFERENCE to the
        admitting slot's pages. Blocks already in the tree are skipped:
        their pages may belong to an earlier admission."""
        p = self.longest_prefix_len(len(ids))
        if p < self.block:
            return
        ppb = self.block // self._pool.page_size
        with self._lock:
            node, depth = self._walk(ids, lora)
            now = self._clock
            while depth + self.block <= p:
                first = depth // self._pool.page_size
                pages = list(slot_pages[first:first + ppb])
                if len(pages) < ppb:
                    break  # a slot shorter than the prefix: stop
                child = _Node(node, tuple(ids[depth:depth + self.block]))
                child.pages = pages
                child.nbytes = ppb * self._page_bytes
                child.last_used = now
                self._pool.ref_pages(pages)
                self._attach(node, child)
                self._bytes += child.nbytes
                self._pages += ppb
                node = child
                depth += self.block
            self._evict_over_budget()

    def pin_run(self, ids: List[int], lora: int = 0) -> Optional[Dict[str, Any]]:
        """Protect the stored run for ``ids`` from eviction until
        ``unpin_run``. Returns a handle, or None when nothing is stored."""
        with self._lock:
            node, depth = self._walk(ids, lora)
            if depth < self.block:
                return None
            nodes = self._path_nodes(node)
            for n in nodes:
                n.pinned += 1
            return {"nodes": nodes, "len": depth, "host_nodes": 0}

    def unpin_run(self, handle: Optional[Dict[str, Any]]) -> None:
        """Release a ``pin_run`` hold; the eviction it deferred runs now."""
        if not handle:
            return
        with self._lock:
            for n in handle.pop("nodes", ()):
                n.pinned = max(0, n.pinned - 1)
            self._evict_over_budget()

    # -- eviction -------------------------------------------------------------------

    def _over_budget(self) -> bool:
        return (
            self._n_nodes > self.max_nodes
            or self._bytes > self.max_bytes
            or (self.max_pages is not None and self._pages > self.max_pages)
        )

    def _drop_leaf(self, victim: _Node) -> None:  # lock held by the caller
        """Remove one leaf; the cache's page references drop with it."""
        parent = victim.parent
        parent.children.pop(victim.edge, None)
        if not parent.children and parent.parent is not None:
            self._leaf_nodes.add(parent)
        self._leaf_nodes.discard(victim)
        self._n_nodes -= 1
        self._bytes -= victim.nbytes
        self._pages -= len(victim.pages)
        self._pool.unref_pages(victim.pages)
        victim.parent = None
        self.evictions += 1

    def _evict_over_budget(self) -> None:  # lock held by the caller
        """Drop least recently used unpinned leaves while over a budget;
        with every candidate pinned, the overage waits for ``unpin_run``."""
        while self._over_budget():
            candidates = [n for n in self._leaf_nodes if not n.pinned]
            if not candidates:
                return
            self._drop_leaf(min(candidates, key=lambda n: n.last_used))

    # -- sanitizer support -------------------------------------------------------

    def page_refs(self, pool=None):
        """Cache-held references per page id; with ``pool``, also a pool
        snapshot taken under the tree lock (the lock order of every
        mutating cache path: tree, then pool)."""
        with self._lock:
            counts: Dict[int, int] = {}
            stack = list(self._roots.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                for page in node.pages or ():
                    counts[page] = counts.get(page, 0) + 1
            if pool is None:
                return counts
            return counts, pool.snapshot()

    # -- observability -------------------------------------------------------------

    @property
    def total_bytes(self) -> int:
        return self._bytes

    @property
    def cached_pages(self) -> int:
        return self._pages

    def __len__(self) -> int:
        return self._n_nodes

    def stats(self) -> Dict[str, Any]:
        """The reference's keys; the host-tier ones stay zero."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "nodes": self._n_nodes,
                "cached_bytes": self._bytes,
                "cached_pages": self._pages,
                "hits_by_tier": {"hbm": self.hits, "host": 0},
                "host_nodes": 0,
                "host_bytes": 0,
                "host_pages": 0,
                "demotions": 0,
                "promotions": 0,
            }
