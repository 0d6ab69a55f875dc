"""Radix-tree prefix caching over shared, refcounted KV pages.

A copy of ``clearml_serving_tpu/llm/prefix_cache.py``'s
``RadixPrefixCache`` for the paged backend, with its host-RAM tier. Chat
traffic shares system prompts, multi-turn histories and few-shot templates:
the KV of a shared prompt head is computed once and reused.

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

Host-RAM tier: with a ``backend`` (the ``PagedKVCache`` whose host tier is
enabled), eviction under the device budgets DEMOTES instead of dropping:
the victims' pages (and int8 scale rows) are copied into host-tier pages
and the nodes hold host ids instead; only the host budgets drop runs for
real (host leaf LRU). Pinned runs are neither demoted nor dropped.
Demotion candidates come from the resident frontier (resident nodes
without resident children), so along any root-to-leaf path the demoted
nodes are a suffix; ``store_pages`` keeps that true by re-onlining demoted
path nodes by reference to the admitting slot's own pages. A lookup whose
matched run has a demoted suffix PROMOTES it: fresh device pages are
allocated and the copies into them are enqueued on the engine's stream
before the page ids are returned (``PagedKVCache.promote_pages``), and the
hit is tagged ``tier="host"``. A failed promotion (pool pressure, the
``engine.kv.promote`` seam) drops the unpinned demoted suffix and falls
back to the resident prefix: the tail recomputes, nothing leaks.

Lookups pin the returned pages (a pool pin under the tree lock), so an
eviction cannot free them between the lookup and the slot's mapping; the
engine releases the pin once the pages are mapped or the admission failed.
One mutex guards the tree: admissions run in worker threads. Hits and
``pin_run`` holds record into the ownership ledger
(``llm/lifecycle_ledger.py``) when it is armed.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import faults
from . import lifecycle_ledger as _ledger


class _Node:
    """One block-granular edge of the radix tree."""

    __slots__ = ("parent", "edge", "children", "pages", "host_pages", "nbytes",
                 "last_used", "pinned")

    def __init__(self, parent: Optional["_Node"], edge: Tuple[int, ...]):
        self.parent = parent
        self.edge = edge          # this node's block of tokens
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        # device page ids, or (demoted) host-tier page ids: a tiered node
        # holds exactly one of the two (the sanitizer's two-tier rule)
        self.pages: Optional[List[int]] = None
        self.host_pages: Optional[List[int]] = None
        self.nbytes = 0
        self.last_used = 0
        # pin_run() holds: eviction must neither drop nor demote this node
        self.pinned = 0


class RadixPrefixCache:
    """Radix tree of block-aligned prompt-prefix KV pages, bounded by node
    count, bytes (default 2 GiB) and optionally pages.

    ``pool`` is the engine's ``PagePool``; ``page_bytes`` the device bytes
    of one page (K and V, and the scale rows on int8 pools). ``backend``:
    the ``PagedKVCache`` whose host tier is enabled (None: eviction drops,
    as without a tier); ``host_max_pages`` (default the tier's capacity)
    and ``host_max_bytes`` bound the host tier."""

    def __init__(self, max_nodes: int = 512, block: int = 64,
                 max_bytes: Optional[int] = None, *, max_pages: Optional[int] = None,
                 pool=None, page_bytes: int = 0, backend=None,
                 host_max_pages: Optional[int] = None, host_max_bytes: Optional[int] = None):
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
        self._backend = backend
        self._host = getattr(backend, "host_tier", None) if backend is not None else None
        if backend is not None and self._host is None:
            raise ValueError("tiering backend given but its host tier is not enabled "
                             "(PagedKVCache.enable_host_tier)")
        if self._host is None:
            self.host_max_pages = None
        else:
            self.host_max_pages = (min(int(host_max_pages), self._host.num_pages)
                                   if host_max_pages else self._host.num_pages)
        self.host_max_bytes = int(host_max_bytes) if host_max_bytes else None
        self._roots: Dict[int, _Node] = {}
        # leaves (nodes without children), maintained as nodes come and go
        self._leaf_nodes: set = set()
        # the resident frontier (with a tier): resident nodes without
        # resident children, the demotion candidates
        self._frontier: set = set()
        self._bytes = 0
        self._pages = 0
        self._host_bytes = 0
        self._host_pages = 0
        self._n_nodes = 0
        self._n_resident = 0    # resident nodes (the device budgets)
        self._clock = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0     # prompt tokens served from the cache
        self.evictions = 0
        # tier movement, and hits by the tier that served them (hbm: the
        # run was resident; host: it needed a promotion)
        self.demotions = 0
        self.promotions = 0
        self._hit_tiers: Dict[str, int] = {"hbm": 0, "host": 0}

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
        if self._host is not None:
            self._frontier_fix(child)
            self._frontier_fix(parent)

    def _frontier_fix(self, node: Optional[_Node]) -> None:  # lock held by the caller
        """Re-derive one node's membership of the resident frontier."""
        if node is None or node.parent is None:
            return  # roots carry no payload
        if node.pages is not None and not any(
                c.pages is not None for c in node.children.values()):
            self._frontier.add(node)
        else:
            self._frontier.discard(node)

    def uncount_hit(self, hit: Optional[Dict[str, Any]]) -> None:
        """The engine could not use a returned hit and recomputed the
        prompt cold: count it as a miss."""
        if not hit:
            return
        with self._lock:
            self.hits -= 1
            self.misses += 1
            self.hit_tokens -= int(hit.get("len", 0))
            tier = hit.get("tier", "hbm")
            if tier in self._hit_tiers:
                self._hit_tiers[tier] -= 1

    # -- lookups ----------------------------------------------------------------

    def match_len(self, ids: List[int], lora: int = 0) -> int:
        """Tokens a lookup for ``ids`` would serve from the cache, without
        pinning pages or counting a hit or a miss (admission control's pool
        headroom: a cached prefix needs no fresh pages). With a host tier,
        only the resident run counts: a demoted suffix allocates fresh
        device pages when it is promoted."""
        with self._lock:
            node, depth = self._walk(ids, lora)
            if self._host is None:
                return depth
            resident = 0
            for n in self._path_nodes(node):
                if n.pages is None:
                    break
                resident += self.block
        return min(resident, depth)

    def lookup_pages(self, ids: List[int], lora: int = 0) -> Optional[Dict[str, Any]]:
        """Longest stored block run of ``ids``: ``{"len": P, "pages":
        [ids], "tier": "hbm"|"host"}`` with the pages PINNED for the
        caller, who must ``release()`` the hit; None on a miss. A demoted
        suffix of the run is promoted first (its copies enqueued before
        this returns); if that fails, the unpinned suffix drops and the hit
        shortens to the resident prefix."""
        with self._lock:
            node, depth = self._walk(ids, lora)
            if depth < self.block:
                self.misses += 1
                return None
            path = self._path_nodes(node)
            tier = "hbm"
            if self._host is not None:
                first_demoted = next((i for i, n in enumerate(path) if n.pages is None), None)
                if first_demoted is not None:
                    if self._promote_run(path[first_demoted:]):
                        tier = "host"
                    else:
                        # fall back to the resident prefix; a pinned demoted
                        # suffix survives for its pin holder
                        if not self._subtree_pinned(path[first_demoted]):
                            self._drop_subtree(path[first_demoted])
                        path = path[:first_demoted]
                        depth = first_demoted * self.block
                        if depth < self.block:
                            self.misses += 1
                            return None
            self.hits += 1
            self.hit_tokens += depth
            self._hit_tiers[tier] += 1
            pages: List[int] = []
            for n in path:
                pages.extend(n.pages)
            self._pool.pin_pages(pages)
        hit = {"len": depth, "pages": pages, "tier": tier}
        if _ledger.armed():
            _ledger.acquire("prefix.hit", key=id(hit), domain=self)
        return hit

    def release(self, hit: Optional[Dict[str, Any]]) -> None:
        """Drop a ``lookup_pages`` pin (after the slot mapping took its own
        references, or the admission failed). Releasing twice is a no-op."""
        pages = hit.pop("pages", None) if hit else None
        if pages:
            self._pool.unpin_pages(pages)
            if _ledger.armed():
                _ledger.release("prefix.hit", key=id(hit), domain=self)

    # -- storing ------------------------------------------------------------------

    def store_pages(self, ids: List[int], lora: int, slot_pages: List[int]) -> None:
        """Store the prompt's block-aligned prefix by REFERENCE to the
        admitting slot's pages. Blocks already in the tree are skipped:
        their pages may belong to an earlier admission. With a tier, a
        demoted node on the matched path is re-onlined by reference to the
        slot's own pages (which hold this very prefix), top-down, before
        new children attach below it."""
        p = self.longest_prefix_len(len(ids))
        if p < self.block:
            return
        ppb = self.block // self._pool.page_size
        with self._lock:
            node, depth = self._walk(ids, lora)
            now = self._clock
            if self._host is not None:
                reonlined = 0
                for i, n in enumerate(self._path_nodes(node)):
                    if n.pages is not None or n.host_pages is None:
                        continue
                    first = (i * self.block) // self._pool.page_size
                    pages = list(slot_pages[first:first + ppb])
                    if len(pages) < ppb:
                        break  # a slot shorter than this depth: stays demoted
                    self._pool.ref_pages(pages)
                    self._host.free(n.host_pages)
                    self._host_pages -= len(n.host_pages)
                    self._host_bytes -= n.nbytes
                    n.host_pages = None
                    n.pages = pages
                    self._pages += len(pages)
                    self._bytes += n.nbytes
                    self._n_resident += 1
                    reonlined += 1
                    self._frontier_fix(n)
                    self._frontier_fix(n.parent)
                if reonlined:
                    # one promotion per re-onlined run, as _promote_run counts
                    self.promotions += 1
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
                self._n_resident += 1
                node = child
                depth += self.block
            self._evict_over_budget()

    def store_shipped(self, ids: List[int], lora: int, shipment, backend) -> int:
        """Attach a KV-transport shipment (``llm/kv_transport.py``
        ``KVShipment``) as RESIDENT nodes for the prompt's block-aligned
        prefix: the receive half of disaggregated prefill/decode (the
        reference's ``store_shipped``). ``backend`` is the ``PagedKVCache``
        whose ``import_pages`` enqueues the upload: fresh device pages are
        allocated, their copies ENQUEUED on the cache's stream, and only
        then do the nodes attach and the page ids become visible.

        Blocks already resident are skipped (their pages may be shared with
        live slots); demoted path nodes re-online from the shipment.
        Returns the device pages imported (0: nothing missing). Raises
        MemoryError on pool pressure and ValueError on a geometry mismatch;
        the caller drops the shipment, with no page leaked either way."""
        page_size = self._pool.page_size
        if int(shipment.page_size) != page_size:
            raise ValueError("shipment page size {} != pool page size {}".format(
                shipment.page_size, page_size))
        if bool(shipment.hk_scale is not None) != bool(getattr(backend, "kv_quant", "")):
            raise ValueError(
                "shipment quantization does not match the pool (scales {}, kv_quant "
                "{!r})".format("present" if shipment.hk_scale is not None else "absent",
                               getattr(backend, "kv_quant", "")))
        p = min(self.longest_prefix_len(len(ids)), int(shipment.prefix_len))
        if p < self.block:
            return 0
        ppb = self.block // page_size
        with self._lock:
            node, depth = self._walk(ids, lora)
            now = self._clock
            # one import job per missing block: demoted path nodes re-online,
            # absent blocks attach as new children
            jobs: List[tuple] = []
            for i, n in enumerate(self._path_nodes(node)):
                if n.pages is None and n.host_pages is not None:
                    jobs.append((i * self.block, n))
            d = depth
            while d + self.block <= p:
                jobs.append((d, None))
                d += self.block
            if not jobs:
                return 0
            total = len(jobs) * ppb
            fresh = self._pool.allocate_cache_pages(total)
            try:
                rows = [tok_depth // page_size + j for tok_depth, _ in jobs for j in range(ppb)]
                if rows == list(range(rows[0], rows[0] + len(rows))):
                    sel = slice(rows[0], rows[0] + len(rows))   # a view
                else:
                    sel = torch.as_tensor(rows)                 # a copy
                backend.import_pages(
                    shipment.hk[sel], shipment.hv[sel], fresh,
                    shipment.hk_scale[sel] if shipment.hk_scale is not None else None,
                    shipment.hv_scale[sel] if shipment.hv_scale is not None else None)
            except BaseException:
                self._pool.unref_pages(fresh)
                raise
            # the upload is enqueued: publish the page ids
            for i, (tok_depth, existing) in enumerate(jobs):
                pages = list(fresh[i * ppb:(i + 1) * ppb])
                if existing is not None:
                    if self._host is not None:
                        self._host.free(existing.host_pages)
                    self._host_pages -= len(existing.host_pages)
                    self._host_bytes -= existing.nbytes
                    existing.host_pages = None
                    existing.pages = pages
                    existing.last_used = now
                    self._bytes += existing.nbytes
                    self._pages += ppb
                    self._n_resident += 1
                    self._frontier_fix(existing)
                    self._frontier_fix(existing.parent)
                    continue
                child = _Node(node, tuple(ids[tok_depth:tok_depth + self.block]))
                child.pages = pages
                child.nbytes = ppb * self._page_bytes
                child.last_used = now
                self._attach(node, child)
                self._bytes += child.nbytes
                self._pages += ppb
                self._n_resident += 1
                node = child
            self._evict_over_budget()
        return total

    def pin_run(self, ids: List[int], lora: int = 0) -> Optional[Dict[str, Any]]:
        """Protect the stored run for ``ids`` from eviction and demotion
        until ``unpin_run``. Returns a handle (``host_nodes``: how many of
        its nodes are demoted), or None when nothing is stored."""
        with self._lock:
            node, depth = self._walk(ids, lora)
            if depth < self.block:
                return None
            nodes = self._path_nodes(node)
            for n in nodes:
                n.pinned += 1
            handle = {"nodes": nodes, "len": depth,
                      "host_nodes": sum(1 for n in nodes if n.host_pages is not None)}
            if _ledger.armed():
                _ledger.acquire("prefix.resume_pin", key=id(handle), domain=self)
            return handle

    def unpin_run(self, handle: Optional[Dict[str, Any]]) -> None:
        """Release a ``pin_run`` hold; the eviction it deferred runs now."""
        if not handle:
            return
        with self._lock:
            for n in handle.pop("nodes", ()):
                n.pinned = max(0, n.pinned - 1)
            if _ledger.armed():
                _ledger.release("prefix.resume_pin", key=id(handle), domain=self)
            self._evict_over_budget()

    # -- eviction and tiering ---------------------------------------------------------

    def _over_budget(self) -> bool:
        """The device budgets. With a host tier the node budget counts
        resident nodes only: demotion keeps a node in the tree."""
        nodes = self._n_resident if self._host is not None else self._n_nodes
        return (
            nodes > self.max_nodes
            or self._bytes > self.max_bytes
            or (self.max_pages is not None and self._pages > self.max_pages)
        )

    def _host_over_budget(self, extra_pages: int = 0, extra_bytes: int = 0) -> bool:
        """The host budgets; ``extra_*`` reserves room for a demotion about
        to land."""
        if self._host is None:
            return False
        return (self._host_pages + extra_pages > self.host_max_pages
                or (self.host_max_bytes is not None
                    and self._host_bytes + extra_bytes > self.host_max_bytes))

    def _release_node_payload(self, n: _Node) -> None:  # lock held by the caller
        """The accounting of one node leaving the tree, in either tier: the
        cache's page references or its host ids go."""
        self._leaf_nodes.discard(n)
        self._frontier.discard(n)
        self._n_nodes -= 1
        if n.host_pages is not None:
            self._host_pages -= len(n.host_pages)
            self._host_bytes -= n.nbytes
            self._host.free(n.host_pages)
        else:
            self._bytes -= n.nbytes
            if n.pages is not None:
                self._pages -= len(n.pages)
                self._n_resident -= 1
                self._pool.unref_pages(n.pages)
        n.parent = None
        self.evictions += 1

    def _drop_leaf(self, victim: _Node) -> None:  # lock held by the caller
        """Remove one leaf (either tier)."""
        parent = victim.parent
        parent.children.pop(victim.edge, None)
        if not parent.children and parent.parent is not None:
            self._leaf_nodes.add(parent)
        self._release_node_payload(victim)
        if self._host is not None:
            self._frontier_fix(parent)

    def _subtree_pinned(self, root: _Node) -> bool:  # lock held by the caller
        """Whether ``root`` or a descendant holds a ``pin_run`` pin."""
        stack = [root]
        while stack:
            n = stack.pop()
            if n.pinned:
                return True
            stack.extend(n.children.values())
        return False

    def _drop_subtree(self, root: _Node) -> None:  # lock held by the caller
        """Remove ``root`` and every descendant (the demote and promote
        failures' fallbacks: the run recomputes instead of leaking)."""
        stack, nodes = [root], []
        while stack:
            n = stack.pop()
            nodes.append(n)
            stack.extend(n.children.values())
        parent = root.parent
        parent.children.pop(root.edge, None)
        if not parent.children and parent.parent is not None:
            self._leaf_nodes.add(parent)
        for n in nodes:
            self._release_node_payload(n)
        if self._host is not None:
            self._frontier_fix(parent)

    def _demote(self, victims: List[_Node]) -> bool:  # lock held by the caller
        """Move resident frontier nodes' pages to the host tier in one
        backend call, then drop the cache's device references (a page no
        live slot maps returns to the free list; the backend orders any
        later write into it after the copy). False (the caller drops
        instead) when the tier is full or the ``engine.kv.demote`` seam
        fires."""
        all_pages = [p for v in victims for p in v.pages]
        if faults.active():
            try:
                faults.fire("engine.kv.demote", pages=all_pages)
            except faults.InjectedFault:
                return False
        try:
            host_ids = self._backend.demote_pages(all_pages)
        except MemoryError:
            return False
        i = 0
        for victim in victims:
            pages = victim.pages
            k = len(pages)
            victim.host_pages = host_ids[i:i + k]
            i += k
            victim.pages = None
            self._pages -= k
            self._bytes -= victim.nbytes
            self._n_resident -= 1
            self._host_pages += k
            self._host_bytes += victim.nbytes
            self._pool.unref_pages(pages)
            self._frontier.discard(victim)
            self._frontier_fix(victim.parent)
        # one demotion per batched round (pages: the backend's count)
        self.demotions += 1
        return True

    def _promote_run(self, nodes: List[_Node]) -> bool:  # lock held by the caller
        """Re-online a demoted path suffix: allocate device pages, enqueue
        the copies into them, then flip the nodes. False on pool pressure
        or the ``engine.kv.promote`` seam; the caller then drops the
        suffix (recompute, no leak). A failed copy raises."""
        total = sum(len(n.host_pages) for n in nodes)
        if faults.active():
            try:
                faults.fire("engine.kv.promote", pages=total)
            except faults.InjectedFault:
                return False
        try:
            fresh = self._pool.allocate_cache_pages(total)
        except MemoryError:
            return False
        host_ids = [h for n in nodes for h in n.host_pages]
        try:
            self._backend.promote_pages(host_ids, fresh)
        except BaseException:
            # a failed copy is not a fallback: the payload is gone (the
            # backend freed the host ids when it staged them). Release the
            # fresh pages, orphan the nodes' host side so the drop below
            # does not free it twice, drop the suffix, and raise
            for n in nodes:
                self._host_pages -= len(n.host_pages)
                self._host_bytes -= n.nbytes
                n.host_pages = None
                n.nbytes = 0
            self._pool.unref_pages(fresh)
            self._drop_subtree(nodes[0])
            raise
        i = 0
        for n in nodes:
            k = len(n.host_pages)
            n.pages = list(fresh[i:i + k])
            i += k
            n.host_pages = None
            self._pages += k
            self._bytes += n.nbytes
            self._n_resident += 1
            self._host_pages -= k
            self._host_bytes -= n.nbytes
            self._frontier_fix(n)
            self._frontier_fix(n.parent)
        self.promotions += 1
        return True

    def spill(self, target_pages: int = 0) -> int:
        """Demote resident runs (LRU over the resident frontier; pinned
        runs stay) until at most ``target_pages`` device pages remain
        cached. A test and operations hook that forces the cold-cache state
        the tier exists for. Returns the pages demoted."""
        if self._host is None:
            return 0
        moved = 0
        with self._lock:
            while self._pages > target_pages:
                victims = self._demotion_round(lambda pages, _b, _n: pages > target_pages)
                if not victims:
                    break
                self._evict_host_over_budget(
                    extra_pages=sum(len(v.pages) for v in victims),
                    extra_bytes=sum(v.nbytes for v in victims))
                if not self._demote(victims):
                    break
                moved += sum(len(v.host_pages) for v in victims)
            self._evict_host_over_budget()
        return moved

    def _demotion_round(self, still_over) -> List[_Node]:  # lock held by the caller
        """LRU-ordered victims whose projected removal clears
        ``still_over(pages, bytes, resident_nodes)``, chosen up front so one
        backend copy moves the whole round. Choosing a frontier node
        exposes its parent as the next candidate, so a whole cold run is
        demoted before any page of a newer one."""
        cand = {n for n in self._frontier if not n.pinned}
        victims: List[_Node] = []
        selected: set = set()
        pages, nbytes, nres = self._pages, self._bytes, self._n_resident
        while cand and still_over(pages, nbytes, nres):
            victim = min(cand, key=lambda n: n.last_used)
            cand.discard(victim)
            victims.append(victim)
            selected.add(victim)
            pages -= len(victim.pages)
            nbytes -= victim.nbytes
            nres -= 1
            parent = victim.parent
            if (parent is not None and parent.parent is not None
                    and parent.pages is not None and not parent.pinned
                    and all(c.pages is None or c in selected
                            for c in parent.children.values())):
                cand.add(parent)
        return victims

    def _evict_over_budget(self) -> None:  # lock held by the caller
        """LRU eviction. Without a tier: drop least recently used unpinned
        leaves while over a budget. With one: device pressure demotes a
        batched round of LRU frontier nodes (host room made first), and
        only host pressure drops runs. With every candidate pinned, the
        overage waits for ``unpin_run``."""
        while self._over_budget():
            if self._host is None:
                candidates = [n for n in self._leaf_nodes if not n.pinned]
                if not candidates:
                    return
                self._drop_leaf(min(candidates, key=lambda n: n.last_used))
                continue
            max_nodes, max_bytes, max_pages = self.max_nodes, self.max_bytes, self.max_pages
            victims = self._demotion_round(
                lambda pages, nbytes, nres: (
                    nres > max_nodes or nbytes > max_bytes
                    or (max_pages is not None and pages > max_pages)))
            if not victims:
                break
            self._evict_host_over_budget(
                extra_pages=sum(len(v.pages) for v in victims),
                extra_bytes=sum(v.nbytes for v in victims))
            if not self._demote(victims):
                # the tier is full even after host eviction (pinned host
                # runs), or the demote seam fired: drop the LRU victim and
                # its (demoted) descendants; the loop plans the rest again
                self._drop_subtree(victims[0])
        self._evict_host_over_budget()

    def _evict_host_over_budget(self, extra_pages: int = 0,
                                extra_bytes: int = 0) -> None:  # lock held by the caller
        while self._host_over_budget(extra_pages, extra_bytes):
            candidates = [n for n in self._leaf_nodes
                          if not n.pinned and n.host_pages is not None]
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

    def tier_refs(self) -> Tuple[Dict[int, int], int]:
        """(references per host id, nodes holding both payloads) under one
        tree-lock hold: the sanitizer's two-tier audit."""
        with self._lock:
            counts: Dict[int, int] = {}
            dual = 0
            stack = list(self._roots.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                if node.pages is not None and node.host_pages is not None:
                    dual += 1
                for hid in node.host_pages or ():
                    counts[hid] = counts.get(hid, 0) + 1
            return counts, dual

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
        """The reference's keys (the host ones zero without a tier)."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "evictions": self.evictions,
                "nodes": self._n_nodes,
                "cached_bytes": self._bytes,
                "cached_pages": self._pages,
                "hits_by_tier": dict(self._hit_tiers),
                "host_nodes": (self._n_nodes - self._n_resident
                               if self._host is not None else 0),
                "host_bytes": self._host_bytes,
                "host_pages": self._host_pages,
                "demotions": self.demotions,
                "promotions": self.promotions,
            }
