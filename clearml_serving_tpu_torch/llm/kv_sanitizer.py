"""Runtime KV/refcount sanitizer: prove the page accounting, don't assume it.

A copy of ``clearml_serving_tpu/llm/kv_sanitizer.py``. Live slots, the radix prefix cache, pins (in-flight
admissions' lookup pins and the pages a preempted request parks) and
pending copy-on-write swaps share the pool's pages under one refcount. With
``TPUSERVE_SANITIZE=1`` the engine asserts, after every loop step and at
drain:

1. **Refcount conservation**: for every page, ``refcount == slot-table
   references + radix-cache node references + pins``. A page the books
   cannot explain is a leak or a page freed while someone still reads it.
2. **Free-list integrity**: no duplicates, no referenced page on the free
   list, every zero-ref page on it, and the null page 0 neither free nor
   referenced.
3. **Slot-table shape**: each slot's page count matches its token length
   (``pages_needed``), so device page tables never index garbage.
4. **Pending copy-on-write**: every recorded (src, dst) swap still has a
   live src and a dst owned by some slot.
5. **At drain** (no active request, no admission in flight): no slot holds
   pages and no pin remains; every surviving reference belongs to the
   prefix cache. Anything else is a leaked page, named by id.
6. **Scale rows** (int8 pools): the scale pools address exactly the
   allocator's pages, so every page operation covers its scale rows; drain
   leak reports name the stranded scale rows beside the pages.
7. **Two-tier exclusivity** (the host-RAM tier): a page lives in exactly
   one tier. No cache node holds both a device and a host payload; every
   allocated host id is referenced by exactly one node and every id a node
   references is allocated; the host free list has no duplicates, does not
   overlap the allocated ids, and with them covers the tier; an int8
   pool's tier carries scale slabs, and the page sizes agree.

Failures raise :class:`KVSanitizerError` (an AssertionError) naming the
offending pages. The checks are host-side integer audits over a locked
snapshot, O(num_pages + cached nodes), with no device work.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

__all__ = ["KVSanitizerError", "KVSanitizer", "enabled"]


def enabled() -> bool:
    """Armed via ``TPUSERVE_SANITIZE`` (1/true/yes; 0/empty disarms)."""
    return os.environ.get("TPUSERVE_SANITIZE", "").lower() in ("1", "true", "yes")


class KVSanitizerError(AssertionError):
    """A KV page-accounting invariant failed. Carries the offending page ids
    (``pages``) and the check site (``where``) for programmatic triage."""

    def __init__(self, message: str, *, where: str, pages: Optional[List[int]] = None):
        super().__init__(message)
        self.where = where
        self.pages = list(pages or [])


class KVSanitizer:
    """Audits one PagedKVCache's PagePool (and the radix prefix cache that
    shares it) against the conservation invariants above.

    ``check()`` is thread-safe: the snapshot is taken under the cache's tree
    lock and the pool's bookkeeping lock (same order as every mutating cache
    path), so a concurrent admission can interleave only BETWEEN atomic pool
    operations — each of which preserves the invariants — never inside one.
    """

    def __init__(self, pool, prefix_cache=None, paged_cache=None):
        self.pool = pool
        self.prefix = prefix_cache
        # the PagedKVCache (optional): int8 pools carry per-page scale rows
        # whose lifecycle is the page id itself — the audit verifies the
        # scale pools stay shape-consistent with the page allocator (a
        # drifted page axis would dequantize every page with the wrong
        # rows), and leak reports name the scale rows leaked alongside.
        self.paged_cache = paged_cache
        self.checks = 0     # observability: how many audits ran
        self.failures = 0

    # -- snapshot ----------------------------------------------------------

    def _snapshot(self):
        if self.prefix is not None and getattr(self.prefix, "_pool", None) is self.pool:
            cache_refs, snap = self.prefix.page_refs(self.pool)
        else:
            cache_refs = {}
            snap = self.pool.snapshot()
        return cache_refs, snap

    # -- checks ------------------------------------------------------------

    def check(self, where: str = "step", drained: bool = False,
              inflight: int = 0) -> None:
        """Raise KVSanitizerError on the first violated invariant.

        ``inflight``: decode chunks dispatched but not yet retired (the
        pipelined engine). Conservation and
        free-list invariants hold at EVERY instant — in-flight chunks only
        defer page frees, they never hide references — but the drain-time
        "no slot holds pages" rule is meaningful only once the pipeline is
        empty, so a drained audit with chunks still in flight downgrades to
        a regular audit rather than misreporting deferred frees as leaks."""
        self.checks += 1
        drained = drained and int(inflight) == 0
        cache_refs, snap = self._snapshot()
        refs: List[int] = snap["refs"]
        free: List[int] = snap["free"]
        slot_pages: List[List[int]] = snap["slot_pages"]
        slot_len: List[int] = snap["slot_len"]
        pins: Dict[int, int] = snap["pins"]
        pending_cow = snap["pending_cow"]

        def fail(message: str, pages: Optional[List[int]] = None) -> None:
            self.failures += 1
            raise KVSanitizerError(
                "KV sanitizer [{}]: {}".format(where, message),
                where=where, pages=pages,
            )

        # (0) scale-pool/page-pool consistency (int8 pools): a page id must
        # address a scale row in BOTH scale pools — shape drift would make
        # every dequant read the wrong row, silently
        pc = self.paged_cache
        quantized = pc is not None and getattr(pc, "has_scales", False)
        if quantized:
            for name in ("k_scale", "v_scale"):
                sp = getattr(pc, name)
                if sp.shape[2] != self.pool.num_pages or (
                    sp.shape[3] != self.pool.page_size
                ):
                    fail(
                        "{} pool shape {} does not address the page pool "
                        "({} pages x {} tokens): pages and scale rows no "
                        "longer share a lifecycle".format(
                            name, tuple(sp.shape), self.pool.num_pages,
                            self.pool.page_size,
                        )
                    )

        # (7) two-tier exclusivity (the host-RAM tier)
        tier = getattr(pc, "host_tier", None) if pc is not None else None
        if (tier is not None and self.prefix is not None
                and getattr(self.prefix, "_host", None) is tier):
            host_refs, dual = self.prefix.tier_refs()
            hsnap = tier.snapshot()
            if dual:
                fail("{} cache node(s) hold BOTH a device and a host payload: a page "
                     "must live in exactly one tier".format(dual))
            hfree, hused = hsnap["free"], hsnap["used"]
            if len(set(hfree)) != len(hfree):
                dupes = sorted({h for h in hfree if hfree.count(h) > 1})
                fail("host-tier free list contains duplicates: {}".format(dupes), pages=dupes)
            overlap = sorted(set(hfree) & hused)
            if overlap:
                fail("host pages {} are both free and allocated".format(overlap),
                     pages=overlap)
            if len(hfree) + len(hused) != hsnap["num_pages"]:
                fail("host tier accounts for {} + {} pages of {}".format(
                    len(hfree), len(hused), hsnap["num_pages"]))
            orphans = sorted(h for h in hused if host_refs.get(h, 0) != 1)
            orphans += sorted(h for h in host_refs if h not in hused)
            if orphans:
                fail("host-tier ownership violated (each allocated id must be referenced "
                     "by exactly one cache node): {}".format(sorted(set(orphans))),
                     pages=sorted(set(orphans)))
            if quantized != tier.quantized:
                fail("host tier {} scale slabs but the device pools are {}quantized: "
                     "demoted scale rows no longer track their pages".format(
                         "lacks" if not tier.quantized else "carries",
                         "" if quantized else "not "))
            if tier.page_size != self.pool.page_size:
                fail("host tier page size {} != device page size {}".format(
                    tier.page_size, self.pool.page_size))

        # slot-table occurrences per page (a page CAN legally appear in
        # several slots — shared prefix mapped into multiple page tables)
        slot_occ: Dict[int, int] = {}
        for slot, pages in enumerate(slot_pages):
            for page in pages:
                slot_occ[page] = slot_occ.get(page, 0) + 1
        # (3) slot-table shape
        for slot, pages in enumerate(slot_pages):
            need = self.pool.pages_needed(slot_len[slot])
            if len(pages) != need:
                fail(
                    "slot {} holds {} pages for {} tokens (expected {})".format(
                        slot, len(pages), slot_len[slot], need
                    ),
                    pages=pages,
                )

        # (2) free-list integrity + null page
        if len(set(free)) != len(free):
            dupes = sorted({p for p in free if free.count(p) > 1})
            fail("free list contains duplicates: {}".format(dupes), pages=dupes)
        bad = sorted(p for p in free if refs[p] != 0)
        if bad:
            fail(
                "pages {} are on the free list with refcount > 0".format(bad),
                pages=bad,
            )
        if 0 in free or refs[0] != 0 or slot_occ.get(0) or cache_refs.get(0):
            fail("reserved null page 0 entered circulation", pages=[0])
        free_set = set(free)

        # (1) refcount conservation, page by page
        leaked: List[str] = []
        leaked_ids: List[int] = []
        for page in range(1, len(refs)):
            expected = (
                slot_occ.get(page, 0)
                + cache_refs.get(page, 0)
                + pins.get(page, 0)
            )
            if refs[page] != expected:
                leaked_ids.append(page)
                leaked.append(
                    "page {}: refcount {} != {} accounted "
                    "(slots {} + cache {} + pins {})".format(
                        page, refs[page], expected,
                        slot_occ.get(page, 0), cache_refs.get(page, 0),
                        pins.get(page, 0),
                    )
                )
            if refs[page] == 0 and page not in free_set:
                leaked_ids.append(page)
                leaked.append(
                    "page {}: refcount 0 but missing from the free list".format(
                        page
                    )
                )
        if leaked:
            fail(
                "refcount conservation violated:\n  " + "\n  ".join(leaked),
                pages=sorted(set(leaked_ids)),
            )

        # (4) pending-CoW sanity
        for src, dst in pending_cow:
            if refs[src] <= 0:
                fail(
                    "pending CoW src page {} has no live references".format(src),
                    pages=[src],
                )
            if not slot_occ.get(dst):
                fail(
                    "pending CoW dst page {} is in no slot table".format(dst),
                    pages=[dst],
                )

        # (5) drain: only the prefix cache may keep references
        if drained:
            held = {
                slot: pages for slot, pages in enumerate(slot_pages) if pages
            }
            if held:
                detail = ", ".join(
                    "slot {} -> pages {}".format(slot, pages)
                    for slot, pages in sorted(held.items())
                )
                leaked_pages = sorted(
                    p for pages in held.values() for p in pages
                )
                scale_note = (
                    " (each leaked page also strands its k/v scale rows "
                    "{})".format(leaked_pages)
                    if quantized
                    else ""
                )
                fail(
                    "leaked pages at drain (no live requests): {}{}".format(
                        detail, scale_note
                    ),
                    pages=leaked_pages,
                )
            if pins:
                fail(
                    "admission pins outlived drain: {}".format(dict(pins)),
                    pages=sorted(pins),
                )

    def stats(self) -> Dict[str, int]:
        return {"checks": self.checks, "failures": self.failures}
