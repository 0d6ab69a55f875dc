"""Warmup sweep: the serve loop's first-use costs paid before traffic.

A counterpart of ``clearml_serving_tpu/llm/warmup.py`` (``warmup_plan``
and ``run_warmup``). The JAX engine compiles an XLA program per shape; the
port pays instead for each prefill bucket's first launches (kernel loads,
library handles, allocator growth) and for the CUDA-graph capture of each
decode-chunk variant and ragged launch key. The startup sweep
(``warmup: startup``):

- the CUDA-graph capture of each plain decode-chunk variant (greedy,
  sampled), each preceded by one eager chunk over null rows; as in the
  reference's sweep, the extras and logprob variants are captured at
  their first use;
- one cold prefill per prefill bucket (and the implicit ``max_seq_len``
  bucket past the last configured one), each with one decode chunk;
- with the prefix cache on, the reference's startup subset instead
  (``warmup_plan(full=False)``): per bucket a cold prompt whose
  block-aligned head is stored, then a second prompt with the same head
  that hits it (the gather and the tail's ``prefill_chunk`` segments);
  with the host-RAM tier, the sweep ends by waiting for every promotion
  it started (``reap_promotions(force=True)``).

The full sweep (``warmup: full``) is the reference's, in its order: its
whole request plan (``warmup_plan(full=True)``: resume tails of every
length, every page count of a cold commit, multi-segment tails, a
speculation round), then the copy-on-write copies of null pages at every
power-of-two pair count (the scale pools too on int8), with a KV transport
the export/import round trip of null pages at every power-of-two page
count, and every plain ragged launch key (``ragged_graph.plain_variants``:
windows × verify rows × greedy or sampled), each captured as a CUDA graph
on the card (the port's analog of the reference's
``warm_ragged_variants``; without graphs there is nothing to capture).
The reference's finish-row gathers compile a program per row count,
which PyTorch does not, so the port leaves them out. The extras, logprob
and guided ragged keys are captured at their first use.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List

import torch


def _ids(seed: int, n: int, vocab: int) -> List[int]:
    """Deterministic token content (the reference's ``_ids``)."""
    lim = max(2, min(250, vocab - 2))
    return [(seed * 13 + i * 11) % lim + 1 for i in range(n)]


def _tail(seed: int, n: int, vocab: int) -> List[int]:
    """The reference's ``_tail``."""
    lim = max(2, min(250, vocab - 2))
    return [(seed * 53 + j * 3) % lim + 1 for j in range(n)]


def _buckets(engine) -> List[int]:
    buckets = list(engine._buckets)
    if buckets[-1] < engine.max_seq_len:
        # prompts past the last configured bucket take max_seq_len
        buckets.append(engine.max_seq_len)
    return buckets


def warmup_plan(engine, full: bool = False) -> List[Dict[str, Any]]:
    """The warmup request sweep for this engine's configuration: a list of
    ``{"prompt_ids", "max_new_tokens"}`` specs in order (earlier steps
    store the prefix runs later steps hit). ``full``: the reference's
    ``warmup_plan(full=True)``, spec for spec."""
    vocab = max(engine.model.vocab_size, 8)
    buckets = _buckets(engine)
    if full:
        return _full_plan(engine, buckets, vocab)
    if engine._prefix is not None:
        return _prefix_pairs(engine, buckets, vocab)
    plan = []
    for b in buckets:
        # the longest prompt of bucket b that leaves room for a second
        # token, which takes a decode chunk
        n = min(b, engine.max_seq_len - 2)
        plan.append({"prompt_ids": _ids(b, n, vocab), "max_new_tokens": 2})
    return plan


async def run_warmup(engine, full: bool = False) -> Dict[str, Any]:
    """Capture the decode chunk's graphs, then drive the sweep through
    ``engine.generate`` one request at a time, with the engine in its
    warming state: a capture then counts as a warmup capture, made in the
    global capture mode (nothing else uses the card). ``full`` adds the
    reference's full sweep after the requests (the module docstring).
    Returns ``{"requests", "graph_captures"}``, and with ``full`` the
    reference's ``cow_buckets`` and ``ship_buckets`` besides."""
    from .engine import GenRequest

    plan = warmup_plan(engine, full=full)
    captures = engine.counters["graph_captures"]
    cow = ships = 0
    await engine.wait_drained()
    engine._warming = True
    try:
        await asyncio.to_thread(engine._on_stream, engine._capture_graphs)
        for spec in plan:
            request = GenRequest(prompt_ids=spec["prompt_ids"],
                                 max_new_tokens=spec["max_new_tokens"])
            async for _ in engine.generate(request):
                pass
            await engine.wait_drained()
        # the pairs' hits may have promoted demoted heads
        engine._reap_promotions(force=True)
        if full:
            cow, ships = await asyncio.to_thread(engine._on_stream, _warm_movement, engine)
            await asyncio.to_thread(engine._on_stream, engine._capture_graphs, True)
    finally:
        engine._warming = False
    out = {"requests": len(plan),
           "graph_captures": engine.counters["graph_captures"] - captures}
    if full:
        out.update(cow_buckets=cow, ship_buckets=ships)
    return out


def _warm_movement(engine) -> tuple:
    """The full sweep's page movements over null pages, on the engine's
    stream (the reference's order): the copy-on-write copies at every
    power-of-two pair count up to ``2 * pages_needed(max_seq_len)`` (the
    scale pools with the data on int8), the KV transport's export/import
    round trip at every power-of-two page count up to
    ``pages_needed(max_seq_len)``. Page 0 is the null page: its contents
    are never read. Returns ``(cow_buckets, ship_buckets)``."""
    cache = engine.paged_cache
    dev = engine.device
    cow = 0
    max_pairs = 2 * cache.pool.pages_needed(engine.max_seq_len)
    p = 1
    while p <= max_pairs:
        zeros = torch.zeros(p, dtype=torch.int64, device=dev)
        for pool in cache._pools():
            pool[:, :, zeros] = pool[:, :, zeros]
        cow += 1
        p *= 2
    ships = 0
    if engine._kv_transport is not None:
        max_pages = cache.pool.pages_needed(engine.max_seq_len)
        p = 1
        while True:
            pages = [0] * p
            slabs = cache.export_pages(pages)
            cache.import_pages(slabs["hk"], slabs["hv"], pages, slabs.get("hk_scale"),
                               slabs.get("hv_scale"))
            ships += 1
            if p >= max_pages:
                break
            p *= 2
        cache.reap_promotions(force=True)
    return cow, ships


def _prefix_pairs(engine, buckets: List[int], vocab: int) -> List[Dict[str, Any]]:
    """The reference's ``warmup_plan(full=False)`` with a prefix cache: per
    bucket, the largest block-aligned head that leaves room for a sub-block
    tail in the bucket, then two tails after it (cold + store, then the
    hit); a bucket too small for a head gets one cold prompt."""
    block = engine._prefix.block
    lim = max(2, min(250, vocab - 2))
    plan = []
    for b in buckets:
        p = ((b - block) // block) * block if b > block else 0
        head = _ids(b, p, vocab)
        for rep in range(2 if p else 1):
            tail = [(rep * 37 + j * 5 + b) % lim + 1
                    for j in range(max(1, min(b - p, block) - 1))]
            ids = head + tail
            if 0 < len(ids) < engine.max_seq_len:
                plan.append({"prompt_ids": ids, "max_new_tokens": 2})
    return plan


def _full_plan(engine, buckets: List[int], vocab: int) -> List[Dict[str, Any]]:
    """The reference's ``warmup_plan(full=True)`` (its parts 1-5, the
    comments its own, shortened): the port serves the paged cache only."""
    prefix = engine._prefix
    block = prefix.block if prefix is not None else 0
    plan: List[Dict[str, Any]] = []

    def req(ids: List[int], max_new: int = 2) -> None:
        if 0 < len(ids) < engine.max_seq_len:
            plan.append({"prompt_ids": ids, "max_new_tokens": max_new})

    def bucket_prefix_len(b: int) -> int:
        # the largest block multiple that leaves room for a sub-block tail
        # in the same bucket (0: no stored prefix at this bucket)
        return ((b - block) // block) * block if block and b > block else 0

    # 1) cold prefill per bucket, and a radix store then hit per bucket
    for b in buckets:
        p = bucket_prefix_len(b)
        head = _ids(b, p, vocab)
        for rep in range(2 if (p and prefix is not None) else 1):
            tail = [(rep * 37 + j * 5 + b) % max(2, min(250, vocab - 2)) + 1
                    for j in range(max(1, min(b - p, block or b) - 1))]
            req(head + tail)
    if prefix is None:
        return plan

    # 2) resume tails of one page: every final-segment length 1..block
    for b in buckets:
        p = bucket_prefix_len(b)
        if p < block:
            continue
        head = _ids(b, p, vocab)
        for t in range(1, block + 1):
            req(head + _tail(t, t, vocab))

    # 2b) resume tails of several pages: every (bucket, k pages) pair a
    # stored run shortened to any block-multiple depth can reach
    page = engine.paged_cache.pool.page_size
    for b in buckets:
        p_b = bucket_prefix_len(b)
        if p_b < block:
            continue
        head = _ids(b, p_b, vocab)
        for k in range(2, (b - block) // page + 1):
            p_prime = ((b - k * page) // block) * block
            if p_prime < block or p_prime > p_b:
                continue
            req(head[:p_prime] + _tail(200 + b + k, (k - 1) * page + 1, vocab))

    # 3) a cold commit at every page count
    for n_pages in range(1, engine.paged_cache.pool.pages_needed(buckets[-1]) + 1):
        req(_ids(67 + n_pages, n_pages * page - min(3, page - 1), vocab))

    # 4) multi-segment tails: a hit replaying a tail longer than one block
    if block:
        seed_run = _ids(7, 2 * block - 1, vocab)
        req(seed_run)
        heads = [seed_run[:block]]
        heads += [_ids(b, bucket_prefix_len(b), vocab) for b in buckets
                  if bucket_prefix_len(b) >= block]
        for i, head in enumerate(heads):
            req(head + _tail(100 + i, block + 1, vocab))

    # 5) speculation: one longer greedy request, a verify round
    if engine._speculation is not None:
        k = engine._spec_k
        req(_ids(5, max(1, 2 * block or 8), vocab),
            max_new=max(4, 2 * engine.decode_steps * (k + 1)))
    return plan
