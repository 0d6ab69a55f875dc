"""Warmup sweep: the serve loop's first-use costs paid before traffic.

A trimmed counterpart of ``clearml_serving_tpu/llm/warmup.py``
(``warmup_plan`` and ``run_warmup``). The JAX engine compiles an XLA
program per shape; the port pays instead for each prefill bucket's first
launches (kernel loads, library handles, allocator growth) and for the
CUDA-graph capture of each decode-chunk variant. The sweep keeps what the
port serves:

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

The reference's full sweep (resume tails, copy-on-write and transport
steps, the ragged variants) stays out: ragged launches run eagerly, and
the fleet is not ported.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, List


def _ids(seed: int, n: int, vocab: int) -> List[int]:
    """Deterministic token content (the reference's ``_ids``)."""
    lim = max(2, min(250, vocab - 2))
    return [(seed * 13 + i * 11) % lim + 1 for i in range(n)]


def warmup_plan(engine) -> List[Dict[str, Any]]:
    """The warmup request sweep for this engine's configuration: a list of
    ``{"prompt_ids", "max_new_tokens"}`` specs in order (a pair's cold
    prompt stores the head its second prompt hits)."""
    vocab = max(engine.model.vocab_size, 8)
    buckets = list(engine._buckets)
    if buckets[-1] < engine.max_seq_len:
        buckets.append(engine.max_seq_len)
    if engine._prefix is not None:
        return _prefix_pairs(engine, buckets, vocab)
    plan = []
    for b in buckets:
        # the longest prompt of bucket b that leaves room for a second
        # token, which takes a decode chunk
        n = min(b, engine.max_seq_len - 2)
        plan.append({"prompt_ids": _ids(b, n, vocab), "max_new_tokens": 2})
    return plan


async def run_warmup(engine) -> Dict[str, Any]:
    """Capture the graphs, then drive the sweep through ``engine.generate``
    one request at a time, with the engine in its warming state: a capture
    then counts as a warmup capture, made in the global capture mode
    (nothing else uses the card). Returns ``{"requests",
    "graph_captures"}``."""
    from .engine import GenRequest

    plan = warmup_plan(engine)
    captures = engine.counters["graph_captures"]
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
    finally:
        engine._warming = False
    return {"requests": len(plan),
            "graph_captures": engine.counters["graph_captures"] - captures}


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
