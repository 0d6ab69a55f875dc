"""Warmup sweep: the serve loop's first-use costs paid before traffic.

A trimmed counterpart of ``clearml_serving_tpu/llm/warmup.py``
(``warmup_plan`` and ``run_warmup``). The JAX engine compiles an XLA
program per shape; the port pays instead for each prefill bucket's first
launches (kernel loads, library handles, allocator growth) and for the
CUDA-graph capture of each decode-chunk variant. The sweep keeps what the
port serves:

- the CUDA-graph capture of each decode-chunk variant (greedy, sampled),
  each preceded by one eager chunk over null rows;
- one cold prefill per prefill bucket (and the implicit ``max_seq_len``
  bucket past the last configured one), each with one decode chunk.

The reference's radix-hit, resume-tail, copy-on-write, transport and
ragged-variant steps have nothing to warm here: the prefix cache and the
fleet are not ported, and ragged launches run eagerly.
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
    ``{"prompt_ids", "max_new_tokens"}`` specs in order."""
    vocab = max(engine.model.vocab_size, 8)
    buckets = list(engine._buckets)
    if buckets[-1] < engine.max_seq_len:
        buckets.append(engine.max_seq_len)
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
    finally:
        engine._warming = False
    return {"requests": len(plan),
            "graph_captures": engine.counters["graph_captures"] - captures}
