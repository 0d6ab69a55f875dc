"""Prefill bucketing: prompts pad to the next bucket, as in the reference
engine (``clearml_serving_tpu/llm/engine.py`` ``_DEFAULT_PREFILL_BUCKETS``,
``__init__`` and ``_bucket_for``). PyTorch runs eagerly, so a bucket is not a
compile key here; it keeps the prefill's padded shapes, and so its numbers,
the same as the reference's."""

from __future__ import annotations

from typing import List, Optional, Sequence

DEFAULT_PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)


def prefill_buckets(buckets: Optional[Sequence[int]], max_seq_len: int) -> List[int]:
    """The buckets that fit ``max_seq_len`` (or ``[max_seq_len]``)."""
    return sorted(
        b for b in (buckets or DEFAULT_PREFILL_BUCKETS) if b <= max_seq_len
    ) or [max_seq_len]


def bucket_for(n: int, buckets: Sequence[int], max_seq_len: int) -> int:
    """Smallest bucket holding ``n`` tokens, else ``max_seq_len``."""
    for b in buckets:
        if n <= b:
            return b
    return max_seq_len
