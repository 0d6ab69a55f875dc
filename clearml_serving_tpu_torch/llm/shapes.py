"""Shape bucketing: prompts pad to the next prefill bucket, as in the
reference engine (``clearml_serving_tpu/llm/engine.py``
``_DEFAULT_PREFILL_BUCKETS``, ``__init__`` and ``_bucket_for``), and the
ragged scheduler's power-of-two collapses (``clearml_serving_tpu/llm/
shapes.py`` ``pow2_bucket`` and ``decode_steps_bucket``). PyTorch runs
eagerly, so a bucket is not a compile key here; it keeps the padded shapes,
and so the numbers and the schedule, the same as the reference's."""

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


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two >= max(n, lo) (finish-row logit gathers)."""
    bucket = max(1, int(lo))
    n = int(n)
    while bucket < n:
        bucket *= 2
    return bucket


def decode_steps_bucket(n: int, cap: Optional[int] = None) -> int:
    """Largest power of two <= max(1, n), optionally capped: the ragged
    scheduler's multi-step decode window. Rounding down keeps a launch
    within its token budget."""
    n = max(1, int(n))
    if cap is not None:
        n = min(n, max(1, int(cap)))
    bucket = 1
    while bucket * 2 <= n:
        bucket *= 2
    return bucket
