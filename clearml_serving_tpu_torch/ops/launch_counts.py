"""Launch counts of the hand-written kernels' wrappers.

Each wrapper keeps its total in ``<wrapper>.launches`` (the ragged wrapper
its draft-tree launches in ``.tree_launches`` besides), which the card's
checks hold to the kernels the card ran; a CUDA-graph capture moves its
warm-up run's launches into ``.setup_launches``. Admission workers and the
decode loop's threads launch at once, so every change goes through
:func:`add`, under one lock. Each thread also keeps its own tally (:func:`own`), from
which a CUDA-graph capture takes its own calls back out of the totals
without touching another thread's launches.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_local = threading.local()


def add(fn, n: int = 1, attr: str = "launches") -> None:
    """Add ``n`` launches (negative: take them back) to wrapper ``fn``'s
    ``attr`` count and to this thread's tally of it."""
    with _lock:
        setattr(fn, attr, getattr(fn, attr) + n)
    tally = _local.__dict__.setdefault("tally", {})
    key = (id(fn), attr)
    tally[key] = tally.get(key, 0) + n


def own(fn, attr: str = "launches") -> int:
    """The launches of wrapper ``fn`` that this thread counted so far."""
    return getattr(_local, "tally", {}).get((id(fn), attr), 0)
