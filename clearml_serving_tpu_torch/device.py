"""Device selection shared by every entry point of the port.

Entry points take ``device`` and default to ``"cuda"``. Nothing moves to the
CPU on its own: asking for CUDA where there is none raises, and the CPU is
used only when the caller names it (as the CPU tests do).

``replica_stream(dev, i)`` is the CUDA stream the ``i``-th replica of a
fleet is built on (``llm/openai_api.py``; replica 0 stays on the stream
current at the build): one per replica index and card for the life of the
process. ``prefill_worker(stream)`` is the one thread on which the
engines on ``stream`` (None: the CPU) enqueue their prefills, one dispatch
per job, so their jobs interleave. ``lease_step_worker(stream)`` gives an
engine a step thread of its own for its life, so one engine's stall or
capture never holds another's decode dispatch; ``return_step_worker``
hands it back to its stream's pool when the engine is collected. cuBLAS
keeps a 32 MiB workspace per (thread's handle, stream) until the process
ends, so the threads live as long as the process: engines built one after
another on a stream reuse the same threads, and their workspaces, instead
of making new ones, and the prefills' matmuls hold one workspace per
stream however many engines run there.

``CAPTURE_LOCK`` is held through every CUDA-graph capture, and by whoever
releases an engine that was dropped (the processor's eviction): CUDA
objects freed inside a capture (a dead engine's graphs and events)
invalidate it, and ``gc.disable()`` in the capturing thread does not stop a
``gc.collect()`` in another one.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Dict, List, Optional, Tuple, Union

import torch

CAPTURE_LOCK = threading.RLock()

Worker = concurrent.futures.ThreadPoolExecutor

_REPLICA_STREAMS: Dict[Tuple[int, int], "torch.cuda.Stream"] = {}
# by stream (None: the CPU): its prefill thread, its free step threads
_PREFILL_WORKERS: Dict[Optional[int], Worker] = {}
_FREE_STEP_WORKERS: Dict[Optional[int], List[Worker]] = {}
_MADE = threading.Lock()


def replica_stream(dev: torch.device, index: int) -> "torch.cuda.Stream":
    """The process-wide stream of replica ``index`` on card ``dev``."""
    card = dev.index if dev.index is not None else torch.cuda.current_device()
    with _MADE:
        key = (card, int(index))
        if key not in _REPLICA_STREAMS:
            _REPLICA_STREAMS[key] = torch.cuda.Stream(card)
        return _REPLICA_STREAMS[key]


def _stream_key(stream: Optional["torch.cuda.Stream"]) -> Optional[int]:
    return None if stream is None else stream.cuda_stream


def prefill_worker(stream: Optional["torch.cuda.Stream"]) -> Worker:
    """The process-wide prefill thread of ``stream``."""
    with _MADE:
        key = _stream_key(stream)
        if key not in _PREFILL_WORKERS:
            _PREFILL_WORKERS[key] = Worker(max_workers=1, thread_name_prefix="prefill")
        return _PREFILL_WORKERS[key]


def lease_step_worker(stream: Optional["torch.cuda.Stream"]) -> Worker:
    """A free step thread of ``stream``'s pool, made when none is free."""
    with _MADE:
        free = _FREE_STEP_WORKERS.setdefault(_stream_key(stream), [])
        if free:
            return free.pop()
    return Worker(max_workers=1, thread_name_prefix="step")


def return_step_worker(stream: Optional["torch.cuda.Stream"], worker: Worker) -> None:
    """Hand a leased step thread back to ``stream``'s pool."""
    with _MADE:
        _FREE_STEP_WORKERS.setdefault(_stream_key(stream), []).append(worker)


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device {!r} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU".format(str(device))
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda or cpu (got {!r})".format(str(device)))
    return dev
