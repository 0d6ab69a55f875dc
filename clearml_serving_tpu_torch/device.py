"""Device selection shared by every entry point of the port.

Entry points take ``device`` and default to ``"cuda"``. Nothing moves to the
CPU on its own: asking for CUDA where there is none raises, and the CPU is
used only when the caller names it (as the CPU tests do).

``CAPTURE_LOCK`` is held through every CUDA-graph capture, and by whoever
releases an engine that was dropped (the processor's eviction): CUDA
objects freed inside a capture (a dead engine's graphs and events)
invalidate it, and ``gc.disable()`` in the capturing thread does not stop a
``gc.collect()`` in another one.
"""

from __future__ import annotations

import threading
from typing import Union

import torch

CAPTURE_LOCK = threading.RLock()


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
