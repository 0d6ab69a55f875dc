"""Device selection shared by every entry point of the port.

Entry points take ``device`` and default to ``"cuda"``. Nothing moves to the
CPU on its own: asking for CUDA where there is none raises, and the CPU is
used only when the caller names it (as the CPU tests do).
"""

from __future__ import annotations

from typing import Union

import torch


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
