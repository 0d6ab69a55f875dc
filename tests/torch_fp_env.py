"""The process's floating-point rounding, for the message of a failed
float comparison in the port's tests (``test_torch_ragged_ops.py``,
``test_torch_ragged_split.py``) and for ``scripts/fp_rounding_probe.py``."""

import numpy as np
import torch


def fp_environment() -> str:
    """How this process rounds: float32 divisions on the main thread
    (numpy) and 2**20 across torch's intra-op threads. Under
    round-to-nearest +-1/3 is +-0x3EAAAAAB everywhere; a thread left in
    another rounding mode by earlier code shows here."""
    third = float(np.frombuffer(np.uint32(0x3EAAAAAB).tobytes(), np.float32)[0])
    signs = np.float32([1, -1])
    main = bool(((signs / np.float32(3)) == signs * third).all())
    quotients = torch.from_numpy(signs).repeat(1 << 19) / 3.0
    off = int((quotients != torch.from_numpy(signs * third).repeat(1 << 19)).sum())
    return ("float environment: main thread rounds to nearest: {}; torch intra-op threads: "
            "{} of {} float32 quotients off round-to-nearest".format(main, off, 1 << 20))
