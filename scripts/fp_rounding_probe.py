#!/usr/bin/env python3
"""How the ragged split test's comparison reacts to the process's rounding.

    JAX_PLATFORMS=cpu python3 scripts/fp_rounding_probe.py [--mode nearest|upward|downward|towardzero]

``tests/test_torch_ragged_split.py::test_split_combine_mirror_matches_references``
holds an f32 mirror of the ragged kernel's split arithmetic against the
port's plain version at atol = rtol = 1e-5. This script starts torch's
intra-op thread pool while the main thread rounds in ``--mode`` (threads
inherit the floating-point environment of the thread that creates them),
sets the main thread back to round-to-nearest, then runs the test's
``bf16_values``, G = 1, plain-version case and prints the largest
difference, the elements past the tolerance, and what the tests'
``fp_environment`` (``tests/torch_fp_env.py``) reports. CPU only.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys

import numpy as np

MODES = {"nearest": 0x000, "downward": 0x400, "upward": 0x800, "towardzero": 0xC00}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=sorted(MODES), default="towardzero")
    args = parser.parse_args()
    libm = ctypes.CDLL("libm.so.6")
    import torch

    libm.fesetround(MODES[args.mode])
    torch.set_num_threads(torch.get_num_threads())
    x = torch.randn(2000, 2000)
    float((x @ x).sum()), float(torch.ones(10 ** 7).sum())   # starts the pool
    libm.fesetround(MODES["nearest"])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import test_torch_ragged_split as t
    from torch_fp_env import fp_environment

    ops = t._operands(np.random.default_rng(41), g=1, quant=False)
    splits, span = t.ragged_split_plan(ops["q"].shape[0], len(t.ROWS), t.HKV, t.PP, t.P)
    mirror = t.ragged_split_mirror(ops, splits, span)[0].numpy()
    plain = t._reference(ops, "plain")
    err = np.abs(mirror - plain)
    over = int((err > t.TOL["atol"] + t.TOL["rtol"] * np.abs(plain)).sum())
    print("threads started under {}: max difference {:.3g}, {} of {} elements past the "
          "tolerance".format(args.mode, float(err.max()), over, err.size))
    print(fp_environment())
    return 0


if __name__ == "__main__":
    sys.exit(main())
