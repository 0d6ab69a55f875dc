#!/usr/bin/env python3
"""The ragged kernel's key-range split at several span lengths and with the
split off (one span), on one GPU:

    python3 scripts/ragged_split_profile.py [--profile]

First a sweep of launches on the engine's table (129 pages of 16) and flat
axis (312 tokens): R of 8 rows live, each a decode row (1 query) or a
verify row (5 queries) whose keys end at L, bf16 and int8 pools. Each
launch is captured in a CUDA graph under the port's plan
(``ragged_split_plan``), under spans of each of ``SPANS`` tokens and with
one span (``chip_smoke.fixed_span``), and the graphs are replayed in 10
turns (``chip_smoke.graph_turns``, 4 layers rotated). One JSON line per
case: the better time of each.

With ``--profile``, then chip_smoke.py's phase 6 passes that run the
ragged kernel (the bf16-weight ragged pass and phase 5d's tree-arm pass)
under torch.profiler, in the order plan, one span, one span, plan, on
phase 5's Llama-3-8B weights (random, seed 0): one JSON line with, per pass
and mode, the ragged attention's device ms (the union of both grids'
intervals), the device's busy ms, the wall ms and the busy share, one entry
per run.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIVE_ROWS = (1, 2, 4, 8)
KEYS = (300, 512, 768, 1024, 1536, 2048)
QUERIES = {"decode": 1, "verify": 5}
SPANS = (256, 512, 768, 1024)


def sweep(cs) -> None:
    from clearml_serving_tpu_torch.ops.paged_attention import ragged_paged_attention

    gen = torch.Generator("cuda").manual_seed(0)
    layers = 4
    modes = {"plan": contextlib.nullcontext,
             **{str(span): functools.partial(cs.fixed_span, span) for span in SPANS},
             "one_span": cs.fixed_span}
    for quant in (False, True):
        for kind, n in QUERIES.items():
            for live in LIVE_ROWS:
                for keys in KEYS:
                    rows = [(n, n, keys - n)] * live + [(0, 0, 0)] * (8 - live)
                    ops = cs.ragged_operands(gen, rows, quant=quant, layers=layers,
                                             **cs.VERIFY_LAYOUT)

                    def call(li, mode, ops=ops):
                        args, kw = cs.ragged_args(ops, li)
                        with modes[mode]():
                            ragged_paged_attention(*args, **kw)

                    times = cs.graph_turns([functools.partial(call, mode=mode) for mode in modes],
                                           layers, 100, cs.TREE_PAIRS)
                    print(json.dumps(dict(
                        kv="int8" if quant else "bf16", kind=kind, live_rows=live, keys=keys,
                        ms={mode: min(t) for mode, t in zip(modes, times)})), flush=True)
                    del ops
                    torch.cuda.empty_cache()


def profile(cs) -> None:
    params = cs.llama3_8b_params()
    modes = {"plan": contextlib.nullcontext, "one_span": cs.fixed_span}
    result = {}
    for scheduler in ("ragged", "ragged-tree"):
        runs = result.setdefault(scheduler, {mode: [] for mode in modes})
        for mode in ("plan", "one_span", "one_span", "plan"):
            cs.log("{} pass, {}".format(scheduler, mode))
            with modes[mode]():
                prof = cs.phase_profile(params, scheduler)
            runs[mode].append({key: prof[key] for key in (
                "ragged_attention_ms", "device_busy_ms", "wall_ms", "busy_share",
                "ragged_steps")})
    print(json.dumps(result), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run phase 6's ragged passes with the split on and off")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ragged_split_profile: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    sweep(chip_smoke)
    if args.profile:
        profile(chip_smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
