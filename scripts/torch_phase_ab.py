#!/usr/bin/env python3
"""Run chip_smoke.py's phase 7 (the request lifecycle) and 12a (the
two-dispatch admission beside decode) from one checkout on one GPU, and
print their figures as one JSON line: phase 7's interactive TTFT with and
without preemption, each 12a arm's admitted TTFT and the live rows' worst
and median emission gaps, and the ``behind_train`` arm: on 12a's engine,
six of its live chats decoding, its long prompt as a ``batch`` admission
chunked in 256-token segments (paced by a fresh default gate, 2 segments
a decode chunk), and its seventh chat as an ``interactive`` admission
submitted 50 ms after it; the TTFT of each.

    python3 scripts/torch_phase_ab.py [--tree DIR] [--label NAME]

``--tree`` is the root of the checkout whose ``chip_smoke.py`` and
``clearml_serving_tpu_torch`` run (default: this one), e.g. the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists; its kernels are built from its own sources. Compare two versions on
one card by running this once per checkout in turns (baseline, change,
change, baseline), each in a process of its own. Prints the card line,
the phases' own log lines, then the JSON line.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BEHIND_DELAY_S = 0.05
BEHIND_TOKENS = 8


async def behind_train(cs, engine, tokenizer) -> dict:
    """The ``behind_train`` arm (module docstring)."""
    from clearml_serving_tpu_torch.llm.engine import GenRequest, _PrefillGate

    chats, long_ids = cs.admission_traffic(tokenizer)
    live = chats[:6]
    engine._chunked = cs.ADMIT_CHUNK
    engine._prefill_gate = _PrefillGate(2)
    first = {}

    async def consume(name, ids, max_new, priority):
        t0 = time.perf_counter()
        async for _ in engine.generate(GenRequest(prompt_ids=list(ids), max_new_tokens=max_new,
                                                  priority=priority)):
            first.setdefault(name, (time.perf_counter() - t0) * 1e3)

    tasks = [asyncio.ensure_future(consume(i, ids, cs.ADMIT_LIVE_TOKENS, "interactive"))
             for i, ids in enumerate(live)]
    await cs.until(lambda: len(first) == len(live), 300, "the live rows decoding")
    await asyncio.sleep(0.2)
    tasks.append(asyncio.ensure_future(consume("batch", long_ids, cs.ADMIT_LONG_TOKENS,
                                               "batch")))
    await asyncio.sleep(BEHIND_DELAY_S)
    tasks.append(asyncio.ensure_future(consume("interactive", chats[6], BEHIND_TOKENS,
                                               "interactive")))
    await asyncio.gather(*tasks)
    return {"batch_ttft_ms": first["batch"], "interactive_ttft_ms": first["interactive"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=ROOT,
                        help="root of the checkout to run (default: this one)")
    parser.add_argument("--label", default=None, help="name printed with the figures")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_phase_ab: needs a GPU", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from clearml_serving_tpu_torch.ops import _build

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    params = cs.llama3_8b_params()
    t0 = time.perf_counter()
    lifecycle = cs.phase_lifecycle(params, card)
    engine, tokenizer = cs._engine(params, "", "llama3-8b", pipeline_depth=2)
    admission = asyncio.run(cs.admission_12a(engine, tokenizer, card))
    behind = asyncio.run(behind_train(cs, engine, tokenizer))
    engine.stop()
    out = {"label": args.label or str(tree), "card": card,
           "seconds": time.perf_counter() - t0,
           "phase7": {k: lifecycle[k] for k in ("ttft_ms_preempt", "ttft_ms_no_preempt",
                                                "first_text_ms_preempt",
                                                "first_text_ms_no_preempt", "preemptions")},
           "phase12a": {arm: {k: run.get(k) for k in ("ttft_ms", "worst_gap_ms",
                                                       "median_gap_ms", "steady_gap_ms")}
                        for arm, run in admission["runs"].items()},
           "behind_train": behind}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
