#!/usr/bin/env python3
"""A/B the two-dispatch admission against another checkout's on one GPU, in
one process, under chip_smoke.py phase 12a's traffic.

    python3 scripts/admission_ab.py --baseline build/parent [--runs 4]

The baseline is another checkout of the repository (e.g. the parent commit
unpacked with ``git archive`` into a directory that .gitignore lists). Its
``clearml_serving_tpu_torch`` package is copied under
``build/admission_ab/`` as ``clearml_serving_tpu_torch_baseline`` and
imported under that name beside this checkout's package; where its kernel
sources equal this checkout's, both load one built library.

Llama-3-8B at full width (chip_smoke.py's seed-0 weights, made once), bf16
KV, depth 2 with graphs, max_batch 8, each engine built through its
package's ``build_engine`` with the aux defaults and warmed up
(``warmup()``). Runs in turns baseline, change, change, baseline; a change
run measures the default gate (2 segments per decode chunk, one-dispatch
prefill) and the gate with ``chunked_prefill`` 256, a baseline run its own
admission (one arm). Each arm: seven ~100-token chats decode 256 tokens
each, and once all decode a 1536-token prompt is admitted; printed are the
live rows' worst and median emission gap inside the admission window, the
admitted prompt's TTFT, the live rows' tok/s and the pipeline's dispatch
and retire ms (``chip_smoke.admission_run``). The live rows' greedy streams
must be equal in every run of both checkouts. Prints the card line, then
one JSON line per arm.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

BASELINE_PKG = "clearml_serving_tpu_torch_baseline"
ENGINE = {"preset": "llama3-8b", "cache": "paged", "max_batch": 8, "max_seq_len": 2048,
          "page_size": 16, "decode_steps": 4, "seed": 0, "pipeline_depth": 2}


def import_baseline(base: Path) -> str:
    """Copy the baseline's package under ``build/admission_ab`` as
    ``BASELINE_PKG`` and import it; share this checkout's kernel library
    when the sources are the same. Returns the package name."""
    src = base / "clearml_serving_tpu_torch"
    if not src.is_dir():
        raise SystemExit("no clearml_serving_tpu_torch package under {}".format(base))
    root = ROOT / "build" / "admission_ab"
    dst = root / BASELINE_PKG
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    sys.path.insert(0, str(root))
    mine = importlib.import_module("clearml_serving_tpu_torch.ops._build")
    theirs = importlib.import_module(BASELINE_PKG + ".ops._build")
    if torch.device(cs.DEV).type == "cuda" and theirs._digest() == mine._digest():
        theirs._lib = mine.load_library()
    return BASELINE_PKG


def arms_of(pkg: str) -> list:
    """(label, chunked_prefill) of one run: the baseline's own admission,
    or the change's default gate and its chunked arm."""
    if pkg == BASELINE_PKG:
        return [("baseline", None)]
    return [("gate2", None), ("gate2_chunked", cs.ADMIT_CHUNK)]


async def run_arms(pkg: str, params) -> list:
    api = importlib.import_module(pkg + ".llm.openai_api")
    GenRequest = importlib.import_module(pkg + ".llm.engine").GenRequest
    engine, tokenizer = api.build_engine(dict(ENGINE), device=cs.DEV, params=params)
    live, long_ids = cs.admission_traffic(tokenizer)
    await engine.warmup()
    out = []
    for label, chunk in arms_of(pkg):
        recorder = None
        if pkg != BASELINE_PKG:
            # the default gate's budget, recording its dispatches and deposits
            recorder = cs.arm_admission(engine, 2, chunk)
        if chunk:
            # the segments' first use, outside the measured arm
            async for _ in engine.generate(GenRequest(prompt_ids=long_ids, max_new_tokens=2)):
                pass
            await engine.wait_drained()
        run = await cs.admission_run(engine, GenRequest, live, long_ids, recorder)
        cs.check_admission_tokens(label, run, len(live))
        run["arm"] = label
        out.append(run)
    engine.stop()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", required=True, type=Path)
    parser.add_argument("--runs", type=int, default=4,
                        help="turns baseline, change, change, baseline, ... (default 4)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("admission_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    card = cs.card_line()
    baseline = import_baseline(args.baseline.resolve())
    params = cs.llama3_8b_params()
    order = [baseline, "clearml_serving_tpu_torch", "clearml_serving_tpu_torch", baseline]
    order = (order * (-(-args.runs // 4)))[:args.runs]
    streams = None
    print(card, flush=True)
    for turn, pkg in enumerate(order):
        for run in asyncio.run(run_arms(pkg, params)):
            live = run.pop("tokens")[:len(cs.ADMIT_CHATS)]
            if streams is None:
                streams = live
            elif live != streams:
                raise AssertionError("turn {} {}: a live row's greedy stream differs: {}".format(
                    turn, run["arm"], [cs.first_token_difference(a, b)
                                       for a, b in zip(streams, live)]))
            cs.log_admission("turn {} {}".format(turn, run["arm"]), run, card)
            print(json.dumps(dict(run, turn=turn, card=card)), flush=True)
        cs.release_card_memory()
    print("live rows' greedy streams equal in every run", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
