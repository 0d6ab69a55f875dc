"""Split a ragged step's host time on the card into its parts.

Runs phase 5b's traffic (``chip_smoke.serve_ragged``: four long prompts
admitted one after another beside live decode rows, 32 tokens each) and
phase 5d's tree-speculation traffic on Llama-3-8B at full width and depth,
with eager ragged steps (``cuda_graphs`` off), and times on the host, per
ragged step:

- ``prepare``: the loop thread's plan (``_prepare_ragged``);
- ``coords``: the page allocation and the per-token page coordinates
  (``PagePool.extend`` and ``PagePool.token_coords``);
- ``enqueue``: the launches of the step (``forward_ragged``,
  ``decode_paged``, the acceptance, the tree KV compaction and the
  sampling), or the CUDA-graph replay;
- ``reads``: the ``.cpu()`` reads at the end of the step, which wait for
  the card;
- ``other``: the rest of the worker's call (the uploads, the staging).

Usage, on the machine with the card::

    python3 scripts/ragged_step_split.py [--tree DIR]

``--tree`` imports the port and ``chip_smoke.py`` from another checkout
(the parent, unpacked with ``git archive``), so one call can split both.
The functions it wraps exist in every tree since the ragged scheduler
came; a name a tree lacks is skipped. Writes
``chiprun_out/ragged_split.json`` beside the printed lines. Phase 5f of
``chip_smoke.py`` splits its graphed steps with ``StepSplit``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

PARTS = ("prepare", "coords", "enqueue", "reads", "other")


class StepSplit:
    """Host timers of one engine's ragged steps, armed between ``start``
    and ``stop`` (``chip_smoke.serve_ragged`` calls them around its timed
    traffic, as it would a profiler's)."""

    def __init__(self):
        self.armed = False
        self.ms = {part: 0.0 for part in PARTS}
        self.worker_ms = 0.0
        self.steps = 0
        self._local = threading.local()

    def start(self):
        self.armed = True

    def stop(self):
        self.armed = False

    def _timed(self, part, fn, in_step=True):
        split = self

        def wrapper(*args, **kwargs):
            local = split._local
            # a wrapped call inside another (forward_ragged inside the eager
            # launch) counts once, in the outer one
            if not split.armed or getattr(local, "timing", False) or (
                    in_step and not getattr(local, "in_step", False)):
                return fn(*args, **kwargs)
            local.timing = True
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if part == "coords" and not isinstance(out, (list, tuple, type(None))):
                    out = list(out)
                return out
            finally:
                local.timing = False
                split.ms[part] += (time.perf_counter() - t0) * 1e3
        return wrapper

    @contextlib.contextmanager
    def on(self, engine):
        """Wrap the engine's (and its model's, pool's) functions, and
        ``torch.Tensor.cpu`` on its step thread, while the block runs."""
        import torch

        split = self
        patched = []

        def patch(obj, name, wrapper_of):
            fn = getattr(obj, name, None)
            if fn is None:
                return
            setattr(obj, name, wrapper_of(fn))
            patched.append((obj, name))

        def worker(fn):
            def wrapper(*args, **kwargs):
                if not split.armed:
                    return fn(*args, **kwargs)
                split._local.in_step = True
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    split._local.in_step = False
                    split.worker_ms += (time.perf_counter() - t0) * 1e3
                    split.steps += 1
            return wrapper

        patch(engine, "_prepare_ragged", lambda fn: self._timed("prepare", fn, in_step=False))
        patch(engine, "_dispatch_ragged_device", worker)
        pool = engine.paged_cache.pool
        for name in ("extend", "token_coords"):
            patch(pool, name, lambda fn: self._timed("coords", fn))
        for name in ("forward_ragged", "decode_paged"):
            patch(engine.model, name, lambda fn: self._timed("enqueue", fn))
        for name in ("_spec_accept", "_compact_tree_kv", "_sample_rows", "_run_ragged"):
            patch(engine, name, lambda fn: self._timed("enqueue", fn))
        graphs = getattr(engine, "_ragged_graphs", None)
        if graphs is not None:
            patch(graphs, "replay", lambda fn: self._timed("enqueue", fn))
        cpu = torch.Tensor.cpu
        torch.Tensor.cpu = self._timed("reads", cpu)
        try:
            yield self
        finally:
            torch.Tensor.cpu = cpu
            for obj, name in patched:
                delattr(obj, name)

    def summary(self) -> dict:
        """ms a step of each part (``other``: the worker's time the wrapped
        functions leave over)."""
        n = max(1, self.steps)
        out = {part: self.ms[part] / n for part in PARTS}
        worker = self.worker_ms / n
        out["other"] = worker - sum(out[p] for p in ("coords", "enqueue", "reads"))
        out["worker"] = worker
        out["step"] = worker + out["prepare"]
        out["steps"] = self.steps
        return out


ARMS = (("plain", "", "RAGGED_KNOBS", None),
        ("plain", "int8", "RAGGED_KNOBS", None),
        ("tree", "", "TREE_KNOBS", "spec"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ragged_step_split: no card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import asyncio

    import chip_smoke as cs

    card = cs.card_line()
    params = cs.llama3_8b_params()
    rows = []
    for arm, kv, knobs_name, traffic in ARMS:
        knobs = getattr(cs, knobs_name)
        engine, tokenizer = cs._engine(params, kv, "llama3-8b", False, **knobs)
        split = StepSplit()
        kw = ({"max_tokens": cs.SPEC_MAX_TOKENS, "prompts": cs.SPEC_PROMPTS,
               "samplings": cs.SPEC_SAMPLINGS} if traffic == "spec" else {})
        with split.on(engine):
            _results, wall, c = asyncio.run(cs.serve_ragged(engine, tokenizer, profiler=split,
                                                            **kw))
        row = dict(arm=arm, kv=kv or "bf16", wall_s=wall, ragged_steps=c["ragged_steps"],
                   ragged_ms=c["ragged_ms"] / max(1, c["ragged_steps"]), **split.summary())
        rows.append(row)
        print("{} {}: {} ragged steps, {:.2f} ms each by the engine; host ms a step: "
              "prepare {prepare:.2f}, coords {coords:.2f}, enqueue {enqueue:.2f}, reads "
              "{reads:.2f}, other {other:.2f} (worker {worker:.2f})".format(
                  arm, row["kv"], row["ragged_steps"], row["ragged_ms"], **row), flush=True)
        del engine
        torch.cuda.empty_cache()
    out = {"card": card, "tree": tree, "rows": rows}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "ragged_split.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
