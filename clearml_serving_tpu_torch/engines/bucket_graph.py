"""The ``jax`` engine type's compute: one CUDA graph per batch-bucket key.

The reference jits a bundle's ``apply`` once per batch bucket
(``clearml_serving_tpu/engines/jax_engine.py``, ``_compiled``), and jit
traces again for any other input shape, such as BERT's sequence length. So
the port keys its graphs by the bucket and the padded inputs' shapes and
dtypes. Each key:

- has static input buffers on the card, which a request's padded host
  arrays are copied into;
- is captured once, at its first request, through
  ``llm/decode_graph.capture_graph`` (``CAPTURE_LOCK``, the capture thread
  and stream, the eager warm-up run, the cycle collector off); a failed
  capture raises, naming the key, and nothing falls back;
- replays into the graph's outputs, which are copied to the host before
  the next replay.

The keys of one endpoint share one memory pool: replays are serial (one
lock) and each one's outputs are read before the next. Runners that never
replay at once may share one pool too (``pool``: the encoder's three
functions, ``llm/encoder.py``). ``release()`` drops a retired runner's
graphs, buffers, function and pool; its owner calls it under
``CAPTURE_LOCK``, after its last replay. ``health()``
reports the captures, replays, the pool's bytes (the rise of the card's
reserved memory inside the captures) and each key's capture ms, as the LLM
engine's ``health()`` reports its graphs.

``cuda_graphs=False`` (the constructor's argument; no aux key sets it) runs
every request eagerly: the arm the card tests hold the replays against. A
user ``load()`` callable runs eagerly too: the port does not capture code it
does not know. On the CPU everything runs eagerly.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..llm.decode_graph import _on_capture_thread, capture_graph

Key = Tuple[int, Tuple[Tuple[Tuple[int, ...], str], ...]]


def bucket_key(arrays: List[np.ndarray]) -> Key:
    """(bucket, ((shape, dtype), ...)) of a request's padded inputs."""
    bucket = int(arrays[0].shape[0]) if arrays and arrays[0].ndim else 1
    return bucket, tuple((tuple(int(d) for d in a.shape), a.dtype.str) for a in arrays)


def key_label(key: Key) -> str:
    bucket, specs = key
    return "b{}:".format(bucket) + ",".join(
        "x".join(str(d) for d in shape) + np.dtype(dt).name for shape, dt in specs)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_host(t):
    """An output tensor as numpy (bf16 widened to f32: numpy has no bf16,
    and the values are the same)."""
    if not isinstance(t, torch.Tensor):
        return t
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class BucketRunner:
    """Runs ``fn(*tensors)`` over a request's padded host arrays on
    ``device``: a CUDA graph per key (``graphs``), else eagerly."""

    def __init__(self, fn: Callable, device, cuda_graphs: bool = True, pool=None):
        self._fn = fn
        self.device = torch.device(device)
        self.graphs = self.device.type == "cuda" and bool(cuda_graphs)
        self._lock = threading.Lock()
        # key -> (graph, static inputs, static outputs)
        self._entries: Dict[Key, tuple] = {}
        self.captures = 0
        self.replays = 0
        self.eager_runs = 0
        # key label -> {"capture_ms", "pool_bytes"} (the rise of the card's
        # reserved memory inside its capture)
        self.graph_keys: Dict[str, Dict[str, float]] = {}
        self._stream = torch.cuda.current_stream(self.device) if self.graphs else None
        self._pool = None
        if self.graphs:
            self._pool = pool if pool is not None else torch.cuda.graph_pool_handle()

    def run(self, arrays: List[np.ndarray]):
        """The outputs (numpy, the whole bucket) of one padded batch."""
        if self._fn is None:
            raise RuntimeError("this bucket runner was released")
        if not self.graphs:
            with torch.inference_mode():
                out = self._fn(*[to_device(a, self.device) for a in arrays])
                self.eager_runs += 1
                return tree_map(to_host, out)
        key = bucket_key(arrays)
        with self._lock, torch.inference_mode(), torch.cuda.stream(self._stream):
            entry = self._entries.get(key)
            if entry is None:
                inputs = [to_device(a, self.device) for a in arrays]
                entry = self._capture(key, inputs)
            else:
                for buf, a in zip(entry[1], arrays):
                    buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            entry[0].replay()
            self.replays += 1
            return tree_map(to_host, entry[2])

    def _capture(self, key: Key, inputs: List[torch.Tensor]) -> tuple:
        t0 = time.perf_counter()
        try:
            graph, out, _per_replay, grown = _on_capture_thread(
                self._capture_on, inputs)
        except Exception as ex:
            raise RuntimeError("CUDA graph capture of bucket key {} failed: {}".format(
                key_label(key), ex)) from ex
        self.captures += 1
        self.graph_keys[key_label(key)] = {
            "capture_ms": round((time.perf_counter() - t0) * 1e3, 3), "pool_bytes": int(grown)}
        entry = (graph, inputs, out)
        self._entries[key] = entry
        return entry

    def _capture_on(self, inputs: List[torch.Tensor]):
        """On the capture thread, ordered after the endpoint's stream."""

        def run():
            with torch.inference_mode():
                return self._fn(*inputs)

        with torch.cuda.stream(self._stream):
            return capture_graph(run, self._stream, (), "thread_local", pool=self._pool)

    def release(self) -> None:
        """Drop the graphs, their static buffers, the function (and the
        weights it holds) and the pool handle. The caller holds
        ``CAPTURE_LOCK`` and collects afterwards."""
        with self._lock:
            self._entries.clear()
            self._fn = None
            self._pool = None

    def entry(self, arrays: List[np.ndarray]):
        """(graph, static inputs, static outputs) of the key of ``arrays``
        (None before its capture): what a timing harness replays."""
        return self._entries.get(bucket_key(arrays))

    def health(self) -> Dict[str, Any]:
        return {
            "ready": True,
            "device": str(self.device),
            "cuda_graphs": self.graphs,
            "graph_captures": self.captures,
            "graph_replays": self.replays,
            "eager_runs": self.eager_runs,
            "graph_pool_bytes": sum(int(k["pool_bytes"]) for k in self.graph_keys.values()),
            "graph_keys": {label: dict(k) for label, k in self.graph_keys.items()},
        }
