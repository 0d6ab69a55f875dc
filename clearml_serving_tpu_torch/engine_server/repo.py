"""Engine-server model repository: control-plane reconciler + served models.

The port's copy of ``clearml_serving_tpu/engine_server/repo.py``. Every
endpoint with engine type ``jax_grpc`` becomes a ``CompiledModel``: a
model bundle (``engines/jax_engine.py::load_bundle``) behind a
``DynamicBatcher``; config changes swap the entry while in-flight requests
finish on the old one. What changes on the card:

- **graphs in place of ``jax.jit``**: a model runs through a
  ``BucketRunner`` (``engines/bucket_graph.py``), one CUDA graph per bucket
  key, captured through ``decode_graph.capture_graph`` (``CAPTURE_LOCK``,
  the capture thread and stream, the cycle collector off), so a capture
  started by the reconcile thread is safe beside another model's replay;
- **one thread per model**: its batches run on a step thread leased from
  ``device.lease_step_worker`` (cuBLAS keeps a workspace per thread for the
  life of the process), handed back when the model is retired;
- **retirement in place of collection**: a swapped-out or removed model
  finishes its queued and running batches, then drops its graphs, pool and
  weights under ``CAPTURE_LOCK`` (``CompiledModel.retire``): a graph pool
  freed by the collector at an arbitrary moment, inside another model's
  capture, would invalidate that capture.

The reference canonicalizes 64-bit inputs to 32 bits (``jax.jit`` without
x64); ``run_batch`` does the same before padding. Its multi-host
``dispatcher`` (``parallel/multihost.py``) is not ported.
"""

from __future__ import annotations

import asyncio
import gc
import logging
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from ..device import CAPTURE_LOCK, lease_step_worker, resolve_device, return_step_worker
from ..engines.bucket_graph import BucketRunner
from ..serving.endpoints import ModelEndpoint
from .batcher import DynamicBatcher

# what jax.jit makes of numpy inputs with x64 off
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32}


class CompiledModel:
    """One endpoint's model: a graph per bucket key + a dynamic batcher.
    ``cuda_graphs=False`` runs every batch eagerly: the arm the card tests
    hold the replays against."""

    def __init__(self, endpoint: ModelEndpoint, bundle, params, *, key: str = "",
                 device="cuda", cuda_graphs: bool = True):
        self.endpoint = endpoint
        self.bundle = bundle
        self.params = params
        self.key = key or endpoint.serving_url
        aux = endpoint.auxiliary_cfg if isinstance(endpoint.auxiliary_cfg, dict) else {}
        batching = aux.get("batching") or {}
        self.buckets = sorted(int(b) for b in batching.get("buckets", [1, 2, 4, 8, 16, 32, 64]))
        apply_fn = bundle.apply

        def run(*xs):
            return apply_fn(params, *xs)

        self.runner: Optional[BucketRunner] = BucketRunner(
            run, resolve_device(device), cuda_graphs=cuda_graphs)
        self._stream = self.runner._stream
        self._worker = lease_step_worker(self._stream)
        self._retiring = False
        self.released = threading.Event()
        self.batcher = DynamicBatcher(
            self.run_batch,
            preferred_batch_size=int(batching.get("preferred_batch_size", 8)),
            max_queue_delay_us=int(batching.get("max_queue_delay_us", 2000)),
            max_batch_size=int(batching.get("max_batch_size", 64)),
            # the padding waste of run_batch's bucket padding
            bucket_for=lambda rows: next(
                (b for b in self.buckets if rows <= b), rows
            ),
            executor=self._worker,
        )
        self.input_names = endpoint.input_name or []
        self.input_types = endpoint.input_type or []
        self.output_names = endpoint.output_name or ["output_0"]

    def run_batch(self, concat_inputs: List[np.ndarray]) -> List[np.ndarray]:
        """Batch-concat'd inputs -> list of outputs (leading axis = batch)."""
        runner = self.runner
        if runner is None:
            raise RuntimeError("model {!r} was retired".format(self.key))
        batch = int(concat_inputs[0].shape[0])
        bucket = next((b for b in self.buckets if batch <= b), batch)
        padded = []
        for a in concat_inputs:
            a = np.asarray(a)
            if a.dtype in _CANONICAL:
                a = a.astype(_CANONICAL[a.dtype])
            if a.shape[0] != bucket:
                pad = [(0, bucket - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad)
            padded.append(a)
        out = runner.run(padded)
        leaves = out if isinstance(out, (list, tuple)) else [out]
        return [np.asarray(o)[:batch] for o in leaves]

    def warmup(self) -> None:
        """Capture the smallest bucket ahead of traffic, on the model's
        thread."""
        if not self.input_names:
            return
        try:
            shapes = self.endpoint.input_size or []
            inputs = []
            for i in range(len(self.input_names)):
                shape = [self.buckets[0]] + [int(d) for d in (shapes[i] if i < len(shapes) else [1])]
                dtype = np.dtype(self.input_types[i]) if i < len(self.input_types) else np.float32
                inputs.append(np.zeros(shape, dtype))
            self._worker.submit(self.run_batch, inputs).result()
        except Exception as ex:
            # best effort (the first request captures instead), but a failure
            # here usually means the endpoint I/O spec is wrong: say so
            print("warmup of {!r} failed: {}".format(self.key, ex))

    def health(self) -> Dict[str, Any]:
        runner = self.runner
        return runner.health() if runner is not None else {"ready": False, "released": True}

    # -- retirement -------------------------------------------------------------

    def retire(self) -> None:
        """The repo dropped this model (swapped or removed; called on the
        reconcile thread). Once its batcher is idle, its graphs, pool and
        weights go under ``CAPTURE_LOCK`` and its thread goes back to the
        pool; a model that never served is released now."""
        if self._retiring:
            return
        self._retiring = True
        loop = self.batcher.loop
        if loop is None or loop.is_closed() or not loop.is_running():
            self._release()
            return
        asyncio.run_coroutine_threadsafe(self._retire_when_idle(), loop)

    async def _retire_when_idle(self) -> None:
        try:
            await self.batcher.wait_idle()
            await asyncio.get_running_loop().run_in_executor(self._worker, self._release)
        except Exception:
            logging.getLogger(__name__).exception("retiring model %r failed", self.key)

    def _release(self) -> None:
        with CAPTURE_LOCK:
            runner, self.runner = self.runner, None
            if runner is not None:
                runner.release()
            del runner
            self.params = None
            self.bundle = None
            gc.collect()
        return_step_worker(self._stream, self._worker)
        self.released.set()


class EngineModelRepo:
    """Reconciles the control-plane endpoint set into served models."""

    ENGINE_TYPES = ("jax_grpc",)

    def __init__(self, processor, device="cuda"):
        # processor: ModelRequestProcessor (control-plane reader + registry)
        self._processor = processor
        self.device = resolve_device(device)
        self._models: Dict[str, CompiledModel] = {}
        self._hashes: Dict[str, str] = {}
        self._lock = threading.Lock()

    def get_by_key(self, key: str) -> Optional[CompiledModel]:
        return self._models.get(key)

    @staticmethod
    def model_key(serving_url: str, version: Optional[str] = None) -> str:
        key = serving_url.strip("/")
        if version:
            key = "{}/{}".format(key, version)
        return key

    def get(self, model: str, version: Optional[str] = None) -> Optional[CompiledModel]:
        return self._models.get(self.model_key(model, version))

    def list_models(self) -> Dict[str, Dict[str, Any]]:
        out = {}
        for key, cm in list(self._models.items()):
            health = cm.health()
            out[key] = {
                "engine": cm.endpoint.engine_type,
                "model_id": cm.endpoint.model_id,
                "buckets": cm.buckets,
                "requests_served": cm.batcher.requests_served,
                "batches_executed": cm.batcher.batches_executed,
                "rows_executed": cm.batcher.batch_size_sum,
                "padded_rows": cm.batcher.padded_rows_sum,
                # the port's graphs: one capture per bucket key
                "graph_captures": health.get("graph_captures", 0),
                "graph_replays": health.get("graph_replays", 0),
                "eager_runs": health.get("eager_runs", 0),
                "graph_pool_bytes": health.get("graph_pool_bytes", 0),
                "graph_keys": sorted(health.get("graph_keys") or {}),
            }
        return out

    def sync(self) -> int:
        """One reconcile pass; returns number of (re)loaded models."""
        from ..engines.jax_engine import load_bundle

        self._processor.deserialize(skip_sync=True)
        wanted: Dict[str, ModelEndpoint] = {}
        for url, ep in {
            **self._processor._model_monitoring_endpoints,
            **self._processor.list_endpoints(),
        }.items():
            if ep.engine_type in self.ENGINE_TYPES:
                wanted[url] = ep

        loaded = 0
        registry = self._processor.registry
        for url, ep in wanted.items():
            record = registry.get(ep.model_id) if ep.model_id else None
            content_hash = "{}:{}".format(
                hash(str(sorted(ep.as_dict().items()))),
                (record.as_dict().get("hash") if record else None),
            )
            if self._hashes.get(url) == content_hash and url in self._models:
                continue
            if record is None:
                continue
            try:
                bundle, params = load_bundle(record.get_local_copy(), endpoint=ep,
                                             device=self.device)
            except Exception as ex:
                print("engine-server: failed loading {}: {}".format(url, ex))
                continue
            model = CompiledModel(ep, bundle, params, key=url, device=self.device)
            del bundle, params
            model.warmup()
            with self._lock:
                old = self._models.get(url)
                self._models[url] = model  # atomic swap
                self._hashes[url] = content_hash
            if old is not None:
                old.retire()
            loaded += 1

        stale = set(self._models) - set(wanted)
        for url in stale:
            with self._lock:
                old = self._models.pop(url, None)
                self._hashes.pop(url, None)
            if old is not None:
                old.retire()
        return loaded
