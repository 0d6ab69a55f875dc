"""Request orchestration core.

Capability parity with the reference's ModelRequestProcessor
(clearml_serving/serving/model_request_processor.py, 1569 LoC):

- endpoint registry (static + monitoring-generated), lazy per-endpoint engine
  construction with cache eviction after config sync;
- **zero-downtime config updates**: an inflight-request counter (GIL-atomic two
  `itertools.count` design, reference :58-70) lets `deserialize` drain inflight
  requests, atomically swap every endpoint dict, and release — requests arriving
  mid-swap async-sleep briefly and retry;
- config-hash change detection so a poll with no changes is a no-op;
- canary routing: weighted choice over resolved routes, fixed lists (weight
  renormalization, missing-endpoint skip) and prefix mode (numeric-version-desc
  resolution);
- auto-deployment: model-registry queries materialize versioned endpoints with
  monotone version numbers and publish them to the `model_monitoring_eps`
  config object for engine sidecars;
- background sync daemon (heartbeat ping + reload + monitored query) and a
  batched stats queue drained to the statistics broker;
- per-request sampled statistics with reserved `_latency`/`_count`/`_url` keys.

The control plane is a ServingService document (state/store.py) instead of a
ClearML Task; the mechanism (poll + reconcile, serialize/deserialize) is the
same.

The port's copy of ``clearml_serving_tpu/serving/model_request_processor.py``,
with three changes:

- the stats queue is the deque alone (the reference's optional native MPSC
  ring, ``TPUSERVE_NATIVE_QUEUE``, is not ported);
- the processor takes ``device`` (default ``"cuda"``) and passes it to every
  engine request it builds: the CPU tests ask for the CPU this way, and no
  environment variable does;
- an evicted processor is retired (``BaseEngineRequest.retire``: the LLM
  engine stops once its in-flight requests end, and its device memory comes
  back), and the eviction's release runs under ``device.CAPTURE_LOCK``,
  never inside another engine's CUDA-graph capture.
"""

from __future__ import annotations

import asyncio
import gc
import itertools
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Union

import numpy as np

from .endpoints import (
    CanaryEP,
    EndpointMetricLogging,
    ModelEndpoint,
    ModelMonitoring,
)
from ..device import CAPTURE_LOCK
from ..engines import get_engine_cls
from ..engines.base import BaseEngineRequest
from .responses import StreamingOutput
from ..state import ModelRegistry, ServingService, StateStore
from ..utils.files import sha256_obj
from ..version import __version__


# serve-type dispatch allowlist: v1_chat_completions, v2_embeddings, ...
# versioned API handler names, plus the bare "version" route (the reference's
# show_version, preprocess_service.py:890 / :1218)
_SERVE_TYPE_RE = re.compile(r"^(v\d+_[a-z][a-z0-9_]*|version)$")


class EndpointNotFoundException(Exception):
    pass


class EndpointBackendError(Exception):
    pass


class ServingInitializationError(Exception):
    pass


class FastWriteCounter:
    """Lock-free inflight counter: two GIL-atomic itertools counters
    (reference model_request_processor.py:58-70)."""

    def __init__(self):
        self._inc = itertools.count()
        self._dec = itertools.count()

    def inc(self) -> None:
        next(self._inc)

    def dec(self) -> None:
        next(self._dec)

    def value(self) -> int:
        # next() returns the number of prior calls; advancing both counters by
        # one each keeps the inc-dec difference invariant across reads.
        return next(self._inc) - next(self._dec)


class FastSimpleQueue:
    """Stats queue with batched wakeups: the notifier only fires the Event
    every `_notify_every` seconds, trading latency for throughput on the hot
    path (reference :73-101). A plain deque (GIL-atomic append/popleft)."""

    _notify_every = 10.0

    def __init__(self):
        self._q = deque()
        self._event = threading.Event()
        self._last_notify = time.time()

    def put(self, item) -> None:
        self._q.append(item)
        self._maybe_notify()

    def _maybe_notify(self) -> None:
        if time.time() - self._last_notify > self._notify_every:
            self._last_notify = time.time()
            self._event.set()

    def wake(self) -> None:
        """End a ``get_all`` wait now (a stop)."""
        self._event.set()

    def get_all(self, timeout: float) -> List[Any]:
        self._event.wait(timeout=timeout)
        self._event.clear()
        out: List[Any] = []
        while True:
            try:
                out.append(self._q.popleft())
            except IndexError:
                break
        return out


class ModelRequestProcessor:
    _config_key_serving_base_url = "serving_base_url"
    _config_key_engine_grpc_addr = "engine_grpc_server"
    _config_key_stats_broker = "stats_broker"
    _config_key_metric_log_freq = "metric_logging_freq"

    # the endpoint/canary/metric registries and telemetry counters are read
    # lock-free on the serving event loop. The sync daemon
    # (_sync_daemon_loop) may REPLACE them, but only through the
    # zero-downtime swap protocol: atomic dict rebinds under
    # _update_lock_guard after the inflight-request drain

    def __init__(
        self,
        service_id: Optional[str] = None,
        state_root: Optional[str] = None,
        force_create: bool = False,
        name: Optional[str] = None,
        project: Optional[str] = None,
        tags: Optional[List[str]] = None,
        update_lock_guard: Optional[threading.Lock] = None,
        device: str = "cuda",
    ):
        # where the engine requests this processor builds place their models
        self.device = device
        self._store = StateStore(state_root)
        self._registry = ModelRegistry(self._store.root)
        if force_create:
            self._service = self._store.create_service(
                name or "tpu-serving", project=project or "DevOps", tags=tags
            )
        elif service_id:
            self._service = self._store.get_service(service_id)
        else:
            svc = self._store.find_service(name)
            if svc is None:
                raise ServingInitializationError(
                    "no serving service found (create one with `tpu-serving create`)"
                )
            self._service = svc

        self._endpoints: Dict[str, ModelEndpoint] = {}
        self._model_monitoring: Dict[str, ModelMonitoring] = {}
        self._model_monitoring_endpoints: Dict[str, ModelEndpoint] = {}
        self._model_monitoring_versions: Dict[str, Dict[str, int]] = {}
        self._canary_endpoints: Dict[str, CanaryEP] = {}
        self._canary_route: Dict[str, dict] = {}
        self._metric_logging: Dict[str, EndpointMetricLogging] = {}
        self._engine_processor_lookup: Dict[str, BaseEngineRequest] = {}
        self._last_update_hash: Optional[str] = None
        self._sync_daemon: Optional[threading.Thread] = None
        self._stats_sender: Optional[threading.Thread] = None
        self._stats_queue = FastSimpleQueue()
        self._inflight = FastWriteCounter()
        self._update_lock_flag = False
        self._update_lock_guard = update_lock_guard or threading.Lock()
        self._stop_event = threading.Event()
        self._poll_frequency_sec = 300.0
        self._serving_base_url: Optional[str] = None
        self._metric_log_freq: float = 0.0
        self._stats_broker_url: Optional[str] = None
        self._stats_producer = None
        self._stats_producer_url: Optional[str] = None
        self._instance_id = "inst_{:x}".format(random.getrandbits(48))
        # per-endpoint telemetry counters (reference endpoint_telemetry,
        # :165-251): request/error counts + cumulative latency, surfaced via
        # /dashboard. Plain dicts mutated GIL-atomically per key.
        self._telemetry: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------------ API

    def get_id(self) -> str:
        return self._service.id

    @property
    def service(self) -> ServingService:
        return self._service

    @property
    def registry(self) -> ModelRegistry:
        return self._registry

    def get_version(self) -> str:
        props = self._service.get_runtime_properties()
        return str(props.get("version") or __version__)

    # -- endpoint management (CLI surface) ----------------------------------

    def add_endpoint(
        self,
        endpoint: Union[ModelEndpoint, dict],
        preprocess_code: Optional[str] = None,
    ) -> str:
        if isinstance(endpoint, dict):
            endpoint = ModelEndpoint.from_dict(endpoint)
        self._validate_endpoint(endpoint)
        endpoint.serving_url = endpoint.serving_url.strip("/")
        url = self._normalize_endpoint_url(endpoint.serving_url, endpoint.version)
        if url in self._endpoints and not self._endpoints[url] == endpoint:
            print("Warning: overwriting endpoint {}".format(url))
        if endpoint.model_id is None and not preprocess_code and endpoint.engine_type not in (
            "custom", "custom_async", "llm",
        ):
            raise ValueError(
                "endpoint {!r} requires a model_id for engine {!r}".format(
                    url, endpoint.engine_type
                )
            )
        if preprocess_code:
            endpoint.preprocess_artifact = self._upload_preprocess_code(url, preprocess_code)
        self._endpoints[url] = endpoint
        return url

    def remove_endpoint(self, endpoint_url: str) -> bool:
        endpoint_url = endpoint_url.strip("/")
        for d in (self._endpoints, self._model_monitoring, self._canary_endpoints):
            if endpoint_url in d:
                d.pop(endpoint_url, None)
                return True
        return False

    def add_model_monitoring(
        self,
        monitoring: Union[ModelMonitoring, dict],
        preprocess_code: Optional[str] = None,
    ) -> str:
        if isinstance(monitoring, dict):
            monitoring = ModelMonitoring.from_dict(monitoring)
        name = monitoring.base_serving_url.strip("/")
        monitoring.base_serving_url = name
        if preprocess_code:
            monitoring.preprocess_artifact = self._upload_preprocess_code(name, preprocess_code)
        self._model_monitoring[name] = monitoring
        return name

    def remove_model_monitoring(self, base_url: str) -> bool:
        return self._model_monitoring.pop(base_url.strip("/"), None) is not None

    def add_canary_endpoint(self, canary: Union[CanaryEP, dict]) -> str:
        if isinstance(canary, dict):
            canary = CanaryEP.from_dict(canary)
        self._canary_endpoints[canary.endpoint.strip("/")] = canary
        return canary.endpoint

    def remove_canary_endpoint(self, endpoint_url: str) -> bool:
        return self._canary_endpoints.pop(endpoint_url.strip("/"), None) is not None

    def add_metric_logging(self, metric: Union[EndpointMetricLogging, dict]) -> bool:
        if isinstance(metric, dict):
            metric = EndpointMetricLogging.from_dict(metric)
        name = str(metric.endpoint).strip("/")
        metric.endpoint = name
        if "*" not in name and name not in self._endpoints and name.rsplit("/", 1)[0] not in (
            list(self._model_monitoring) + [u.rsplit("/", 1)[0] for u in self._endpoints]
        ):
            # wildcard-less metric on an unknown endpoint is allowed but noted
            print("Warning: metric logging for unknown endpoint {!r}".format(name))
        existing = self._metric_logging.get(name)
        if existing:
            existing.metrics.update(metric.metrics)
            if metric.log_frequency is not None:
                existing.log_frequency = metric.log_frequency
        else:
            self._metric_logging[name] = metric
        return True

    def remove_metric_logging(self, endpoint: str, variable: Optional[str] = None) -> bool:
        name = endpoint.strip("/")
        if name not in self._metric_logging:
            return False
        if variable is None:
            self._metric_logging.pop(name)
            return True
        return self._metric_logging[name].metrics.pop(variable, None) is not None

    def list_endpoints(self) -> Dict[str, ModelEndpoint]:
        return dict(self._endpoints)

    def list_model_monitoring(self) -> Dict[str, ModelMonitoring]:
        return dict(self._model_monitoring)

    def list_canary_endpoints(self) -> Dict[str, CanaryEP]:
        return dict(self._canary_endpoints)

    def list_endpoint_logging(self) -> Dict[str, EndpointMetricLogging]:
        return dict(self._metric_logging)

    def get_endpoint_metric_logging(self, endpoint: str) -> Optional[EndpointMetricLogging]:
        """Resolve a concrete endpoint url against specs incl. `model/*`
        wildcards (reference :925-949)."""
        endpoint = endpoint.strip("/")
        direct = self._metric_logging.get(endpoint)
        if direct:
            return direct
        for name, spec in self._metric_logging.items():
            # "model/*" matches "model/..." only — not "model2/..."
            if name.endswith("/*") and endpoint.startswith(name[:-1]):
                return spec
        return None

    # -- serialization (control-plane sync) ---------------------------------

    def serialize(self) -> None:
        config = {
            "endpoints": {k: v.as_dict() for k, v in self._endpoints.items()},
            "model_monitoring": {k: v.as_dict() for k, v in self._model_monitoring.items()},
            "canary": {k: v.as_dict() for k, v in self._canary_endpoints.items()},
            "metric_logging": {k: v.as_dict() for k, v in self._metric_logging.items()},
            "model_monitoring_eps": {
                k: v.as_dict() for k, v in self._model_monitoring_endpoints.items()
            },
            "model_monitoring_versions": self._model_monitoring_versions,
        }
        self._service.set_configuration_objects(config)
        self._service.set_runtime_properties({"version": __version__})

    def deserialize(
        self,
        skip_sync: bool = False,
        prefetch_artifacts: bool = False,
    ) -> bool:
        """Reload state from the service document. Returns True if anything
        changed. When not `skip_sync`, performs the zero-downtime swap: set the
        update flag, drain inflight requests, swap dicts, release."""
        # One consistent snapshot — config objects, params, and artifact hashes
        # all come from a single atomic document read so a concurrent writer
        # can never produce a torn config (e.g. new canary + old endpoints).
        snapshot = self._service.get_snapshot()
        configuration = snapshot.get("configuration") or {}
        config = {
            name: configuration.get(name) or {}
            for name in (
                "endpoints",
                "model_monitoring",
                "canary",
                "metric_logging",
                "model_monitoring_eps",
                "model_monitoring_versions",
            )
        }
        artifact_hashes = {
            name: (meta or {}).get("hash")
            for name, meta in (snapshot.get("artifacts") or {}).items()
        }
        params = snapshot.get("parameters") or {}
        new_hash = sha256_obj(
            {"config": config, "artifacts": artifact_hashes, "params": params}
        )
        if new_hash == self._last_update_hash:
            return False

        endpoints = {
            k: ModelEndpoint.from_dict(v) for k, v in config["endpoints"].items()
        }
        monitoring = {
            k: ModelMonitoring.from_dict(v) for k, v in config["model_monitoring"].items()
        }
        monitoring_eps = {
            k: ModelEndpoint.from_dict(v) for k, v in config["model_monitoring_eps"].items()
        }
        canary = {k: CanaryEP.from_dict(v) for k, v in config["canary"].items()}
        metrics = {
            k: EndpointMetricLogging.from_dict(v)
            for k, v in config["metric_logging"].items()
        }
        self._deserialize_conf_params(params)

        if skip_sync:
            self._endpoints = endpoints
            self._model_monitoring = monitoring
            self._model_monitoring_endpoints = monitoring_eps
            self._model_monitoring_versions = dict(config["model_monitoring_versions"])
            self._canary_endpoints = canary
            self._metric_logging = metrics
            self._update_canary_lookup()
            self._last_update_hash = new_hash
            return True

        with self._update_lock_guard:
            self._update_lock_flag = True
            try:
                # Drain inflight requests (zero-downtime swap, reference :700-717).
                t0 = time.time()
                while self._inflight.value() > 0 and time.time() - t0 < 60:
                    time.sleep(0.05)
                self._endpoints = endpoints
                self._model_monitoring = monitoring
                self._model_monitoring_endpoints = monitoring_eps
                self._model_monitoring_versions = dict(config["model_monitoring_versions"])
                self._canary_endpoints = canary
                self._metric_logging = metrics
                self._update_canary_lookup()
                self._last_update_hash = new_hash
            finally:
                self._update_lock_flag = False

        # Evict engine processors whose endpoint disappeared or changed.
        self._cleanup_processor_cache()
        self._prune_telemetry()
        if prefetch_artifacts:
            for url in list(self._endpoints) + list(self._model_monitoring_endpoints):
                try:
                    self._get_processor(url)
                except Exception:  # prefetch only warms the cache; the request path re-raises
                    pass
        return True

    def _prune_telemetry(self) -> None:
        """Drop counters for endpoints that no longer exist (bounded growth
        across removed endpoints / churned monitored versions)."""
        live = set(self._endpoints) | set(self._model_monitoring_endpoints)
        for url in [u for u in list(self._telemetry) if u not in live]:
            self._telemetry.pop(url, None)

    def _cleanup_processor_cache(self) -> None:
        """Evict processors whose endpoint disappeared, changed, or whose
        preprocess artifact content changed (hot reload of re-uploaded user
        code). Runs on the sync thread while the event loop serves requests:
        iterate a snapshot, and do NOT call unload() — an inflight request may
        still hold the instance; GC finalizes it via __del__ once the last
        reference drops. Each evicted instance is retired (the LLM engine
        stops once its requests end). The drops and the collection run
        under ``CAPTURE_LOCK``: CUDA objects they free (a dead engine's
        graphs) must not be released inside another engine's capture."""
        all_eps = {**self._model_monitoring_endpoints, **self._endpoints}
        stale = []
        for url, proc in list(self._engine_processor_lookup.items()):
            ep = all_eps.get(url)
            if ep is None or ep != proc.endpoint:
                stale.append(url)
                continue
            art = ep.preprocess_artifact
            if art and proc._preprocess_hash != self._service.artifact_hash(art):
                stale.append(url)
        if not stale:
            return
        with CAPTURE_LOCK:
            for url in stale:
                proc = self._engine_processor_lookup.pop(url, None)
                if proc is not None:
                    proc.retire()
                del proc
            gc.collect()

    def _deserialize_conf_params(self, params: Optional[Dict[str, Any]] = None) -> None:
        if params is None:
            params = self._service.get_parameters()
        self._serving_base_url = params.get(self._config_key_serving_base_url) or os.environ.get(
            "TPUSERVE_DEFAULT_BASE_SERVE_URL", "http://127.0.0.1:8080/serve"
        )
        self._stats_broker_url = params.get(self._config_key_stats_broker) or os.environ.get(
            "TPUSERVE_STATS_BROKER", ""
        )
        try:
            self._metric_log_freq = float(
                params.get(self._config_key_metric_log_freq)
                if params.get(self._config_key_metric_log_freq) is not None
                else os.environ.get("TPUSERVE_DEFAULT_METRIC_LOG_FREQ", 0.0)
            )
        except (TypeError, ValueError):
            self._metric_log_freq = 0.0
        BaseEngineRequest.set_server_config(
            {
                "serving_base_url": self._serving_base_url,
                "engine_grpc_server": params.get(self._config_key_engine_grpc_addr)
                or os.environ.get("TPUSERVE_DEFAULT_ENGINE_GRPC_ADDR"),
                "stats_broker": self._stats_broker_url,
            }
        )

    def configure(
        self,
        external_serving_base_url: Optional[str] = None,
        external_engine_grpc_address: Optional[str] = None,
        external_stats_broker: Optional[str] = None,
        default_metric_log_freq: Optional[float] = None,
    ) -> None:
        params = {}
        if external_serving_base_url is not None:
            params[self._config_key_serving_base_url] = external_serving_base_url
        if external_engine_grpc_address is not None:
            params[self._config_key_engine_grpc_addr] = external_engine_grpc_address
        if external_stats_broker is not None:
            params[self._config_key_stats_broker] = external_stats_broker
        if default_metric_log_freq is not None:
            params[self._config_key_metric_log_freq] = float(default_metric_log_freq)
        if params:
            self._service.update_parameters(params)

    # -- canary --------------------------------------------------------------

    def _update_canary_lookup(self) -> None:
        canary_route = {}
        for name, canary in self._canary_endpoints.items():
            if canary.load_endpoint_prefix:
                prefix = canary.load_endpoint_prefix.strip("/")
                # match on name boundaries only: prefix "ep" must match
                # "ep" and "ep/2" but NOT "ep2/1"
                matches = [
                    u for u in list(self._endpoints) + list(self._model_monitoring_endpoints)
                    if u == prefix or u.startswith(prefix + "/")
                ]
                # sort by zero-padded numeric version suffix, descending
                def _version_key(u):
                    tail = u.rsplit("/", 1)[-1]
                    return tail.zfill(12) if tail.isdigit() else tail
                matches = sorted(matches, key=_version_key, reverse=True)
                matches = matches[: len(canary.weights)]
                weights = canary.weights[: len(matches)]
            else:
                matches, weights = [], []
                for ep, w in zip(canary.load_endpoints, canary.weights):
                    ep = ep.strip("/")
                    if ep in self._endpoints or ep in self._model_monitoring_endpoints:
                        matches.append(ep)
                        weights.append(w)
            if not matches:
                continue
            total = sum(weights)
            if total <= 0:
                continue
            canary_route[name] = {
                "endpoints": matches,
                "weights": [w / total for w in weights],
            }
        self._canary_route = canary_route

    def _process_canary(self, base_url: str) -> Optional[str]:
        route = self._canary_route.get(base_url)
        if not route:
            return None
        return str(np.random.choice(route["endpoints"], p=route["weights"]))

    # -- monitoring auto-deployment ------------------------------------------

    def _update_monitored_models(self) -> bool:
        """Run each monitoring query; assign monotone versions to newly seen
        model ids; (de)materialize versioned endpoints (reference :816-923)."""
        changed = False
        new_eps: Dict[str, ModelEndpoint] = {}
        for name, mon in self._model_monitoring.items():
            records = self._registry.query(
                project=mon.monitor_project or None,
                name=mon.monitor_name or None,
                tags=mon.monitor_tags or None,
                only_published=mon.only_published,
                max_results=mon.max_versions or None,
            )
            versions = self._model_monitoring_versions.setdefault(name, {})
            next_version = (max(versions.values()) + 1) if versions else 1
            # oldest-first so version numbers increase with recency
            for record in sorted(records, key=lambda r: r.created):
                if record.id not in versions:
                    versions[record.id] = next_version
                    next_version += 1
                    changed = True
            keep_ids = {r.id for r in records}
            for model_id in keep_ids:
                version = versions[model_id]
                url = "{}/{}".format(name, version)
                ep = ModelEndpoint(
                    engine_type=mon.engine_type,
                    serving_url=url,
                    model_id=model_id,
                    version=str(version),
                    preprocess_artifact=mon.preprocess_artifact,
                    input_size=mon.input_size,
                    input_type=mon.input_type,
                    input_name=mon.input_name,
                    output_size=mon.output_size,
                    output_type=mon.output_type,
                    output_name=mon.output_name,
                    auxiliary_cfg=mon.auxiliary_cfg,
                )
                if new_eps.get(url) != ep:
                    new_eps[url] = ep
        if new_eps != self._model_monitoring_endpoints:
            changed = True
        if changed:
            self._model_monitoring_endpoints = new_eps
            self._update_canary_lookup()
            # publish for sidecars + persistence of version assignments
            self._service.set_configuration_objects(
                {
                    "model_monitoring_eps": {
                        k: v.as_dict() for k, v in new_eps.items()
                    },
                    "model_monitoring_versions": self._model_monitoring_versions,
                }
            )
            self._last_update_hash = None  # force re-hash next poll
        return changed

    # -- request processing ---------------------------------------------------

    def _normalize_endpoint_url(self, endpoint: str, version: Optional[str] = None) -> str:
        return "{}/{}".format(endpoint.rstrip("/"), version) if version else endpoint.strip("/")

    def _resolve_lora_alias(self, name: str) -> Optional[str]:
        """Endpoint whose aux ``engine.lora.modules`` declares adapter
        ``name`` (config-driven, so it works before the endpoint's engine has
        ever been constructed). None if nothing claims the name."""
        for registry in (self._endpoints, self._model_monitoring_endpoints):
            for url, ep in registry.items():
                aux = ep.auxiliary_cfg if isinstance(ep.auxiliary_cfg, dict) else {}
                modules = ((aux.get("engine") or {}).get("lora") or {}).get(
                    "modules"
                ) or {}
                if name in modules:
                    return url
        return None

    def _get_processor(self, url: str) -> BaseEngineRequest:
        processor = self._engine_processor_lookup.get(url)
        if processor is None:
            ep = self._endpoints.get(url) or self._model_monitoring_endpoints.get(url)
            if ep is None:
                raise EndpointNotFoundException("endpoint {!r} not found".format(url))
            processor_cls = get_engine_cls(ep.engine_type)
            processor = processor_cls(ep, service=self._service, registry=self._registry,
                                      device=self.device)
            self._engine_processor_lookup[url] = processor
        return processor

    async def process_request(
        self, base_url: str, version: Optional[str], request_body: Any,
        serve_type: str = "process",
    ) -> Any:
        """The hot path (reference :253-304)."""
        self._inflight.inc()
        try:
            # stall-free update: wait out an in-progress config swap
            while self._update_lock_flag:
                self._inflight.dec()
                await asyncio.sleep(0.5 + 1.0 * random.random())
                self._inflight.inc()
            url = self._normalize_endpoint_url(base_url, version)
            canary_url = self._process_canary(url)
            if canary_url:
                url = canary_url
            if url not in self._endpoints and url not in self._model_monitoring_endpoints:
                # OpenAI multi-LoRA: an adapter name declared in some llm
                # endpoint's aux engine.lora.modules serves as a top-level
                # model name (vLLM-compatible); route it to that endpoint —
                # the engine applies the adapter per the body's `model` field
                alias = self._resolve_lora_alias(url)
                if alias is None:
                    raise EndpointNotFoundException(
                        "endpoint {!r} not found (have: {})".format(
                            url,
                            sorted(list(self._endpoints) + list(self._model_monitoring_endpoints)),
                        )
                    )
                url = alias
            processor = self._get_processor(url)
            tic = time.monotonic()
            entry = self._telemetry.setdefault(
                url, {"requests": 0, "errors": 0, "latency_sum": 0.0}
            )
            # "requests" counts every attempt (errors included), so
            # errors/requests is a true error rate
            entry["requests"] += 1
            try:
                result = await self._process_request(
                    processor, url, request_body, serve_type
                )
            except Exception:
                entry["errors"] += 1
                raise
            entry["latency_sum"] += time.monotonic() - tic
            return result
        finally:
            self._inflight.dec()

    async def _process_request(
        self, processor: BaseEngineRequest, url: str, body: Any, serve_type: str
    ) -> Any:
        # sampling decision (reference :1316-1323)
        metric_spec = self.get_endpoint_metric_logging(url)
        freq = (
            metric_spec.log_frequency
            if metric_spec is not None and metric_spec.log_frequency is not None
            else self._metric_log_freq
        )
        collect = freq and random.random() <= freq
        custom_stats: Dict[str, Any] = {}
        collect_fn = custom_stats.update if collect else None
        state: Dict[str, Any] = {}

        tic = time.time()
        if serve_type == "process":
            if processor.is_preprocess_async:
                data = await processor.preprocess(body, state, collect_fn)
            else:
                data = processor.preprocess(body, state, collect_fn)
            if processor.is_process_async:
                out = await processor.process(data, state, collect_fn)
            else:
                out = processor.process(data, state, collect_fn)
        else:
            # OpenAI-style serve types dispatch to a named engine method,
            # e.g. "v1/chat/completions" -> processor.v1_chat_completions
            # (reference :1327-1339).
            method_name = serve_type.replace("/", "_").replace(".", "_")
            # Allowlist: only versioned API handler names (v1_*, v2_* ...) are
            # dispatchable — a URL-derived name must never reach lifecycle or
            # dunder attributes (e.g. /serve/openai/__class__ or /unload).
            if not _SERVE_TYPE_RE.match(method_name):
                raise EndpointBackendError(
                    "invalid serve type {!r}".format(serve_type)
                )
            method = getattr(processor, method_name, None)
            if method is None and processor._preprocess is not None:
                # user Preprocess code may implement the OpenAI-style handler
                method = getattr(processor._preprocess, method_name, None)
            if method is None:
                raise EndpointBackendError(
                    "endpoint engine {!r} does not support serve type {!r}".format(
                        processor.engine_name, serve_type
                    )
                )
            if processor.is_preprocess_async:
                data = await processor.preprocess(body, state, collect_fn)
            else:
                data = processor.preprocess(body, state, collect_fn)
            out = method(data, state, collect_fn)
            if asyncio.iscoroutine(out):
                out = await out
        if processor.is_postprocess_async:
            result = await processor.postprocess(out, state, collect_fn)
        else:
            result = processor.postprocess(out, state, collect_fn)

        if collect:

            def _emit_stats() -> None:
                stats = {
                    "_url": url,
                    "_latency": round(time.time() - tic, 6),
                    "_count": int(1.0 / freq) if freq else 1,
                }
                # whitelisted request/response fields per the metric spec
                if metric_spec is not None:
                    for key in metric_spec.metrics:
                        if key.startswith("_"):
                            continue
                        if isinstance(body, dict) and key in body:
                            stats[key] = body[key]
                        elif isinstance(result, dict) and key in result:
                            stats[key] = result[key]
                stats.update(custom_stats)
                self._stats_queue.put(stats)

            if isinstance(result, StreamingOutput):
                # streaming: defer the packet to stream completion so
                # _latency covers the whole stream and the engine's
                # end-of-stream TTFT/token stats (written through collect_fn
                # during the body) are included — streaming chat is THE LLM
                # workload; its TTFT is the BASELINE.md headline metric
                result.on_complete = _emit_stats
            else:
                _emit_stats()
        return result

    # -- daemons --------------------------------------------------------------

    def launch(self, poll_frequency_sec: float = 300.0) -> None:
        """Initial sync + background sync daemon + stats sender
        (reference :951-1047)."""
        self._poll_frequency_sec = poll_frequency_sec
        # Prefetch at startup: engine construction (model load + jit compile)
        # must happen here, not lazily on the event loop's first request.
        self.deserialize(prefetch_artifacts=True)
        self._update_monitored_models()
        self._stop_event.clear()
        self._sync_daemon = threading.Thread(target=self._sync_daemon_loop, daemon=True)
        self._sync_daemon.start()
        self._stats_sender = threading.Thread(target=self._stats_send_loop, daemon=True)
        self._stats_sender.start()

    def stop(self) -> None:
        """Stop the sync daemon and the stats sender, and wait for them:
        each holds this processor, and through it every endpoint's engine,
        until it returns (the sender's wait is cut short; what it has
        queued is sent first)."""
        self._stop_event.set()
        self._stats_queue.wake()
        for name in ("_sync_daemon", "_stats_sender"):
            thread = getattr(self, name, None)
            if thread is not None and thread is not threading.current_thread():
                thread.join(timeout=30.0)

    def _sync_daemon_loop(self) -> None:
        while not self._stop_event.wait(timeout=self._poll_frequency_sec):
            try:
                self._service.ping(instance_id=self._instance_id)
                self.deserialize()
                self._update_monitored_models()
                self._service.set_runtime_properties(
                    {"layout": self.get_serving_layout()}
                )
            except Exception as ex:
                print("sync daemon error: {}".format(ex))

    def _get_stats_producer(self):
        # Rebuild when the broker URL changes at runtime (configure + poll).
        if self._stats_producer_url != self._stats_broker_url:
            self._stats_producer = None
            self._stats_producer_url = self._stats_broker_url
        if self._stats_producer is None and self._stats_broker_url:
            from ..statistics.broker import make_producer

            self._stats_producer = make_producer(self._stats_broker_url)
        return self._stats_producer

    def _stats_send_loop(self) -> None:
        while not self._stop_event.is_set():
            batch = self._stats_queue.get_all(timeout=5.0)
            if not batch:
                continue
            try:
                producer = self._get_stats_producer()
                if producer is not None:
                    producer.send_batch(batch)
            except Exception as ex:
                print("stats send error: {}".format(ex))
                time.sleep(5.0)

    # -- observability ---------------------------------------------------------

    def get_serving_layout(self) -> Dict[str, Any]:
        """Endpoint table + routing graph — the reference's endpoint-table /
        Sankey plot data (reference :1141-1278) as a JSON document. Exposed by
        the router's /dashboard route; the sync daemon also persists it to the
        service document's runtime properties each poll."""
        table = []
        for url, ep in sorted({**self._model_monitoring_endpoints, **self._endpoints}.items()):
            table.append(
                {
                    "endpoint": url,
                    "engine": ep.engine_type,
                    "model_id": ep.model_id,
                    "version": ep.version,
                    "preprocess": ep.preprocess_artifact,
                    "monitored": url in self._model_monitoring_endpoints,
                    "loaded": url in self._engine_processor_lookup,
                }
            )
        # routing graph: external -> canary -> versions, monitoring -> versions
        edges = []
        for name, route in self._canary_route.items():
            for target, weight in zip(route["endpoints"], route["weights"]):
                edges.append({"from": "canary:{}".format(name), "to": target,
                              "weight": round(weight, 4)})
        for name in self._model_monitoring:
            for url in self._model_monitoring_endpoints:
                if url.startswith(name + "/"):
                    edges.append({"from": "monitor:{}".format(name), "to": url, "weight": 1.0})
        telemetry = {}
        # snapshot: the event-loop thread inserts keys while the sync daemon
        # may be iterating from its own thread
        for url, entry in list(self._telemetry.items()):
            ok = entry["requests"] - entry["errors"]
            telemetry[url] = {
                "requests": entry["requests"],
                "errors": entry["errors"],
                "mean_latency_ms": round(entry["latency_sum"] / ok * 1000, 3) if ok else None,
            }
        return {
            "service_id": self._service.id,
            "instance": self._instance_id,
            "endpoints": table,
            "routing": edges,
            "metrics": {k: v.as_dict() for k, v in self._metric_logging.items()},
            "telemetry": telemetry,
        }

    # -- validation ------------------------------------------------------------

    def _validate_endpoint(self, endpoint: ModelEndpoint) -> None:
        """Tensor engines require a full I/O spec so compiled signatures are
        static (reference :1459-1535 enforces the same for Triton)."""
        if endpoint.engine_type in ("jax_grpc",):
            if not (endpoint.input_type and endpoint.output_type):
                raise ValueError(
                    "engine {!r} endpoints require --input-type/--output-type "
                    "(and matching sizes/names) so the engine server can compile "
                    "a static signature".format(endpoint.engine_type)
                )

    def _upload_preprocess_code(self, url: str, code_path: str) -> str:
        name = "py_code_{}".format(url.replace("/", "_"))
        self._service.upload_artifact(name, code_path)
        return name

    # -- service discovery (CLI) ----------------------------------------------

    @classmethod
    def list_control_plane_services(cls, state_root: Optional[str] = None) -> List[dict]:
        return StateStore(state_root).list_services()
