"""Typed endpoint / canary / monitoring / metric-logging records.

Capability parity with the reference's endpoint schemas
(clearml_serving/serving/endpoints.py:1-124): engine-type validation against the
engine registry, numpy-dtype validation of I/O specs with scalar auto-wrapping,
and dict round-tripping for the control-plane state store. Implemented as plain
dataclasses (no attrs) with explicit validation so the records stay trivially
JSON-serializable.

The port's copy of ``clearml_serving_tpu/serving/endpoints.py``.
``KNOWN_ENGINES`` keeps the reference's seed, ``jax`` and ``jax_grpc``
included, so a service document the reference's CLI wrote deserializes
whole here; the port's engine registry (``engines/base.py``) refuses the
engines it does not serve when a request reaches them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np

# Engine implementations register their names here at import time (see
# engines/base.py). Seeded with the full engine surface so
# schema validation works even before engine modules are imported.
KNOWN_ENGINES: set = {
    "sklearn",
    "xgboost",
    "lightgbm",
    "custom",
    "custom_async",
    "jax",          # in-process JAX/XLA engine (Triton-equivalent, local)
    "jax_grpc",     # remote JAX engine server over gRPC (Triton-equivalent)
    "llm",          # continuous-batching TPU LLM engine (vLLM-equivalent)
}


def register_engine_name(name: str) -> None:
    KNOWN_ENGINES.add(name)


def _validate_engine_type(value: Optional[str]) -> None:
    if value is not None and value not in KNOWN_ENGINES:
        raise ValueError(
            "engine_type={!r} is not a registered engine (known: {})".format(
                value, sorted(KNOWN_ENGINES)
            )
        )


def _as_list(value):
    """Scalars auto-wrap into single-element lists (reference endpoints.py:21-33)."""
    if value is None:
        return None
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def _validate_dtypes(value: Optional[List[str]]) -> None:
    for v in value or []:
        try:
            np.dtype(v)
        except TypeError as ex:
            raise ValueError("invalid numpy dtype {!r}: {}".format(v, ex)) from ex


def _normalize_io_spec(record) -> None:
    """Shared I/O-spec normalization: scalar entries auto-wrap to lists, single
    shapes wrap to a list-of-shapes, dtypes validated against numpy."""
    for attr_name in ("input_type", "input_name", "output_type", "output_name"):
        setattr(record, attr_name, _as_list(getattr(record, attr_name)))
    for attr_name in ("input_size", "output_size"):
        v = getattr(record, attr_name)
        if v is not None:
            v = list(v)
            if v and not isinstance(v[0], (list, tuple)):
                v = [v]
            setattr(record, attr_name, [list(s) for s in v])
    _validate_dtypes(record.input_type)
    _validate_dtypes(record.output_type)


class _Record:
    """Shared dict round-trip for all control-plane records."""

    def as_dict(self, remove_null_entries: bool = False) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if remove_null_entries:
            d = {k: v for k, v in d.items() if v is not None}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass
class ModelEndpoint(_Record):
    """A single served model version (reference endpoints.py:64-78)."""

    engine_type: str = "custom"
    serving_url: str = ""
    model_id: Optional[str] = None
    version: Optional[str] = None
    preprocess_artifact: Optional[str] = None
    input_size: Optional[List[Any]] = None   # list of shapes (or one shape)
    input_type: Optional[List[str]] = None   # numpy dtype names
    input_name: Optional[List[str]] = None
    output_size: Optional[List[Any]] = None
    output_type: Optional[List[str]] = None
    output_name: Optional[List[str]] = None
    # Engine-specific tuning block (reference: Triton pbtxt aux config). Here: a
    # dict/str with batching buckets, mesh spec, dtype policy, compile options.
    auxiliary_cfg: Optional[Union[str, dict]] = None

    def __post_init__(self):
        _validate_engine_type(self.engine_type)
        if not self.serving_url:
            raise ValueError("serving_url is required")
        _normalize_io_spec(self)


@dataclass
class ModelMonitoring(_Record):
    """Auto-deployment query: newly published models matching the query become
    versioned endpoints (reference endpoints.py:44-61)."""

    base_serving_url: str = ""
    engine_type: str = "custom"
    monitor_project: Optional[str] = None
    monitor_name: Optional[str] = None
    monitor_tags: Optional[List[str]] = None
    only_published: bool = False
    max_versions: Optional[int] = None
    preprocess_artifact: Optional[str] = None
    input_size: Optional[List[Any]] = None
    input_type: Optional[List[str]] = None
    input_name: Optional[List[str]] = None
    output_size: Optional[List[Any]] = None
    output_type: Optional[List[str]] = None
    output_name: Optional[List[str]] = None
    auxiliary_cfg: Optional[Union[str, dict]] = None

    def __post_init__(self):
        _validate_engine_type(self.engine_type)
        if not self.base_serving_url:
            raise ValueError("base_serving_url is required")
        _normalize_io_spec(self)


@dataclass
class CanaryEP(_Record):
    """Weighted A/B routing entry (reference endpoints.py:81-88)."""

    endpoint: str = ""
    weights: List[float] = field(default_factory=list)
    load_endpoints: List[str] = field(default_factory=list)
    load_endpoint_prefix: Optional[str] = None

    def __post_init__(self):
        if not self.endpoint:
            raise ValueError("endpoint is required")
        if self.load_endpoints and self.load_endpoint_prefix:
            raise ValueError(
                "load_endpoints and load_endpoint_prefix are mutually exclusive"
            )
        if not self.load_endpoints and not self.load_endpoint_prefix:
            raise ValueError(
                "one of load_endpoints / load_endpoint_prefix is required"
            )


@dataclass
class MetricType(_Record):
    """One logged variable: scalar (bucketed histogram) | enum | value | counter
    (reference endpoints.py:93-96)."""

    type: str = "scalar"
    buckets: Optional[List[Any]] = None

    _TYPES = ("scalar", "enum", "value", "counter")

    def __post_init__(self):
        if self.type not in self._TYPES:
            raise ValueError(
                "metric type must be one of {}, got {!r}".format(self._TYPES, self.type)
            )
        if self.type in ("scalar", "enum") and not self.buckets:
            raise ValueError("metric type {!r} requires buckets".format(self.type))


@dataclass
class EndpointMetricLogging(_Record):
    """Per-endpoint logged variables + sampling frequency
    (reference endpoints.py:91-124)."""

    endpoint: str = ""
    log_frequency: Optional[float] = None  # 0..1 fraction of requests sampled
    metrics: Dict[str, MetricType] = field(default_factory=dict)

    def __post_init__(self):
        if not self.endpoint:
            raise ValueError("endpoint is required")
        if self.log_frequency is not None and not (0.0 <= float(self.log_frequency) <= 1.0):
            raise ValueError("log_frequency must be within [0, 1]")
        self.metrics = {
            k: (v if isinstance(v, MetricType) else MetricType.from_dict(v))
            for k, v in (self.metrics or {}).items()
        }

    def as_dict(self, remove_null_entries: bool = False) -> Dict[str, Any]:
        d = super().as_dict(remove_null_entries=remove_null_entries)
        d["metrics"] = {
            k: v.as_dict(remove_null_entries) if isinstance(v, MetricType) else v
            for k, v in (self.metrics or {}).items()
        }
        return d
