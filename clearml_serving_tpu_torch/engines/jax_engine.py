"""The ``jax`` engine type, on torch: model bundles served in process.

Counterpart of ``clearml_serving_tpu/engines/jax_engine.py``. It keeps the
reference's name because endpoints store the engine name ``jax``; nothing
here runs JAX. Model payloads are **bundles**: a directory with

    model_config.json   {"arch": "mlp"|"cnn"|"bert"|"llama", "config": {...}}
    params.msgpack      flax-serialized parameter tree (utils/flax_msgpack.py)

or a foreign graph the importers read (``engines/importers/``): ``.onnx``,
``.graphdef``/``.pb`` (frozen TF graphs, TF1 SavedModel wrappers) and
``.pt``/``.torchscript``. ``load_bundle`` dispatches in the reference's
order. The engine:

- builds the architecture from the models registry and carries the
  parameters over with its ``convert_params`` (each leaf read from the file
  and copied once to the device);
- pads each batch with zeros up to its bucket (aux ``batching.buckets``,
  default ``[1, 2, 4, 8, 16, 32, 64, 128]``) and slices the outputs back;
- on the card, runs each bucket key as one CUDA graph
  (``engines/bucket_graph.py``), the counterpart of the reference's jit per
  bucket;
- converts JSON bodies to typed arrays per the endpoint I/O spec and back.

The reference's persistent XLA compilation cache has no counterpart: a
graph is captured at a key's first request in each process (tens to
hundreds of ms), and nothing is kept across restarts.

A user ``Preprocess.load()`` returning a callable replaces the native
loader: it is called as ``fn(*inputs)`` on device tensors, eagerly. The
user's ``process``/``postprocess`` override the engine's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from ..utils import flax_msgpack
from ..utils.files import atomic_write_json, read_json
from .base import BaseEngineRequest, EndpointModelError, register_engine
from .bucket_graph import BucketRunner, tree_map

_DEFAULT_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128]


# -- bundle IO ----------------------------------------------------------------

def save_bundle(path, arch: str, config: dict, params) -> int:
    """Write a bundle directory: ``params`` in the reference's layout (a
    model's ``init`` output, tensors on any device or numpy arrays), the
    bytes the reference's ``save_bundle`` writes. Returns the parameter
    file's bytes."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    atomic_write_json(path / "model_config.json", {"arch": arch, "config": config})
    return flax_msgpack.write(path / "params.msgpack", params)


def _endpoint_input_spec(endpoint) -> Tuple[List[List[int]], List[str]]:
    """Endpoint I/O spec -> per-input example shapes (batch dim 1) + dtypes."""
    sizes = endpoint.input_size or []
    types = endpoint.input_type or []
    if sizes and not isinstance(sizes[0], (list, tuple)):
        sizes = [sizes]  # single flat shape
    if isinstance(types, str):
        types = [types]
    shapes = [[1] + [int(d) for d in s] for s in sizes]
    torch_types = []
    for t in types:
        torch_types.append(
            {"float32": "float32", "float64": "float64", "int64": "int64",
             "int32": "int32", "uint8": "uint8", "bool": "bool"}.get(str(t), "float32")
        )
    return shapes, torch_types


def load_bundle(path, endpoint=None, config_overrides=None, device="cuda"):
    """Returns (model bundle namespace, params on ``device``).

    ``config_overrides`` merges into the stored model config before the
    architecture builds (native bundles only). Dispatches on the payload's
    format, in the reference's order:
    - a directory with ``model_config.json`` is a native bundle, even with a
      stray ``.onnx`` beside it;
    - ``*.onnx`` (or a directory holding one) -> the ONNX importer;
    - ``*.graphdef`` / ``*.pb`` -> the GraphDef importer;
    - ``*.pt`` / ``*.torchscript`` -> the scripted module itself (needs the
      endpoint's input_size/input_type spec, as the reference does);
    - otherwise a native bundle (a single file resolves to its directory).
    """
    from .. import models
    from .importers.onnx_import import find_onnx_file, load_onnx_bundle

    dev = resolve_device(device)
    path = Path(path)
    is_native = path.is_dir() and (path / "model_config.json").exists()
    onnx_file = None if is_native else find_onnx_file(path)
    if onnx_file is not None:
        return load_onnx_bundle(onnx_file, device=dev)
    if not is_native:
        from .importers.graphdef_import import find_graphdef_file, load_graphdef_bundle

        gd_file = find_graphdef_file(path)
        if gd_file is not None:
            return load_graphdef_bundle(gd_file, device=dev)
    ts_file = None
    if path.is_file() and path.suffix in (".pt", ".torchscript"):
        ts_file = path
    elif path.is_dir():
        cands = sorted(path.glob("*.pt")) + sorted(path.glob("*.torchscript"))
        if cands and not (path / "model_config.json").exists():
            ts_file = cands[0]
    if ts_file is not None:
        from .importers.torchscript_import import load_torchscript_bundle

        if endpoint is None or not endpoint.input_size:
            raise EndpointModelError(
                "TorchScript model {} needs the endpoint's input_size/"
                "input_type spec to derive export shapes".format(ts_file)
            )
        shapes, dtypes = _endpoint_input_spec(endpoint)
        return load_torchscript_bundle(ts_file, shapes, dtypes, device=dev)

    if path.is_file():  # single-file bundles not supported; need the dir
        path = path.parent
    meta = read_json(path / "model_config.json")
    if not meta:
        raise EndpointModelError(
            "not a jax model bundle (missing model_config.json): {}".format(path)
        )
    model_cfg = dict(meta.get("config") or {})
    if config_overrides:
        model_cfg.update(config_overrides)
    bundle = models.build_model(meta["arch"], model_cfg)
    tree = flax_msgpack.read(path / "params.msgpack", device=dev)
    return bundle, bundle.convert_params(tree, device=dev)


# -- batching -----------------------------------------------------------------

def bucket_for(batch: int, buckets: List[int]) -> int:
    for b in buckets:
        if batch <= b:
            return b
    return batch  # beyond the largest bucket: capture exactly (rare)


@register_engine("jax", modules=["torch"])
class JaxEngineRequest(BaseEngineRequest):
    """Serve a bundle (or a user-loaded callable) on the processor's device.
    ``cuda_graphs=False`` runs every bucket eagerly (no aux key sets it)."""

    def __init__(self, *args, cuda_graphs: bool = True, **kwargs):
        self._cuda_graphs = cuda_graphs
        self.engine: Optional[BucketRunner] = None
        super().__init__(*args, **kwargs)
        aux = self.endpoint.auxiliary_cfg or {}
        if isinstance(aux, str):
            aux = {}
        batching = (aux.get("batching") or {}) if isinstance(aux, dict) else {}
        self._buckets = sorted(int(b) for b in batching.get("buckets", _DEFAULT_BUCKETS))

    # -- loading ------------------------------------------------------------

    def _load_model(self) -> None:
        super()._load_model()
        dev = resolve_device(self.device)
        if self._model is not None and callable(self._model):
            # user load() returned fn(*inputs): eager, on device tensors
            self.engine = BucketRunner(self._model, dev, cuda_graphs=False)
        elif self._model_local_path:
            bundle, params = load_bundle(self._model_local_path, endpoint=self.endpoint,
                                         device=dev)
            self._model = bundle
            apply_fn = bundle.apply

            def run(*xs):
                return apply_fn(params, *xs)

            self.engine = BucketRunner(run, dev, cuda_graphs=self._cuda_graphs)
        else:
            raise EndpointModelError(
                "jax endpoint {!r} has neither a model bundle nor a user load()".format(
                    self.endpoint.serving_url
                )
            )

    # -- request IO ---------------------------------------------------------

    def _body_to_arrays(self, data: Any) -> List[np.ndarray]:
        """JSON body -> list of typed input arrays per the endpoint I/O spec.
        Accepts {"name": values, ...} or a bare array for single-input models."""
        names = self.endpoint.input_name or []
        types = self.endpoint.input_type or []
        if isinstance(data, dict) and names:
            raw = []
            for i, name in enumerate(names):
                if name not in data:
                    raise ValueError("missing input {!r}".format(name))
                raw.append(data[name])
        elif isinstance(data, dict) and len(data) == 1:
            raw = [next(iter(data.values()))]
        else:
            raw = [data]
        arrays = []
        for i, r in enumerate(raw):
            dt = np.dtype(types[i]) if i < len(types) else np.float32
            arrays.append(np.asarray(r, dtype=dt))
        return arrays

    def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "process"):
            # a user process() is a full override of the compiled path
            return self._preprocess.process(data, state, collect_fn)
        if isinstance(data, (list, dict)):
            arrays = self._body_to_arrays(data)
        elif isinstance(data, np.ndarray):
            arrays = [data]
        elif isinstance(data, tuple):
            arrays = [np.asarray(a) for a in data]
        else:
            arrays = [np.asarray(data)]

        batch = arrays[0].shape[0] if arrays[0].ndim > 0 else 1
        bucket = bucket_for(batch, self._buckets)
        padded = []
        for a in arrays:
            if a.ndim == 0:
                a = a[None]
            if a.shape[0] != bucket:
                pad = [(0, bucket - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad)
            padded.append(a)
        out = self.engine.run(padded)
        return tree_map(lambda t: np.asarray(t)[:batch], out)

    def postprocess(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "postprocess"):
            return self._preprocess.postprocess(data, state, collect_fn)

        def _to_list(x):
            if isinstance(x, np.ndarray):
                return x.tolist()
            if isinstance(x, dict):
                return {k: _to_list(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [_to_list(v) for v in x]
            return x
        if isinstance(data, (list, tuple)) and len(data) == 1:
            return _to_list(data[0])
        return _to_list(data)
