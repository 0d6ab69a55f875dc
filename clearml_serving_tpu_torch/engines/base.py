"""Engine framework: registry + hot-loaded user code + per-phase async dispatch.

Capability parity with the reference's BasePreprocessRequest
(clearml_serving/serving/preprocess_service.py:25-264):

- one engine-request instance **per endpoint per process** (thread-safety is the
  user code's responsibility — per-request scratch goes in the ``state`` dict);
- the user's preprocess artifact is downloaded from the control plane, cached
  locally, re-loaded when its content hash changes, and imported either as a
  single module file or an extracted zip package with ``__init__.py``;
- a ``send_request`` callable is injected into user code for pipeline
  composition (HTTP POST back to this serving service);
- async-ness is declared per phase via class flags the orchestrator branches on;
- engines self-register under a string name with optional heavy modules that
  are imported once pre-fork via :func:`load_engine_modules`.

The port's copy of ``clearml_serving_tpu/engines/base.py``, with three
changes: ``requests`` is imported where ``send_request`` posts, not with the
module; every engine request takes the processor's ``device`` (default
``"cuda"``; the CPU tests pass ``"cpu"``); and ``retire()`` is called when
the processor drops an instance, so an engine that holds the card (the LLM
engine) can stop once its requests are done.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import shutil
import sys
import zipfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Type

from ..serving.endpoints import ModelEndpoint, register_engine_name
from ..utils.files import read_json

_ENGINE_REGISTRY: Dict[str, Type["BaseEngineRequest"]] = {}
_ENGINE_MODULES: Dict[str, List[str]] = {}

def register_engine(name: str, modules: Optional[List[str]] = None):
    """Class decorator registering an engine implementation under ``name``."""

    def _decorator(cls):
        _ENGINE_REGISTRY[name] = cls
        _ENGINE_MODULES[name] = list(modules or [])
        register_engine_name(name)
        cls.engine_name = name
        return cls

    return _decorator


def get_engine_cls(name: str) -> Type["BaseEngineRequest"]:
    try:
        return _ENGINE_REGISTRY[name]
    except KeyError:
        raise ValueError(
            "unknown engine {!r}; registered: {}".format(name, sorted(_ENGINE_REGISTRY))
        ) from None


def load_engine_modules() -> None:
    """Pre-fork import of every engine's heavy dependencies (reference
    preprocess_service.py:245-253): call once in the parent so forked workers
    share the pages."""
    for name, modules in _ENGINE_MODULES.items():
        for mod in modules:
            try:
                importlib.import_module(mod)
            except ImportError:
                pass


class EndpointModelError(RuntimeError):
    """Model payload missing/unloadable (maps to HTTP 422 in the router)."""


class BaseEngineRequest:
    """Per-endpoint engine instance. Subclasses implement the three phases."""

    engine_name = "base"
    is_preprocess_async = False
    is_process_async = False
    is_postprocess_async = False

    # Server-wide config pushed by the orchestrator on every sync
    # (reference BasePreprocessRequest.set_server_config).
    _server_config: Dict[str, Any] = {}

    def __init__(
        self,
        endpoint: ModelEndpoint,
        service=None,          # state.ServingService (artifact source), optional
        registry=None,         # state.ModelRegistry (model payloads), optional
        cache_dir: Optional[str] = None,
        device: str = "cuda",  # where an engine that computes places its model
    ):
        self.endpoint = endpoint
        self.device = device
        self._service = service
        self._registry = registry
        self._cache_dir = Path(
            cache_dir
            or os.environ.get("TPUSERVE_CACHE_DIR")
            or (Path.home() / ".tpu-serving" / "cache")
        )
        self._preprocess = None          # user Preprocess instance
        self._preprocess_hash = None     # artifact content hash when loaded
        self._model: Any = None
        self._model_local_path: Optional[str] = None

        if endpoint.preprocess_artifact:
            self._load_user_code()
        self._load_model()

    # -- server config -----------------------------------------------------

    @classmethod
    def set_server_config(cls, config: Dict[str, Any]) -> None:
        BaseEngineRequest._server_config = dict(config or {})

    @classmethod
    def get_server_config(cls) -> Dict[str, Any]:
        return BaseEngineRequest._server_config

    # -- user code hot-loading ---------------------------------------------

    def _artifact_cache_path(self, name: str) -> Path:
        return self._cache_dir / "artifacts" / self.endpoint.serving_url / name

    def _fetch_artifact(self, name: str) -> Optional[Path]:
        """Local copy of the artifact; re-copied when the stored hash changed
        (reference preprocess_service.py:68-82)."""
        if self._service is None:
            return None
        src = self._service.get_artifact(name)
        if src is None:
            return None
        new_hash = self._service.artifact_hash(name)
        dest_dir = self._artifact_cache_path(name)
        meta_path = dest_dir / ".hash.json"
        meta = read_json(meta_path) or {}
        dest = dest_dir / src.name
        if meta.get("hash") != new_hash or not dest.exists():
            if dest_dir.exists():
                shutil.rmtree(dest_dir)
            dest_dir.mkdir(parents=True)
            shutil.copyfile(str(src), str(dest))
            from ..utils.files import atomic_write_json
            atomic_write_json(meta_path, {"hash": new_hash})
        return dest

    def _load_user_code(self) -> None:
        name = self.endpoint.preprocess_artifact
        path = self._fetch_artifact(name)
        if path is None:
            raise EndpointModelError(
                "preprocess artifact {!r} not found for endpoint {!r}".format(
                    name, self.endpoint.serving_url
                )
            )
        new_hash = self._service.artifact_hash(name)
        if self._preprocess is not None and new_hash == self._preprocess_hash:
            return
        module = self._import_user_module(path)
        user_cls = getattr(module, "Preprocess", None)
        if user_cls is None:
            raise EndpointModelError(
                "artifact {!r} does not define a Preprocess class".format(name)
            )
        instance = user_cls()
        instance.serving_config = self.endpoint.as_dict(remove_null_entries=True)
        # Inject pipeline-composition hook unless user code provides its own.
        if not hasattr(instance, "send_request"):
            instance.send_request = self._make_send_request()
        old = self._preprocess
        self._preprocess = instance
        self._preprocess_hash = new_hash
        if old is not None and hasattr(old, "unload"):
            try:
                old.unload()
            except Exception as ex:
                # hot swap proceeds — the NEW code is already installed —
                # but a throwing unload leaks whatever it held; leave a trace
                print("unload of replaced preprocess failed: {}".format(ex))

    def _import_user_module(self, path: Path):
        """Import a single .py file, or a zip package (extracted; must contain
        ``__init__.py`` at its root)."""
        mod_name = "tpuserve_user_{}".format(
            self.endpoint.serving_url.replace("/", "_").replace("-", "_")
        )
        if path.suffix == ".zip":
            extract_dir = path.parent / "package"
            if extract_dir.exists():
                shutil.rmtree(extract_dir)
            with zipfile.ZipFile(path) as zf:
                zf.extractall(str(extract_dir))
            if not (extract_dir / "__init__.py").is_file():
                raise EndpointModelError(
                    "preprocess package zip must contain a top-level __init__.py"
                )
            spec = importlib.util.spec_from_file_location(
                mod_name, str(extract_dir / "__init__.py"),
                submodule_search_locations=[str(extract_dir)],
            )
        else:
            spec = importlib.util.spec_from_file_location(mod_name, str(path))
        module = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)
        return module

    def _make_send_request(self) -> Callable:
        def send_request(endpoint: str, version: Optional[str] = None, data: Any = None):
            import requests

            base = self.get_server_config().get("serving_base_url") or ""
            url = "/".join(p.strip("/") for p in (base, endpoint, version or "") if p)
            r = requests.post(url, json=data, timeout=self.request_timeout())
            return r.json() if r.ok else None

        return send_request

    @staticmethod
    def request_timeout() -> float:
        # 0.8 x serving timeout (reference preprocess_service.py:48-49).
        return 0.8 * float(os.environ.get("TPUSERVE_SERVING_TIMEOUT", 600))

    # -- model loading ------------------------------------------------------

    def _load_model(self) -> None:
        """Resolve the model payload to a local path, then let user ``load()``
        or the engine's native loader build the model object."""
        if self.endpoint.model_id and self._registry is not None:
            record = self._registry.get(self.endpoint.model_id)
            if record is None:
                raise EndpointModelError(
                    "model {!r} not found in registry".format(self.endpoint.model_id)
                )
            self._model_local_path = record.get_local_copy()
        if self._preprocess is not None and hasattr(self._preprocess, "load"):
            loaded = self._preprocess.load(self._model_local_path)
            if loaded is not None:
                self._model = loaded
                return
        if self._model is None:
            self._model = self._native_load()

    def _native_load(self) -> Any:
        """Engine-specific default model loader (no-op for pure-custom)."""
        return None

    # -- request phases ------------------------------------------------------

    def preprocess(self, body: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "preprocess"):
            return self._preprocess.preprocess(body, state, collect_fn)
        return body

    def process(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "process"):
            return self._preprocess.process(data, state, collect_fn)
        return data

    def postprocess(self, data: Any, state: dict, collect_fn=None) -> Any:
        if self._preprocess is not None and hasattr(self._preprocess, "postprocess"):
            return self._preprocess.postprocess(data, state, collect_fn)
        return data

    def retire(self) -> None:
        """Called by the processor when it drops this instance (its endpoint
        was removed or changed; in-flight requests may still hold it). The
        default leaves the release to the collector, as the reference does;
        an engine that holds the card overrides it."""

    def unload(self) -> None:
        if self._preprocess is not None and hasattr(self._preprocess, "unload"):
            try:
                self._preprocess.unload()
            except Exception as ex:
                print("preprocess unload failed: {}".format(ex))
        self._preprocess = None
        self._model = None

    def __del__(self):
        try:
            self.unload()
        except Exception:  # a finalizer's exceptions are unraisable
            pass
