"""Self-contained control-plane state store.

The port's copy of ``clearml_serving_tpu/state/store.py``, with the same
on-disk format and environment (``TPUSERVE_STATE_ROOT``): one state root can
be written by either package's CLI and served by either package's processor.

The reference keeps all control-plane state on a ClearML "Task" object that every
runtime container polls and reconciles against (SURVEY.md §0; reference
model_request_processor.py:610-760). This module provides the same semantics
without an external server: a **file-backed service document** with

- parameters (the "General/*" config keys),
- named config objects (endpoints / canary / model_monitoring / metric_logging /
  model_monitoring_eps),
- runtime properties (framework version etc.),
- artifacts (uploaded preprocess code, content-hashed),
- a monotonically increasing ``update_counter`` and heartbeat timestamps.

Writes are atomic (tmp + rename) and read-modify-write cycles take an
``fcntl`` file lock, so any number of router / engine / statistics processes can
poll one service document concurrently — the same eventual-consistency model as
the reference's Task polling, with the filesystem (or a network mount / object
store sync) as the transport.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import time
import uuid
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from ..utils.files import atomic_write_json, read_json, sha256_file
from ..version import __version__

SERVICE_TAG = "serving-control-plane"


def default_state_root() -> Path:
    return Path(
        os.environ.get("TPUSERVE_STATE_ROOT")
        or os.environ.get("CLEARML_SERVING_STATE_ROOT")
        or (Path.home() / ".tpu-serving")
    )


class ServingService:
    """Handle on one service document (the control-plane 'Task' equivalent)."""

    def __init__(self, store: "StateStore", service_id: str):
        self._store = store
        self.id = service_id
        self._dir = store.services_dir / service_id
        self._doc_path = self._dir / "service.json"
        self._lock_path = self._dir / ".lock"
        self.artifacts_dir = self._dir / "artifacts"

    # -- lifecycle ---------------------------------------------------------

    @property
    def exists(self) -> bool:
        return self._doc_path.is_file()

    def _read(self) -> Dict[str, Any]:
        doc = read_json(self._doc_path)
        if doc is None:
            raise FileNotFoundError(
                "serving service {!r} not found under {}".format(self.id, self._dir)
            )
        return doc

    @contextmanager
    def _locked(self):
        self._dir.mkdir(parents=True, exist_ok=True)
        with open(self._lock_path, "a+") as lock_f:
            fcntl.flock(lock_f.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock_f.fileno(), fcntl.LOCK_UN)

    def _mutate(self, fn) -> Dict[str, Any]:
        """Locked read-modify-write; bumps update_counter."""
        with self._locked():
            doc = self._read()
            fn(doc)
            doc["update_counter"] = int(doc.get("update_counter", 0)) + 1
            doc["last_update"] = time.time()
            atomic_write_json(self._doc_path, doc)
            return doc

    # -- reference-Task-equivalent surface ---------------------------------

    def get_snapshot(self) -> Dict[str, Any]:
        """One consistent read of the whole service document (atomic replace on
        the writer side guarantees a torn-free view)."""
        return self._read()

    def get_parameters(self) -> Dict[str, Any]:
        return dict(self._read().get("parameters") or {})

    def update_parameters(self, params: Dict[str, Any]) -> None:
        self._mutate(lambda d: d.setdefault("parameters", {}).update(params))

    def get_configuration_object(self, name: str) -> Optional[Any]:
        return (self._read().get("configuration") or {}).get(name)

    def set_configuration_objects(self, objects: Dict[str, Any]) -> None:
        self._mutate(lambda d: d.setdefault("configuration", {}).update(objects))

    def get_runtime_properties(self) -> Dict[str, Any]:
        return dict(self._read().get("runtime") or {})

    def set_runtime_properties(self, props: Dict[str, Any]) -> None:
        self._mutate(lambda d: d.setdefault("runtime", {}).update(props))

    def ping(self, instance_id: Optional[str] = None) -> None:
        """Heartbeat (reference: Task keep-alive ping each poll cycle)."""
        def _apply(doc):
            doc["last_ping"] = time.time()
            if instance_id:
                doc.setdefault("instances", {})[instance_id] = time.time()
        self._mutate(_apply)

    @property
    def name(self) -> str:
        return self._read().get("name") or ""

    @property
    def project(self) -> str:
        return self._read().get("project") or ""

    @property
    def update_counter(self) -> int:
        return int(self._read().get("update_counter", 0))

    # -- artifacts (preprocess code) ---------------------------------------

    def upload_artifact(self, name: str, local_path: Union[str, Path]) -> str:
        """Store a file (or package directory) under the service; returns the
        artifact name. Directories are zipped (reference uploads preprocess
        packages the same way)."""
        local_path = Path(local_path)
        dest_dir = self.artifacts_dir / name
        with self._locked():
            if dest_dir.exists():
                shutil.rmtree(dest_dir)
            dest_dir.mkdir(parents=True)
            if local_path.is_dir():
                archive = shutil.make_archive(
                    str(dest_dir / "package"), "zip", root_dir=str(local_path)
                )
                stored = Path(archive)
            else:
                stored = dest_dir / local_path.name
                shutil.copyfile(str(local_path), str(stored))
            meta = {
                "file": stored.name,
                "hash": sha256_file(stored),
                "uploaded": time.time(),
            }
            atomic_write_json(dest_dir / "artifact.json", meta)
            # Update the service doc inside the SAME lock acquisition so the
            # doc's artifact hash can never diverge from artifact.json when
            # two processes upload the same artifact name concurrently.
            doc = self._read()
            doc.setdefault("artifacts", {})[name] = meta
            doc["update_counter"] = int(doc.get("update_counter", 0)) + 1
            doc["last_update"] = time.time()
            atomic_write_json(self._doc_path, doc)
        return name

    def get_artifact(self, name: str) -> Optional[Path]:
        """Local path of a stored artifact file (hash in ``artifact_hash``)."""
        meta = read_json(self.artifacts_dir / name / "artifact.json")
        if not meta:
            return None
        return self.artifacts_dir / name / meta["file"]

    def artifact_hash(self, name: str) -> Optional[str]:
        meta = read_json(self.artifacts_dir / name / "artifact.json")
        return meta.get("hash") if meta else None

    def list_artifacts(self) -> List[str]:
        return sorted((self._read().get("artifacts") or {}).keys())


class StateStore:
    """Root of all local control-plane state: services + the model registry."""

    def __init__(self, root: Optional[Union[str, Path]] = None):
        self.root = Path(root) if root else default_state_root()
        self.services_dir = self.root / "services"
        self.services_dir.mkdir(parents=True, exist_ok=True)

    def create_service(
        self,
        name: str,
        project: str = "DevOps",
        tags: Optional[List[str]] = None,
    ) -> ServingService:
        service_id = uuid.uuid4().hex
        svc = ServingService(self, service_id)
        doc = {
            "id": service_id,
            "name": name,
            "project": project,
            "tags": sorted(set(list(tags or []) + [SERVICE_TAG])),
            "type": "service",
            "created": time.time(),
            "last_update": time.time(),
            "update_counter": 0,
            "parameters": {},
            "configuration": {},
            "runtime": {"version": __version__},
            "artifacts": {},
            "instances": {},
        }
        svc._dir.mkdir(parents=True, exist_ok=True)
        atomic_write_json(svc._doc_path, doc)
        return svc

    def get_service(self, service_id: str) -> ServingService:
        svc = ServingService(self, service_id)
        if not svc.exists:
            raise FileNotFoundError("serving service {!r} not found".format(service_id))
        return svc

    def find_service(self, name: Optional[str] = None) -> Optional[ServingService]:
        """Most recently updated service (optionally by name)."""
        candidates = []
        for entry in self.services_dir.iterdir() if self.services_dir.is_dir() else []:
            doc = read_json(entry / "service.json")
            if not doc:
                continue
            if name and doc.get("name") != name:
                continue
            candidates.append((doc.get("last_update", 0), doc["id"]))
        if not candidates:
            return None
        candidates.sort(reverse=True)
        return ServingService(self, candidates[0][1])

    def list_services(self) -> List[Dict[str, Any]]:
        out = []
        for entry in sorted(self.services_dir.iterdir()) if self.services_dir.is_dir() else []:
            doc = read_json(entry / "service.json")
            if doc:
                out.append(
                    {
                        "id": doc.get("id"),
                        "name": doc.get("name"),
                        "project": doc.get("project"),
                        "tags": doc.get("tags"),
                        "created": doc.get("created"),
                        "update_counter": doc.get("update_counter"),
                    }
                )
        return out
