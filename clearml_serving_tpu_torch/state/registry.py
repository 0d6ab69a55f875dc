"""File-backed model registry.

The port's copy of ``clearml_serving_tpu/state/registry.py`` (same format).

Replaces the ClearML model repository the reference queries for model lookup,
upload, publication, and auto-deployment (reference __main__.py:123-154
`func_model_upload`; model_request_processor.py:874-923 monitored-model query).
Each model is a directory with metadata (`model.json`) + payload files, queryable
by project / name / tags / published, newest-first — which is exactly the
ordering the monitoring auto-deploy logic depends on.
"""

from __future__ import annotations

import shutil
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from ..utils.files import atomic_write_json, read_json, sha256_file


class ModelRecord:
    def __init__(self, registry: "ModelRegistry", model_id: str, meta: Dict[str, Any]):
        self._registry = registry
        self.id = model_id
        self._meta = meta

    @property
    def name(self) -> str:
        return self._meta.get("name") or ""

    @property
    def project(self) -> str:
        return self._meta.get("project") or ""

    @property
    def tags(self) -> List[str]:
        return list(self._meta.get("tags") or [])

    @property
    def framework(self) -> Optional[str]:
        return self._meta.get("framework")

    @property
    def published(self) -> bool:
        return bool(self._meta.get("published"))

    @property
    def created(self) -> float:
        return float(self._meta.get("created") or 0)

    @property
    def uri(self) -> Optional[str]:
        return self._meta.get("uri")

    @property
    def files_dir(self) -> Path:
        return self._registry.models_dir / self.id / "files"

    def get_local_copy(self) -> Optional[str]:
        """Local filesystem path to the model payload: the single stored file,
        or the files directory for multi-file models (SavedModel dirs etc.)."""
        d = self.files_dir
        if not d.is_dir():
            return None
        entries = sorted(d.iterdir())
        if len(entries) == 1:
            return str(entries[0])
        return str(d) if entries else None

    def publish(self) -> None:
        self._meta["published"] = True
        self._registry._write_meta(self.id, self._meta)

    def set_metadata(self, **kwargs) -> None:
        self._meta.update(kwargs)
        self._registry._write_meta(self.id, self._meta)

    def as_dict(self) -> Dict[str, Any]:
        return dict(self._meta, id=self.id)


class ModelRegistry:
    def __init__(self, root: Union[str, Path]):
        self.models_dir = Path(root) / "models"
        self.models_dir.mkdir(parents=True, exist_ok=True)

    def _write_meta(self, model_id: str, meta: Dict[str, Any]) -> None:
        atomic_write_json(self.models_dir / model_id / "model.json", meta)

    def register(
        self,
        name: str,
        project: Optional[str] = None,
        tags: Optional[List[str]] = None,
        framework: Optional[str] = None,
        path: Optional[Union[str, Path]] = None,
        uri: Optional[str] = None,
        publish: bool = False,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> ModelRecord:
        """Create a model entry; `path` copies a local file/dir into the
        registry, `uri` records an external destination without copying
        (reference `model upload --url`)."""
        model_id = uuid.uuid4().hex
        model_dir = self.models_dir / model_id
        files_dir = model_dir / "files"
        files_dir.mkdir(parents=True)
        file_hash = None
        if path is not None:
            path = Path(path)
            if path.is_dir():
                shutil.copytree(str(path), str(files_dir / path.name))
            else:
                shutil.copyfile(str(path), str(files_dir / path.name))
                file_hash = sha256_file(files_dir / path.name)
        meta = {
            "id": model_id,
            "name": name,
            "project": project,
            "tags": sorted(set(tags or [])),
            "framework": framework,
            "published": bool(publish),
            "created": time.time(),
            "uri": uri,
            "hash": file_hash,
            "metadata": metadata or {},
        }
        self._write_meta(model_id, meta)
        return ModelRecord(self, model_id, meta)

    def get(self, model_id: str) -> Optional[ModelRecord]:
        meta = read_json(self.models_dir / model_id / "model.json")
        return ModelRecord(self, model_id, meta) if meta else None

    def query(
        self,
        project: Optional[str] = None,
        name: Optional[str] = None,
        tags: Optional[List[str]] = None,
        only_published: bool = False,
        max_results: Optional[int] = None,
    ) -> List[ModelRecord]:
        """Newest-first query — the ordering contract the auto-deploy monitor
        relies on (reference model_request_processor.py:884-893 uses
        `Model.query_models(..., max_results=max_versions)` newest-first)."""
        out: List[ModelRecord] = []
        for entry in self.models_dir.iterdir() if self.models_dir.is_dir() else []:
            meta = read_json(entry / "model.json")
            if not meta:
                continue
            if project is not None and meta.get("project") != project:
                continue
            if name is not None and name not in (meta.get("name") or ""):
                continue
            if tags and not set(tags).issubset(set(meta.get("tags") or [])):
                continue
            if only_published and not meta.get("published"):
                continue
            out.append(ModelRecord(self, meta["id"], meta))
        out.sort(key=lambda m: m.created, reverse=True)
        if max_results:
            out = out[: int(max_results)]
        return out
