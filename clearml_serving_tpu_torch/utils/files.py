"""Atomic file IO + hashing helpers shared by the state store and engines.

The port's copy of ``clearml_serving_tpu/utils/files.py``: the state store
writes the same documents, so either package's CLI and processor read them.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path
from typing import Any, Optional, Union


def atomic_write_text(path: Union[str, Path], text: str) -> None:
    """Write a file so readers never observe a partial write (tmp + rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(path.parent), prefix=".{}.".format(path.name))
    try:
        # mkstemp creates 0600; shared-state docs must be readable by the other
        # service processes (router/engine/statistics may run as different UIDs
        # against one mount).
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, str(path))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: Union[str, Path], obj: Any) -> None:
    # No `default=` fallback: a non-JSON-serializable value must fail at the
    # write site, not silently stringify and corrupt the round-trip.
    atomic_write_text(path, json.dumps(obj, indent=1, sort_keys=True))


def read_json(path: Union[str, Path], retries: int = 3) -> Optional[Any]:
    """Read JSON, tolerating a concurrent atomic replace (retry on decode
    error) and stray non-document paths (None, like a missing file)."""
    path = Path(path)
    for attempt in range(retries):
        try:
            with open(path, "r") as f:
                return json.load(f)
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            return None
        except json.JSONDecodeError:
            if attempt == retries - 1:
                raise
    return None


def sha256_file(path: Union[str, Path], chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            h.update(data)
    return h.hexdigest()


def sha256_obj(obj: Any) -> str:
    """Stable content hash of a JSON-serializable object."""
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode("utf-8")
    ).hexdigest()
