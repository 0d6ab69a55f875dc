"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``clearml_serving_tpu_torch/csrc`` are compiled for
``sm_90a`` into one shared library with a plain C interface,
``build/kernels/libtpu_torch_kernels.so`` at the repository root. The build
runs at first use, one ``nvcc`` process per source, all started together,
and runs again whenever the hash of the sources and flags changes. The check
and the build hold an exclusive ``fcntl.flock`` on ``build/kernels/.lock``:
the object files have fixed names, so processes that reach their first kernel
together (a process fleet's workers on a cold tree) take turns, and the later
ones find the library current. Nothing is built or loaded when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("paged_attention.cu", "ragged_paged_attention.cu", "fused_int4_matmul.cu")
BUILD_DIR = _PKG.parent / "build" / "kernels"
LIB_NAME = "libtpu_torch_kernels.so"
# --split-compile=0 runs the compiler's optimizations and ptxas on every
# CPU: the ragged kernel's 48 template instances took 43.1 s in one nvcc
# without it and 19.0 s with both (nvcc 12.9 on the card's 8-core host)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "--split-compile=0", "-Xptxas", "--split-compile=0",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
            "CUDA kernels are built from source at first use"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh", ".h"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()


@contextlib.contextmanager
def _interprocess_lock():
    """The build directory's exclusive lock, across processes."""
    with open(BUILD_DIR / ".lock", "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build() -> Path:
    """Compile the library unless a current one exists; returns its path.
    The compiler's register and shared-memory report (``-Xptxas -v``) is
    kept in ``build/kernels/build.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _interprocess_lock():
        return _build_locked()


def _build_locked() -> Path:
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = _nvcc()
    jobs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    log, failed = [], []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append("== {} (exit {})\n{}".format(src, proc.returncode, out))
        if proc.returncode:
            failed.append(src)
    tmp = BUILD_DIR / "{}.{}.tmp".format(LIB_NAME, os.getpid())
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in jobs),
             "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append("== link (exit {})\n{}".format(link.returncode, link.stdout))
        if link.returncode:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            "kernel build failed ({}):\n{}".format(", ".join(failed), "\n".join(log))
        )
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def build_log() -> str:
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


def load_library() -> ctypes.CDLL:
    """The built library with every entry point's ctypes signature set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.tpu_torch_paged_attention
            # q, k_pool, v_pool, k_scale, v_scale, page_table, lengths, out,
            # part_acc, part_m, part_l; batch, hkv, groups, head_dim, n_pages,
            # page_size, pages_per_seq, kv_int8, splits, span; stream
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.tpu_torch_ragged_paged_attention
            # q, k_pool, v_pool, k_scale, v_scale, page_table, kv_lens,
            # row_starts, row_lens, block_rows, block_q0, tree_anc, out,
            # part_acc, part_m, part_l; n_blocks, hkv, groups, head_dim,
            # n_pages, page_size, pages_per_seq, n_rows, kv_int8, tree_width,
            # splits, span; stream
            fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = lib.tpu_torch_fused_int4_matmul
            # x, packed, scale, out, workspace; m, k, n, group;
            # workspace_bytes; stream
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fn = lib.tpu_torch_fused_int4_workspace
            # m, k, n, group; out: workspace bytes
            fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
