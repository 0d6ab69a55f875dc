"""The parameter file of a model bundle, ``params.msgpack``, read and written
without flax or the ``msgpack`` package.

The reference writes it with ``flax.serialization.msgpack_serialize`` and
reads it with ``msgpack_restore``. This module speaks the same bytes:

- msgpack maps, arrays, str, bin, ints, floats, bool and nil;
- ndarray leaves as extension type 1 (and numpy scalars as type 3), whose
  payload is the msgpack array ``(shape, dtype name, raw C-order bytes)``;
  ``bfloat16`` is read and written by its name, bit for bit;
- flax's chunked leaves: an array of more than ``MAX_CHUNK_SIZE`` bytes that
  is a map's value (or the root) is written as ``{"__msgpack_chunked_array__":
  True, "shape": {"0": ...}, "chunks": {"0": ...}}`` of flat chunks. Arrays
  inside lists are never chunked, as in flax.

Map keys are written sorted, as ``jax.tree.map`` orders them before flax
packs a tree, so ``dumps(tree)`` equals ``msgpack_serialize(tree)`` byte for
byte.

Leaves come back as ``torch`` tensors. ``read`` maps the file and each leaf
is a ``torch.frombuffer`` view of the mapped bytes, copied once to
``device`` (on the CPU nothing is copied); a chunked leaf is assembled on
``device`` from its chunks. Tuples come back as lists, as in msgpack.
"""

from __future__ import annotations

import io
import mmap
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: read at every call, so a test can
# make it small
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPES: Dict[str, torch.dtype] = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "uint8": torch.uint8,
    "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "bool": torch.bool, "complex64": torch.complex64, "complex128": torch.complex128,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


# -- writing -------------------------------------------------------------------

def _uint_header(n: int, fix: int, fix_limit: int, codes: Tuple[int, int, int]) -> bytes:
    """A length header: the fix form below ``fix_limit``, else 8/16/32-bit
    (``codes``; a 0 code skips that width)."""
    if n < fix_limit:
        return bytes([fix | n])
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code and n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError("msgpack object too large: {}".format(n))


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                 (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError("int out of msgpack range: {}".format(v))


def _pack_str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _uint_header(len(data), 0xa0, 32, (0xd9, 0xda, 0xdb)) + data


def _bin_header(n: int) -> bytes:
    return _uint_header(n, 0, 0, (0xc4, 0xc5, 0xc6))


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _uint_header(n, 0, 0, (0xc7, 0xc8, 0xc9)) + bytes([code])


def _as_numpy(leaf) -> np.ndarray:
    """A leaf's C-order host array (bf16 as its uint16 bits, with the
    dtype name kept apart)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    arr = np.ascontiguousarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _DTYPE_NAMES[leaf.dtype]
    return np.asarray(leaf).dtype.name


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(leaf.nbytes)


def _map_header(n: int) -> bytes:
    return _uint_header(n, 0x80, 16, (0, 0xde, 0xdf))


def _emit_chunked(leaf, emit: Callable[[Any], None]) -> None:
    """flax's ``_chunk``: flat chunks of at most MAX_CHUNK_SIZE bytes, in a
    map whose keys keep flax's insertion order."""
    shape = tuple(leaf.shape)
    itemsize = leaf.element_size() if isinstance(leaf, torch.Tensor) else leaf.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = leaf.reshape(-1)
    starts = range(0, flat.shape[0], size)
    emit(_map_header(3) + _pack_str(_CHUNKED) + b"\xc3" + _pack_str("shape")
         + _map_header(len(shape)))
    for i, d in enumerate(shape):
        emit(_pack_str(str(i)) + _pack_int(int(d)))
    emit(_pack_str("chunks") + _map_header(len(starts)))
    for i, start in enumerate(starts):
        emit(_pack_str(str(i)))
        _emit_array(flat[start:start + size], emit)


def _emit_array(leaf, emit: Callable[[Any], None], code: int = _EXT_NDARRAY) -> None:
    arr = _as_numpy(leaf)
    name = _dtype_name(leaf)
    shape = tuple(leaf.shape)
    inner = (_uint_header(3, 0x90, 16, (0, 0xdc, 0xdd))
             + _uint_header(len(shape), 0x90, 16, (0, 0xdc, 0xdd))
             + b"".join(_pack_int(int(d)) for d in shape)
             + _pack_str(name) + _bin_header(arr.nbytes))
    emit(_ext_header(len(inner) + arr.nbytes, code) + inner)
    if arr.nbytes:
        emit(memoryview(arr.reshape(-1)).cast("B"))


def _emit(obj, emit: Callable[[Any], None], chunkable: bool) -> None:
    """Pack ``obj``; ``chunkable``: reached from the root through maps
    only, where flax chunks a large array."""
    if obj is None:
        emit(b"\xc0")
    elif obj is True or obj is False:
        emit(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        if chunkable and _nbytes(obj) > MAX_CHUNK_SIZE:
            _emit_chunked(obj, emit)
        else:
            _emit_array(obj, emit)
    elif isinstance(obj, np.generic):
        _emit_array(np.asarray(obj), emit, _EXT_NPSCALAR)
    elif isinstance(obj, int):
        emit(_pack_int(obj))
    elif isinstance(obj, float):
        emit(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        emit(_pack_str(obj))
    elif isinstance(obj, (bytes, bytearray)):
        emit(_bin_header(len(obj)) + bytes(obj))
    elif isinstance(obj, (list, tuple)):
        emit(_uint_header(len(obj), 0x90, 16, (0, 0xdc, 0xdd)))
        for v in obj:
            _emit(v, emit, False)
    elif isinstance(obj, dict):
        # sorted, as jax.tree.map leaves a tree's maps before flax packs it
        emit(_map_header(len(obj)))
        for k in sorted(obj):
            _emit(k, emit, False)
            _emit(obj[k], emit, chunkable)
    else:
        raise TypeError("cannot serialize {!r} into a bundle".format(type(obj)))


def dumps(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes."""
    out = io.BytesIO()
    _emit(tree, out.write, True)
    return out.getvalue()


def write(path, tree) -> int:
    """Stream ``tree`` into the file ``path`` (each array's bytes written
    from its host copy, without one buffer of the whole file); returns the
    bytes written."""
    with open(path, "wb") as f:
        _emit(tree, f.write, True)
        return f.tell()


# -- reading -------------------------------------------------------------------

class _Reader:
    """Recursive descent over one msgpack document held in ``buf``."""

    def __init__(self, buf):
        self.buf = buf
        self.view = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.view):
            raise ValueError("truncated msgpack document")
        return start

    def _unpack(self, fmt: str, n: int):
        return struct.unpack_from(fmt, self.view, self._take(n))[0]

    def _str(self, n: int) -> str:
        start = self._take(n)
        return bytes(self.view[start:start + n]).decode("utf-8")

    def value(self):
        b = self.view[self._take(1)]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self._str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            n = self._unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b], 1 << (b - 0xc4))
            start = self._take(n)
            return bytes(self.view[start:start + n])
        if b in (0xc7, 0xc8, 0xc9):
            n = self._unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b], 1 << (b - 0xc7))
            return self._ext(n)
        if b == 0xca:
            return self._unpack(">f", 4)
        if b == 0xcb:
            return self._unpack(">d", 8)
        ints = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
                0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
        if b in ints:
            return self._unpack(*ints[b])
        if 0xd4 <= b <= 0xd8:
            return self._ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return self._str(self._unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b],
                                          1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):
            n = self._unpack(">H" if b == 0xdc else ">I", 2 if b == 0xdc else 4)
            return [self.value() for _ in range(n)]
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I", 2 if b == 0xde else 4))
        raise ValueError("unsupported msgpack byte 0x{:02x} at {}".format(b, self.pos - 1))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self.view[self._take(1)]
        end = self.pos + n
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError("unsupported msgpack extension type {}".format(code))
        # the payload: [shape, dtype name, raw bytes], with the bytes
        # located, not copied
        head = self.view[self._take(1)]
        if head != 0x93:
            raise ValueError("malformed ndarray extension")
        shape = tuple(int(d) for d in self.value())
        name = self.value()
        b = self.view[self._take(1)]
        if b not in (0xc4, 0xc5, 0xc6):
            raise ValueError("malformed ndarray extension: no raw bytes")
        nbytes = self._unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b], 1 << (b - 0xc4))
        offset = self._take(nbytes)
        if self.pos != end:
            raise ValueError("malformed ndarray extension length")
        dtype = _TORCH_DTYPES.get(name)
        if dtype is None:
            raise ValueError("unsupported ndarray dtype {!r}".format(name))
        count = int(np.prod(shape, dtype=np.int64))
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self.buf, dtype=dtype, count=count, offset=offset).reshape(shape)


def _place(obj, device: torch.device, chunkable: bool = True):
    """Each leaf's one copy to ``device`` (none on the CPU); a chunked leaf
    reached from the root through maps only is assembled there from its
    chunks (flax's ``_unchunk``)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        if chunkable and obj.get(_CHUNKED) is True:
            chunks = [obj["chunks"][str(i)] for i in range(len(obj["chunks"]))]
            out = torch.empty(sum(c.numel() for c in chunks), dtype=chunks[0].dtype,
                              device=device)
            at = 0
            for c in chunks:
                out[at:at + c.numel()].copy_(c)
                at += c.numel()
            return out.reshape([obj["shape"][str(i)] for i in range(len(obj["shape"]))])
        return {k: _place(v, device, chunkable) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_place(v, device, False) for v in obj]
    return obj


def loads(data, device="cpu"):
    """``msgpack_restore(data)`` with tensor leaves on ``device`` (bytes are
    copied into a writable buffer first, which ``torch.frombuffer`` needs)."""
    buf = data if isinstance(data, (bytearray, mmap.mmap)) else bytearray(data)
    reader = _Reader(buf)
    out = reader.value()
    if reader.pos != len(reader.view):
        raise ValueError("trailing bytes after the msgpack document")
    return _place(out, torch.device(device))


def read(path, device="cpu"):
    """The tree of the file ``path``, each leaf a view of the mapped file
    copied once to ``device``."""
    with open(Path(path), "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return loads(mm, device)
