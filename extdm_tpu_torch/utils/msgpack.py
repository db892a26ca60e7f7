"""Reader of the JAX package's checkpoints (``extdm_tpu/train/checkpoint.py``
writes one flax msgpack file per checkpoint), without the ``msgpack`` or
``flax`` packages, which the card's machine lacks.

``unpackb`` decodes the msgpack wire format: nil, bool, int, float, str,
bin, array, map and the ext family (fixext 1-16, ext 8/16/32), every
length big-endian. ``msgpack_restore`` follows
``flax.serialization.msgpack_restore``: flax's three ext types (1: an
ndarray packed as (shape, dtype name, raw bytes); 2: a complex number
packed as (real, imag); 3: a numpy scalar packed as an ndarray), then the
chunked leaves that flax writes for arrays over ``MAX_CHUNK_SIZE`` bytes
({"__msgpack_chunked_array__", "shape", "chunks"}) joined back. Arrays are
numpy arrays (read-only views of the file's bytes, as flax gives them);
a bfloat16 leaf, which numpy cannot hold without ``ml_dtypes``, is a
``torch.bfloat16`` tensor. A malformed file or an ext code flax does not
write raises ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Optional

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # first byte -> (struct format, size) of the fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Decoder:
    def __init__(self, data: bytes, raw: bool, ext_hook: Optional[Callable[[int, bytes], Any]]):
        self.data, self.pos, self.raw, self.ext_hook = bytes(data), 0, raw, ext_hook

    def take(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            raise ValueError(f"msgpack: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.unpack(_LEN[size], size)

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str(b & 0x1F)
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return self.take(self.length(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            return self.ext(self.length(1 << (b - 0xC7)))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.str(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.length(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.length(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at offset {self.pos - 1} starts no object")

    def str(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")  # UnicodeDecodeError is a ValueError

    def array(self, n: int) -> list:
        if n > len(self.data) - self.pos:  # each element takes a byte at least
            raise ValueError(f"msgpack: an array of {n} elements at offset {self.pos}")
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        if 2 * n > len(self.data) - self.pos:
            raise ValueError(f"msgpack: a map of {n} entries at offset {self.pos}")
        out = {}
        for _ in range(n):
            key = self.obj()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack: a map key of type {type(key).__name__}")
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        data = self.take(n)
        if self.ext_hook is None:
            raise ValueError(f"msgpack: ext type {code} with no hook")
        return self.ext_hook(code, data)


def unpackb(data: bytes, raw: bool = False,
            ext_hook: Optional[Callable[[int, bytes], Any]] = None) -> Any:
    """One msgpack object from `data` (all of it): maps as dicts, arrays as
    lists, str as str (bytes with `raw`), bin as bytes, ext through
    ext_hook(code, payload)."""
    dec = _Decoder(data, raw, ext_hook)
    try:
        out = dec.obj()
    except RecursionError as e:
        raise ValueError("msgpack: nested too deep") from e
    if dec.pos != len(dec.data):
        raise ValueError(f"msgpack: {len(dec.data) - dec.pos} bytes after the object")
    return out


def _ndarray(data: bytes):
    """flax's ndarray payload: (shape, dtype name, C-order bytes)."""
    parts = unpackb(data, raw=True)
    if not (isinstance(parts, list) and len(parts) == 3 and isinstance(parts[0], list)
            and isinstance(parts[1], bytes) and isinstance(parts[2], bytes)
            and all(isinstance(d, int) and d >= 0 for d in parts[0])):
        raise ValueError("msgpack: an ndarray payload is not (shape, dtype name, bytes)")
    shape, name, buf = parts
    if name == b"bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name.decode("ascii"))
    except TypeError as e:
        raise ValueError(f"msgpack: unknown dtype {name!r}") from e
    if dtype.hasobject:
        raise ValueError(f"msgpack: object dtype {name!r}")
    return np.frombuffer(buf, dtype).reshape(shape)


def flax_ext_hook(code: int, data: bytes):
    """flax.serialization's _msgpack_ext_unpack, raising on any other code."""
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        parts = unpackb(data)
        if not (isinstance(parts, list) and len(parts) == 2):
            raise ValueError("msgpack: a complex payload is not (real, imag)")
        return complex(parts[0], parts[1])
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    raise ValueError(f"msgpack: ext type {code} is none of flax's (1 ndarray, 2 complex, "
                     f"3 numpy scalar)")


def _unchunk(node: dict):
    def as_tuple(d):
        if not isinstance(d, dict):
            raise ValueError("msgpack: a chunked array's shape or chunks is not a map")
        return tuple(d[str(i)] for i in range(len(d)))

    try:
        shape, chunks = as_tuple(node["shape"]), as_tuple(node["chunks"])
    except KeyError as e:
        raise ValueError(f"msgpack: a chunked array without {e}") from e
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(node):
    """flax's _unchunk_array_leaves_in_place: chunked maps (the tree itself
    and values of maps, not list items) back into arrays."""
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        for k, v in node.items():
            if isinstance(v, dict):
                node[k] = _unchunk_leaves(v)
    return node


def msgpack_restore(data: bytes) -> Any:
    """flax.serialization.msgpack_restore without msgpack or flax."""
    return _unchunk_leaves(unpackb(data, ext_hook=flax_ext_hook))


def load_jax_checkpoint(path: str) -> Any:
    """The tree a JAX package checkpoint (or any flax msgpack file) holds."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
