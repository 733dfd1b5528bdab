"""Read-only loader for the reference's checkpoint files.

Counterpart of tal_asrd_tpu/core/checkpoint.py `load_pytree` (no target):
the reference writes parameters as flax msgpack bytes. This is a minimal
pure-Python reader of the msgpack subset that format uses — maps, strings,
binaries, integers, floats, booleans, arrays and extension types — so the
port needs neither `msgpack` nor `flax`. Extension type 1 is an ndarray
packed as msgpack `(shape, dtype_name, bytes)`; type 3 is a numpy scalar in
the same packing; oversized leaves arrive as chunk dictionaries and are
re-joined.

numpy has no bfloat16, so a `bfloat16` leaf comes back as its 16-bit
patterns in an array of dtype `BFLOAT16_BITS` (uint16 tagged through dtype
metadata). `core/convert.py` turns those into `torch.bfloat16` with a view;
`is_bfloat16_bits` tells them apart from ordinary uint16 data.

There is no writer and there are no checkpoint managers here; they arrive
with training.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

# uint16 carrying bfloat16 bit patterns. The metadata survives frombuffer /
# reshape / view, which is all the loader does with it.
BFLOAT16_BITS = np.dtype(np.uint16, metadata={"bits_of": "bfloat16"})

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def is_bfloat16_bits(arr: np.ndarray) -> bool:
    """True for arrays that hold bfloat16 bit patterns: this loader's tagged
    uint16, or a third-party 2-byte dtype named 'bfloat16'."""
    meta = arr.dtype.metadata
    if meta is not None and meta.get("bits_of") == "bfloat16":
        return True
    return arr.dtype.name == "bfloat16"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def num(self, fmt: str):
        (v,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        return v

    def read(self) -> Any:
        t = self.num("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):
            n = self.num((">B", ">H", ">I")[t - 0xC4])
            return bytes(self.take(n))
        if t in (0xC7, 0xC8, 0xC9):
            n = self.num((">B", ">H", ">I")[t - 0xC7])
            return self.ext(n)
        if t == 0xCA:
            return self.num(">f")
        if t == 0xCB:
            return self.num(">d")
        if 0xCC <= t <= 0xCF:
            return self.num((">B", ">H", ">I", ">Q")[t - 0xCC])
        if 0xD0 <= t <= 0xD3:
            return self.num((">b", ">h", ">i", ">q")[t - 0xD0])
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.string(self.num((">B", ">H", ">I")[t - 0xD9]))
        if t in (0xDC, 0xDD):
            return self.array(self.num((">H", ">I")[t - 0xDC]))
        if t in (0xDE, 0xDF):
            return self.map(self.num((">H", ">I")[t - 0xDE]))
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def string(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int) -> Any:
        code = self.num("b")
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(payload)[()]
        raise ValueError(f"unsupported msgpack extension type {code}")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, raw = _Reader(payload).read()
    dtype = BFLOAT16_BITS if dtype_name == "bfloat16" else np.dtype(dtype_name)
    return np.frombuffer(raw, dtype=dtype).reshape(tuple(shape))


def _index_dict_to_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(node: Any) -> Any:
    """Re-join leaves the writer split into chunks (arrays over 2**30 bytes)."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = _index_dict_to_tuple(node["shape"])
        chunks = _index_dict_to_tuple(node["chunks"])
        # concatenate drops dtype metadata; the view puts the tag back
        return np.concatenate(chunks).view(chunks[0].dtype).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes) -> Any:
    """msgpack bytes -> nested dict of numpy arrays (and Python scalars)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)


def load_pytree(path: str) -> Any:
    """Read a checkpoint file into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
