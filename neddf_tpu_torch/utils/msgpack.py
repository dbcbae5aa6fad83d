"""Minimal msgpack reader and writer for flax checkpoints (no msgpack
package).

``flax.serialization.to_bytes`` writes a msgpack map whose leaves are
arrays in extension type 1: the ext payload is itself a msgpack array
``[shape, dtype-name, raw bytes]`` (C order). Extension type 3 is a numpy
scalar with the same payload. Python lists in the saved tree were turned
into maps keyed ``"0"``, ``"1"``, ... before writing, so they come back
as such maps; ``training/checkpoint.py`` handles both forms. The writer
(``packb``) produces the same layout, so ``flax.serialization.
msgpack_restore`` and this reader both load what it writes.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple, Union

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated input")
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Tuple[Any, ...]:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def value(self) -> Any:
        (b,) = self.take(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
            0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
            0xDC: ("arr", ">H"), 0xDD: ("arr", ">I"),
            0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
            0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
        }
        if b in sized:
            kind, fmt = sized[b]
            (n,) = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode("utf-8")
            if kind == "arr":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            (code,) = self.unpack(">b")
            return _ext(code, self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            (code,) = self.unpack(">b")
            return _ext(code, self.take(fixext[b]))
        numbers = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in numbers:
            return self.unpack(numbers[b])[0]
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, bytes):
                key = key.decode("utf-8")
            out[key] = self.value()
        return out


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Reader(payload).value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("utf-8")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext(code: int, payload: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack: unsupported extension type {code}")


def unpackb(data: bytes) -> Any:
    """Decode one msgpack document (flax array extensions included)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the document")
    return out


def load_msgpack(path: Union[str, Path]) -> Any:
    return unpackb(Path(path).read_bytes())


def _ext_header(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        head = bytes([fixext[n]])
    elif n < 1 << 8:
        head = struct.pack(">BB", 0xC7, n)
    elif n < 1 << 16:
        head = struct.pack(">BH", 0xC8, n)
    else:
        head = struct.pack(">BI", 0xC9, n)
    return head + struct.pack(">b", code) + payload


def _sized(n: int, fix_base: int, fix_max: int, codes: Tuple[int, int, int]) -> bytes:
    if n < fix_max:
        return bytes([fix_base | n])
    if codes[0] and n < 1 << 8:
        return struct.pack(">BB", codes[0], n)
    if n < 1 << 16:
        return struct.pack(">BH", codes[1], n)
    return struct.pack(">BI", codes[2], n)


def _pack(obj: Any, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            out.append(struct.pack(">BQ", 0xCF, obj))
        else:
            out.append(struct.pack(">Bq", 0xD3, obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_sized(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + data)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_sized(len(obj), 0, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj))
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        out.append(_ext_header(_EXT_NDARRAY, payload))
    elif isinstance(obj, np.generic):
        arr = np.asarray(obj)
        out.append(_ext_header(_EXT_NPSCALAR, packb([[], arr.dtype.name, arr.tobytes("C")])))
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), 0x80, 16, (0, 0xDE, 0xDF)))
        for key, value in obj.items():
            _pack(str(key), out)
            _pack(value, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_sized(len(obj), 0x90, 16, (0, 0xDC, 0xDD)))
        for value in obj:
            _pack(value, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode maps, lists, scalars, bytes and numpy arrays (flax's array
    extension types) as one msgpack document."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def save_msgpack(path: Union[str, Path], obj: Any) -> None:
    """Write ``packb(obj)`` atomically (a reader never sees half a file)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(packb(obj))
    tmp.replace(path)
