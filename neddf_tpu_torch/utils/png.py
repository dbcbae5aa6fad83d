"""Minimal PNG reader and writer (zlib + numpy, no image library).

Covers what the bundled NeRF-synthetic scenes and the eval outputs use:
8-bit, non-interlaced, grayscale / gray+alpha / RGB / RGBA. The reader
undoes all five scanline filters (None, Sub, Up, Average, Paeth); the
writer emits filter 0 rows compressed with zlib.

Channel order is the file's own (RGB[A]). OpenCV's ``imread`` returns
BGR[A]; callers that must match it flip the channels themselves.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    """Undo the Paeth filter on one scanline (sequential along the row)."""
    out = bytearray(len(filt))
    for i in range(len(filt)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (filt[i] + pred) & 0xFF
    return out


def _average_row(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    """Undo the Average filter on one scanline."""
    out = bytearray(len(filt))
    for i in range(len(filt)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (filt[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    types = rows[:, 0]
    data = rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(types[y])
        row = data[y]
        if ftype == 0:
            cur = row
        elif ftype == 1:
            # Sub: running sum per channel along the row, mod 256
            cur = np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0)
            cur = (cur & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:
            cur = row + prior  # uint8 wraps mod 256
        elif ftype == 3:
            cur = np.frombuffer(
                _average_row(row.tobytes(), prior.tobytes(), bpp), np.uint8
            )
        elif ftype == 4:
            cur = np.frombuffer(
                _paeth_row(row.tobytes(), prior.tobytes(), bpp), np.uint8
            )
        else:
            raise ValueError(f"PNG scanline {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: Union[str, Path]) -> np.ndarray:
    """Decode an 8-bit PNG to ``[H, W, C]`` uint8 (``[H, W]`` for gray)."""
    blob = Path(path).read_bytes()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        body = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: missing IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); only 8-bit non-interlaced gray/RGB[A]"
        )
    channels = _CHANNELS[ctype]
    pixels = _unfilter(
        zlib.decompress(b"".join(idat)), height, width * channels, channels
    )
    img = pixels.reshape(height, width, channels)
    return img[:, :, 0] if channels == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def write_png(path: Union[str, Path], img: np.ndarray) -> None:
    """Encode ``[H, W]`` / ``[H, W, C]`` uint8 (C in 1..4, RGB[A] order)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    height, width, channels = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), img.reshape(height, width * channels)],
        axis=1,
    )
    header = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    Path(path).write_bytes(
        _SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )
