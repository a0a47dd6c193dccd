"""Minimal 8-bit PNG reader and writer on numpy and zlib. It exists only
for hosts with neither OpenCV nor Pillow, such as a bare CUDA container;
the CLI uses OpenCV, else Pillow, when one is installed. PNG only: other
formats need one of those libraries.

Reads non-interlaced 8-bit grayscale, gray+alpha, RGB and RGBA images with
any of the five row filters; writes RGB with filter 0.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """HWC uint8 RGB -> PNG file."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes RGB, got {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    Path(path).write_bytes(
        _SIG
        + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def read_png(path: str | Path) -> np.ndarray:
    """PNG file -> HWC uint8 RGB (alpha dropped, gray expanded)."""
    data = Path(path).read_bytes()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:  # Up
            cur = (line + prev) & 0xFF
        else:  # Sub, Average, Paeth depend on the reconstructed left pixel
            cur = line.copy()
            for i in range(w * c):
                a = cur[i - c] if i >= c else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + prev[i]) // 2
                else:
                    pred = _paeth(a, prev[i], prev[i - c] if i >= c else 0)
                cur[i] = (cur[i] + pred) & 0xFF
        out[y] = prev = cur
    img = out.astype(np.uint8).reshape(h, w, c)
    if c in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
