"""A PNG writer on zlib and struct, for hosts without an imaging library.

Writes 8-bit RGB (or grayscale) images: the pixels that
`PIL.Image.fromarray(a).save(path)` writes for a uint8 array, every row
with filter type 0 in one zlib-compressed IDAT chunk.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"PNG pixels must be uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 3:
        color = 2
    elif a.ndim == 2:
        color = 0
    else:
        raise ValueError(f"expected (H, W, 3) or (H, W), got {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
