"""A PNG writer and reader on zlib and struct, for hosts without an
imaging library.

Writes 8-bit RGB (or grayscale) images: the pixels that
`PIL.Image.fromarray(a).save(path)` writes for a uint8 array, every row
with filter type 0 in one zlib-compressed IDAT chunk.

Reads 8-bit, non-interlaced PNGs of colour types 0 (grey), 2 (RGB),
3 (palette), 4 (grey + alpha) and 6 (RGBA), with all five row filters,
as RGB: the pixels of `PIL.Image.open(path).convert("RGB")` (alpha and
tRNS dropped, grey repeated, palette looked up). Anything else raises
ValueError.
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


# samples per pixel of each colour type
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    """(kind, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or corrupt")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("PNG file ends before IEND")


def png_size(path: str) -> tuple:
    """(width, height) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])


def _unfilter(raw: np.ndarray, h: int, w: int, ch: int) -> np.ndarray:
    """Undo the per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)
    of (h, 1 + w * ch) filtered bytes -> (h, w, ch) uint8.

    A pixel's prediction reads its left, upper and upper-left neighbours,
    so the pixels of one anti-diagonal (y + x = d) depend only on earlier
    diagonals: the loop walks the diagonals, each at once."""
    rows = raw.reshape(h, 1 + w * ch)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {kinds.max()} is not one of 0-4")
    data = rows[:, 1:].reshape(h, w, ch)
    if not kinds.any():
        return data.copy()
    line = data.astype(np.int32)
    # out[y + 1, x + 1] is pixel (y, x); row 0 and column 0 stay 0
    out = np.zeros((h + 1, w + 1, ch), np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        left, up, up_left = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, up_left))
        k = kinds[ys][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [left, up, (left + up) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}; 8-bit "
                         "non-interlaced types 0, 2, 3, 4, 6 are read")
    ch = CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * ch + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, not "
                         f"{h * (w * ch + 1)}")
    px = _unfilter(raw, h, w, ch)
    if color == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        table = np.zeros((256, 3), np.uint8)  # entries past PLTE are black
        table[:len(palette)] = palette
        return table[px[..., 0]]
    if color in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path: str) -> np.ndarray:
    """A PNG file -> (H, W, 3) uint8 RGB (see decode_png)."""
    with open(path, "rb") as f:
        return decode_png(f.read())
