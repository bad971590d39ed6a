"""Native host preprocessing: a C++ library bound by ctypes, and the numpy
form of each of its functions. Counterpart of storygen_tpu/native.

`preprocess.cpp` is compiled by g++ at the first call (never at import)
into `build/storygen_tpu_torch/native/<hash>/libpreprocess.so` at the
repository root, keyed by a hash of the flags and the source, and built
into a temporary file that is then renamed, so that processes building at
once do not read a half-written library. A missing compiler or a failed
build raises with the compiler's output: no function falls back to its
numpy form. The numpy forms (`*_numpy`) are the plain versions that the
tests and the smoke hold the library against; each computes the same
float32 arithmetic in the same order, so the two agree bit for bit.
(The JAX package's fallback for `resize_bilinear` is PIL's bilinear, which
antialiases when it shrinks an image and rounds in fixed point: another
function.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parent / "preprocess.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "storygen_tpu_torch" / "native")
LIB_NAME = "libpreprocess.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
SIGNATURES = {
    # src, dst, n, scale, offset
    "normalize_u8_to_f32": (_U8P, _F32P, ctypes.c_int64, ctypes.c_float,
                            ctypes.c_float),
    # srcs, dst, batch, elements per image, scale, offset
    "assemble_batch_f32": (ctypes.POINTER(_U8P), _F32P, ctypes.c_int,
                           ctypes.c_int64, ctypes.c_float, ctypes.c_float),
    # src, sh, sw, dst, dh, dw, channels
    "resize_bilinear_u8": (_U8P, ctypes.c_int, ctypes.c_int, _U8P,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path(root: Optional[Path] = None) -> Path:
    """The library's path under `root` (None: BUILD_ROOT)."""
    key = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return Path(root or BUILD_ROOT) / key.hexdigest()[:16] / LIB_NAME


def build(root: Optional[Path] = None,
          compiler: Optional[str] = None) -> Path:
    """Compile the library under `root` (None: BUILD_ROOT) with
    `compiler` (None: CXX) unless it is there; its path."""
    out = lib_path(root)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [compiler or CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"no C++ compiler {cmd[0]!r} to build "
                           f"{SRC.name}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = None
            _lib = lib
        return _lib


def normalize_u8(img: np.ndarray, scale: float,
                 offset: float) -> np.ndarray:
    """uint8 array -> float32 img * scale + offset (any shape)."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty(img.shape, np.float32)
    lib.normalize_u8_to_f32(img.ctypes.data_as(_U8P),
                            out.ctypes.data_as(_F32P), img.size, scale,
                            offset)
    return out


def normalize_u8_numpy(img: np.ndarray, scale: float,
                       offset: float) -> np.ndarray:
    return np.ascontiguousarray(img, dtype=np.uint8).astype(
        np.float32) * np.float32(scale) + np.float32(offset)


def assemble_batch(images: Sequence[np.ndarray], scale: float,
                   offset: float) -> np.ndarray:
    """Same-shaped uint8 images -> (B, *shape) float32 img * scale +
    offset, in one pass over several threads."""
    lib = load()
    imgs = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    if not imgs or any(im.shape != imgs[0].shape for im in imgs):
        raise ValueError("assemble_batch needs one or more images of one "
                         "shape")
    out = np.empty((len(imgs),) + imgs[0].shape, np.float32)
    ptrs = (_U8P * len(imgs))(*[im.ctypes.data_as(_U8P) for im in imgs])
    lib.assemble_batch_f32(ptrs, out.ctypes.data_as(_F32P), len(imgs),
                           imgs[0].size, scale, offset)
    return out


def assemble_batch_numpy(images: Sequence[np.ndarray], scale: float,
                         offset: float) -> np.ndarray:
    return normalize_u8_numpy(np.stack(images), scale, offset)


def resize_bilinear(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W, C) bilinear resize to (dh, dw, C): half-pixel centres,
    no antialias (torch's F.interpolate(align_corners=False)), rounded to
    the nearest integer."""
    lib = load()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or dh < 1 or dw < 1:
        raise ValueError(f"resize_bilinear needs (H, W, C) uint8 and a size "
                         f"of at least 1 x 1, got {img.shape} -> {dh}x{dw}")
    sh, sw, c = img.shape
    out = np.empty((dh, dw, c), np.uint8)
    lib.resize_bilinear_u8(img.ctypes.data_as(_U8P), sh, sw,
                           out.ctypes.data_as(_U8P), dh, dw, c)
    return out


def resize_bilinear_numpy(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    sh, sw, _ = img.shape
    f32 = np.float32

    def taps(n_out, n_in):
        pos = (np.arange(n_out, dtype=f32) + f32(0.5)) * (
            f32(n_in) / f32(n_out)) - f32(0.5)
        i0 = np.clip(pos.astype(np.int32), 0, n_in - 1)
        i1 = np.minimum(i0 + 1, n_in - 1)
        w = np.clip(pos - i0.astype(f32), f32(0), f32(1))
        return i0, i1, w

    y0, y1, wy = taps(dh, sh)
    x0, x1, wx = taps(dw, sw)
    src = img.astype(f32)
    wy, wx = wy[:, None, None], wx[None, :, None]
    v = (src[y0][:, x0] * (1 - wy) * (1 - wx)
         + src[y0][:, x1] * (1 - wy) * wx
         + src[y1][:, x0] * wy * (1 - wx)
         + src[y1][:, x1] * wy * wx)
    return np.minimum(f32(255), np.maximum(f32(0), v + f32(0.5))).astype(
        np.uint8)
